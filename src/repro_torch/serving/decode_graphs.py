"""Piecewise CUDA graphs of the paged GQA decode step.

Run eagerly, a decode step of a dense GQA stack is about a hundred small
launches a layer (the norms, the projections and their biases, the
rotary embeddings, the K/V writes into the pools, the MLP, the residual
adds), one of them ``paged_attention``; with 64 rows on an H100 the host
takes longer to launch them than the card to run them. Here the step's
work between its attention calls is captured once into ``L + 1`` CUDA
graphs at a fixed row count, and each step replays them:

* ``G_0``: the embedding, then layer 0 up to its attention (``ln1``, q,
  k, v, both rotary embeddings, and the K/V writes into the pools at the
  step's (page, offset) slots); its output is layer 0's q;
* ``G_l`` (``0 < l < L``): layer ``l - 1`` after its attention (``wo``,
  the residual, ``ln2``, the MLP, the residual), then layer ``l`` up to
  its attention;
* ``G_L``: the last layer after its attention, the final norm and the
  unembedding; its output is the logits.

Each layer's attention runs eagerly between the pieces, through the
caller's ``attention`` callable: ``paged_attention``'s grid follows the
step's block-table width, which changes from step to step, and a call
that a graph replays would no longer be a call (its launch count and the
benchmark's spans around it go with it). Its output lands in the static
context buffer that the next piece reads.

A replay reads and writes fixed addresses: the step's inputs (tokens,
positions, and each row's page slot and offset in it) are copied into one
static buffer first; the pools and the weights are allocated once for the
engine's life and written in place only; every tensor that crosses a
piece boundary (the residual stream, the queries, the context) is held
here for as long as the graphs are. The pieces share one memory pool.

Off the card (no graphs) :meth:`DecodeGraphs.run` runs the same pieces
eagerly, in the same order, which is how the CPU tests hold the
decomposition to the eager layers.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import gqa_layer_out, gqa_layer_qkv
from repro_torch.models.layers import embed, rms_norm, unembed


class DecodeGraphs:
    """The pieces of one engine's GQA decode step at ``n`` rows, captured
    into CUDA graphs on a CUDA engine. ``engine`` is a dense GQA
    :class:`~repro_torch.serving.engine.PagedEngine`; it is not kept."""

    def __init__(self, engine, n: int):
        cfg, dev = engine.cfg, engine.device
        self.cfg = cfg
        self.params = engine.params
        # per layer: (segment, index, parameters, its K pool, its V pool)
        self.layers = [(seg, li, p, engine.k_pages[li], engine.v_pages[li])
                       for seg, li, p in engine.model.layers(engine.params)]
        # rows of the step's inputs: tokens, positions, the page slot of
        # each row's write (the trash page for an idle row), its offset
        self.inputs = torch.zeros(4, n, dtype=torch.int64, device=dev)
        # the attention output of the layer the next piece finishes
        self.ctx = torch.zeros(n, 1, cfg.num_heads, cfg.head_dim,
                               dtype=cfg.torch_dtype, device=dev)
        self._ctx_rows = self.ctx[:, 0]
        self.graphs = None
        # per piece: (residual stream, q or logits), held for the replays
        self.outs = None
        if dev.type == "cuda":
            self._capture(dev, engine.ecfg.num_pages)

    def _piece(self, i: int, x):
        """Piece ``i``'s work on the residual stream ``x`` (the previous
        piece's); returns (its residual stream, its q or the logits)."""
        cfg, params = self.cfg, self.params
        toks, pos, slot, off = self.inputs
        if i == 0:
            x = embed(params["embed"], toks[:, None])  # (n, 1, d)
        else:
            x = gqa_layer_out(cfg, self.layers[i - 1][2], x, self.ctx)
        if i == len(self.layers):
            h = rms_norm(params["final_norm"], x, cfg.norm_eps)
            return x, unembed(params["embed"], h, cfg.vocab_size,
                              fp32=cfg.logits_fp32)[:, 0]
        _, _, p, kp, vp = self.layers[i]
        q, k, v = gqa_layer_qkv(cfg, p, x, pos[:, None])
        kp[slot, off] = k.flatten(0, 1).to(kp.dtype)
        vp[slot, off] = v.flatten(0, 1).to(vp.dtype)
        return x, q

    def _capture(self, dev, trash_page: int) -> None:
        """One eager pass of the pieces on the capture stream (the lazy
        set-up of the libraries they call happens outside a capture), its
        writes parked on the trash page, then one graph per piece."""
        self.inputs[2].fill_(trash_page)
        cur = torch.cuda.current_stream(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            x = None
            for i in range(len(self.layers) + 1):
                x, _ = self._piece(i, x)
            stream.synchronize()
            pool = torch.cuda.graph_pool_handle()
            self.graphs, self.outs, x = [], [], None
            for i in range(len(self.layers) + 1):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                x, out = self._piece(i, x)
                g.capture_end()
                self.graphs.append(g)
                self.outs.append((x, out))
        cur.wait_stream(stream)

    def run(self, attention):
        """The step on the inputs already in :attr:`inputs`: each piece in
        turn and, between two, ``attention(seg, li, q, k_pool, v_pool,
        out=)`` of layer ``li``, which writes the attention of ``q`` (n, 1,
        H, Dh) into ``out`` (n, H, Dh). Returns the logits (n, V); on the
        card they are the graphs' own buffer, rewritten by the next
        step."""
        x = None
        for i in range(len(self.layers) + 1):
            if self.graphs is None:
                x, out = self._piece(i, x)
            else:
                self.graphs[i].replay()
                out = self.outs[i][1]
            if i < len(self.layers):
                seg, li, _, kp, vp = self.layers[i]
                attention(seg, li, out, kp, vp, out=self._ctx_rows)
        return out
