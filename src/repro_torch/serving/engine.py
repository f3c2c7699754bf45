"""Paged serving engine on a real PyTorch model: ORCA iteration-level
scheduling, vLLM paging, and the prefill- and decode-attention CUDA
kernels. The GQA and MLA flavours of ``repro.serving.engine``.

Per iteration (continuous batching):

1. the :class:`IterationScheduler` plans prefill *chunks* and decodes under
   the token budget and the page supply (chunked prefill: a prompt larger
   than the budget is admitted once and contributes budget-sized chunks over
   later iterations, next to the running decodes);
2. each chunk runs through :meth:`PagedEngine._prefill_chunk`: its K/V is
   written into the paged cache at per-token (page, offset) slots through the
   request's block table, and its queries attend causally, at absolute RoPE
   positions, over every context page (radix-cached prefix pages, earlier
   chunks and the chunk itself) with
   :func:`repro_torch.kernels.flash_prefill.prefill_attention_paged`, which
   reads the pages in place in the CUDA kernel for CUDA tensors and
   gathers them for its plain version on CPU tensors. Chunk starts need not
   be page-aligned, which is what lets a mid-page prefix-cache hit resume.
   Only the last chunk samples a token;
3. all running sequences advance one token in one batched
   :meth:`PagedEngine._decode` over fixed slots: decode attention reads the
   pages through the block tables with
   :func:`repro_torch.kernels.paged_attention.paged_attention`, which
   launches the CUDA kernel for CUDA tensors and runs its plain version for
   CPU tensors, and sampling is fused over the slots with per-slot
   parameters. On the card a dense GQA stack's step replays the work
   between its attention calls from piecewise CUDA graphs
   (:mod:`repro_torch.serving.decode_graphs`), ``paged_attention`` still
   called between the pieces.

**MLA** (deepseek-v2): the two pools hold the shared latent instead of
per-head K/V, ``ckv`` (L, P+1, ps, r) in ``k_pages`` and ``krope`` (L, P+1,
ps, dr) in ``v_pages`` (``KVPageLayout``'s ``mla`` schema), and both the
chunk and the decode attend over it in the matrix-absorbed form
(``mla_layer``) as single-KV-head attention: the chunk with
``blockwise_attention`` over the gathered context pages, the decode with
one float32 ``attention_partial`` over the gathered block tables and its
merge. That is the reference's path (``repro/serving/engine.py:368-411,
481-501``): it refuses the decode kernel for MLA and runs both in XLA, so
no kernel of the port is launched for MLA either. Everything page-granular
(COW, forks, the prefix cache, preemption) is the same for both flavours.

Unlike the reference, which copies its immutable pools on every write, the
KV pools here are updated **in place** (``index_put_``): the decode and
prefill writes, the copy-on-write page copies and best-of-n forks all write
into ``k_pages`` / ``v_pages`` directly. PyTorch runs eagerly, so the
reference's power-of-two padding of chunk lengths and page lists (a jit
shape bucket) is gone. Its one visible effect is kept: a MoE layer sizes
its experts' capacity from the padded chunk length (:func:`_pow2_bucket`).

**Cluster serving.** Several engines behind
:class:`~repro_torch.serving.router.RouterBackend` share one ``params``
dict on the card; none copies or changes it, and each has its own pools
and trash page. Their cluster half is the reference's
(``repro/serving/engine.py:236-244, 540-750, 1067-1132``):

* a **zero-copy lease** (an admission-time prefix lease, or the lease of a
  disaggregated handoff) serves a request's leading ``r_base`` tokens from
  pages of a creditor engine, read in place through ``remote_reader(home)``
  (the creditor's ``k_pages`` / ``v_pages``, wired by the router); the
  request's local table covers ``[r_base, end)`` and its new K/V is
  written at ``pos - r_base``, while RoPE keeps the absolute position.
  Attention is a local partial and a remote partial merged by log-sum-exp
  (``merge_partials_tree``). The decode's GQA partials are two
  ``paged_attention(..., return_partials=True)`` calls, one over the local
  table and one per creditor over the lease's pages in the creditor's
  pool, with context 0 on rows holding no lease there; the reference
  gathers every lease into an ``(L, n, R, Hkv, Dh)`` copy each step
  (``_lease_kv_batch``) instead, so the port keeps no per-lease gather and
  nothing to prune. A leased chunk, and MLA's decode, take the
  reference's plain float32 partials (``attention_partial``). Sliding
  windows are refused (``_check_zero_copy_ok``), as in the reference;
* **page payloads**: ``export_page_payload`` / ``import_page_payloads``
  carry one page's pool contents as CPU tensors in the pool's dtype,
  bit-exact (numpy has no bfloat16), pinned on a CUDA engine;
* the **handoff seam** of disaggregated serving: ``release_for_handoff``
  and ``install_for_handoff``.

A leased page is never written: the board pins it through the home
allocator's refcount, and every writer of a shared page copies it first
(COW), so reading the creditor's pools in place is safe although the
port's pools change in place.

**Tiered KV memory** (``EngineConfig.host_pages > 0``): one host pool per
device pool, ``host_pages`` pages in the pool's dtype, allocated once and
pinned on a CUDA engine (it raises if pinning fails; it never falls back
to pageable memory). The host pools are page-major, ``(H, L, ps,
*token_shape)``, so one host page is one contiguous slab. The scheduler
moves pages through the engine's movers (``repro/serving/engine.py:
1008-1063``): a preemption victim swaps out to host pages and back in
instead of recomputing (``swap_mode``, ``victim_policy``), a speculative
swap-out is issued one iteration early and completed or cancelled at the
next (``speculative_swap``), and cold prefix-cache pages spill to host
pages within ``cache_spill_pages``. Every mover gathers or scatters the
pages on the card through one contiguous page-major buffer per pool and
copies it to or from the pinned pools with ``non_blocking`` copies, so
the host never waits for a mover. Because the port's pools change in
place, each copy is ordered by stream: a swap-out, swap-in or spill runs
on the current stream, ahead of every later write in that iteration (a
COW copy, a chunk's scatter, a decode write, a swap-in landing on the
pages a swap-out just freed) and behind every earlier one; a host page
freed by a swap-in and handed to a swap-out in the same ``schedule()`` is
written after the swap-in has read it. A speculative swap-out's copy
really is in flight across an iteration: it runs on a side stream after
an event of the current stream (so it sees the pages' last writes), and
the next ``step()`` makes the current stream wait for it before
``schedule()`` completes or cancels it and hands its pages on. The
reference's pools are immutable, so it defers that copy to the complete
half instead; the pages are not written in between, so both give the same
bytes.

The engine implements :class:`~repro_torch.serving.api.ServingBackend`;
drive it through :class:`~repro_torch.serving.api.LLMService`. Best-of-n
requests (``SamplingParams.n > 1``) COW-fork the parent's block table right
after its prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.distkv.dist_attention import (attention_partial,
                                                    merge_partials_tree)
from repro_torch.core.paging.allocator import BlockAllocator, BlockTable
from repro_torch.core.paging.layout import KVPageLayout, check_schema
from repro_torch.core.prefixcache.radix import PrefixCache
from repro_torch.core.scheduling.iteration import IterationScheduler
from repro_torch.core.scheduling.request import Request
from repro_torch.core.telemetry import MetricsRegistry, Tracer, \
    keep_profiled
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_prefill import prefill_attention_paged
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import sampling
from repro_torch.models.attention import (_mla_scale, blockwise_attention,
                                          gqa_layer, mla_effective_ctx,
                                          mla_effective_kv, mla_layer)
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.models.moe import moe_forward
from repro_torch.models.transformer import Model, seg_window
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.decode_graphs import DecodeGraphs


def _pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (>= floor): the reference pads each
    prefill chunk to this length (``repro/serving/engine.py:85-93``)."""
    p = floor
    while p < n:
        p *= 2
    return p


def _to_device(x, dev, dtype=None, out=None) -> torch.Tensor:
    """``x`` (an array or a list) as a tensor on ``dev``, or copied into
    ``out`` there. A CUDA copy is staged through pinned memory, so the host
    does not wait for the stream to drain first, as a copy from pageable
    memory does: a step waits on the card only for its sampled tokens
    (``sample.wait``)."""
    t = torch.as_tensor(x, dtype=dtype)
    if dev.type == "cuda":
        t = t.pin_memory()
        if out is None:
            return t.to(dev, non_blocking=True)
    if out is not None:
        return out.copy_(t, non_blocking=True)
    return t


@dataclasses.dataclass
class EngineConfig:
    num_pages: int = 512
    page_size: int = 16
    max_slots: int = 8
    max_tokens_per_iter: int = 2048
    # seeds the sample stream of requests whose SamplingParams carry none
    seed: int = 0
    # radix-tree prefix KV cache: share prompt pages across requests and
    # prefill only the uncached suffix
    enable_prefix_cache: bool = False
    # drop a request after this many preemptions (finish_reason
    # "preempted-dropped"); None = recompute forever
    max_preemptions: Optional[int] = None
    # chunked-prefill budget policy: "decode_first", "prefill_first",
    # "monolithic" or "solo" (see core.scheduling.iteration)
    chunk_policy: str = "decode_first"
    # host swap tier: host-memory pages a preemption victim's KV can move
    # to (0 = disabled, classic sacrifice-and-recompute). With pages
    # available, swap_mode ("sacrifice" | "swap" | "auto") and
    # victim_policy ("lifo" | "fifo" | "lru" | "cost") pick who loses
    # device pages and whether their KV survives on host — see
    # core.scheduling.iteration.SWAP_MODES / VICTIM_POLICIES
    host_pages: int = 0
    swap_mode: str = "sacrifice"
    victim_policy: str = "lifo"
    # speculative swap-outs: the scheduler issues a decode victim's
    # swap-out one iteration early when free pages trend under the running
    # decodes' growth (issue/complete halves behind the allocator's pending
    # ledger), cancelling if pressure recedes before it resolves
    speculative_swap: bool = False
    # prefix-cache spill: cold radix pages move to host pages (bounded LRU
    # budget, drawn from the same host_pages pool) instead of dying — a
    # later match restores them instead of recomputing
    cache_spill_pages: int = 0
    # structured event tracing + per-iteration metric timelines (a step
    # also records its spans while a torch.profiler session is on)
    enable_telemetry: bool = False


class PagedEngine:
    """Single-device engine instance. Implements the ServingBackend
    protocol. ``params`` must already live on ``device``."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig, *,
                 device="cuda"):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.model = Model(cfg)
        if {seg.mixer for seg in self.model.plan} not in ({"gqa"}, {"mla"}):
            raise ValueError(f"{cfg.arch_id}: this engine serves GQA stacks "
                             "only, or MLA stacks only (an SSM or hybrid "
                             "model runs Model.prefill and "
                             "Model.decode_step)")
        # the reference's engine checks the mixers alone and would serve an
        # encoder-decoder plan as a decoder-only one, without its encoder
        # or cross-attention; here it is refused
        if any(seg.cross for seg in self.model.plan):
            raise ValueError(f"{cfg.arch_id}: this engine has no encoder or "
                             "cross-attention (an encoder-decoder model "
                             "runs Model.prefill and Model.decode_step)")
        # GQA pools hold per-head (k, v); MLA pools the shared latent
        # (ckv, krope)
        self.kv_layout = KVPageLayout.from_arch(cfg)
        self.flavor = self.kv_layout.flavor
        if self.flavor == "mla" and cfg.sliding_window:
            raise ValueError("MLA + sliding window is unsupported")
        P, ps = ecfg.num_pages, ecfg.page_size
        # +1 trash page (index P): inactive decode slots park their writes
        # there; no real context ever reads it. The pools keep the names
        # k_pages / v_pages for both flavours (MLA: ckv / krope)
        shape_a, shape_b = self.kv_layout.pool_shapes(P + 1, ps)
        self.k_pages = torch.zeros(shape_a, dtype=cfg.torch_dtype,
                                   device=self.device)
        self.v_pages = torch.zeros(shape_b, dtype=cfg.torch_dtype,
                                   device=self.device)
        self.allocator = BlockAllocator(P, ps, host_blocks=ecfg.host_pages,
                                        layout=self.kv_layout)
        self.prefix_cache = PrefixCache(
            self.allocator, spill_budget=ecfg.cache_spill_pages) \
            if ecfg.enable_prefix_cache else None
        self.scheduler = IterationScheduler(
            self.allocator, max_running=ecfg.max_slots,
            max_tokens_per_iter=ecfg.max_tokens_per_iter,
            prefix_cache=self.prefix_cache,
            max_preemptions=ecfg.max_preemptions,
            chunk_policy=ecfg.chunk_policy,
            swap_mode=ecfg.swap_mode, victim_policy=ecfg.victim_policy,
            speculative_swap=ecfg.speculative_swap)
        # host swap tier: the host pools, the side stream of speculative
        # swap-outs and the events of those still in flight
        self.h_k_pages = self.h_v_pages = None
        self._swap_stream = None
        self._in_flight: List[torch.cuda.Event] = []
        if ecfg.host_pages:
            self._init_host_tier(ecfg.host_pages)
        self.swapped_out = 0
        self.swapped_in = 0
        # per-sequence context cap: the trained limit, within the pages
        self.max_context_len = min(cfg.max_seq_len or P * ps, P * ps)
        self.slots: Dict[int, int] = {}  # request_id -> slot
        self.free_slots = list(range(ecfg.max_slots - 1, -1, -1))
        self.last_token = np.zeros(ecfg.max_slots, np.int64)
        self.iterations = 0
        self.preemptions = 0
        self.decode_steps = 0  # batched decode calls (one per iteration)
        # decode calls that replayed the piecewise graphs, and those graphs
        # (captured at the first such call)
        self.graph_decode_steps = 0
        self._graphs: Optional[DecodeGraphs] = None
        self.prefill_chunks = 0  # prefill chunk calls
        # zero-copy leases: chunks that attended over a lease (plain
        # partials, no prefill kernel), decode steps that merged remote
        # partials, and the remote partials (one per creditor) over them
        self.leased_chunks = 0
        self.leased_decode_steps = 0
        self.remote_partials = 0
        # requests submitted without sampling params decode greedily
        self._default_sp = SamplingParams()
        # best-of-n children awaiting their parent's prefill (COW fork)
        self._pending_forks: Dict[int, List[Request]] = {}
        if ecfg.enable_telemetry:
            self.trace = Tracer()
            self.metrics = MetricsRegistry()
            self.scheduler.trace = self.trace
        else:
            self.trace = None
            self.metrics = None
        # the tracer the last step recorded its spans into, or None: the
        # telemetry's, or while a torch.profiler session is on, with
        # telemetry off, one of the engine's own for profiles
        self.recording: Optional[Tracer] = None
        self._profile_trace: Optional[Tracer] = None
        # cluster serving: reader(home) -> (k_pages, v_pages) of a creditor
        # engine, wired by RouterBackend for zero-copy leases
        self.remote_reader = None
        # modeled network seconds (payload copies, lease RPCs): a wall-clock
        # engine cannot advance its clock, so this is observability only
        self.net_time = 0.0
        self._window = cfg.sliding_window \
            if any(seg.attn_kind == "swa" for seg in self.model.plan) \
            else None

    # -- model steps ------------------------------------------------------------

    def _mlp_fn(self, seg, capacity_tokens=None):
        """Per-segment MLP dispatch for the shared layer body: dense
        segments use the layer's MLP, MoE segments the expert dispatch, with
        their capacity sized from ``capacity_tokens`` where given."""
        if seg.mlp_kind == "moe":
            return lambda pm, h: moe_forward(self.cfg, pm, h,
                                             capacity_tokens=capacity_tokens)
        return None

    def _layer(self, seg, li, p, x, positions, slot_pages, in_page,
               attention, mlp_fn):
        """Layer ``li`` through the flavour's shared layer body
        (``gqa_layer`` / ``mla_layer``). Its attend callable writes this
        call's pool payloads, the last two arguments the body hands it (k /
        v, or ckv / krope), into their (page, offset) slots in place, then
        returns ``attention(seg, li, *queries, pool_a, pool_b)``."""
        kp, vp = self.k_pages[li], self.v_pages[li]

        def attend(*args):
            *queries, a, b = args
            kp[slot_pages, in_page] = a.flatten(0, 1).to(kp.dtype)
            vp[slot_pages, in_page] = b.flatten(0, 1).to(vp.dtype)
            return attention(seg, li, *queries, kp, vp)

        body = mla_layer if self.flavor == "mla" else gqa_layer
        return body(self.cfg, p, x, positions, attend, mlp_fn)

    @staticmethod
    def _latent(cp, rp, idx, dtype):
        """The latent context of each row of pages ``idx`` (n, w) from the
        ckv / krope pools: (n, w * ps, r) and (n, w * ps, dr)."""
        n = idx.shape[0]
        return (cp[idx].reshape(n, -1, cp.shape[-1]).to(dtype),
                rp[idx].reshape(n, -1, rp.shape[-1]).to(dtype))

    @staticmethod
    def _gathered(pool, idx):
        """The GQA K or V of each row of pages ``idx`` (n, w) from a
        layer's pool: (n, w * ps, Hkv, Dh)."""
        return pool[idx].reshape(idx.shape[0], -1, *pool.shape[2:])

    @torch.no_grad()
    def _prefill_chunk(self, tokens, page_ids, start: int, lease=None):
        """One prefill chunk at absolute positions ``[start, start + S)``.

        tokens: (S,) chunk token ids; page_ids: the physical pages covering
        the local context positions ``[r_base, start + S)`` in order
        (cached prefix pages, pages of earlier chunks and the pages this
        chunk lands in), where ``r_base`` is the tokens of a zero-copy
        ``lease`` (0 without one). Each chunk token's K/V (MLA: its latent)
        is written to its (page, offset) slot, then the chunk's queries
        attend causally over every context page: keys past a query's
        position are masked, so stale slot contents past the chunk's end
        are never read. GQA attends through ``prefill_attention_paged``;
        MLA through ``blockwise_attention`` on the gathered latent pages in
        the absorbed single-KV-head form, scaled by ``_mla_scale``. Returns
        the logits (V,) of the chunk's last position.

        With a lease, positions ``[0, r_base)`` are the lease's pages in
        the creditor's pools, and the chunk attends as the reference's
        does (``repro/serving/engine.py:386-404, 429-444``): a float32
        causal ``attention_partial`` over the local pages, one over the
        lease's tokens (all of them precede every query), and their merge.
        The reference pads the lease's tokens to a power of two and masks
        the pad; eagerly there is no pad.

        A MoE layer's capacity is that of the reference's padded chunk,
        ``_pow2_bucket(S)`` tokens (``repro/serving/engine.py:876`` pads
        the chunk, ``repro/models/moe.py:37-39`` sizes the capacity from
        it). The pad tokens would come after every real token in the
        experts' place order, so they never move a real token's place: the
        count alone is passed, the chunk is not padded.
        """
        tr = self.recording
        if tr is not None:
            tr.enter("engine", "chunk.inputs")
        cfg, ps, dev = self.cfg, self.ecfg.page_size, self.device
        s = len(tokens)
        r_base = lease.num_tokens if lease is not None else 0
        toks = _to_device(np.asarray(tokens, np.int64), dev)
        pages = _to_device(np.asarray(page_ids, np.int32), dev)
        idx = pages.long()[None]
        positions = start + torch.arange(s, device=dev)
        tok_pages = pages.long()[(positions - r_base) // ps]
        in_page = (positions - r_base) % ps
        if lease is not None:
            home_a, home_b = self.remote_reader(lease.home)
            lease_idx = _to_device(lease.blocks, dev, torch.int64)[None]
            key_pos = r_base + torch.arange(idx.shape[1] * ps, device=dev)
            mask_l = (positions[:, None] >= key_pos[None, :])[None]
            mask_r = torch.ones(1, s, r_base, dtype=torch.bool, device=dev)
        if tr is not None:
            tr.exit()

        def attention(seg, li, *args):
            if self.flavor == "gqa":
                q, kp, vp = args
                if lease is None:
                    return prefill_attention_paged(
                        q, kp, vp, pages, q_offset=start,
                        window=seg_window(cfg, seg))
                parts = [attention_partial(q, self._gathered(kp, idx),
                                           self._gathered(vp, idx), mask_l),
                         attention_partial(
                             q, self._gathered(home_a[li], lease_idx),
                             self._gathered(home_b[li], lease_idx), mask_r)]
                return merge_partials_tree(*zip(*parts)).to(q.dtype)
            q_lat, qr, cp, rp = args
            scale = _mla_scale(cfg)
            q_eff, k_eff, v_eff = mla_effective_kv(
                q_lat, qr, *self._latent(cp, rp, idx, q_lat.dtype))
            if lease is None:
                ctx = blockwise_attention(q_eff, k_eff, v_eff, causal=True,
                                          q_offset=start, scale=scale)
                return ctx[..., :cfg.kv_lora_rank]
            parts = [attention_partial(q_eff, k_eff, v_eff, mask_l,
                                       scale=scale),
                     attention_partial(q_eff, *mla_effective_ctx(
                         *self._latent(home_a[li], home_b[li], lease_idx,
                                       q_lat.dtype)), mask_r, scale=scale)]
            ctx = merge_partials_tree(*zip(*parts))
            return ctx[..., :cfg.kv_lora_rank].to(q_lat.dtype)

        if tr is not None:
            tr.enter("engine", "chunk.layers")
        x = embed(self.params["embed"], toks[None])  # (1, s, d)
        s_pad = _pow2_bucket(s)
        for seg, li, p in self.model.layers(self.params):
            x = self._layer(seg, li, p, x, positions, tok_pages, in_page,
                            attention, self._mlp_fn(seg, s_pad))
        x = rms_norm(self.params["final_norm"], x[:, -1:], cfg.norm_eps)
        logits = unembed(self.params["embed"], x, cfg.vocab_size,
                         fp32=cfg.logits_fp32)
        if tr is not None:
            tr.exit()
        self.prefill_chunks += 1
        self.leased_chunks += lease is not None
        return logits[0, 0]

    def _eager_reason(self, n: int, remote) -> Optional[str]:
        """Why a decode step of ``n`` rows with the remote partials
        ``remote`` runs its layers eagerly, or None where it replays the
        piecewise graphs (:mod:`repro_torch.serving.decode_graphs`): those
        hold a dense GQA stack's step on the card at the engine's slots,
        with one local ``paged_attention`` call a layer."""
        if self.flavor != "gqa":
            return self.flavor
        kinds = {seg.mlp_kind for seg in self.model.plan} - {"dense"}
        if kinds:
            return f"{min(kinds)} MLP"
        if remote:
            return "remote partials"
        if n != self.ecfg.max_slots:
            return "rows"
        if self.device.type != "cuda":
            return self.device.type
        return None

    @torch.no_grad()
    def _decode(self, tokens, positions, block_tables, ctx_lens,
                r_base=None, remote=(), *, eager: bool = False):
        """Batched one-token step over all slots.

        tokens, positions, ctx_lens: (n,) with ctx_len 0 for an inactive
        slot; block_tables: (n, width). Each slot's new K/V (MLA: latent) is
        written into its page (inactive slots write to the trash page),
        then attention runs over the block tables: GQA through
        ``paged_attention``; MLA through one float32 ``attention_partial``
        over the gathered latent pages, masked to each slot's context, and
        its merge, which gives an inactive slot zeros. Returns logits (n,
        V). Every row goes through a MoE layer's routing, inactive ones
        too, as in the reference: they take places in the experts'
        capacity.

        A dense GQA step on the card at the engine's slots, with no remote
        partials (:meth:`_eager_reason`), replays the piecewise CUDA graphs
        of :class:`~repro_torch.serving.decode_graphs.DecodeGraphs`,
        captured at its first such step: the same operations on the same
        shapes, each layer's ``paged_attention`` still called between the
        pieces with the step's own block tables. Every other step runs the
        layers eagerly, and so does every step with ``eager`` (the graphed
        path's oracle).

        Zero-copy leases, as the reference's ``_decode_zc_fn``
        (``repro/serving/engine.py:540-636``): ``r_base`` (n,) is the
        leading tokens each slot serves from a creditor (0 = fully local;
        such a slot computes what it would without leases), and
        ``remote`` holds one ``(home, block_tables (n, w), context_lens
        (n,))`` per creditor: the lease pages of the slots that borrow from
        ``home`` and their ``r_base``, context 0 on the other rows. A
        slot's local table covers ``[r_base, ctx_len)``, its write lands at
        ``position - r_base``, and its attention is the local partial
        merged with one remote partial per creditor, each read in place
        from that creditor's pools: for GQA through ``paged_attention``
        with its ``(m, l)``, for MLA through the plain float32 partial
        over the gathered latent.
        """
        tr = self.recording
        if tr is not None:
            tr.enter("engine", "decode.inputs")
        cfg, ecfg, dev = self.cfg, self.ecfg, self.device
        n, ps = len(tokens), ecfg.page_size
        graphs = None
        if not eager and self._eager_reason(n, remote) is None:
            if self._graphs is None:
                self._graphs = DecodeGraphs(self, n)
            graphs = self._graphs
            # the write slots on the host, from the tables already there
            pos = np.asarray(positions, np.int64)
            slot = np.where(np.asarray(ctx_lens) > 0,
                            np.asarray(block_tables)[np.arange(n), pos // ps],
                            ecfg.num_pages)
            _to_device(np.stack([np.asarray(tokens, np.int64), pos, slot,
                                 pos % ps]), dev, out=graphs.inputs)
        else:
            toks = _to_device(tokens, dev)
            pos = _to_device(positions, dev, torch.int64)
        bt = _to_device(block_tables, dev, torch.int32)
        lens = _to_device(ctx_lens, dev, torch.int32)
        if graphs is None:
            loc_pos, loc_lens = pos, lens
            if remote:
                rb = _to_device(r_base, dev, torch.int32)
                loc_pos = (pos - rb).clamp_min(0)
                loc_lens = (lens - rb).clamp_min(0)
                remote = [(home, _to_device(rbt, dev, torch.int32),
                           _to_device(rlens, dev, torch.int32))
                          for home, rbt, rlens in remote]
            page_slot = bt[torch.arange(n, device=dev), loc_pos // ps].long()
            page_slot = torch.where(lens > 0, page_slot,
                                    torch.full_like(page_slot,
                                                    ecfg.num_pages))
            in_page = loc_pos % ps
        if tr is not None:
            tr.exit(width=bt.shape[1])

        def attention(seg, li, *args, out=None):
            if self.flavor == "gqa":
                q, kp, vp = args
                q1 = q[:, 0]
                if not remote:
                    att = paged_attention(q1, kp, vp, bt, lens, page_size=ps,
                                          window=seg_window(cfg, seg),
                                          out=out)
                    return att.reshape(n, 1, cfg.num_heads, cfg.head_dim)
                sources = [(kp, vp, bt, loc_lens)]
                for home, t, c in remote:
                    home_a, home_b = self.remote_reader(home)
                    sources.append((home_a[li], home_b[li], t, c))
                parts = []
                for pa, pb, t, c in sources:
                    out, m, l = paged_attention(q1, pa, pb, t, c,
                                                page_size=ps,
                                                return_partials=True)
                    # the merge's form: o unnormalised, m and l as they are
                    parts.append((out.float() * l[..., None], m, l))
                att = merge_partials_tree(*zip(*parts)).to(q.dtype)
                return att.reshape(n, 1, cfg.num_heads, cfg.head_dim)
            q_lat, qr, cp, rp = args
            scale = _mla_scale(cfg)
            q_eff, k_eff, v_eff = mla_effective_kv(
                q_lat, qr, *self._latent(cp, rp, bt.long(), q_lat.dtype))
            keys = torch.arange(k_eff.shape[1], device=dev)
            mask = (keys[None, :] < loc_lens[:, None])[:, None, :]  # (n,1,S)
            parts = [attention_partial(q_eff, k_eff, v_eff, mask,
                                       scale=scale)]
            for home, t, c in remote:
                home_a, home_b = self.remote_reader(home)
                k_r, v_r = mla_effective_ctx(*self._latent(
                    home_a[li], home_b[li], t.long(), q_lat.dtype))
                keys = torch.arange(k_r.shape[1], device=dev)
                mask = (keys[None, :] < c[:, None])[:, None, :]
                parts.append(attention_partial(q_eff, k_r, v_r, mask,
                                               scale=scale))
            ctx = merge_partials_tree(*zip(*parts))
            return ctx[..., :cfg.kv_lora_rank].to(q_lat.dtype)

        if tr is not None:
            tr.enter("engine", "decode.layers")
        if graphs is not None:
            logits = graphs.run(attention)
        else:
            x = embed(self.params["embed"], toks[:, None])  # (n, 1, d)
            for seg, li, p in self.model.layers(self.params):
                x = self._layer(seg, li, p, x, pos[:, None], page_slot,
                                in_page, attention, self._mlp_fn(seg))
            x = rms_norm(self.params["final_norm"], x, cfg.norm_eps)
            logits = unembed(self.params["embed"], x, cfg.vocab_size,
                             fp32=cfg.logits_fp32)[:, 0]
        if tr is not None:
            tr.exit(graphed=int(graphs is not None))
        self.decode_steps += 1
        self.graph_decode_steps += graphs is not None
        if remote:
            self.leased_decode_steps += 1
            self.remote_partials += len(remote)
        return logits

    # -- ServingBackend protocol ------------------------------------------------

    def add_request(self, req: Request) -> None:
        if req.prompt_len + req.max_new_tokens > self.max_context_len:
            raise ValueError(
                f"request {req.request_id} needs "
                f"{req.prompt_len + req.max_new_tokens} context tokens, "
                f"engine limit is {self.max_context_len}")
        if req.parent_id is not None and any(
                r.request_id == req.parent_id for r in self.scheduler.waiting):
            # best-of-n sibling: COW-forked off the parent's prefill instead
            # of prefilling again
            self._pending_forks.setdefault(req.parent_id, []).append(req)
            return
        self.scheduler.add_request(req)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.waiting or self.scheduler.running
                    or self._pending_forks)

    def clock(self) -> Optional[float]:
        return None  # wall-clock backend: the caller supplies `now`

    # -- per-request sampling ---------------------------------------------------

    def _sp_of(self, req: Request) -> SamplingParams:
        return req.sampling if req.sampling is not None else self._default_sp

    def _seed_of(self, req: Request) -> int:
        sp = self._sp_of(req)
        if sp.seed is not None:
            return sp.seed & 0x7FFFFFFF
        return (self.ecfg.seed * 1_000_003 + req.request_id * 7919
                + 0x5BD1) & 0x7FFFFFFF

    def _sample_rows(self, logits, reqs_by_row):
        """Fused per-slot sampling. ``reqs_by_row``: Request or None per
        row of ``logits``. Returns (tokens, logprobs) as numpy arrays."""
        tr = self.recording
        if tr is not None:
            tr.enter("engine", "sample")
            tr.enter("engine", "sample.launch")
        n = logits.shape[0]
        temp = np.zeros(n, np.float32)
        topk = np.zeros(n, np.int64)
        topp = np.ones(n, np.float32)
        seeds = np.zeros(n, np.int64)
        steps = np.zeros(n, np.int64)
        for i, req in enumerate(reqs_by_row):
            if req is None:
                continue
            sp = self._sp_of(req)
            temp[i] = sp.temperature
            topk[i] = sp.top_k
            topp[i] = sp.top_p
            seeds[i] = self._seed_of(req)
            # cumulative token index: keeps the stream aligned across
            # preemption/recompute
            steps[i] = req.total_generated
        dev = logits.device
        toks, lps = sampling.sample_batch(
            logits, *(_to_device(a, dev)
                      for a in (seeds, steps, temp, topk, topp)))
        if tr is not None:
            tr.exit()
            tr.enter("engine", "sample.wait")
        # both copies queued, then one wait for the stream
        toks, lps = (t.to("cpu", non_blocking=True) for t in (toks, lps))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        out = toks.numpy(), lps.numpy()
        if tr is not None:
            tr.exit()
            tr.exit(rows=n)
        return out

    def _sample_one(self, req: Request, logits_row):
        toks, lps = self._sample_rows(logits_row[None], [req])
        return int(toks[0]), float(lps[0])

    def _emit(self, req: Request, slot: int, tok: int, lp: float,
              now: float) -> None:
        req.output.append(tok)
        req.cumulative_logprob += lp
        req.logprobs.append(lp)
        req.record_token_time(now)
        self.last_token[slot] = tok

    # -- engine loop ------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[Request]:
        """Run ONE iteration (ORCA's unit of scheduling)."""
        now = time.monotonic() if now is None else now
        tr = self.trace
        if torch.autograd._profiler_enabled():
            if tr is None:
                tr = self._profile_trace = self._profile_trace or Tracer()
            keep_profiled(tr)
        self.recording = tr
        if tr is not None:
            tr.iteration = self.iterations
            tr.enter("engine", "iteration", root=True)
            tr.enter("engine", "schedule")
        # a speculative swap-out issued last iteration resolves in this
        # schedule(): its pages may be handed on only after its copy
        self._join_swaps()
        plan = self.scheduler.schedule()
        self.preemptions += len(plan.preempted)
        # the swap copies already ran in the scheduler's hooks; here only
        # the decode slots move: a request swapped out (or issued) gives its
        # slot up, one swapped in (or cancelled) claims one and re-arms its
        # input token, the last sampled one, whose KV was never written
        for req in plan.preempted + [r for r, _ in plan.swap_out
                                     + plan.swap_issue]:
            if req.request_id in self.slots:
                self.free_slots.append(self.slots.pop(req.request_id))
        for req, _ in plan.swap_in + plan.swap_cancel:
            slot = self.free_slots.pop()
            self.slots[req.request_id] = slot
            if req.output:
                self.last_token[slot] = req.output[-1]
        if plan.empty:
            if tr is not None:
                tr.exit(preempted=len(plan.preempted))
            # a self-preempted request can leave an otherwise-empty plan:
            # run completion anyway (the scheduler's preemption budget)
            finished = self.scheduler.complete_iteration(plan, now) \
                if plan.preempted else []
            self._end_iteration(tr, plan, now)
            return finished
        # COW: copy replaced shared pages before anything writes this
        # iteration (the gather on the right copies before the write)
        if plan.cow:
            old = self._index([o for o, _ in plan.cow])
            new = self._index([w for _, w in plan.cow])
            self.k_pages[:, new] = self.k_pages[:, old]
            self.v_pages[:, new] = self.v_pages[:, old]
        if tr is not None:
            tr.exit(preempted=len(plan.preempted))

        # --- prefill chunks (initiation phase) ---
        forked: List[Request] = []
        ps = self.ecfg.page_size
        for ch in plan.chunks:
            req = ch.req
            if req.request_id not in self.slots:
                # first chunk: claim the decode slot the request will keep
                self.slots[req.request_id] = self.free_slots.pop()
            slot = self.slots[req.request_id]
            if req.scheduled_time is None:
                req.scheduled_time = now
            table = self.scheduler.tables[req.request_id]
            # positions [0, r_base) are served from a creditor's pages
            # (zero-copy lease); the local table covers [r_base, end)
            r_base = self.scheduler.remote_tokens_of(req.request_id)
            lease = None
            if r_base:
                self._check_zero_copy_ok()
                lease = self._checked_lease(req.request_id)
            n_ctx_pages = -(-(ch.end - r_base) // ps)  # ceil, local pages
            if tr is not None:
                tr.enter("engine", "chunk", rid=req.request_id)
            logits = self._prefill_chunk(req.prompt[ch.start:ch.end],
                                         table.blocks[:n_ctx_pages],
                                         ch.start, lease)
            if ch.is_last:
                tok, lp = self._sample_one(req, logits)
                if req.first_token_time is None:
                    # the value complete_iteration would stamp; the
                    # instant marks when the token was sampled
                    req.first_token_time = now
                    if tr is not None:
                        tr.instant("req", "first_token", rid=req.request_id)
                self._emit(req, slot, tok, lp, now)
                forked.extend(self._fork_children(req, logits, now))
            if tr is not None:
                tr.exit(start=ch.start, length=ch.length, last=ch.is_last)

        # best-of-n children join the plan so completion sees them
        plan.prefill.extend(forked)

        # --- fused decode step (increment phase) ---
        if plan.decode:
            if tr is not None:
                tr.enter("engine", "decode.inputs")
            n = self.ecfg.max_slots
            width = max(len(self.scheduler.tables[r.request_id].blocks)
                        for r in plan.decode)
            # unused entries stay 0: a real page (the trash page is
            # num_pages), and one no valid position reaches. A row that is
            # not decoding (a free slot, or one still in prefill) is token
            # 0 at position 0, as in the reference
            # (``repro/serving/engine.py:663-669, 920``): a MoE layer
            # routes it, so its token decides which expert place it takes
            bt = np.zeros((n, width), np.int32)
            lens = np.zeros(n, np.int32)
            pos = np.zeros(n, np.int64)
            toks = np.zeros(n, np.int64)
            rbase = np.zeros(n, np.int32)
            row_reqs: List[Optional[Request]] = [None] * n
            for req in plan.decode:
                slot = self.slots[req.request_id]
                blocks = self.scheduler.tables[req.request_id].blocks
                bt[slot, :len(blocks)] = blocks
                # input token t_g sits at absolute position ctx_len-1; after
                # its KV is written the attention span is ctx_len tokens
                lens[slot] = req.context_len
                pos[slot] = req.context_len - 1
                toks[slot] = self.last_token[slot]
                rbase[slot] = self.scheduler.remote_tokens_of(req.request_id)
                row_reqs[slot] = req
            remote = ()
            if rbase.any():
                # >= 1 slot reads a borrowed prefix: local partial + one
                # remote partial per creditor, merged; fully local slots
                # ride along with r_base = 0
                self._check_zero_copy_ok()
                remote = self._remote_tables(row_reqs)
            if tr is not None:
                tr.exit(width=width)
            logits = self._decode(toks, pos, bt, lens, rbase, remote)
            sampled, lps = self._sample_rows(logits, row_reqs)

        if tr is not None:
            tr.enter("engine", "emit")
        for req in plan.decode:
            slot = self.slots[req.request_id]
            self._emit(req, slot, int(sampled[slot]), float(lps[slot]), now)
        finished = self.scheduler.complete_iteration(plan, now)
        for req in finished:
            if req.request_id in self.slots:
                self.free_slots.append(self.slots.pop(req.request_id))
        if tr is not None:
            tr.exit(finished=len(finished))
        self._end_iteration(tr, plan, now)
        self.iterations += 1
        return finished

    def _end_iteration(self, tr: Optional[Tracer], plan, now: float) -> None:
        """Close the step's ``iteration`` span and, with telemetry on, take
        the metrics' row of this iteration."""
        if tr is None:
            return
        tr.exit(decode_rows=len(plan.decode), chunks=len(plan.chunks),
                prefill_tokens=sum(c.length for c in plan.chunks))
        m = self.metrics
        if m is not None:
            m.gauge("kv_util_frac",
                    self.allocator.num_used / self.allocator.num_blocks)
            m.gauge("prefill_backlog_tokens",
                    self.scheduler.prefill_backlog_tokens())
            m.gauge("budget_fill_frac",
                    plan.token_count() / self.scheduler.max_tokens)
            m.gauge("running", len(self.scheduler.running))
            m.gauge("waiting", len(self.scheduler.waiting))
            m.gauge("net_time_s", self.net_time)
            if self.allocator.num_host_blocks:
                m.gauge("swapped_pages", self.allocator.swapped_pages)
                m.gauge("swap_pending_pages",
                        self.allocator.pending_out_pages)
            if self.prefix_cache is not None:
                m.gauge("prefix_hit_rate", self.prefix_cache.hit_rate)
            m.count("tokens", plan.token_count())
            m.count("decode_tokens", len(plan.decode))
            m.count("prefill_tokens", sum(c.length for c in plan.chunks))
            m.count("preemptions", len(plan.preempted))
            m.count("swap_outs", len(plan.swap_out) + len(plan.swap_complete))
            m.count("swap_ins", len(plan.swap_in))
            m.count("swap_issues", len(plan.swap_issue))
            m.count("swap_cancels", len(plan.swap_cancel))
            m.snapshot(tr.clock(), self.iterations)

    def _fork_children(self, parent: Request, logits, now) -> List[Request]:
        """COW-fork best-of-n siblings off ``parent``'s fresh prefill: each
        child shares the prompt pages (no second prefill) and samples its
        own first token from the same last-position logits."""
        children = self._pending_forks.pop(parent.request_id, [])
        forked = []
        for child in children:
            if self.free_slots and \
                    len(self.scheduler.running) < self.scheduler.max_running:
                self.scheduler.fork_from(parent, child)
                slot = self.free_slots.pop()
                self.slots[child.request_id] = slot
                child.scheduled_time = now
                child.first_token_time = now
                tok, lp = self._sample_one(child, logits)
                if self.recording is not None:
                    self.recording.instant("req", "first_token",
                                           rid=child.request_id)
                self._emit(child, slot, tok, lp, now)
                forked.append(child)
            else:
                # no slot free: an ordinary request (with the prefix cache
                # on it still reuses the parent's prompt pages)
                self.scheduler.add_request(child)
        return forked

    # -- host swap tier -----------------------------------------------------------

    def _init_host_tier(self, n: int) -> None:
        """The host pools and the scheduler's swap and spill hooks. Each
        host pool holds ``n`` pages of its device pool, page-major ``(n, L,
        ps, *token_shape)``, pinned on a CUDA engine. Every page is written
        by a swap-out or spill before anything reads it, so the pools are
        not zeroed."""
        pin = self.device.type == "cuda"
        pools = []
        for pool in (self.k_pages, self.v_pages):
            host = torch.empty((n, pool.shape[0], *pool.shape[2:]),
                               dtype=pool.dtype, pin_memory=pin)
            if pin and not host.is_pinned():
                raise RuntimeError("the host KV pool could not be pinned")
            pools.append(host)
        self.h_k_pages, self.h_v_pages = pools
        if pin:
            self._swap_stream = torch.cuda.Stream(self.device)
        sch = self.scheduler
        sch.swap_out_hook = self._swap_out_copy
        sch.swap_in_hook = self._swap_in_copy
        sch.swap_issue_hook = self._swap_out_issue
        sch.swap_complete_hook = self._swap_out_complete
        sch.swap_cancel_hook = self._swap_out_cancel
        if self.prefix_cache is not None:
            self.prefix_cache.spill_out_fn = self._pages_out
            self.prefix_cache.spill_in_fn = self._pages_in

    def host_page(self, h: int):
        """Host page ``h`` of both pools, ``(L, ps, *token_shape)`` each (the
        JAX engine's ``h_k_pages[:, h]``), once every copy queued so far
        has landed."""
        if self.device.type == "cuda":
            self._join_swaps()
            torch.cuda.current_stream(self.device).synchronize()
        return self.h_k_pages[h], self.h_v_pages[h]

    def _index(self, ids) -> torch.Tensor:
        """``ids`` as an int64 index on the engine's device; on a CUDA
        engine staged through pinned memory, so the host does not wait for
        the copy (it runs on the current stream)."""
        return _to_device(ids, self.device, torch.int64)

    @staticmethod
    def _runs(hosts):
        """``(i, h, k)``: positions ``[i, i + k)`` of ``hosts`` hold the
        consecutive host pages ``[h, h + k)``; one copy moves each run."""
        i = 0
        while i < len(hosts):
            k = 1
            while i + k < len(hosts) and hosts[i + k] == hosts[i] + k:
                k += 1
            yield i, hosts[i], k
            i += k

    def _pages_out(self, pairs) -> None:
        """Device -> host: ``(device, host)`` page pairs of both pools. The
        pages are gathered page-major into one contiguous buffer on the
        device, whose runs are copied into the host pools. Queued on the
        current stream; nothing waits."""
        devs = self._index([d for d, _ in pairs])
        hosts = [h for _, h in pairs]
        for pool, hpool in ((self.k_pages, self.h_k_pages),
                            (self.v_pages, self.h_v_pages)):
            buf = pool.movedim(1, 0).index_select(0, devs).contiguous()
            for i, h, k in self._runs(hosts):
                hpool[h:h + k].copy_(buf[i:i + k], non_blocking=True)

    def _pages_in(self, pairs) -> None:
        """Host -> device: ``(host, device)`` page pairs of both pools,
        through one contiguous buffer on the device per pool, scattered into
        the pool's pages. Queued on the current stream; nothing waits."""
        hosts = [h for h, _ in pairs]
        devs = self._index([d for _, d in pairs])
        for pool, hpool in ((self.k_pages, self.h_k_pages),
                            (self.v_pages, self.h_v_pages)):
            buf = torch.empty((len(pairs), *hpool.shape[1:]),
                              dtype=pool.dtype, device=self.device)
            for i, h, k in self._runs(hosts):
                buf[i:i + k].copy_(hpool[h:h + k], non_blocking=True)
            pool.index_copy_(1, devs, buf.movedim(0, 1))

    def _join_swaps(self) -> None:
        """Make the current stream wait for every speculative swap-out copy
        still in flight on the side stream."""
        if self._in_flight:
            stream = torch.cuda.current_stream(self.device)
            for event in self._in_flight:
                stream.wait_event(event)
            self._in_flight.clear()

    def _swap_out_copy(self, pairs) -> None:
        """One table's swap-out (scheduler hook, called before the freed
        device pages can be reallocated): queued ahead of every later write
        in stream order."""
        self._pages_out(pairs)
        self.swapped_out += 1

    def _swap_out_issue(self, pairs) -> None:
        """Issue half of a speculative swap-out. The source pages stay
        allocated in the allocator's pending ledger and nothing writes them
        until the swap resolves. On a CUDA engine the copy starts now on the
        side stream, after an event of the current stream (it sees the
        pages' last writes, and lands on host pages only after a swap-in
        queued earlier has read them), and runs under this iteration's
        compute; the next ``step()`` joins it. On the CPU it is made now."""
        if self._swap_stream is None:
            self._pages_out(pairs)
            return
        ready = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(self._swap_stream):
            self._swap_stream.wait_event(ready)
            self._pages_out(pairs)
            self._in_flight.append(self._swap_stream.record_event())

    def _swap_out_complete(self, pairs) -> None:
        """Complete half, called before the allocator frees the device
        pages: the copy was issued a step ago, and this step joined it
        before ``schedule()``. It counts as a swap-out now."""
        self.swapped_out += 1

    def _swap_out_cancel(self, pairs) -> None:
        """Pressure receded before the swap resolved: the pages never left
        the device (the allocator returns the host pages; the copy made to
        them was joined before ``schedule()``)."""

    def _swap_in_copy(self, pairs) -> None:
        """Host -> device onto the freshly allocated pages."""
        self._pages_in(pairs)
        self.swapped_in += 1

    # -- zero-copy leases (borrowed rBlocks) -------------------------------------

    def charge_network(self, seconds: float) -> None:
        """Record modeled network time (payload copy / lease RPC). A
        wall-clock engine cannot advance its clock, so this only feeds the
        ``net_time`` stat."""
        self.net_time += seconds
        if self.trace is not None:
            self.trace.instant("net", "charge", seconds=seconds)

    def _check_zero_copy_ok(self) -> None:
        if self.remote_reader is None:
            raise RuntimeError(
                "request holds a zero-copy lease but no remote_reader is "
                "wired — RouterBackend must connect creditor pools")
        if self._window is not None:
            raise RuntimeError(
                "zero-copy remote prefixes are unsupported with sliding-"
                "window attention (the remote partial ignores the window)")

    def _checked_lease(self, request_id: int):
        """The request's lease, its pages' layout checked against ours."""
        lease = self.scheduler.leases[request_id]
        check_schema(self.kv_layout.schema, getattr(lease, "schema", None),
                     where="zero-copy lease read")
        return lease

    def _remote_tables(self, row_reqs):
        """One ``(home, block_tables (n, w) int32, context_lens (n,)
        int32)`` per creditor of the decode rows ``row_reqs``: row ``i``
        holds its lease's pages and tokens where its lease lives on
        ``home``, context 0 (and page 0, never read) elsewhere."""
        n = len(row_reqs)
        by_home: Dict[int, List] = {}
        for slot, req in enumerate(row_reqs):
            if req is not None and req.request_id in self.scheduler.leases:
                lease = self._checked_lease(req.request_id)
                by_home.setdefault(lease.home, []).append((slot, lease))
        remote = []
        for home, rows in sorted(by_home.items()):
            bt = np.zeros((n, max(l.num_pages for _, l in rows)), np.int32)
            lens = np.zeros(n, np.int32)
            for slot, lease in rows:
                bt[slot, :lease.num_pages] = lease.blocks
                lens[slot] = lease.num_tokens
            remote.append((home, bt, lens))
        return remote

    # -- cross-instance page payloads ---------------------------------------------

    def _to_host(self, t):
        """A CPU copy of ``t``: pinned when ``t`` is on the card."""
        if not t.is_cuda:
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t)

    def export_page_payload(self, block: int):
        """One physical page's contents, ``(schema, a, b)``: ``a`` / ``b``
        are the page of pool A / B, ``(L, ps, *token_shape)`` CPU tensors in
        the pool's dtype, bit-exact (pinned on a CUDA engine), tagged with
        the engine's :attr:`KVPageLayout.schema`. A cluster router
        publishes it to the distkv board or hands it to a peer engine (same
        arch and params), which adopts the page without recomputing it."""
        return (self.kv_layout.schema,
                self._to_host(self.k_pages[:, block]),
                self._to_host(self.v_pages[:, block]))

    def import_page_payloads(self, blocks, payloads) -> None:
        """Write published pages into freshly adopted local ``blocks``
        (counterpart of :meth:`export_page_payload`). Every payload's schema
        tag, dtype and shape is checked against the local pools before any
        pool is touched; then one indexed write per pool lands every page
        (the reference batches them so, ``repro/serving/engine.py:1077-
        1097``)."""
        if not blocks:
            return
        if len(blocks) != len(payloads):
            raise ValueError(f"{len(blocks)} blocks for {len(payloads)} "
                             "page payloads")
        pools = (self.k_pages, self.v_pages)
        for p in payloads:
            check_schema(self.kv_layout.schema, p[0],
                         where="page-payload import")
            for t, pool in zip(p[1:], pools):
                want = (pool.shape[0],) + tuple(pool.shape[2:])
                if not isinstance(t, torch.Tensor) or t.dtype != pool.dtype \
                        or tuple(t.shape) != want:
                    raise ValueError(
                        f"page payload of {getattr(t, 'dtype', type(t))} "
                        f"{tuple(getattr(t, 'shape', ()))} does not fit a "
                        f"pool page of {pool.dtype} {want}")
        idx = torch.as_tensor(list(blocks), device=self.device)
        for i, pool in enumerate(pools):
            # each page crosses to the card on its own (asynchronously from
            # pinned memory); the stack is a copy on the card
            pool[:, idx] = torch.stack(
                [p[1 + i].to(self.device, non_blocking=True)
                 for p in payloads], 1)

    # -- disaggregated prefill/decode handoff -------------------------------------

    @property
    def free_decode_slots(self) -> int:
        """Decode slots a KVHandoff placement can still claim."""
        return min(len(self.free_slots),
                   self.scheduler.max_running - len(self.scheduler.running))

    def release_for_handoff(self, req: Request) -> None:
        """Prefill side of a KV handoff: return the request's decode slot
        and detach it from the scheduler WITHOUT finishing. The caller must
        already have secured the KV (exported payloads / lent the blocks)."""
        slot = self.slots.pop(req.request_id, None)
        if slot is not None:
            self.free_slots.append(slot)
        self.scheduler.release_request(req)

    def install_for_handoff(self, req: Request, table: BlockTable,
                            lease=None) -> None:
        """Decode side of a KV handoff: claim a slot and enter decode
        directly. ``table`` holds the locally-materialized KV pages (all of
        them under migration; only the partial tail page under a zero-copy
        lease, whose full pages stay on the prefill host)."""
        if lease is not None:
            self._check_zero_copy_ok()
            check_schema(self.kv_layout.schema,
                         getattr(lease, "schema", None),
                         where="KV handoff install")
        slot = self.free_slots.pop()
        self.slots[req.request_id] = slot
        # the decode input token is the first token, sampled on the prefill
        # instance from its final chunk's logits
        self.last_token[slot] = req.output[-1]
        self.scheduler.install_running(req, table, lease)

    def run_to_completion(self, max_iters: int = 10_000) -> None:
        for _ in range(max_iters):
            self.step()
            if not self.has_work:
                return
        raise RuntimeError("engine did not drain")

    # -- stats ------------------------------------------------------------------
    def kv_utilization(self) -> float:
        return self.allocator.utilization(list(self.scheduler.tables.values()))

    def prefix_cache_stats(self) -> Dict[str, float]:
        if self.prefix_cache is None:
            return {}
        return self.prefix_cache.stats()
