"""Sharding rules (the port of ``repro.launch.sharding``): parameters,
inputs, caches and the activation policy, on a DeviceMesh with DTensors.

The decisions are the reference's, made from shapes and the mesh's named
sizes alone:

* **weights** are 2-D sharded: the penultimate dimension over ``data``
  (FSDP), the last over ``model`` (tensor parallel), stacked-layer
  dimensions replicated. A MoE expert stack ``(E, d, ff)`` shards E over
  ``model`` (expert parallelism) and d over ``data``; the embedding table
  its vocab over ``model``.
* **train / prefill activations**: batch over (pod x) data; heads, ffn
  and vocab over ``model`` where they divide.
* **decode caches**: batch over data where it divides; the KV *sequence*
  axis over ``model`` (and over data too when the batch cannot take it):
  DistAttention.

Every rule checks divisibility and falls back to replication (hymba's 25
heads stay whole on a 16-way axis).

A decision is a :class:`P` (the reference's ``PartitionSpec``: one entry
per tensor dimension, a mesh dimension name, a tuple of them, or None);
:func:`placements_of` turns it into DTensor placements. Where the reference
constrains (``with_sharding_constraint``), :class:`MeshPolicy`
redistributes; its ``moe_apply`` and ``decode_attention`` are
``local_map`` bodies, the reference's ``shard_map``. The environment
switch ``REPRO_LAYOUT=baseline`` turns the Megatron layout off, as in the
reference's dry-run.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, List, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, \
    local_map

from repro_torch.configs import ArchConfig
from repro_torch.core import collectives
from repro_torch.core.distkv.dist_attention import attention_partial, \
    merge_partials, micro_attention_partial
from repro_torch.launch.mesh import data_axes, mesh_axis_names, mesh_sizes
from repro_torch.models.attention import Q_BLOCK, _bf16, blockwise_attention
from repro_torch.models.layers import ShardingPolicy, mlp, token_losses


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dimension 0 over
    ``data``; an entry may be a tuple of mesh dimensions (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def megatron_layout() -> bool:
    """``REPRO_LAYOUT`` (default ``megatron``; ``baseline`` is the
    paper-faithful layout), as the reference's dry-run reads it."""
    return os.environ.get("REPRO_LAYOUT", "megatron") == "megatron"


def placements_of(spec: Sequence, mesh) -> List:
    """DTensor placements, one per mesh dimension, of ``spec``."""
    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(d)
    return out


def shard_tensor(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``placements``, each rank keeping its slice: no communication."""
    coord = mesh.get_coordinate()
    local = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    stride, n = [], 1
    for size in reversed(t.shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False, shape=t.shape,
                              stride=tuple(stride))


def _prod(sizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` forward, and the gradient to the
    same placements backward: a partial sum (the gradient of a
    vocab-parallel or row-parallel product) is reduced there, instead of
    flowing on and making every later product of the backward whole on
    each rank."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        if list(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and list(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def _micro_attention(q, k, v, mesh, dim: str, *, causal, window, q_offset,
                     scale):
    """Causal / windowed attention of q (B, S, H, D) over this rank's slice
    of the keys (B, S_loc, Hkv, D), the slice of mesh dimension ``dim``:
    float32 partials over bf16-rounded operands, merged over ``dim``
    (query blocks of ``Q_BLOCK``, as ``blockwise_attention`` bounds its
    scores)."""
    b, s, h, dh = q.shape
    s_loc = k.shape[1]
    kpos = mesh.get_local_rank(dim) * s_loc + torch.arange(s_loc,
                                                          device=k.device)
    k, v = _bf16(k), _bf16(v)
    scale = scale if scale is not None else dh ** -0.5
    outs = []
    for c0 in range(0, s, Q_BLOCK):
        qc = q[:, c0:c0 + Q_BLOCK]
        qpos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        mask = torch.ones(qc.shape[1], s_loc, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        o, m, l = attention_partial(_bf16(qc), k, v,
                                    mask[None].expand(b, -1, -1),
                                    scale=scale)
        m_g = collectives.pmax(m, mesh, dim)
        corr = torch.exp(m - m_g)
        l_g = collectives.psum(l * corr, mesh, dim)
        o_g = collectives.psum(o * corr[..., None], mesh, dim)
        outs.append((o_g / l_g.clamp_min(1e-9)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1).contiguous()


def _local_matmul(x, w, mesh):
    """``x @ w`` (w 2-D) as each rank's product of its shards, where every
    mesh dimension holds one of the Megatron layouts: tokens sharded and
    the weight whole (the weight's gradient a partial sum), the weight's
    columns sharded and ``x`` whole (``x``'s gradient a partial sum), or
    the contraction sharded on both (the product a partial sum), or both
    whole. None for any other layout (DTensor's own sharding of the
    product runs). Stated gradient layouts keep the backward's products
    on the local shards, where DTensor would choose for itself (and can
    choose to gather the activations for the weight's gradient)."""
    last = x.dim() - 1
    out, gx, gw = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Shard) and px.dim < last and pw == Replicate():
            out.append(px), gx.append(px), gw.append(Partial())
        elif px == Replicate() and pw == Shard(1):
            out.append(Shard(last)), gx.append(Partial()), gw.append(pw)
        elif px == Shard(last) and pw == Shard(0):
            out.append(Partial()), gx.append(px), gw.append(pw)
        elif px == Replicate() and pw == Replicate():
            out.append(px), gx.append(px), gw.append(pw)
        else:
            return None
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(list(x.placements), list(w.placements)),
                     in_grad_placements=(gx, gw), device_mesh=mesh)(x, w)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: the einsums' backward
    hands out permuted gradients, and DTensor's ``view`` of a permuted
    local shard fails further up the backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class MeshPolicy(ShardingPolicy):
    """Activation layouts, divisibility-guarded (``sharding.py:34-275``)."""

    kernels = False

    def __init__(self, mesh, cfg: ArchConfig, *, decode: bool = False,
                 megatron: bool = True):
        """``megatron``: inter-block activations replicated in d_model and
        transient FSDP weight gathers before each matmul; False is the
        baseline layout (activations d@model, weights used as stored)."""
        self.mesh = mesh
        self.cfg = cfg
        self.decode = decode
        self.megatron = megatron
        sizes = mesh_sizes(mesh)
        self.dp = data_axes(mesh)
        self.dp_size = _prod(sizes, self.dp)
        self.mp = "model" if "model" in sizes else None
        self.mp_size = sizes["model"] if self.mp else 1
        # GShard grouped MoE dispatch: one group per data shard
        self.moe_groups = self.dp_size

    def scope(self):
        """Plain tensors (masks, positions, iotas) count as replicated.
        ``implicit_replication`` turns the switch off when it exits, so an
        inner scope (``Model.loss`` inside a train step, whose backward
        runs after it) enters only where the switch is off."""
        if getattr(DTensor._op_dispatcher, "_allow_implicit_replication",
                   False):
            return contextlib.nullcontext()
        return implicit_replication()

    # -- decisions ------------------------------------------------------------
    def param_spec_for(self, shape, kind: str):
        """The layout ``param`` gives a weight of ``shape``, or None. The
        unembedding's table (a port kind) is gathered over data in every
        step, decode too: the logits come out (tokens@data,
        vocab@model), Megatron's vocab-parallel matmul, where DTensor
        would otherwise settle the table's data-sharded d_model against
        the data-sharded tokens by replicating both."""
        nd = len(shape)
        if kind == "unembed_table":
            return P("model" if _div(shape[0], self.mp_size) else None,
                     None)
        if kind != "matmul_weight" or nd < 2 or self.decode \
                or not self.megatron:
            return None
        if _div(shape[-1], self.mp_size):
            return P(*(None,) * (nd - 1), self.mp)
        return P(*(None,) * nd)

    def act_spec(self, shape, kind: str):
        """The layout ``act`` gives an activation of ``shape``, or None
        where the reference leaves it alone (``sharding.py:161-249``)."""
        dp, mp = self.dp, self.mp
        nd = len(shape)
        batch_ax = dp if _div(shape[0], self.dp_size) else None
        if kind == "act_bsd":
            if self.megatron:
                return P(batch_ax, *(None,) * (nd - 1))
            if _div(shape[-1], self.mp_size):
                return P(batch_ax, *(None,) * (nd - 2), mp)
            return P(batch_ax, *(None,) * (nd - 1))
        if kind == "ffn_bsf":
            return P(batch_ax, None, mp) if _div(shape[-1], self.mp_size) \
                else None
        if kind == "logits_bsv":
            return P(batch_ax, *(None,) * (nd - 2), mp) \
                if _div(shape[-1], self.mp_size) else None
        if kind == "heads_bshd":
            if _div(shape[2], self.mp_size):
                return P(batch_ax, None, mp, None)
            return P(batch_ax, None, None, None)
        if kind == "kv_bshd":
            if _div(shape[2], self.mp_size):
                return P(batch_ax, None, mp, None)
            if _div(shape[1], self.mp_size):
                return P(batch_ax, mp, None, None)
            return P(batch_ax, None, None, None)
        if kind in ("kvcache_bskd", "mlacache_bsr"):
            seq_ax = mp if batch_ax else (tuple(dp) + (mp,) if mp else dp)
            size = self.mp_size * (1 if batch_ax else self.dp_size)
            if not _div(shape[1], size):
                seq_ax = mp if _div(shape[1], self.mp_size) else None
            if nd == 4:
                return P(batch_ax, seq_ax, None, None)
            return P(batch_ax, seq_ax, None)
        if kind in ("expert_gecd", "expert_gecf"):
            gax = dp if _div(shape[0], self.dp_size) else None
            eax = mp if _div(shape[1], self.mp_size) else None
            return P(gax, eax, None, None)
        if kind in ("kvrep_bshd", "scores_bchs"):
            return P(batch_ax, None, mp, None)
        if kind == "scores_bchgs":
            if _div(shape[2], self.mp_size):
                return P(batch_ax, None, mp, None, None)
            if _div(shape[-1], self.mp_size):
                return P(batch_ax, None, None, None, mp)
            return P(batch_ax, None, None, None, None)
        if kind == "ssm_bshp":
            if nd == 4 and _div(shape[2], self.mp_size):
                return P(batch_ax, None, mp, None)
            return None
        return None

    def prefers_flat_heads(self, h: int, hkv: int) -> bool:
        """Flat-H sharding works where grouped Hkv sharding does not (96
        heads over 8 KV heads on a 16-way axis)."""
        return (self.megatron and _div(h, self.mp_size)
                and not _div(hkv, self.mp_size))

    # -- hooks ----------------------------------------------------------------
    def _c(self, x, spec):
        """``x`` laid out as ``spec``, its gradient too (as
        ``with_sharding_constraint`` constrains the cotangent)."""
        if not isinstance(x, DTensor):
            return x
        return _Constrain.apply(x, self.mesh, placements_of(spec, self.mesh))

    def act(self, x, kind: str):
        spec = self.act_spec(tuple(x.shape), kind)
        return x if spec is None else self._c(x, spec)

    def param(self, w, kind: str):
        """The transient FSDP gather: a weight stored (d_in@data,
        d_out@model) is redistributed to (d_in, d_out@model) before its
        matmul (its gradient is reduce-scattered back); decode keeps
        weights as stored."""
        spec = self.param_spec_for(tuple(w.shape), kind)
        if spec is None or not isinstance(w, DTensor):
            return w
        pl = placements_of(spec, self.mesh)
        return w if list(w.placements) == pl else \
            w.redistribute(self.mesh, pl)

    def matmul(self, x, w):
        """``x @ param(w)``, except where ``x``'s contraction axis is
        sharded over ``model`` (the row-parallel matmuls: the attention
        output, the MLP's down projection): there the weight is laid out
        (d_in@model, d_out) and the product is a partial sum that the
        output's ``act`` reduces, Megatron's row-parallel layer. The
        reference's transient (d_in, d_out@model) would meet a
        (…, d_in@model) input, which DTensor settles by resharding the
        weight in the forward and replicating the backward's products."""
        if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or \
                w.dim() != 2:
            return x @ self.param(w, "matmul_weight")
        mi = mesh_axis_names(self.mesh).index(self.mp) if self.mp else None
        if mi is not None and self.megatron and not self.decode and \
                x.placements[mi] == Shard(x.dim() - 1):
            pl = [Replicate()] * self.mesh.ndim
            pl[mi] = Shard(0)
            if list(w.placements) != pl:
                w = w.redistribute(self.mesh, pl)
        else:
            w = self.param(w, "matmul_weight")
        y = _local_matmul(x, w, self.mesh)
        return x @ w if y is None else y

    def _pl(self, **dims):
        """Placements: mesh dimension name -> placement, Replicate
        elsewhere."""
        return [dims.get(n, Replicate()) for n in mesh_axis_names(self.mesh)]

    def moe_apply(self, cfg, p, x, return_aux: bool):
        """Expert-parallel MoE (``sharding.py:61-137``): tokens sharded over
        data and replicated over ``model``; each ``model`` rank runs E/mp
        whole experts on its tokens' places (a capacity cursor over all E,
        so the ranks agree), after an all-gather of the weights'
        contraction dimension over data (reduce-scatter backward); one
        all-reduce over ``model`` combines. The aux loss is each data
        shard's. Returns None (the grouped dispatch runs) where E or the
        tokens do not divide."""
        if self.mp is None or not _div(cfg.num_experts, self.mp_size) \
                or not isinstance(x, DTensor):
            return None
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.moe_top_k
        e_loc = e // self.mp_size
        t = b * s
        if t % self.dp_size:
            return None
        t_loc = max(t // self.dp_size, 1)
        cap = max(8, int(t_loc * k * cfg.capacity_factor / e + 8) // 8 * 8)
        mesh, dpa, mp = self.mesh, self.dp, self.mp

        def local(xt, router_w, gate_w, up_w, down_w):
            gate_w = collectives.all_gather(gate_w, mesh, dpa, 1)
            up_w = collectives.all_gather(up_w, mesh, dpa, 1)
            down_w = collectives.all_gather(down_w, mesh, dpa, 1)
            midx = mesh.get_local_rank(mp)
            probs = torch.softmax(xt.float() @ router_w, dim=-1)
            # lax.top_k's order: a stable descending sort
            topv, topi = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
            topv, topi = topv[:, :k], topi[:, :k]
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
            onehot = F.one_hot(topi.reshape(-1), e)
            pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1) \
                .view(-1, k)
            local_e = topi - midx * e_loc
            mine = (local_e >= 0) & (local_e < e_loc) & (pos < cap)
            n_tok = xt.shape[0]
            # places of other ranks' experts, and drops, land in a spare
            # (expert, place) past the end
            disp = xt.new_zeros((e_loc + 1, cap + 1, d))
            disp[torch.where(mine, local_e, e_loc),
                 torch.where(mine, pos, cap)] = \
                xt[:, None, :].expand(n_tok, k, d)
            disp = disp[:e_loc, :cap]
            h = F.silu(torch.bmm(disp, gate_w)) * torch.bmm(disp, up_w)
            out = torch.bmm(h, down_w)  # (e_loc, cap, d)
            gathered = out[torch.where(mine, local_e, 0),
                           torch.where(mine, pos, 0)]  # (T_loc, k, d)
            w = (topv * mine).to(xt.dtype)
            y = collectives.psum((gathered * w[..., None]).sum(1), mesh, mp)
            frac_tok = F.one_hot(topi[:, 0], e).float().mean(0)
            aux = e * (frac_tok * probs.mean(0)).sum()
            # equal on every model rank: its gradient is taken once
            once = 1.0 if midx == 0 else 0.0
            aux = aux.detach() + (aux - aux.detach()) * once
            return y, aux[None]

        tok = self._pl(**{a: Shard(0) for a in dpa})
        tok_grad = self._pl(**{a: Shard(0) for a in dpa}, model=Partial())
        rep = self._pl()
        rep_grad = [Partial()] * len(rep)
        experts = self._pl(**{a: Shard(1) for a in dpa}, model=Shard(0))
        fn = local_map(local, out_placements=(tok, tok),
                       in_placements=(tok, rep, experts, experts, experts),
                       in_grad_placements=(tok_grad, rep_grad, experts,
                                           experts, experts),
                       device_mesh=mesh, redistribute_inputs=True)
        y, aux = fn(x.reshape(t, d), p["router"]["w"].float(), p["gate"],
                    p["up"], p["down"])
        y = y.reshape(b, s, d)
        if "shared" in p:
            y = y + mlp(p["shared"], x, self)
        aux = aux.mean()
        return (y, aux) if return_aux else y

    def local_attention(self, q, k, v, *, causal, window, q_offset,
                        scale):
        """Full-sequence attention on each rank's shards (what GSPMD makes
        of the reference's einsums). q: (B, S, H, D) sharded over batch and
        maybe heads. K/V:
        * sharded as q (grouped heads): ``blockwise_attention`` per rank;
        * replicated or sequence-sharded where q's heads are sharded (flat
          heads): the sequence gathered, each rank takes the KV head of
          each of its query heads, and the K/V gradients are summed;
        * sequence-sharded where q's heads are whole (heads that do not
          divide the axis, llama4's 40 or hymba's 25 on 16): each rank
          attends over its keys (float32 micro-attention partials, masked
          by absolute key position) and the partials merge by all-reduce,
          as DistAttention does; q's gradient is summed.
        None (DTensor's own sharding of the einsums runs) otherwise."""
        if not all(isinstance(t, DTensor) for t in (q, k, v)):
            return None
        mesh = self.mesh
        names = mesh_axis_names(mesh)
        qp, kp = list(q.placements), list(k.placements)
        if list(v.placements) != kp:
            return None
        h, hkv = q.shape[2], k.shape[2]
        g = h // hkv
        flat, seq = [], []
        for i, (a, b) in enumerate(zip(qp, kp)):
            if a == b and a in (Shard(0), Shard(2), Replicate()):
                continue
            if a == Shard(2) and b in (Replicate(), Shard(1)):
                flat.append(i)  # a sequence shard is gathered first
                kp[i] = Replicate()
                continue
            if a == Replicate() and b == Shard(1):
                seq.append(i)
                continue
            return None
        if len(flat) > 1 or len(seq) > 1 or (flat and seq):
            return None
        kv_grad = [Partial() if i in flat else pl for i, pl in
                   enumerate(kp)]
        q_grad = [Partial() if i in seq else pl for i, pl in enumerate(qp)]
        h_loc = h // (mesh.size(flat[0]) if flat else 1)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  scale=scale)

        def local(q_l, k_l, v_l):
            q_l, k_l, v_l = (_DenseGrad.apply(t) for t in (q_l, k_l, v_l))
            if flat:
                first = mesh.get_local_rank(names[flat[0]]) * h_loc
                idx = torch.arange(first, first + h_loc,
                                   device=k_l.device) // g
                k_l, v_l = k_l[:, :, idx], v_l[:, :, idx]
            if seq:
                return _micro_attention(q_l, k_l, v_l, mesh, names[seq[0]],
                                        **kw)
            return blockwise_attention(q_l, k_l, v_l, **kw).contiguous()

        run = local_map(local, out_placements=qp,
                        in_placements=(qp, kp, kp),
                        in_grad_placements=(q_grad, kv_grad, kv_grad),
                        device_mesh=mesh, redistribute_inputs=True)
        return run(q, k, v)

    def token_losses(self, logits, labels):
        """Megatron's vocab-parallel cross-entropy (what GSPMD makes of the
        reference's): each rank reduces its vocab columns; the (B, S)
        maxima, sums and gold logits are all-reduced over the vocab's
        dimensions. Out: batch-sharded, replicated over ``model``."""
        if not isinstance(logits, DTensor):
            return None
        mesh = self.mesh
        names = mesh_axis_names(mesh)
        lp = list(logits.placements)
        vdim = logits.dim() - 1
        vocab = tuple(n for i, (n, pl) in enumerate(zip(names, lp))
                      if pl == Shard(vdim) and mesh.size(i) > 1)
        if len(vocab) > 1:
            return None
        lp = [pl if pl in (Shard(0), Shard(vdim)) else Replicate()
              for pl in lp]
        rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in lp]
        v_loc = logits.shape[-1] // (mesh.size(names.index(vocab[0]))
                                     if vocab else 1)

        def local(lg, lab):
            if not vocab:
                return token_losses(lg, lab)
            # the max plus the log of a sum, and the gold logit as a masked
            # sum: each a local reduction and an all-reduce
            m = collectives.pmax(lg.amax(-1, keepdim=True), mesh, vocab)
            se = collectives.psum(torch.exp(lg - m).sum(-1), mesh, vocab)
            first = mesh.get_local_rank(vocab[0]) * v_loc
            iota = first + torch.arange(lg.shape[-1], device=lg.device)
            gold = collectives.psum(torch.where(
                iota == lab[..., None], lg, 0.0).sum(-1), mesh, vocab)
            return m[..., 0] + torch.log(se) - gold

        run = local_map(local, out_placements=rows, in_placements=(lp, rows),
                        in_grad_placements=(lp, rows), device_mesh=mesh,
                        redistribute_inputs=True)
        if not isinstance(labels, DTensor):
            labels = DTensor.from_local(labels, mesh, self._pl(),
                                        run_check=False)
        return run(logits, labels)

    def embed(self, table, tokens):
        """The vocab-parallel lookup (Megatron's; GSPMD's partitioning of
        the reference's ``take``): the table's d_model columns gathered
        over data, each ``model`` rank the rows of its vocab slice (zero
        elsewhere), one all-reduce over ``model``. Out: batch over data,
        replicated over ``model``."""
        if not isinstance(table, DTensor) or self.mp is None:
            return None
        mesh, dpa, mp = self.mesh, self.dp, self.mp
        names = mesh_axis_names(mesh)
        t_pl = list(table.placements)
        vocab_sharded = t_pl[names.index(mp)] == Shard(0) and \
            self.mp_size > 1
        col_dims = tuple(n for i, (n, pl) in enumerate(zip(names, t_pl))
                         if pl == Shard(1) and mesh.size(i) > 1)
        rows = table.shape[0] // (self.mp_size if vocab_sharded else 1)
        if not isinstance(tokens, DTensor):
            tokens = DTensor.from_local(tokens, mesh, self._pl(),
                                        run_check=False)
        batch = [Shard(0) if pl == Shard(0) and n in dpa else Replicate()
                 for n, pl in zip(names, tokens.placements)]
        tab = [pl if (n == mp and vocab_sharded) or n in col_dims
               else Replicate() for n, pl in zip(names, t_pl)]

        def local(tab_l, tok_l):
            if col_dims:
                tab_l = collectives.all_gather(tab_l, mesh, col_dims, 1)
            if not vocab_sharded:
                return tab_l[tok_l]
            ids = tok_l - mesh.get_local_rank(mp) * rows
            mine = (ids >= 0) & (ids < rows)
            x = tab_l[torch.where(mine, ids, 0)]
            x = x * mine[..., None].to(x.dtype)
            return collectives.psum(x, mesh, mp)

        fn = local_map(local, out_placements=batch,
                       in_placements=(tab, batch),
                       in_grad_placements=(tab, batch), device_mesh=mesh,
                       redistribute_inputs=True)
        return fn(table, tokens)

    def decode_attention(self, q, k, v, mask, scale: float):
        """Decode attention over a cache whose sequence axis is sharded
        (the DistAttention layout): each rank's float32 micro-attention
        partial over its slots, merged by all-reducing the (B, H) maxima
        and sums and the output over the sharding dimensions; no K/V
        moves. q: (B, H, Dk); k, v: (B, S, Hkv, D); mask: (B, S) or None.
        Returns (B, H, Dv) float32."""
        if not isinstance(k, DTensor):
            return None
        names = mesh_axis_names(self.mesh)
        kv_pl = list(k.placements)
        seq_dims = tuple(n for n, pl in zip(names, kv_pl) if pl == Shard(1))
        row = [Shard(0) if pl == Shard(0) else Replicate() for pl in kv_pl]
        mask_pl = [pl if pl in (Shard(0), Shard(1)) else Replicate()
                   for pl in kv_pl]
        mesh = self.mesh

        def local(q_l, k_l, v_l, m_l):
            o, m, l = micro_attention_partial(q_l, k_l, v_l, m_l,
                                              scale=scale)
            if seq_dims:
                return merge_partials(o, m, l, mesh, seq_dims)
            return o / l.clamp_min(1e-9)[..., None]

        if mask is None:
            mask = torch.ones(k.shape[:2], dtype=torch.bool,
                              device=k.device)
        fn = local_map(local, out_placements=row,
                       in_placements=(row, kv_pl, kv_pl, mask_pl),
                       device_mesh=mesh, redistribute_inputs=True)
        if not isinstance(q, DTensor):
            q = DTensor.from_local(q, mesh, [Replicate()] * len(names),
                                   run_check=False)
        if not isinstance(mask, DTensor):
            mask = shard_tensor(mask, mesh, mask_pl)
        return fn(q, k, v, mask)


# ---------------------------------------------------------------------------
# parameter / input / cache layouts
# ---------------------------------------------------------------------------

def _tree_map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples; a path holds dict keys, NamedTuple field names and
    sequence indices."""
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _sizes(mesh):
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    return dp, _prod(sizes, dp), sizes["model"]


def param_spec(path, shape, mesh, cfg: ArchConfig) -> P:
    """A parameter leaf's layout (``sharding.py:282-313``)."""
    dp, dsize, msize = _sizes(mesh)
    nd = len(shape)
    name = path[-1] if path else ""
    if nd <= 1:
        return P()
    if name == "table" and nd == 2:  # vocab-parallel embedding
        v, d = shape
        return P("model" if _div(v, msize) else None,
                 dp if _div(d, dsize) else None)
    if name in ("gate", "up", "down") and nd >= 3 and cfg.is_moe:
        e, w_in = shape[-3], shape[-2]
        return P(*(None,) * (nd - 3), "model" if _div(e, msize) else None,
                 dp if _div(w_in, dsize) else None, None)
    d_in, d_out = shape[-2:]
    return P(*(None,) * (nd - 2), dp if _div(d_in, dsize) else None,
             "model" if _div(d_out, msize) else None)


def param_specs(params, mesh, cfg: ArchConfig):
    """A tree of :class:`P` over a parameter (or optimizer-moment) tree."""
    return _tree_map_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh, cfg),
        params)


def batch_specs(specs, mesh, cfg: ArchConfig):
    """Token batches: batch over (pod x) data where it divides
    (``sharding.py:322-333``). ``specs``: a dict of tensors or
    ``configs.Spec``."""
    dp, dsize, _ = _sizes(mesh)

    def mk(leaf):
        shape = tuple(leaf.shape)
        return P(dp if _div(shape[0], dsize) else None,
                 *(None,) * (len(shape) - 1))
    return {k: mk(v) for k, v in specs.items()}


def cache_specs(caches, mesh, cfg: ArchConfig, batch: int):
    """Decode caches: batch over data where it divides, the sequence axis
    of ``k`` / ``v`` / ``ckv`` / ``krope`` / ``pos`` / ``ck`` / ``cv`` over
    model (and data when the batch cannot take it), an SSM state's heads
    and a conv window's channels over model (``sharding.py:336-392``)."""
    dp, dsize, msize = _sizes(mesh)
    batch_ok = _div(batch, dsize)

    def seq_axis_for(sdim: int):
        if batch_ok:
            return "model" if _div(sdim, msize) else None
        if _div(sdim, dsize * msize):
            return tuple(dp) + ("model",)
        return "model" if _div(sdim, msize) else None

    def mk(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        lead = 1 if (nd >= 3 and shape[0] != batch and shape[1] == batch) \
            else 0
        spec = [None] * nd
        if shape[lead] == batch and batch_ok:
            spec[lead] = dp
        field = path[-1] if path else ""
        if field in ("k", "v", "ckv", "krope", "pos", "ck", "cv"):
            if lead + 1 < nd:
                spec[lead + 1] = seq_axis_for(shape[lead + 1])
        elif field == "state":
            if lead + 1 < nd and _div(shape[lead + 1], msize):
                spec[lead + 1] = "model"
        elif field == "conv":
            if _div(shape[nd - 1], msize):
                spec[nd - 1] = "model"
        return P(*spec)

    return _tree_map_path(mk, caches)


def replicated_specs(tree):
    return _tree_map_path(lambda path, leaf: P(), tree)


def _placements(spec_tree, mesh):
    if isinstance(spec_tree, P):
        return placements_of(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: _placements(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_placements(v, mesh) for v in spec_tree))
    return type(spec_tree)(_placements(v, mesh) for v in spec_tree)


def param_shardings(params, mesh, cfg: ArchConfig):
    """A tree of placements (one list per leaf) for ``params``."""
    return _placements(param_specs(params, mesh, cfg), mesh)


def batch_shardings(specs, mesh, cfg: ArchConfig):
    return _placements(batch_specs(specs, mesh, cfg), mesh)


def cache_shardings(caches, mesh, cfg: ArchConfig, batch: int):
    return _placements(cache_specs(caches, mesh, cfg, batch), mesh)


def replicated(tree, mesh):
    return _placements(replicated_specs(tree), mesh)


def distribute(tree, spec_tree, mesh) -> Any:
    """``tree``'s tensors (whole, the same on every rank) as DTensors laid
    out by ``spec_tree`` (a tree of :class:`P`)."""
    def go(t, s):
        if isinstance(s, P):
            return shard_tensor(t, mesh, placements_of(s, mesh))
        if isinstance(t, dict):
            return {k: go(t[k], s[k]) for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(a, b) for a, b in zip(t, s)))
        return type(t)(go(a, b) for a, b in zip(t, s))
    return go(tree, spec_tree)


def gather(tree) -> Any:
    """Every DTensor of ``tree`` as its whole tensor (a collective: every
    rank calls it)."""
    return _tree_map_path(
        lambda path, t: t.full_tensor() if isinstance(t, DTensor) else t,
        tree)
