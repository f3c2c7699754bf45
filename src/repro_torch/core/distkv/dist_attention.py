"""DistAttention's micro-attention partials and their log-sum-exp merge
(``repro.core.distkv.dist_attention``), in plain float32 PyTorch.

A partial is attention over a subset of the keys that keeps its softmax
statistics apart: the un-normalised weighted values ``o``, the running
maximum ``m`` and the sum of weights ``l``. Partials over disjoint key sets
merge exactly into the attention over their union. The engine's MLA decode
attends through one partial and the merge, as the reference's does, and a
request served from a zero-copy lease merges its local partial with the
remote one read from the creditor's pages.

On a mesh (:func:`dist_attention`) the KV sequence axis is sharded over a
mesh dimension: each rank attends over its shard
(:func:`micro_attention_partial`) and :func:`merge_partials` combines the
partials with an all-reduce of the maxima, then of the rescaled sums and
outputs. K/V never move. ``local_map`` stands in for the reference's
``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import collectives


def micro_attention_partial(q, k, v, valid, *,
                            scale: Optional[float] = None):
    """A shard's micro-attention partial for one query a sequence
    (``dist_attention.py:29-39``). q: (B, H, Dh); k, v: (B, S_local, Hkv,
    Dh); valid: (B, S_local) bool. Returns (o (B, H, Dv) float32,
    un-normalised; m (B, H); l (B, H))."""
    o, m, l = attention_partial(q[:, None], k, v, valid[:, None, :],
                                scale=scale)
    return o[:, 0], m[:, 0], l[:, 0]


def merge_partials(o, m, l, mesh, dim):
    """The log-sum-exp merge of the partials of the ranks of mesh
    dimension(s) ``dim`` (``dist_attention.py:42-52``): the global
    maximum, then the all-reduced rescaled sums. o: (B, H, Dv); m, l:
    (B, H). Returns the normalised (B, H, Dv)."""
    m_glob = collectives.pmax(m, mesh, dim)
    corr = torch.exp(m - m_glob)
    l_glob = collectives.psum(l * corr, mesh, dim)
    o_glob = collectives.psum(o * corr[..., None], mesh, dim)
    return o_glob / l_glob.clamp_min(1e-9)[..., None]


def attention_partial(q, k, v, mask, *, scale: Optional[float] = None):
    """Masked multi-query micro-attention partial.

    q: (B, T, H, Dh); k, v: (B, S, Hkv, Dh); mask: (B, T, S) bool, entry
    ``[b, t, s]`` says query ``t`` may attend key ``s``. Returns
    ``(o_unnorm (B, T, H, Dv) float32, m (B, T, H), l (B, T, H))``. A query
    whose keys are all masked gets ``m = -1e30`` and ``l = 0`` (no NaN), so
    the merge gives it zeros.
    """
    b, t, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    qg = q.reshape(b, t, hkv, g, dh).float()
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.float()) * scale
    keep = mask[:, :, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1)  # (b, t, hkv, g)
    m_safe = m.clamp_min(-1e30)  # fully masked queries must not NaN
    p = torch.exp(s - m_safe[..., None]).masked_fill(~keep, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bthgs,bshd->bthgd", p, v.float())
    return (o.reshape(b, t, h, v.shape[-1]), m_safe.reshape(b, t, h),
            l.reshape(b, t, h))


def merge_partials_tree(os, ms, ls):
    """Merge a list of partials over disjoint key sets into normalised
    attention (B, T, H, Dv)."""
    m_glob = torch.stack(ms).amax(0)
    acc_o = acc_l = 0.0
    for o, m, l in zip(os, ms, ls):
        corr = torch.exp(m - m_glob)
        acc_l = acc_l + l * corr
        acc_o = acc_o + o * corr[..., None]
    return acc_o / acc_l.clamp_min(1e-9)[..., None]


def dist_attention(mesh, q, k, v, context_lens, *, axis: str = "model"):
    """DistAttention decode over a sequence-sharded KV cache
    (``dist_attention.py:95-118``). q: (B, H, Dh) and context_lens: (B,)
    replicated; k, v: (B, S, Hkv, Dh) with S sharded over mesh dimension
    ``axis`` (plain tensors are sharded here, each rank keeping its
    slice). A key is valid below its sequence's length, by absolute
    position. Returns (B, H, Dv) float32, replicated."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    s_local = k.shape[1] // n
    seq = [Shard(1) if name == axis else Replicate()
           for name in mesh.mesh_dim_names]
    rep = [Replicate()] * mesh.ndim
    if not isinstance(k, DTensor):
        from repro_torch.launch.sharding import shard_tensor
        k, v = shard_tensor(k, mesh, seq), shard_tensor(v, mesh, seq)

    def shard_fn(q_l, k_l, v_l, lens):
        idx = mesh.get_local_rank(axis)
        pos = idx * s_local + torch.arange(s_local, device=k_l.device)
        valid = pos[None, :] < lens[:, None]
        o, m, l = micro_attention_partial(q_l, k_l, v_l, valid)
        return merge_partials(o, m, l, mesh, axis)

    fn = local_map(shard_fn, out_placements=rep,
                   in_placements=(rep, seq, seq, rep), device_mesh=mesh,
                   redistribute_inputs=True)
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, rep, run_check=False)
    if not isinstance(context_lens, DTensor):
        context_lens = DTensor.from_local(context_lens, mesh, rep,
                                          run_check=False)
    return fn(q, k, v, context_lens)


def dist_attention_ref(q, k, v, context_lens):
    """The unsharded oracle (``dist_attention.py:121-133``): float32
    softmax attention of q (B, H, Dh) over the first ``context_lens``
    keys of k, v (B, S, Hkv, Dh)."""
    b, h, dh = q.shape
    hkv = k.shape[2]
    valid = torch.arange(k.shape[1], device=k.device)[None, :] \
        < context_lens[:, None]
    qg = q.reshape(b, hkv, h // hkv, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / dh ** 0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(b, h, v.shape[-1])
