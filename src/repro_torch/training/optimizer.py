"""AdamW with a cosine schedule after a linear warm-up, as
``repro.training.optimizer`` computes it.

The learning rate, the bias corrections and the clip scale are float32
tensors, as ``jnp`` computes them (not Python doubles): one bfloat16
rounding of ``p - lr * delta`` depends on them. Weight decay applies to
every leaf of two or more dimensions *as stored*: the layer axis of a
stacked segment counts, so a multi-layer segment's norm scales (2-D) are
decayed and a one-layer segment's (1-D) are not, exactly as the reference
does on the same tree. :func:`apply` updates parameters and moments in
place (the reference's launcher donates both), in slices of
``UPDATE_CHUNK`` elements so that the float32 temporaries of a large bf16
leaf stay small.

DTensor leaves (a mesh's parameters) update shard by shard: each
gradient is first laid out as its parameter is (a partial sum is
reduced), the clip reads the *global* norm, one number on every rank,
and the decay rule reads the leaf's global rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.training.tree import leaves, tree_map

UPDATE_CHUNK = 1 << 26  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim
    mu: Any  # first moment (float32)
    nu: Any  # second moment (float32)


def _f32(x, device=None):
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step):
    """The learning rate after ``step`` steps (an int or an int tensor),
    a float32 tensor (``optimizer.py:34-40``)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1),
                         _f32(1.0, step.device))
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params) -> OptState:
    """Zero float32 moments beside every leaf, on its device (a DTensor
    leaf's with its placements); step 0."""
    first = leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def _whole(t):
    """A replicated DTensor's value as a plain tensor."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed over
    the leaves in the reference's order (``optimizer.py:50-53``); over
    DTensors the global norm, as a plain tensor on every rank."""
    return _whole(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in leaves(tree))))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _like(g, p):
    """``g`` laid out as ``p`` is (a DTensor gradient's partial sums
    reduced)."""
    if isinstance(p, DTensor) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step (``optimizer.py:61-89``): clip by the global norm,
    decoupled weight decay on leaves of two or more dimensions. Updates
    the leaves of ``params``, ``state.mu`` and ``state.nu`` in place and
    returns (params, the new state, {"grad_norm", "lr"})."""
    grads = [_like(g, p) for g, p in zip(leaves(grads), leaves(params))]
    gnorm = global_norm(grads)
    dev = gnorm.device
    # a Python number over a tensor would take the reciprocal first
    scale = torch.minimum(_f32(1.0, dev),
                          torch.div(_f32(cfg.grad_clip, dev), gnorm + 1e-9))
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    for p, g, m, v in zip(leaves(params), grads, leaves(state.mu),
                          leaves(state.nu)):
        decay = p.dim() >= 2  # the stored leaf's rank, layer axis included
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for i in range(0, pf.numel(), UPDATE_CHUNK):
            sl = slice(i, i + UPDATE_CHUNK)
            gi = gf[sl].float() * scale
            mi = mf[sl].mul_(cfg.b1).add_((1 - cfg.b1) * gi)
            vi = vf[sl].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gi))
            delta = (mi / b1c) / (torch.sqrt(vi / b2c) + cfg.eps)
            pi = pf[sl]
            if decay:
                delta = delta + cfg.weight_decay * pi.float()
            pi.copy_(pi.float() - lr * delta)
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
