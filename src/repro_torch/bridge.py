"""Weights for the port.

* :func:`init_params` builds the reference's parameter tree on the target
  device from a seed, with the reference's distributions. This is how
  weights reach the GPU, with no JAX installed beside the port.
* :func:`from_numpy_tree` / :func:`to_numpy_tree` carry a reference tree,
  given as numpy arrays, into torch tensors and back. The tests use it to
  run both packages on the same weights. Layouts are kept as they are
  (``dense`` is ``(d_in, d_out)``; stacked segments keep their leading
  layer axis), so the bridge is a copy, never a transpose. bfloat16 goes
  through a 16-bit integer view, as ``repro/training/checkpoint.py`` does:
  numpy has no native bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa_init, mla_init
from repro_torch.models.layers import embed_init, mlp_init, norm_init
from repro_torch.models.moe import moe_init
from repro_torch.models.ssm import ssm_init
from repro_torch.models.transformer import encoder_plan, stack_plan


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaf_to_torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_numpy_tree(tree):
    """Reference parameter tree (nested dicts / lists of numpy arrays,
    bfloat16 as the ``ml_dtypes`` type JAX hands out) -> the same tree of
    CPU torch tensors, each leaf keeping its dtype."""
    return _map(tree, _leaf_to_torch)


def _leaf_to_numpy(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy_tree(tree):
    """Torch tree -> numpy tree. bfloat16 leaves come back as their raw
    ``uint16`` bits (``a.view(np.uint16)`` of the reference array)."""
    return _map(tree, _leaf_to_numpy)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda", *,
                plan=None, enc_plan=None):
    """The reference's parameter tree for ``cfg``, drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed``: dense weights normal *
    1/sqrt(d_in), the embedding normal * 0.02 over the 512-padded vocab,
    norm scales one (an MLA layer's latent projections and norms too); a
    MoE layer's float32 router normal * 1/sqrt(d), its experts' up and
    gate normal * 1/sqrt(d) and down normal * 1/sqrt(ff); an SSM layer's
    conv weights normal * 0.2, A_log = log(1..H), D one, dt_bias and the
    conv bias zero. A hybrid layer has both ``attn`` and ``ssm`` and the
    dense MLP; a cross layer also ``ln_cross`` and the GQA block ``cross``;
    an encoder-decoder model also ``params["encoder"]`` (``{"segments",
    "final_norm"}``, its dense GQA layers) (``transformer.py:87-106,
    319-330``). Same shapes and distributions as ``Model.init``; not the
    same numbers (JAX's generator differs). ``plan`` / ``enc_plan``
    replace the config's segment plans (the dry-run's capped depth)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype
    d = cfg.d_model
    segments = _init_segments(cfg, plan or stack_plan(cfg), gen, dt, dev)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt, dev),
        "final_norm": norm_init(d, dt, dev, bias=cfg.use_bias),
        "segments": segments,
    }
    if cfg.is_encdec:
        params["encoder"] = {
            "segments": _init_segments(cfg, enc_plan or encoder_plan(cfg),
                                       gen, dt, dev),
            "final_norm": norm_init(d, dt, dev, bias=cfg.use_bias),
        }
    return params


def _init_segments(cfg: ArchConfig, plan, gen, dt, dev):
    """One parameter dict per segment of ``plan``, its layers stacked
    along a leading axis where it has several (``transformer.py:87-106``)."""
    d = cfg.d_model
    segments = []
    for seg in plan:
        lead = (seg.n,) if seg.n > 1 else ()
        p = {"ln1": norm_init(d, dt, dev, lead=lead, bias=cfg.use_bias)}
        if seg.mixer in ("gqa", "hybrid"):
            p["attn"] = gqa_init(cfg, gen, dt, dev, lead=lead)
        if seg.mixer == "mla":
            p["attn"] = mla_init(cfg, gen, dt, dev, lead=lead)
        if seg.mixer in ("ssm", "hybrid"):
            p["ssm"] = ssm_init(cfg, gen, dt, dev, lead=lead)
        if seg.cross:
            p["ln_cross"] = norm_init(d, dt, dev, lead=lead,
                                      bias=cfg.use_bias)
            p["cross"] = gqa_init(cfg, gen, dt, dev, lead=lead)
        if seg.mlp_kind == "dense":
            p["ln2"] = norm_init(d, dt, dev, lead=lead, bias=cfg.use_bias)
            p["mlp"] = mlp_init(gen, d, cfg.d_ff, dt, dev,
                                gated=cfg.gated_mlp, lead=lead,
                                bias=cfg.use_bias)
        if seg.mlp_kind == "moe":
            p["ln2"] = norm_init(d, dt, dev, lead=lead, bias=cfg.use_bias)
            p["mlp"] = moe_init(cfg, gen, dt, dev, lead=lead)
        segments.append(p)
    return segments
