"""``Model.init_cache`` / ``prefill`` / ``decode_step`` with ring-buffer
caches, the port against the JAX package, on the CPU, for every
decoder-only plan: smoke danube (a sliding window), paper-opt-13b (G 1,
biases, GELU MLP), llama4-scout (MoE on GQA), deepseek-v2 (MLA: the latent
ring), mamba2 (SSM) and hymba (hybrid: attention and SSM heads in every
layer), and hymba at 4 layers with ``global_attn_every=4`` (a stacked
window segment of 3) and 10 heads over 2 KV heads (G 5).

The same weights (a JAX ``Model.init`` tree, carried over by the bridge)
and the same tokens (numpy, from a seed) go through both packages in
float32 (``logits_fp32``). The prompts (96 tokens) pass the smoke window
(64) and are a multiple of the smoke ``ssm_chunk`` (32), so the window
rings are seeded from the prompt's last 64 positions and wrap during the 8
decode steps; each step feeds both packages the reference's greedy token.

Tolerances (ROADMAP §3, the levels recorded for these quantities):
- logits: 1e-3 of the largest |logit| in the worst element; greedy
  float32 tokens identical;
- cache leaves (K/V, latent, conv tails, SSM states): 1e-2 of the leaf's
  largest magnitude in the worst element and 1e-5 in the median:
  ``blockwise_attention`` rounds q, k, v and the probabilities to
  bfloat16 in both packages, so a one-ulp float32 difference upstream can
  flip a rounding (2**-8 relative), and every later layer inherits it;
- MLA, the level ROADMAP §3 records for MLA blocks, 1e-2 worst / 1e-4
  median, for the latent leaves and the logits alike (logits median 1e-3):
  MLA's low-rank chains leave 4-6e-7 relative float32 differences, which
  flip bf16 roundings of the decompressed prefill attention (layer 1's
  latent then differs by 1e-3 of its largest magnitude in a few
  elements), and each decode step attends over those keys (the first
  step's logits differ by 1.4e-3 worst, 2.1e-4 median; from identical
  caches the same step agrees to 1e-6);
- positions (int32, -1 where empty) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro.models import attention as jattn

from repro_torch.bridge import from_numpy_tree
from repro_torch.configs import ArchConfig, reference_fields
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model

B, S, CAPACITY, STEPS = 2, 96, 128, 8
HYMBA_G5 = dict(num_layers=4, global_attn_every=4, num_heads=10,
                num_kv_heads=2)
CASES = {
    "h2o-danube-1.8b": ("h2o-danube-1.8b", {}),
    "paper-opt-13b": ("paper-opt-13b", {}),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}),
    "deepseek-v2-236b": ("deepseek-v2-236b", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "hymba-1.5b": ("hymba-1.5b", {}),
    "hymba-1.5b-4L-G5": ("hymba-1.5b", HYMBA_G5),
}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _leaves(tree):
    """Leaves of a cache tree (lists, tuples and NamedTuples in order), as
    ``jax.tree.leaves`` orders them."""
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _close(got, want, worst, median, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want) / scale
    assert d.max() <= worst and np.median(d) <= median, \
        (what, float(d.max()), float(np.median(d)))


def _assert_logits(got, want, mla: bool, what):
    if mla:
        _close(got, want, 1e-2, 1e-3, what)
    else:
        _close(got, want, 1e-3, 1e-3, what)


def _assert_caches(got, want, mla: bool, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        if np.asarray(b).dtype == np.int32:
            assert a.dtype == torch.int32, (what, i)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, 1e-2, 1e-4 if mla else 1e-5, f"{what} leaf {i}")


def _setup(case):
    arch, updates = CASES[case]
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True, **updates)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return jcfg, jm, jparams, Model(ArchConfig(**dataclasses.asdict(jcfg))), \
        tparams


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """Empty caches, then the prefill (logits and every cache leaf), then
    8 decode steps (logits, caches and greedy tokens), against the JAX
    ``Model``."""
    jcfg, jm, jparams, tm, tparams = _setup(case)
    mla = jcfg.attention == "mla"
    assert [(s.n, s.mixer, s.mlp_kind, s.attn_kind) for s in tm.plan] == \
        [(s.n, s.mixer, s.mlp_kind, s.attn_kind) for s in jm.plan]
    _assert_caches(tm.init_cache(B, CAPACITY, device="cpu"),
                   jm.init_cache(B, CAPACITY), mla, "init_cache")

    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, S))
    jprefill = jax.jit(jm.prefill, static_argnames=("seq_capacity",))
    jdecode = jax.jit(jm.decode_step)
    wl, wc = jprefill(jparams, jnp.asarray(toks), seq_capacity=CAPACITY)
    gl, gc = tm.prefill(tparams, _t(toks), seq_capacity=CAPACITY)
    _assert_logits(gl, wl, mla, "prefill logits")
    _assert_caches(gc, wc, mla, "prefill caches")
    v = jcfg.vocab_size
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(wl[:, :v], -1), np.int32)
        np.testing.assert_array_equal(gl[:, :v].argmax(-1).numpy(), tok)
        pos = np.full((B,), S + i, np.int32)
        wl, wc = jdecode(jparams, jnp.asarray(tok[:, None]),
                         jnp.asarray(pos), wc)
        gl, gc = tm.decode_step(tparams, _t(tok[:, None]), _t(pos), gc)
        _assert_logits(gl, wl, mla, f"step {i} logits")
        _assert_caches(gc, wc, mla, f"step {i} caches")


@pytest.mark.parametrize("case", ["h2o-danube-1.8b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "hymba-1.5b-4L-G5"])
def test_prefill_ragged_last_idx_and_raw_kv(case):
    """``last_idx`` picks each row's own last position; ``return_raw_kv``
    returns the per-segment seeds of the whole prompt (the reference's
    tree: (k, v), (ckv, krope), SSMCache or ((k, v), SSMCache))."""
    jcfg, jm, jparams, tm, tparams = _setup(case)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, S))
    last = np.array([S - 1, S - 30], np.int32)
    wl, wseeds = jm.prefill(jparams, jnp.asarray(toks), seq_capacity=CAPACITY,
                            last_idx=jnp.asarray(last), return_raw_kv=True)
    gl, gseeds = tm.prefill(tparams, _t(toks), seq_capacity=CAPACITY,
                            last_idx=_t(last).long(), return_raw_kv=True)
    _assert_logits(gl, wl, jcfg.attention == "mla", "ragged logits")
    assert len(gseeds) == len(wseeds) == len(tm.plan)
    _assert_caches(gseeds, wseeds, jcfg.attention == "mla", "raw seeds")


def test_mla_prefill_cache_matches_reference():
    """``mla_prefill_cache``: the layer's latent for a prompt, padded to
    the capacity with position -1."""
    jcfg, _, jparams, tm, tparams = _setup("deepseek-v2-236b")
    x = np.random.default_rng(9).standard_normal(
        (B, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(40)
    # the MoE layer: a one-layer segment, stored without a layer axis
    want = jattn.mla_prefill_cache(jcfg, jparams["segments"][1]["attn"],
                                   jnp.asarray(x), jnp.asarray(pos), 64)
    got = tattn.mla_prefill_cache(tm.cfg, tparams["segments"][1]["attn"],
                                  _t(x), _t(pos), 64)
    assert isinstance(got, tattn.MLACache)
    _assert_caches(got, want, True, "mla_prefill_cache")
    assert (got.pos[:, 40:] == -1).all() and not got.ckv[:, 40:].any()


def test_hybrid_plan_cache_layout():
    """Full-width hymba: the reference's plan ``[1 global, 15 swa] x 2``,
    and ring capacities of the window in window segments and of the
    sequence in global ones (cache shapes from the config alone: no
    weights)."""
    from repro_torch.configs import get_config
    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import stack_plan as jax_stack_plan
    from repro_torch.models.transformer import segment_cache_capacity, \
        stack_plan

    cfg = get_config("hymba-1.5b")
    assert reference_fields(cfg) == \
        dataclasses.asdict(jax_get_config("hymba-1.5b"))
    plan = [(s.n, s.mixer, s.mlp_kind, s.attn_kind) for s in stack_plan(cfg)]
    assert plan == [(s.n, s.mixer, s.mlp_kind, s.attn_kind)
                    for s in jax_stack_plan(jax_get_config("hymba-1.5b"))]
    assert plan == [(1, "hybrid", "dense", "global"),
                    (15, "hybrid", "dense", "swa")] * 2
    assert [segment_cache_capacity(cfg, s, 2080) for s in stack_plan(cfg)] \
        == [2080, 1024] * 2
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_d_inner) == \
        (64, 50, 3200)
