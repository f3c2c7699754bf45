"""The encoder-decoder and media families on the port against the JAX
package, on the CPU: seamless-m4t-medium (a non-causal encoder whose first
positions are audio frame embeddings, decoder layers that attend over its
output) and internvl2-26b (patch embeddings in place of the decoder's first
positions), at smoke size (2 decoder layers, 2 encoder layers, 8 media
tokens), through ``Model.forward``, ``Model.prefill`` and
``Model.decode_step``; the cross-attention blocks on their own; and the
plain ``prefill_attention(causal=False)`` that the CUDA kernel is held
against on the card, over key counts other than the query count, and that
the card's limits on that comparison catch a key count off by one.

The same weights (a JAX ``Model.init`` tree, carried over by the bridge)
and the same inputs (numpy, from a seed) go through both packages in
float32 (``logits_fp32``). Tolerances are those of
``tests/test_torch_ring_cache.py``: logits 1e-3 of the largest |logit| in
the worst element and greedy tokens identical; cache leaves (K/V rings and
the encoder's K/V) 1e-2 of the leaf's largest magnitude in the worst
element and 1e-5 in the median (``blockwise_attention`` rounds q, k, v and
the probabilities to bfloat16 in both packages, so a one-ulp float32
difference upstream can flip a rounding, 2**-8 relative, that later layers
inherit); positions exactly. The plain prefill attention against JAX
``blockwise_attention`` as ``tests/test_torch_prefill_kernel.py`` holds
the causal form (float32 1e-2 worst / 1e-6 median, bfloat16 3e-2), and
against the Pallas kernel in interpret mode, which keeps float32
probabilities, at 3e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models.transformer import encoder_plan as jax_encoder_plan
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedEngine as JaxEngine

from repro_torch.bridge import from_numpy_tree, init_params, to_numpy_tree
from repro_torch.configs import ARCH_IDS, ArchConfig
from repro_torch.kernels import flash_prefill as tflash
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model, encoder_plan
from repro_torch.serving.engine import EngineConfig, PagedEngine

SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-26b"
ARCHS = [SEAMLESS, INTERNVL]
B, S, ENC, STEPS = 2, 24, 40, 8
CAPACITY = S + STEPS


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _leaves(tree):
    """Leaves of a cache tree in ``jax.tree.leaves`` order (lists, tuples
    and NamedTuples in order, dicts by sorted key)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
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


def _assert_caches(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        if np.asarray(b).dtype == np.int32:
            assert a.dtype == torch.int32, (what, i)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, 1e-2, 1e-5, f"{what} leaf {i}")


def _setup(arch, **updates):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               logits_fp32=True, **updates)
    jm = JaxModel(jcfg, remat=False)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    return jcfg, jm, jparams, Model(ArchConfig(**dataclasses.asdict(jcfg))), \
        tparams


def _inputs(cfg, seed):
    """Decoder tokens (B, S), media (B, M, D) (normal x 0.02, the
    embedding's scale) and, for an encoder-decoder model, encoder tokens
    (B, ENC), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    media = (rng.standard_normal((B, cfg.num_media_tokens, cfg.d_model))
             * 0.02).astype(np.float32)
    enc = rng.integers(0, cfg.vocab_size, (B, ENC)) if cfg.is_encdec \
        else None
    return toks, media, enc


def _kw(media, enc, to):
    kw = dict(media=to(media))
    if enc is not None:
        kw["encoder_tokens"] = to(enc)
    return kw


def _jnp(x):
    return jnp.asarray(x)


# -- configs, plans, weights --------------------------------------------------

def test_arch_ids_cover_the_reference():
    """Every arch of the reference is ported; the port also lists
    paper-opt-13b, whose module the reference has but does not list."""
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS) | {"paper-opt-13b"}
    assert len(ARCH_IDS) == len(set(ARCH_IDS))


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_empty_caches_match_reference(arch):
    """The decoder plan (cross segments for seamless), the encoder plan
    and ``init_cache(enc_len=)``'s leaves: a cross segment's
    ``{"self", "ck", "cv"}``, the layer axis first."""
    jcfg, jm, _, tm, _ = _setup(arch)

    def rows(plan):
        return [(s.n, s.mixer, s.mlp_kind, s.attn_kind, s.cross)
                for s in plan]

    assert rows(tm.plan) == rows(jm.plan)
    assert rows(tm.enc_plan) == rows(jm.enc_plan)
    if jcfg.is_encdec:
        assert rows(encoder_plan(tm.cfg)) == rows(jax_encoder_plan(jcfg)) \
            == [(2, "gqa", "dense", "global", False)]
        assert rows(tm.plan) == [(2, "gqa", "dense", "global", True)]
    got = tm.init_cache(B, CAPACITY, device="cpu", enc_len=ENC)
    want = jm.init_cache(B, CAPACITY, enc_len=ENC)
    _assert_caches(got, want, "init_cache")
    if jcfg.is_encdec:
        assert sorted(got[0]) == ["ck", "cv", "self"]
        assert got[0]["ck"].shape == (2, B, ENC, jcfg.num_kv_heads,
                                      jcfg.head_dim)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch, dtype):
    """``init_params`` gives the reference tree (the encoder's segments
    and final norm, each cross layer's ``ln_cross`` and ``cross``), with
    its shapes and dtypes; the bridge carries the JAX tree, encoder and
    all."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = init_params(ArchConfig(**dataclasses.asdict(jcfg)), seed=0,
                          device="cpu")
    ja = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tb = jax.tree_util.tree_flatten_with_path(to_numpy_tree(tparams))[0]
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        assert a.shape == b.shape, path
        assert a.dtype.itemsize == b.dtype.itemsize, path
    for leaf in jax.tree.leaves(tparams):
        assert leaf.dtype == getattr(torch, dtype)
    carried = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    tc = jax.tree_util.tree_flatten_with_path(to_numpy_tree(carried))[0]
    assert [p for p, _ in tc] == [p for p, _ in ja]
    for (_, a), (_, b) in zip(ja, tc):
        np.testing.assert_array_equal(np.asarray(a).view(b.dtype)
                                      if dtype == "bfloat16" else a, b)
    if jcfg.is_encdec:
        assert set(tparams["encoder"]) == {"segments", "final_norm"}
        assert {"ln_cross", "cross"} <= set(tparams["segments"][0])
        # the cross block's init: normal * 1 / sqrt(d) like any dense
        w = tparams["segments"][0]["cross"]["wq"]["w"].float()
        assert abs(float(w.std()) * jcfg.d_model ** 0.5 - 1) < 0.05


# -- the cross-attention blocks -----------------------------------------------

def test_cross_attention_blocks_match_reference():
    """``encode_kv``, ``gqa_forward(causal=False)`` (the encoder's
    self-attention), ``gqa_forward(causal=False, kv_override=)`` and
    ``gqa_decode(kv_override=)`` (the cross-attention of a decoder layer,
    prefill and decode) on smoke seamless's weights, against the JAX
    functions. ``gqa_decode`` with an override writes nothing and returns
    the cache it was given."""
    jcfg, _, jparams, tm, tparams = _setup(SEAMLESS)
    cfg = tm.cfg
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0]["cross"])
    tp = {k: {n: t[0] for n, t in v.items()}
          for k, v in tparams["segments"][0]["cross"].items()}
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)

    wk, wv = jattn.encode_kv(jcfg, jp, _jnp(enc))
    gk, gv = tattn.encode_kv(cfg, tp, _t(enc))
    _close(gk, wk, 1e-5, 1e-6, "encode_kv k")
    _close(gv, wv, 1e-5, 1e-6, "encode_kv v")

    want = jattn.gqa_forward(jcfg, jp, _jnp(x), _jnp(pos), causal=False)
    got = tattn.gqa_forward(cfg, tp, _t(x), _t(pos), causal=False)
    _close(got, want, 1e-2, 1e-5, "gqa_forward non-causal")

    want, (jk, jv) = jattn.gqa_forward(jcfg, jp, _jnp(x), _jnp(pos),
                                       causal=False, kv_override=(wk, wv),
                                       return_kv=True)
    got, (tk, tv) = tattn.gqa_forward(cfg, tp, _t(x), _t(pos), causal=False,
                                      kv_override=(gk, gv), return_kv=True)
    _close(got, want, 1e-2, 1e-5, "gqa_forward cross")
    assert tk is gk and tv is gv

    x1 = x[:, :1]
    step = np.full((B,), S, np.int32)
    want, _ = jattn.gqa_decode(jcfg, jp, _jnp(x1), None, _jnp(step),
                               kv_override=(wk, wv))
    sentinel = object()
    got, cache = tattn.gqa_decode(cfg, tp, _t(x1), sentinel, _t(step),
                                  kv_override=(gk, gv))
    _close(got, want, 1e-2, 1e-5, "gqa_decode cross")
    assert cache is sentinel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,skv,h,hkv,dh,qb,kb",
    [
        (2, 24, 40, 4, 4, 64, 8, 8),      # more keys than queries, MHA
        (2, 1, 16, 8, 2, 64, 1, 16),      # one query, GQA
        (1, 64, 64, 4, 1, 32, 32, 32),    # self-attention, MQA
        (2, 130, 100, 12, 2, 128, 130, 100),  # G 6, Dh 128, ragged
        (1, 40, 7, 4, 4, 80, 40, 7),      # fewer keys than a tile
    ])
def test_plain_prefill_attention_non_causal(b, s, skv, h, hkv, dh, qb, kb,
                                            dtype):
    """``ref.prefill_attention(causal=False)`` over Skv keys against JAX
    ``blockwise_attention(causal=False)`` and the Pallas ``flash_prefill``
    (interpret mode, ``causal=False``); the wrapper takes it on CPU tensors
    and counts no launch."""
    rng = np.random.default_rng(s * skv + dh)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
            for _ in range(2))
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tq, tk, tv = (_t(a).to(tt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jt) for a in (q, k, v))
    got = tref.prefill_attention(tq, tk, tv, causal=False)
    assert got.dtype == tt and got.shape == (b, s, h, dh)
    want = jattn.blockwise_attention(jq, jk, jv, causal=False)
    if dtype == "float32":
        d = np.abs(_np(got) - _np(want))
        assert d.max() <= 1e-2 and np.median(d) <= 1e-6, \
            (d.max(), np.median(d))
    else:
        np.testing.assert_allclose(_np(got.float()), _np(want), rtol=3e-2,
                                   atol=3e-2)
    pallas = ops.flash_prefill(jq, jk, jv, causal=False, q_block=qb,
                               kv_block=kb)
    np.testing.assert_allclose(_np(got.float()), _np(pallas), rtol=3e-2,
                               atol=3e-2)
    before = tflash.flash_prefill.launches
    same = tflash.prefill_attention(tq, tk, tv, causal=False)
    assert torch.equal(same, got)
    assert tflash.flash_prefill.launches == before


# the card's limits on prefill_attention(causal=False) against its plain
# version, of the largest |plain| value: (worst, median) by dtype
# (NC_TOL in tests/test_torch_cuda.py and chip_smoke.py)
NC_TOL = {torch.float32: (5e-3, 1e-6), torch.bfloat16: (1e-2, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", [(16, 16, 64), (12, 2, 128)])
@pytest.mark.parametrize("s,skv", [(1, 16), (1, 1000), (64, 1024),
                                   (130, 1000), (1000, 1000)])
def test_non_causal_limits_catch_a_key_count_off_by_one(s, skv, h, hkv, dh,
                                                        dtype):
    """NC_TOL has teeth: the plain non-causal attention over one key too
    few (the last dropped), one too many (the next sequence's first, as
    the kernel's pages would give it) or, where Skv is not a multiple of
    64, without the partial last tile breaks both the worst and the median
    limit against the right one, at the card's shapes."""
    rng = np.random.default_rng(s + skv + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in
        ((2, s, h, dh), (2, skv, hkv, dh), (2, skv, hkv, dh)))
    want = tref.prefill_attention(q, k, v, causal=False).float()
    faults = {"short": (k[:, :-1], v[:, :-1]),
              "long": (torch.cat([k, k.roll(-1, 0)[:, :1]], 1),
                       torch.cat([v, v.roll(-1, 0)[:, :1]], 1))}
    if skv % 64 and skv > 64:
        cut = skv // 64 * 64
        faults["no tail tile"] = (k[:, :cut], v[:, :cut])
    worst, median = NC_TOL[dtype]
    for name, (fk, fv) in faults.items():
        got = tref.prefill_attention(q, fk.contiguous(), fv.contiguous(),
                                     causal=False).float()
        d = (got - want).abs() / want.abs().max()
        assert d.max() > worst and d.median() > median, \
            (name, d.max().item(), d.median().item())


def test_prefill_attention_refuses_what_it_does_not_take():
    q = torch.zeros(2, 8, 4, 32)
    kv = torch.zeros(2, 5, 2, 32)
    with pytest.raises(ValueError, match="window"):
        tflash.prefill_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError, match="k and v"):  # causal needs Skv = S
        tflash.prefill_attention(q, kv, kv)
    with pytest.raises(ValueError, match="k and v"):  # another batch
        tflash.prefill_attention(q, kv[:1], kv[:1], causal=False)
    # no keys: zeros
    empty = torch.zeros(2, 0, 2, 32)
    assert not tflash.prefill_attention(q + 1, empty, empty,
                                        causal=False).any()


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Teacher-forced logits with media (and encoder tokens)."""
    jcfg, jm, jparams, tm, tparams = _setup(arch)
    toks, media, enc = _inputs(jcfg, 11)
    want, _ = jm.forward(jparams, _jnp(toks), **_kw(media, enc, _jnp))
    got, aux = tm.forward(tparams, _t(toks), **_kw(media, enc, _t))
    _close(got, want, 1e-3, 1e-3, "forward logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """The prefill (logits and every cache leaf, the encoder's K/V of
    each cross layer included), then 8 decode steps (logits, caches and
    greedy tokens), against the JAX ``Model``; the last step's logits also
    against ``Model.forward`` over prompt + fed tokens."""
    jcfg, jm, jparams, tm, tparams = _setup(arch)
    toks, media, enc = _inputs(jcfg, 7)
    jprefill = jax.jit(jm.prefill, static_argnames=("seq_capacity",))
    jdecode = jax.jit(jm.decode_step)
    wl, wc = jprefill(jparams, _jnp(toks), seq_capacity=CAPACITY,
                      **_kw(media, enc, _jnp))
    gl, gc = tm.prefill(tparams, _t(toks), seq_capacity=CAPACITY,
                        **_kw(media, enc, _t))
    _close(gl, wl, 1e-3, 1e-3, "prefill logits")
    _assert_caches(gc, wc, "prefill caches")
    if jcfg.is_encdec:
        assert gc[0]["ck"].shape == (jcfg.num_layers, B, ENC,
                                     jcfg.num_kv_heads, jcfg.head_dim)
    v = jcfg.vocab_size
    fed = []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(wl[:, :v], -1), np.int32)
        np.testing.assert_array_equal(gl[:, :v].argmax(-1).numpy(), tok)
        fed.append(tok)
        pos = np.full((B,), S + i, np.int32)
        wl, wc = jdecode(jparams, _jnp(tok[:, None]), _jnp(pos), wc)
        gl, gc = tm.decode_step(tparams, _t(tok[:, None]), _t(pos), gc)
        _close(gl, wl, 1e-3, 1e-3, f"step {i} logits")
        _assert_caches(gc, wc, f"step {i} caches")
    full, _ = tm.forward(tparams, _t(np.concatenate([toks, np.stack(
        fed, 1)], 1)), **_kw(media, enc, _t))
    _close(gl, full[:, -1], 1e-3, 1e-3, "last step vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_media_replace_the_tokens_under_them(arch):
    """Token ids under the media positions (the encoder's for seamless,
    the decoder's for internvl2) change neither package's logits; ids
    after them and the media themselves do."""
    jcfg, jm, jparams, tm, tparams = _setup(arch)
    toks, media, enc = _inputs(jcfg, 3)
    m = jcfg.num_media_tokens
    rng = np.random.default_rng(4)
    under = enc.copy() if jcfg.is_encdec else toks.copy()
    under[:, :m] = rng.integers(0, jcfg.vocab_size, (B, m))
    after = under.copy()
    after[:, m] = (after[:, m] + 1) % jcfg.vocab_size
    runs = {}
    for name, ids in [("base", None), ("under", under), ("after", after),
                      ("media", None)]:
        t, e = toks, enc
        if ids is not None:
            t, e = (toks, ids) if jcfg.is_encdec else (ids, enc)
        md = media * 2 if name == "media" else media
        w, _ = jm.forward(jparams, _jnp(t), **_kw(md, e, _jnp))
        g, _ = tm.forward(tparams, _t(t), **_kw(md, e, _t))
        runs[name] = (_np(w), _np(g))
    for i in range(2):
        np.testing.assert_array_equal(runs["under"][i], runs["base"][i])
        assert not np.array_equal(runs["after"][i], runs["base"][i])
        assert not np.array_equal(runs["media"][i], runs["base"][i])


def test_paged_engine_refuses_cross_attention():
    """The port's engine has no encoder or cross-attention and refuses
    seamless. The JAX engine checks only that the plan's mixers are
    uniform GQA or MLA (``repro/serving/engine.py:156-159``) and accepts
    it: it would serve the model as a decoder-only one, without its
    encoder, every token wrong. This refusal is a deliberate difference
    from the reference."""
    jcfg, _, jparams, _, tparams = _setup(SEAMLESS)
    ecfg = dict(num_pages=16, page_size=8, max_slots=2)
    JaxEngine(jcfg, jparams, JaxEngineConfig(**ecfg))  # accepted
    with pytest.raises(ValueError, match="cross-attention"):
        PagedEngine(ArchConfig(**dataclasses.asdict(jcfg)), tparams,
                    EngineConfig(**ecfg), device="cpu")


def test_launcher_refuses_seamless_on_the_paged_engine():
    """``--arch seamless-m4t-medium`` on the port's launcher fails loudly
    at the engine, naming the path that serves it."""
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="Model.prefill"):
        main(["--arch", SEAMLESS, "--reduced", "--device", "cpu",
              "--requests", "2"])
