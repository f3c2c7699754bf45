"""Port parity, model layer by model layer: ``repro_torch`` against the JAX
reference ``repro`` on the same inputs (made with numpy from a seed) and
the same weights (carried over by ``repro_torch.bridge``), on the CPU.

Tolerances: float32 functions that round nowhere agree to 1e-5 (only the
order of float32 sums differs). Attention rounds q, k, v and the softmax
probabilities to bfloat16 in both packages; a float32 difference of one ulp
upstream can flip one such rounding (2**-8 relative), so whole-layer and
whole-model outputs are held at 1e-2 in the worst element and at 1e-4 in
the median, which only the flips' rare outliers could not meet.
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
from repro.models import layers as jlayers

from repro_torch.bridge import from_numpy_tree, init_params, to_numpy_tree
from repro_torch.configs import ArchConfig, get_config, \
    reference_fields, smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import Model, layer_params

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _jax_cfg(**kw):
    return dataclasses.replace(jax_smoke_config("h2o-danube-1.8b"), **kw)


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _assert_bf16_rounding_close(got, want):
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= 1e-2, d.max()
    assert np.median(d) <= 1e-4, np.median(d)


# -- configs and the weight bridge -------------------------------------------

def test_config_fields_and_smoke_match_reference():
    from repro.configs import get_config as jget
    assert reference_fields(get_config("h2o-danube-1.8b")) == \
        dataclasses.asdict(jget("h2o-danube-1.8b"))
    assert reference_fields(smoke_config("h2o-danube-1.8b")) == \
        dataclasses.asdict(jax_smoke_config("h2o-danube-1.8b"))
    assert smoke_config("h2o-danube-1.8b").torch_dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    jcfg = _jax_cfg(dtype=dtype)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = from_numpy_tree(np_tree)
    # layouts kept as they are: dense (d_in, d_out), stacked layer axis
    seg = tparams["segments"][0]
    assert tuple(seg["attn"]["wq"]["w"].shape) == (2, 256, 4 * 64)
    assert seg["attn"]["wq"]["w"].dtype == _port_cfg(jcfg).torch_dtype
    back = to_numpy_tree(tparams)
    flat_a = jax.tree.leaves(np_tree)
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        if dtype == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_params_tree_matches_reference_shapes():
    jcfg = _jax_cfg()
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = init_params(_port_cfg(jcfg), seed=0, device="cpu")
    ja = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tb = jax.tree_util.tree_flatten_with_path(
        to_numpy_tree(tparams))[0]
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (_, a), (_, b) in zip(ja, tb):
        assert a.shape == b.shape
    # the reference's distributions: normal * 1/sqrt(d_in), 0.02 embedding
    w = tparams["segments"][0]["mlp"]["down"]["w"].float()
    assert abs(w.std().item() * np.sqrt(512) - 1.0) < 0.05
    assert abs(tparams["embed"]["table"].float().std().item() - 0.02) < 2e-3
    assert torch.equal(init_params(_port_cfg(jcfg), seed=0,
                                   device="cpu")["embed"]["table"],
                       tparams["embed"]["table"])


# -- layer functions -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dense_rms_norm_embed(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (x, w, b))
    tx, tw, tb = (_t(a).to(tdt) for a in (x, w, b))
    np.testing.assert_allclose(
        _np(tlayers.dense({"w": tw, "b": tb}, tx).float()),
        _np(jlayers.dense({"w": jw, "b": jb}, jx)), **tol)
    # normalise in f32, cast back, then scale in the model type
    np.testing.assert_allclose(
        _np(tlayers.rms_norm({"scale": _t(scale).to(tdt)}, tx, 1e-5).float()),
        _np(jlayers.rms_norm({"scale": jnp.asarray(scale, jdt)}, jx, 1e-5)),
        **tol)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    toks = rng.integers(0, 40, (2, 7))
    np.testing.assert_array_equal(
        _np(tlayers.embed({"table": _t(table)}, _t(toks))),
        _np(jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dh", [64, 80])
def test_apply_rope(batched, dh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 6)) if batched else np.arange(6) + 37
    got = tlayers.apply_rope(_t(x), _t(pos), 10_000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    # float32 sin/cos of angles up to ~5000 rad differ by a few ulps of
    # the angle between libraries
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(2)
    p = {"up": {"w": rng.standard_normal((16, 32)).astype(np.float32)},
         "down": {"w": rng.standard_normal((32, 16)).astype(np.float32)}}
    if gated:
        p["gate"] = {"w": rng.standard_normal((16, 32)).astype(np.float32)}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    got = tlayers.mlp(from_numpy_tree(p), _t(x))
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fp32", [False, True])
def test_unembed_masks_padded_vocab(fp32):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((512, 16)).astype(np.float32)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    got = tlayers.unembed({"table": _t(table)}, _t(x), 500, fp32=fp32)
    want = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                           500, fp32=fp32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert (got[..., 500:] == torch.finfo(torch.float32).min).all()
    np.testing.assert_array_equal(
        _np(tlayers.pad_last(_t(x), 20)), _np(jlayers.pad_last(
            jnp.asarray(x), 20)))


# -- attention -----------------------------------------------------------------

@pytest.mark.parametrize(
    "s,skv,h,hkv,dh,causal,window,q_offset",
    [
        (16, 16, 4, 4, 64, True, None, 0),    # MHA
        (24, 40, 8, 2, 80, True, None, 16),   # GQA chunk at an offset, dh 80
        (40, 40, 4, 1, 64, True, 8, 0),       # MQA sliding window
        (12, 20, 4, 2, 32, False, None, 0),   # non-causal (cross-attention)
        (9, 33, 4, 2, 64, True, 24, 24),      # window + offset, ragged
    ])
def test_blockwise_attention(s, skv, h, hkv, dh, causal, window, q_offset):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, dh)).astype(np.float32)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, q_offset=q_offset)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, q_offset=q_offset)
    # identical inputs: both round the same values to bf16, so only the
    # order of float32 sums differs
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.fixture(scope="module")
def danube_f32():
    jcfg = _jax_cfg(dtype="float32", logits_fp32=True)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    return jcfg, jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("window", [None, 8])
def test_gqa_layer_and_forward(danube_f32, window):
    jcfg, jparams, tparams = danube_f32
    tcfg = _port_cfg(jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.arange(20)
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0])
    tp = layer_params(tparams["segments"][0], 0)

    def jattend(q, k, v):
        return jattn.blockwise_attention(q, k, v, window=window), None

    def tattend(q, k, v):
        return tattn.blockwise_attention(q, k, v, window=window)

    want, _ = jattn.gqa_layer(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              jattend)
    got = tattn.gqa_layer(tcfg, tp, _t(x), _t(pos), tattend)
    _assert_bf16_rounding_close(got, want)

    want, (wk, wv) = jattn.gqa_forward(jcfg, jp["attn"], jnp.asarray(x),
                                       jnp.asarray(pos), window=window,
                                       return_kv=True)
    got, (gk, gv) = tattn.gqa_forward(tcfg, tp["attn"], _t(x), _t(pos),
                                      window=window, return_kv=True)
    _assert_bf16_rounding_close(got, want)
    np.testing.assert_allclose(_np(gk), _np(wk), **F32)
    np.testing.assert_allclose(_np(gv), _np(wv), **F32)


@pytest.mark.parametrize("window", [None, 64])
def test_model_forward_logits(danube_f32, window):
    """Whole-model teacher-forced logits, global and sliding window (the
    smoke window is 64; 100 tokens cross it)."""
    jcfg, jparams, tparams = danube_f32
    _check_forward(dataclasses.replace(jcfg, sliding_window=window), jparams,
                   tparams)


def test_model_forward_logits_head_dim_80():
    """A narrow danube with the full model's head_dim 80 (not a power of
    two) and 2 KV heads for 4 query heads."""
    jcfg = _jax_cfg(dtype="float32", logits_fp32=True, head_dim=80,
                    num_kv_heads=2, sliding_window=48)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(3))
    _check_forward(jcfg, jparams,
                   from_numpy_tree(jax.tree.map(np.asarray, jparams)))


def _check_forward(jcfg, jparams, tparams):
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 100))
    want, _ = JaxModel(jcfg, remat=False).forward(jparams, jnp.asarray(toks))
    got, aux = Model(_port_cfg(jcfg)).forward(tparams, _t(toks))
    assert got.shape == (2, 100, 512) and float(aux) == 0.0
    _assert_bf16_rounding_close(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
