"""Mamba2 (SSD) in the port against the JAX reference, on the CPU: the
plain ``ssd_scan`` against the Pallas kernel (interpret mode), the XLA
``ssd_chunked`` and the sequential oracle; the block (``ssm_forward`` /
``ssm_decode``); and the smoke mamba2 model's forward, prefill and decode
steps. Weights are the JAX ``Model.init`` tree carried over by the bridge;
inputs are made with numpy from a seed. The CUDA kernel is held against
the plain ``ssd_scan`` on the card by ``tests/test_torch_cuda.py``.

Tolerances: the scans, 2e-4 (``tests/test_kernels.py``'s for the Pallas
kernel against the sequential oracle); float32 blocks and models, which
differ only in the order of float32 sums (exp, softplus and rsqrt by a
few ulps), 1e-4, and the same for the port's own prefill + decode against
its teacher-forced forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops, ref as jref
from repro.models import Model as JaxModel
from repro.models import ssm as jssm

from repro_torch.bridge import from_numpy_tree, init_params, to_numpy_tree
from repro_torch.configs import ArchConfig, get_config, \
    reference_fields, smoke_config
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import Model, layer_params

SCAN = dict(rtol=2e-4, atol=2e-4)
F32 = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _scan_inputs(b, l, h, p, g, n, seed):
    """The reference test's distributions: x, B, C normal; dt softplus of
    a normal; A = -exp(normal / 2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


# -- configs ------------------------------------------------------------------

def test_mamba2_config_and_smoke_match_reference():
    full, smoke = get_config("mamba2-1.3b"), smoke_config("mamba2-1.3b")
    jfull, jsmoke = jax_get_config("mamba2-1.3b"), \
        jax_smoke_config("mamba2-1.3b")
    assert reference_fields(full) == dataclasses.asdict(jfull)
    assert reference_fields(smoke) == dataclasses.asdict(jsmoke)
    assert (smoke.ssm_state, smoke.ssm_head_dim, smoke.ssm_chunk) == \
        (16, 32, 32)
    for ours, theirs in ((full, jfull), (smoke, jsmoke)):
        assert ours.ssm_heads == theirs.ssm_heads
        assert ours.ssm_d_inner == theirs.ssm_d_inner
    assert (full.ssm_heads, full.ssm_d_inner) == (64, 4096)


# -- the scan ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_ssd_scan_matches_pallas_chunked_and_sequential(chunk, g):
    x, dt, A, B, C = _scan_inputs(2, 128, 4, 16, g, 8, seed=chunk + g)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    targs = [_t(a) for a in (x, dt, A, B, C)]
    y, st = tref.ssd_scan(*targs, chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (2, 4, 16, 8)
    for wy, ws in (ops.ssd_scan(*jargs, chunk=chunk),
                   jssm.ssd_chunked(*jargs, chunk),
                   jref.ssd_scan_ref(*jargs)):
        np.testing.assert_allclose(_np(y), _np(wy), **SCAN)
        np.testing.assert_allclose(_np(st), _np(ws), **SCAN)
    # the port's own sequential oracle is the reference's
    ry, rs = tref.ssd_scan_ref(*targs)
    wy, ws = jref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(_np(ry), _np(wy), **SCAN)
    np.testing.assert_allclose(_np(rs), _np(ws), **SCAN)
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch
    before = tssd.ssd_scan.launches
    gy, gs = tssd.ssd_scan(*targs, chunk=chunk)
    assert torch.equal(gy, y) and torch.equal(gs, st)
    assert tssd.ssd_scan.launches == before


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_ssd_scan_carries_state_across_many_chunks(chunk, g):
    """mamba2's widths (p 64, n 128) over 16-32 chunks of one 1024-token
    sequence: the chunk-to-chunk state that the CUDA kernel chains from
    block to block, against the Pallas kernel, ``ssd_chunked`` and the
    sequential oracle."""
    x, dt, A, B, C = _scan_inputs(1, 1024, 2, 64, g, 128, seed=chunk + g)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y, st = tref.ssd_scan(*(_t(a) for a in (x, dt, A, B, C)), chunk=chunk)
    assert tuple(st.shape) == (1, 2, 64, 128)
    for wy, ws in (ops.ssd_scan(*jargs, chunk=chunk),
                   jssm.ssd_chunked(*jargs, chunk),
                   jref.ssd_scan_ref(*jargs)):
        np.testing.assert_allclose(_np(y), _np(wy), **SCAN)
        np.testing.assert_allclose(_np(st), _np(ws), **SCAN)


def test_plain_ssd_scan_bf16_inputs():
    """bfloat16 x, B, C are upcast: the same result as float32 inputs of
    the rounded values, as the Pallas kernel computes it."""
    x, dt, A, B, C = _scan_inputs(1, 64, 2, 16, 1, 8, seed=3)
    tb = [_t(a).to(torch.bfloat16) for a in (x, B, C)]
    y, st = tref.ssd_scan(tb[0], _t(dt), _t(A), tb[1], tb[2], chunk=32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, B, C)]
    wy, ws = ops.ssd_scan(jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1],
                          jb[2], chunk=32)
    np.testing.assert_allclose(_np(y), _np(wy), **SCAN)
    np.testing.assert_allclose(_np(st), _np(ws), **SCAN)


def test_ssd_scan_raises_on_a_ragged_sequence():
    """The training scan (``ssd_chunked``, the reference's) still raises
    on a sequence that is no multiple of its chunk; the serving scans
    (the kernel's wrapper and its plain version) take it since the short
    last chunk was ported, and give the sequential recurrence's result to
    float32 rounding."""
    x, dt, A, B, C = (_t(a) for a in _scan_inputs(1, 48, 2, 8, 1, 4, 0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tssm.ssd_chunked(x, dt, A, B, C, chunk=32)
    yr, sr = tref.ssd_scan_ref(x, dt, A, B, C)
    for scan in (tssd.ssd_scan, tref.ssd_scan):
        y, st = scan(x, dt, A, B, C, chunk=32)
        np.testing.assert_allclose(_np(y), _np(yr), **SCAN)
        np.testing.assert_allclose(_np(st), _np(sr), **SCAN)


# -- the Mamba2 block ------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_f32():
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-1.3b"),
                               dtype="float32", logits_fp32=True)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg)), jparams, \
        from_numpy_tree(jax.tree.map(np.asarray, jparams))


def test_ssm_forward_and_decode_match_reference(mamba_f32):
    jcfg, tcfg, jparams, tparams = mamba_f32
    jp = jax.tree.map(lambda a: a[1], jparams["segments"][0])["ssm"]
    tp = layer_params(tparams["segments"][0], 1)["ssm"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    want, wc = jssm.ssm_forward(jcfg, jp, jnp.asarray(x), return_cache=True)
    got, gc = tssm.ssm_forward(tcfg, tp, _t(x), return_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gc.state), _np(wc.state), **F32)
    np.testing.assert_allclose(_np(gc.conv), _np(wc.conv), **F32)
    assert torch.equal(tssm.ssm_forward(tcfg, tp, _t(x)), got)
    # three decode steps from the prefill cache
    for i in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, wc = jssm.ssm_decode(jcfg, jp, jnp.asarray(xt), wc)
        got, gc = tssm.ssm_decode(tcfg, tp, _t(xt), gc)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(gc.state), _np(wc.state), **F32)
        np.testing.assert_allclose(_np(gc.conv), _np(wc.conv), **F32)


def test_ssm_forward_short_sequence_pads_the_conv_tail(mamba_f32):
    """A 2-token prompt (shorter than the conv window) and a chunk of 2."""
    jcfg, tcfg, jparams, tparams = mamba_f32
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0])["ssm"]
    tp = layer_params(tparams["segments"][0], 0)["ssm"]
    x = np.random.default_rng(2).standard_normal(
        (1, 2, jcfg.d_model)).astype(np.float32)
    want, wc = jssm.ssm_forward(jcfg, jp, jnp.asarray(x), return_cache=True)
    got, gc = tssm.ssm_forward(tcfg, tp, _t(x), return_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gc.conv), _np(wc.conv), **F32)
    assert gc.conv.shape == (1, jcfg.ssm_conv_width - 1,
                             tssm.conv_dim(tcfg))


def test_packed_chunks_continue_each_sequence(mamba_f32):
    """``ssm_forward_packed`` (the paged engine's prefill: several
    sequences' chunks on one token axis, each from its own carried conv
    window and state, or from zeros) gives each sequence what
    ``ssm_forward`` gives it whole: sequences of 70, 2 and 45 tokens cut
    at 33, 1 and 20 into two packed calls (ragged scan chunks, and chunks
    shorter than the conv window), held at the file's float32 tolerance
    (the scans' chunks fall elsewhere, so the sums round otherwise)."""
    _, tcfg, _, tparams = mamba_f32
    tp = layer_params(tparams["segments"][0], 0)["ssm"]
    rng = np.random.default_rng(5)
    seqs = [_t(rng.standard_normal((1, n, tcfg.d_model)).astype(np.float32))
            for n in (70, 2, 45)]
    cuts = [(0, 33, 70), (0, 1, 2), (0, 20, 45)]
    caches, outs = [None] * 3, [[] for _ in seqs]
    for piece in (0, 1):
        xs = [s[:, c[piece]:c[piece + 1]] for s, c in zip(seqs, cuts)]
        out, caches = tssm.ssm_forward_packed(
            tcfg, tp, torch.cat(xs, dim=1), [x.shape[1] for x in xs], caches)
        assert out.shape == (1, sum(x.shape[1] for x in xs), tcfg.d_model)
        o = 0
        for i, x in enumerate(xs):
            outs[i].append(out[:, o:o + x.shape[1]])
            o += x.shape[1]
    for i, s in enumerate(seqs):
        want, wc = tssm.ssm_forward(tcfg, tp, s, return_cache=True)
        np.testing.assert_allclose(_np(torch.cat(outs[i], dim=1)),
                                   _np(want), **F32)
        np.testing.assert_allclose(_np(caches[i].state), _np(wc.state),
                                   **F32)
        assert torch.equal(caches[i].conv, wc.conv)


# -- the model ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_logits(dtype):
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-1.3b"), dtype=dtype,
                               logits_fp32=True)
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(1))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 64))
    want, _ = JaxModel(jcfg, remat=False).forward(jparams, jnp.asarray(toks))
    got, aux = Model(ArchConfig(**dataclasses.asdict(jcfg))).forward(
        tparams, _t(toks))
    assert got.shape == (2, 64, 512) and float(aux) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    else:
        # bf16 activations round after every op in both packages, in
        # places that differ (XLA fuses, PyTorch does not): held at the
        # reference's own prefill-vs-forward tolerance
        # (tests/test_arch_smoke.py)
        np.testing.assert_allclose(_np(got), _np(want), atol=0.08,
                                   rtol=0.08)


def test_model_prefill_and_decode_match_reference(mamba_f32):
    jcfg, tcfg, jparams, tparams = mamba_f32
    jm, tm = JaxModel(jcfg, remat=False), Model(tcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 64))
    wl, wc = jm.prefill(jparams, jnp.asarray(toks), seq_capacity=96)
    gl, gc = tm.prefill(tparams, _t(toks), seq_capacity=96)
    np.testing.assert_allclose(_np(gl), _np(wl), **F32)
    assert len(gc) == len(wc) == 1
    np.testing.assert_allclose(_np(gc[0].state), _np(wc[0].state), **F32)
    np.testing.assert_allclose(_np(gc[0].conv), _np(wc[0].conv), **F32)
    for i in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        pos = np.full((2,), 64 + i, np.int32)
        wl, wc = jm.decode_step(jparams, jnp.asarray(nxt), jnp.asarray(pos),
                                wc)
        gl, gc = tm.decode_step(tparams, _t(nxt), _t(pos), gc)
        np.testing.assert_allclose(_np(gl), _np(wl), **F32)
        np.testing.assert_allclose(_np(gc[0].state), _np(wc[0].state),
                                   **F32)
    # empty caches: the reference's shapes and types
    jempty = jm.init_cache(2, 96)
    tempty = tm.init_cache(2, 96, device="cpu")
    for a, b in ((jempty[0].conv, tempty[0].conv),
                 (jempty[0].state, tempty[0].state)):
        assert tuple(b.shape) == a.shape and not b.any()
    assert tempty[0].state.dtype == torch.float32


def test_prefill_decode_matches_teacher_forcing(mamba_f32):
    """As tests/test_arch_smoke.py checks the reference: the prefill's last
    logits equal the forward's, a decode step after it equals the forward
    on the extended sequence, and stepping decode from empty caches over
    the whole prompt reaches the prefill's caches."""
    _, tcfg, _, tparams = mamba_f32
    model = Model(tcfg)
    rng = np.random.default_rng(5)
    toks = _t(rng.integers(0, tcfg.vocab_size, (2, 32)))
    nxt = _t(rng.integers(0, tcfg.vocab_size, (2, 1)))
    # padded to 64 tokens, a multiple of the chunk, as the reference test
    # pads; causal, so the padding changes no earlier position
    full, _ = model.forward(tparams, torch.cat(
        [toks, nxt, torch.zeros(2, 31, dtype=toks.dtype)], 1))
    last, caches = model.prefill(tparams, toks, seq_capacity=64)
    np.testing.assert_allclose(_np(last), _np(full[:, 31]), **F32)
    got, _ = model.decode_step(tparams, nxt, torch.full((2,), 32), caches)
    np.testing.assert_allclose(_np(got), _np(full[:, 32]), **F32)
    steps = model.init_cache(2, 64, device="cpu")
    for t in range(32):
        lg, steps = model.decode_step(tparams, toks[:, t:t + 1],
                                      torch.full((2,), t), steps)
    np.testing.assert_allclose(_np(lg), _np(last), **F32)
    np.testing.assert_allclose(_np(steps[0].state), _np(caches[0].state),
                               **F32)
    np.testing.assert_allclose(_np(steps[0].conv), _np(caches[0].conv),
                               **F32)


def test_init_params_tree_matches_reference():
    jcfg = jax_smoke_config("mamba2-1.3b")
    jparams = JaxModel(jcfg, remat=False).init(jax.random.PRNGKey(0))
    tparams = init_params(ArchConfig(**dataclasses.asdict(jcfg)), seed=0,
                          device="cpu")
    ja = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tb = jax.tree_util.tree_flatten_with_path(to_numpy_tree(tparams))[0]
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (_, a), (_, b) in zip(ja, tb):
        assert a.shape == b.shape
        assert b.dtype == (np.uint16 if a.dtype == jnp.bfloat16 else a.dtype)
    p = tparams["segments"][0]["ssm"]
    np.testing.assert_allclose(  # log(1..H): linspace differs by an ulp
        _np(p["A_log"]), _np(jparams["segments"][0]["ssm"]["A_log"]),
        rtol=1e-6, atol=1e-6)
    assert abs(p["conv_w"].float().std().item() - 0.2) < 0.01
    assert not p["conv_b"].any() and not p["dt_bias"].any()
    assert (p["D"] == 1).all() and (p["norm_scale"] == 1).all()


def test_init_cache_runs_on_the_card_unless_asked(monkeypatch):
    """Like the other entry points, ``Model.init_cache`` defaults to the
    GPU and raises without one instead of falling back to the CPU."""
    model = Model(smoke_config("mamba2-1.3b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 32)
    assert model.init_cache(1, 32, device="cpu")[0].conv.device.type == \
        "cpu"


def test_paged_engine_refuses_an_ssm_model():
    """The paged engine serves GQA stacks; mamba2's decode cache is a
    constant-size state, served by Model.prefill / decode_step."""
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    cfg = smoke_config("mamba2-1.3b")
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="GQA stacks only"):
        PagedEngine(cfg, params, EngineConfig(num_pages=8, page_size=8),
                    device="cpu")
