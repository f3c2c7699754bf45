"""Prefill attention: the port's plain versions of ``flash_prefill`` against
the JAX Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and the JAX oracle ``ref.flash_prefill_ref``, and the engine form
(paged K/V, chunk offset) against the JAX ``blockwise_attention`` on the
gathered pages. The CUDA kernel is held against these plain versions on
the card by ``tests/test_torch_cuda.py``.

Inputs are made with numpy from a seed. Tolerances: ``flash_prefill`` at
``tests/test_kernels.py``'s, float32 2e-5 and bfloat16 3e-2. The engine
form rounds q, k, v and the probabilities to bfloat16 in both packages
from identical inputs, so only the order of float32 sums differs; but a
one-ulp difference in a probability can flip its bfloat16 rounding (2**-8
relative), which at danube's widths happens to a few of every thousand
outputs. So in float32 it is held at 1e-2 in the worst element and 1e-6
in the median; in bfloat16 at 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro.models import attention as jattn

from repro_torch.kernels import flash_prefill as tflash
from repro_torch.kernels import ref as tref

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _np(x):
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), \
            torch.from_numpy(a.copy()).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,hkv,dh,qb,kb,causal,window",
    [
        (1, 128, 4, 4, 64, 64, 64, True, None),
        (2, 256, 8, 2, 64, 128, 128, True, None),
        (2, 256, 8, 2, 64, 128, 64, True, 64),
        (1, 128, 4, 1, 32, 32, 32, False, None),
        (2, 192, 6, 2, 80, 64, 64, True, None),  # non-pow2 heads/dh
        # the shapes the card holds the CUDA kernel to (``s`` as (S, Skv)
        # where the two differ): G 5, 6 and 48, Dh 128, non-causal over
        # Skv != S, and causal Skv < S with a window, where queries 79..127
        # see no key and return zeros
        pytest.param(1, 128, 10, 2, 64, 64, 64, True, 32, id="g5"),
        pytest.param(1, 64, 6, 1, 128, 64, 64, True, None, id="g6-dh128"),
        pytest.param(1, 64, 48, 1, 128, 32, 32, True, None, id="g48-dh128"),
        pytest.param(2, (64, 96), 4, 2, 64, 64, 32, False, None,
                     id="noncausal-skv96"),
        pytest.param(1, (128, 64), 4, 2, 64, 64, 64, True, 16,
                     id="causal-skv64-window16"),
    ])
def test_plain_flash_prefill_matches_pallas_and_oracle(b, s, h, hkv, dh, qb,
                                                       kb, causal, window,
                                                       dtype):
    s, skv = s if isinstance(s, tuple) else (s, s)
    rng = np.random.default_rng(b * s + dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, s, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    got = tref.flash_prefill(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = ops.flash_prefill(jq, jk, jv, causal=causal, window=window,
                               q_block=qb, kv_block=kb)
    oracle = jref.flash_prefill_ref(jq, jk, jv, causal=causal, window=window)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got.float()), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got.float()), _np(oracle), **tol)
    if causal and window and skv < s:  # queries past skv - 1 + window
        assert (got[:, skv - 1 + window:] == 0).all()
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch
    before = tflash.flash_prefill.launches
    same = tflash.flash_prefill(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(same, got)
    assert tflash.flash_prefill.launches == before


def test_plain_flash_prefill_fully_masked_rows_are_zero():
    """Non-causal with a window of 4 over 8 keys: queries 12..15 see no
    key. The Pallas kernel and the port return zeros there (the JAX oracle
    maps its NaNs to zeros)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, 16, 2, 32), (1, 8, 2, 32), (1, 8, 2, 32)))
    got = tref.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=False, window=4)
    assert (got[0, 12:] == 0).all()
    for want in (ops.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, window=4,
                                   q_block=16, kv_block=8),
                 jref.flash_prefill_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False,
                                        window=4)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "s,q_offset,h,hkv,dh,ps,window",
    [
        (24, 0, 4, 4, 64, 8, None),      # first chunk, MHA
        (24, 40, 8, 2, 80, 8, None),     # a later chunk, GQA, dh 80
        (17, 37, 32, 8, 80, 16, None),   # danube's head layout, unaligned
        (30, 50, 4, 1, 64, 16, 24),      # MQA, sliding window
        (1, 63, 8, 2, 64, 8, 16),        # a one-token chunk
    ])
def test_plain_prefill_attention_paged_matches_blockwise(s, q_offset, h, hkv,
                                                         dh, ps, window,
                                                         dtype):
    """The engine form: K/V of context positions [0, q_offset + s) in
    pages of a pool, in random page order, plus one stale page past the
    context; the JAX reference is ``blockwise_attention`` on the same pages
    gathered in order, with the chunk's offset."""
    rng = np.random.default_rng(s + q_offset + h)
    n = -(-(q_offset + s) // ps) + 1
    npages = n + 3
    q = rng.standard_normal((1, s, h, dh)).astype(np.float32)
    kp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    pages = rng.permutation(npages)[:n].astype(np.int32)
    (jq, tq), (jkp, tkp), (jvp, tvp) = (_pair(a, dtype) for a in (q, kp, vp))
    got = tref.prefill_attention_paged(tq, tkp, tvp, torch.from_numpy(pages),
                                       q_offset=q_offset, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kall = jkp[pages].reshape(1, n * ps, hkv, dh)
    vall = jvp[pages].reshape(1, n * ps, hkv, dh)
    want = jattn.blockwise_attention(jq, kall, vall, causal=True,
                                     window=window, q_offset=q_offset)
    if dtype == "float32":
        d = np.abs(_np(got) - _np(want))
        assert d.max() <= 1e-2 and np.median(d) <= 1e-6, \
            (d.max(), np.median(d))
    else:
        np.testing.assert_allclose(_np(got.float()), _np(want), **BF16)
    before = tflash.flash_prefill.launches
    same = tflash.prefill_attention_paged(
        tq, tkp, tvp, torch.from_numpy(pages), q_offset=q_offset,
        window=window)
    assert torch.equal(same, got)
    assert tflash.flash_prefill.launches == before


def test_wrappers_refuse_mixed_devices_and_bad_windows():
    q = torch.zeros(1, 4, 2, 8)
    kp = torch.zeros(2, 4, 2, 8)
    pages = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_prefill(q, q, q, window=0)
    with pytest.raises(ValueError, match="window"):
        tflash.prefill_attention_paged(q, kp, kp, pages, q_offset=0,
                                       window=0)
    with pytest.raises(ValueError, match="meta"):
        tflash.prefill_attention_paged(q, kp, kp, pages.to("meta"),
                                       q_offset=0)
