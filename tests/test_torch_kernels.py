"""Paged-attention decode: the port's plain version against the JAX Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it) and the JAX
oracle ``ref.paged_attention_ref`` (the CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py``).

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 3e-2. The JAX oracle
returns NaN on a row with ``ctx_len = 0`` (softmax over nothing), so it is
compared on active rows only; the port, like the Pallas kernel, returns
zeros there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref

from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_attention

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _inputs(b, h, hkv, dh, ps, nper, dtype=np.float32, seed=0,
            lens=None):
    rng = np.random.default_rng(seed)
    npages = nper * b + 2
    q = rng.standard_normal((b, h, dh)).astype(dtype)
    kp = rng.standard_normal((npages, ps, hkv, dh)).astype(dtype)
    vp = rng.standard_normal((npages, ps, hkv, dh)).astype(dtype)
    bt = rng.integers(0, npages, (b, nper)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, nper * ps + 1, b)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 8, 24])
@pytest.mark.parametrize(
    "b,h,hkv,dh,ps,nper",
    [
        (1, 4, 4, 32, 8, 4),     # MHA
        (3, 8, 2, 64, 16, 8),    # GQA
        (2, 8, 1, 64, 16, 4),    # MQA
        (2, 4, 4, 80, 8, 6),     # danube head_dim 80
        (3, 32, 8, 80, 16, 5),   # danube's full head layout
    ])
def test_plain_matches_pallas_and_oracle(b, h, hkv, dh, ps, nper, window):
    q, kp, vp, bt, lens = _inputs(b, h, hkv, dh, ps, nper, seed=b * dh)
    got = tref.paged_attention(*_torch(q, kp, vp, bt, lens), page_size=ps,
                               window=window)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    pallas = ops.paged_attention(*jargs, page_size=ps, window=window)
    oracle = jref.paged_attention_ref(*jargs, page_size=ps, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_plain_bf16_matches_pallas():
    import ml_dtypes
    q, kp, vp, bt, lens = _inputs(2, 8, 2, 80, 8, 6, seed=7)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)] + \
        [jnp.asarray(bt), jnp.asarray(lens)]
    pallas = ops.paged_attention(*jargs, page_size=8)
    targs = [torch.from_numpy(np.asarray(a).view(np.int16).copy())
             .view(torch.bfloat16) for a in jargs[:3]] + _torch(bt, lens)
    assert np.asarray(jargs[0]).dtype == ml_dtypes.bfloat16
    got = tref.paged_attention(*targs, page_size=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **BF16)


def test_zero_length_rows_are_zero():
    q, kp, vp, bt, _ = _inputs(4, 8, 2, 80, 8, 3, seed=3)
    lens = np.array([0, 5, 0, 24], np.int32)
    out, m, l = tref.paged_attention(*_torch(q, kp, vp, bt, lens),
                                     page_size=8, return_partials=True)
    assert torch.isfinite(out).all()
    assert (out[[0, 2]] == 0).all() and (l[[0, 2]] == 0).all()
    assert (m[[0, 2]] == tref.NEG_INF).all()
    # the Pallas kernel agrees on every row, the JAX oracle on active ones
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    po, pm, pl = ops.paged_attention(*jargs, page_size=8,
                                     return_partials=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(po), **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(pl), **F32)
    np.testing.assert_allclose(m.numpy(), np.asarray(pm), rtol=2e-5)
    oracle = np.asarray(jref.paged_attention_ref(*jargs, page_size=8))
    assert np.isnan(oracle[[0, 2]]).all()
    np.testing.assert_allclose(out.numpy()[[1, 3]], oracle[[1, 3]], **F32)


def test_partials_merge_to_the_full_result():
    """(m, l) partials of two half caches merge to the full result: the
    DistAttention contract, as ``tests/test_kernels.py`` states it."""
    from repro.core.distkv.dist_attention import merge_partials_tree
    q, kp, vp, _, _ = _inputs(2, 4, 2, 32, 8, 4, seed=9)
    bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    lens = np.array([30, 32], np.int32)
    full = tref.paged_attention(*_torch(q, kp, vp, bt, lens), page_size=8)
    o1, m1, l1 = tref.paged_attention(
        *_torch(q, kp, vp, bt[:, :2], np.minimum(lens, 16)), page_size=8,
        return_partials=True)
    o2, m2, l2 = tref.paged_attention(
        *_torch(q, kp, vp, bt[:, 2:], np.maximum(lens - 16, 0)),
        page_size=8, return_partials=True)
    merged = merge_partials_tree(
        [jnp.asarray(o1 * l1[..., None]), jnp.asarray(o2 * l2[..., None])],
        [jnp.asarray(m1), jnp.asarray(m2)], [jnp.asarray(l1),
                                             jnp.asarray(l2)])
    np.testing.assert_allclose(np.asarray(merged), full.numpy(), rtol=1e-4,
                               atol=1e-4)
    # and the partials themselves match the Pallas kernel's
    _, pm, pl = ops.paged_attention(
        *[jnp.asarray(a) for a in (q, kp, vp, bt[:, :2],
                                   np.minimum(lens, 16))],
        page_size=8, return_partials=True)
    np.testing.assert_allclose(m1.numpy(), np.asarray(pm), **F32)
    np.testing.assert_allclose(l1.numpy(), np.asarray(pl), rtol=1e-4)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, kp, vp, bt, lens = _inputs(2, 8, 2, 64, 8, 3, seed=11)
    before = paged_attention.launches
    got = paged_attention(*_torch(q, kp, vp, bt, lens), page_size=8,
                          window=8)
    want = tref.paged_attention(*_torch(q, kp, vp, bt, lens), page_size=8,
                                window=8)
    assert torch.equal(got, want)
    assert paged_attention.launches == before  # nothing was launched


def test_wrapper_rejects_mixed_devices():
    q, kp, vp, bt, lens = _torch(*_inputs(1, 4, 2, 32, 8, 2))
    with pytest.raises(ValueError):
        paged_attention(q, kp.to("meta"), vp, bt, lens, page_size=8)


@pytest.mark.parametrize("n_parts,masked", [(1, None), (2, None), (3, 1),
                                            (4, 0), (2, "all")])
def test_merge_partials_matches_jax_tree(n_parts, masked):
    """The plain version of the decode kernel's split merge against the JAX
    ``merge_partials_tree`` on seeded partials, with an all-masked split
    (o = 0, m = -1e30, l = 0) among them, or every split masked; the
    merged (m, l) are the global max and the sum rescaled to it."""
    from repro.core.distkv.dist_attention import merge_partials_tree
    rng = np.random.default_rng(n_parts)
    b, h, dh = 3, 4, 16
    os_ = [rng.standard_normal((b, h, dh)).astype(np.float32)
           for _ in range(n_parts)]
    ms = [rng.standard_normal((b, h)).astype(np.float32) * 3
          for _ in range(n_parts)]
    ls = [rng.uniform(0.5, 20, (b, h)).astype(np.float32)
          for _ in range(n_parts)]
    for i in range(n_parts) if masked == "all" else \
            ([] if masked is None else [masked]):
        os_[i][:] = 0
        ms[i][:] = tref.NEG_INF
        ls[i][:] = 0
    o, m, l = tref.merge_partials(*(_torch(*x) for x in (os_, ms, ls)))
    want = merge_partials_tree([jnp.asarray(x) for x in os_],
                               [jnp.asarray(x) for x in ms],
                               [jnp.asarray(x) for x in ls])
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **F32)
    m_glob = np.max(np.stack(ms), axis=0)
    l_glob = sum(li * np.exp(mi - m_glob) for mi, li in zip(ms, ls))
    np.testing.assert_allclose(m.numpy(), m_glob, **F32)
    np.testing.assert_allclose(l.numpy(), l_glob, **F32)
    if masked == "all":
        assert (o == 0).all() and (l == 0).all()


@pytest.mark.parametrize("split_pages", [1, 2, 3])
@pytest.mark.parametrize("g", [1, 4])
def test_plain_split_by_page_runs_merges_to_unsplit(split_pages, g):
    """The decode kernel's scheme in plain PyTorch: each row's context cut
    into runs of ``split_pages`` whole pages, each run's partials from the
    plain paged attention, merged by ``merge_partials``, gives the unsplit
    result, (m, l) included. Rows end at, before and after a run's edge,
    one is empty (its runs are all masked)."""
    ps, nper, hkv, dh = 8, 6, 2, 32
    run = split_pages * ps
    lens = [run - 1, run, run + 1, nper * ps, 0]
    q, kp, vp, bt, lens = _inputs(len(lens), hkv * g, hkv, dh, ps, nper,
                                  seed=split_pages * 10 + g, lens=lens)
    full, fm, fl = tref.paged_attention(*_torch(q, kp, vp, bt, lens),
                                        page_size=ps, return_partials=True)
    os_, ms, ls = [], [], []
    for p0 in range(0, nper, split_pages):
        cols = bt[:, p0:p0 + split_pages]
        ctx = np.clip(lens - p0 * ps, 0, cols.shape[1] * ps).astype(np.int32)
        o, m, l = tref.paged_attention(*_torch(q, kp, vp, cols, ctx),
                                       page_size=ps, return_partials=True)
        os_.append(o * l[..., None])
        ms.append(m)
        ls.append(l)
    o, m, l = tref.merge_partials(os_, ms, ls)
    torch.testing.assert_close(o, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, fm, **F32)
    torch.testing.assert_close(l, fl, rtol=1e-5, atol=1e-5)
