"""The port's CUDA kernels (paged_attention, flash_prefill, ssd_scan)
against their plain PyTorch versions, on the card. Every test here needs a
CUDA device and skips without one (a kernel has no CPU mode). This file
imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 3e-2; the float32
partials m to 2e-5 and l (a sum of up to a few hundred terms) to 1e-4.
The engine form of flash_prefill rounds its probabilities to bfloat16, so
a one-ulp float32 difference in a score can flip a rounding (2**-8
relative): it is held at 3e-2 in float32 too. ssd_scan returns float32
from the same upcast inputs in both versions, in another order of sums:
2e-4, as ``tests/test_kernels.py`` holds the Pallas kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               prefill_attention_paged)
from repro_torch.kernels.paged_attention import SPLIT_TOKENS, paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
# a bf16 result of float32 math against the plain version's: at most one
# bf16 rounding apart (2**-7 of the value) plus the float32 difference
BF16_OUT = dict(rtol=2.0 ** -7, atol=1e-5)


def _inputs(b, h, hkv, dh, ps, nper, seed=0):
    rng = np.random.default_rng(seed)
    npages = nper * b + 2
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    bt = rng.integers(0, npages, (b, nper)).astype(np.int32)
    lens = rng.integers(1, nper * ps + 1, b).astype(np.int32)
    return q, kp, vp, bt, lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize(
    "b,h,hkv,dh,ps,nper",
    [(3, 8, 2, 64, 16, 8), (2, 8, 1, 64, 16, 4), (4, 32, 8, 80, 16, 9),
     (2, 4, 4, 80, 8, 6),
     # the widest rows a TMA box takes, then rows staged element by element
     (2, 8, 2, 240, 16, 3), (2, 8, 2, 256, 16, 3)])
def test_cuda_kernel_matches_plain(cuda, b, h, hkv, dh, ps, nper, window,
                                   dtype):
    q, kp, vp, bt, lens = _inputs(b, h, hkv, dh, ps, nper, seed=5)
    lens[0] = 0
    args = [t.to(cuda) for t in _torch(q, kp, vp, bt, lens)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    before = paged_attention.launches
    out, m, l = paged_attention(*args, page_size=ps, window=window,
                                return_partials=True)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    wo, wm, wl = tref.paged_attention(*args, page_size=ps, window=window,
                                      return_partials=True)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.float(), wo.float(), **tol)
    torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)


def _split_inputs(lens, h, hkv, dh, ps, seed):
    """Inputs whose block tables cover the longest context, pages in random
    order and distinct."""
    rng = np.random.default_rng(seed)
    b, n = len(lens), max(1, max(-(-x // ps) for x in lens))
    npages = b * n + 3
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, hkv, dh)).astype(np.float32)
    bt = rng.permutation(npages)[:b * n].reshape(b, n).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


# contexts around one split and over several, beside an empty row; then a
# window that starts mid-page several splits into a long context; then a
# context past danube's 4096-token window
_SPLIT = SPLIT_TOKENS
_SPLIT_CASES = [
    ([_SPLIT - 1, _SPLIT, _SPLIT + 1, 3 * _SPLIT + 7, 0, 5], None),
    ([4 * _SPLIT + 10, 0, 2 * _SPLIT + 3], 2 * _SPLIT - 37),
    ([4096 + 300, 4096, 77, 0], 4096),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("lens,window", _SPLIT_CASES)
def test_cuda_kernel_split_contexts_match_plain(cuda, lens, window, g,
                                                dtype):
    """Contexts split over several blocks and merged on the card: at a
    split's size - 1, size and size + 1, over several splits, with a window
    and past danube's window, GQA groups of 1-8 heads; the merged (m, l)
    equal the unsplit plain version's."""
    hkv, dh, ps = 8 // g if g < 8 else 1, 80, 16
    q, kp, vp, bt, lens = _split_inputs(lens, hkv * g, hkv, dh, ps,
                                        seed=len(lens) + g)
    args = [t.to(cuda) for t in _torch(q, kp, vp, bt, lens)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    before = paged_attention.launches
    out, m, l = paged_attention(*args, page_size=ps, window=window,
                                return_partials=True)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    wo, wm, wl = tref.paged_attention(*args, page_size=ps, window=window,
                                      return_partials=True)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.float(), wo.float(), **tol)
    if dtype == torch.bfloat16:  # long-context outputs are far below 3e-2
        torch.testing.assert_close(out.float(), wo.float(), **BF16_OUT)
    torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
    empty = args[4] == 0
    assert (out[empty] == 0).all() and (l[empty] == 0).all()
    assert (m[empty] == tref.NEG_INF).all()


@pytest.mark.gpu
def test_cuda_kernel_reads_a_strided_layer_slice(cuda):
    """A layer of a (P, L, ps, Hkv, Dh) pool is a view whose page stride
    is L times a page: the kernel reads it in place."""
    q, kp, vp, bt, lens = _inputs(3, 32, 8, 80, 16, 4, seed=6)
    L = 3
    rng = np.random.default_rng(0)
    big_k = torch.from_numpy(rng.standard_normal(
        (kp.shape[0], L) + kp.shape[1:]).astype(np.float32)).to(cuda)
    big_v = torch.from_numpy(rng.standard_normal(
        (kp.shape[0], L) + kp.shape[1:]).astype(np.float32)).to(cuda)
    qt, btt, lt = (t.to(cuda) for t in _torch(q, bt, lens))
    got = paged_attention(qt, big_k[:, 1], big_v[:, 1], btt, lt,
                          page_size=16)
    want = tref.paged_attention(qt, big_k[:, 1].contiguous(),
                                big_v[:, 1].contiguous(), btt, lt,
                                page_size=16)
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.gpu
def test_cuda_kernel_raises_instead_of_falling_back(cuda):
    q, kp, vp, bt, lens = (t.to(cuda) for t in _torch(
        *_inputs(2, 8, 2, 64, 16, 3)))
    with pytest.raises(TypeError):  # float64 has no kernel
        paged_attention(q.double(), kp.double(), vp.double(), bt, lens,
                        page_size=16)
    with pytest.raises(ValueError):  # int64 block tables are refused
        paged_attention(q, kp, vp, bt.long(), lens, page_size=16)
    with pytest.raises(ValueError):  # q not contiguous
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp,
                        vp, bt, lens, page_size=16)


# -- flash_prefill ----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,h,hkv,dh,causal,window",
    [(1, 128, 4, 4, 64, True, None), (2, 256, 8, 2, 64, True, None),
     (2, 256, 8, 2, 64, True, 64), (1, 128, 4, 1, 32, False, None),
     (2, 192, 6, 2, 80, True, None), (1, 100, 32, 8, 80, False, 16)])
def test_cuda_flash_prefill_matches_plain(cuda, b, s, h, hkv, dh, causal,
                                          window, dtype):
    rng = np.random.default_rng(b * s + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = tref.flash_prefill(q, k, v, causal=causal, window=window)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("layout", ["layer_slice", "page_major_slice"])
@pytest.mark.parametrize("s,q_offset", [(48, 0), (100, 37), (17, 160)])
def test_cuda_prefill_attention_paged_matches_plain(cuda, s, q_offset,
                                                    layout, window, dtype):
    """The engine entry point at danube's head layout (H 32, Hkv 8, Dh 80,
    page 16) over a strided layer slice of a 3-layer pool, pages in random
    order, chunks at unaligned offsets."""
    h, hkv, dh, ps, L = 32, 8, 80, 16, 3
    rng = np.random.default_rng(s + q_offset)
    n = -(-(q_offset + s) // ps) + 1  # one page past the context
    npages = n + 5
    shape = (npages, L, ps, hkv, dh) if layout == "page_major_slice" \
        else (L, npages, ps, hkv, dh)
    kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    k = kp[:, 1] if layout == "page_major_slice" else kp[1]
    v = vp[:, 1] if layout == "page_major_slice" else vp[1]
    pages = torch.from_numpy(rng.permutation(npages)[:n].astype(
        np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((1, s, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    before = flash_prefill.launches
    got = prefill_attention_paged(q, k, v, pages, q_offset=q_offset,
                                  window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = tref.prefill_attention_paged(q, k, v, pages, q_offset=q_offset,
                                        window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize(
    "s,q_offset,h,hkv,dh",
    [(1, 0, 32, 8, 80), (15, 3, 32, 8, 80), (33, 64, 32, 8, 80),
     (100, 29, 24, 8, 80), (70, 5, 12, 4, 64), (40, 17, 8, 2, 32),
     (57, 90, 16, 4, 128), (129, 0, 4, 4, 64)])
def test_cuda_prefill_attention_paged_tensor_core_shapes(
        cuda, s, q_offset, h, hkv, dh, window, dtype):
    """The engine form's tensor-core tiles at the edges: chunks that are
    not a multiple of 16 rows, G = 3 (64 rows do not divide into groups),
    G = 1, head_dim 32 / 64 / 80 / 128, float32 pools (rounded to bf16 as
    they are staged) and bf16 pools (copied by cp.async)."""
    ps = 16
    rng = np.random.default_rng(s * 7 + dh + h)
    n = -(-(q_offset + s) // ps)
    npages = n + 4
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (npages, ps, hkv, dh)).astype(np.float32)).to(cuda, dtype)
        for _ in range(2))
    pages = torch.from_numpy(rng.permutation(npages)[:n].astype(
        np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((1, s, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    before = flash_prefill.launches
    got = prefill_attention_paged(q, kp, vp, pages, q_offset=q_offset,
                                  window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = tref.prefill_attention_paged(q, kp, vp, pages, q_offset=q_offset,
                                        window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["heads_strided", "page_size_24"])
def test_cuda_kernels_stage_layouts_tma_does_not_take(cuda, layout, dtype):
    """Both kernels stage K/V by TMA boxes of whole pages when the pool's
    heads are contiguous and its pages split into 8-token multiples; other
    layouts are staged element by element: a pool whose head slices are
    spaced apart, and 24-token pages."""
    h, hkv, dh = 32, 8, 80
    ps = 24 if layout == "page_size_24" else 16
    pad = 16 if layout == "heads_strided" else 0
    rng = np.random.default_rng(ps + pad)
    lens = np.array([5, 200, 0, 333], np.int32)
    nper = -(-int(lens.max()) // ps)
    npages = 4 * nper + 2
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (npages, ps, hkv, dh + pad)).astype(np.float32)).to(cuda, dtype)
        [..., :dh] for _ in range(2))
    bt = torch.from_numpy(rng.permutation(npages)[:4 * nper].reshape(
        4, nper).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((4, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    ctx = torch.from_numpy(lens).to(cuda)
    got = paged_attention(q, kp, vp, bt, ctx, page_size=ps, window=100)
    want = tref.paged_attention(q, kp, vp, bt, ctx, page_size=ps,
                                window=100)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    s, q_offset = 70, 90
    qp = torch.from_numpy(rng.standard_normal((1, s, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    pages = bt[1, :-(-(q_offset + s) // ps)].contiguous()
    got = prefill_attention_paged(qp, kp, vp, pages, q_offset=q_offset,
                                  window=64)
    want = tref.prefill_attention_paged(qp, kp, vp, pages,
                                        q_offset=q_offset, window=64)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.gpu
def test_cuda_flash_prefill_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda)
    kp = torch.zeros(4, 16, 2, 32, device=cuda)
    pages = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # float64 has no kernel
        flash_prefill(q.double(), q[:, :, :2].double(), q[:, :, :2].double())
    with pytest.raises(ValueError):  # int64 page ids are refused
        prefill_attention_paged(q, kp, kp, pages.long(), q_offset=0)
    with pytest.raises(ValueError):  # positions 9..16 need a second page
        prefill_attention_paged(q, kp, kp, pages, q_offset=9)
    with pytest.raises(ValueError):  # Dh above the kernel's tile
        flash_prefill(torch.zeros(1, 8, 2, 160, device=cuda),
                      torch.zeros(1, 8, 2, 160, device=cuda),
                      torch.zeros(1, 8, 2, 160, device=cuda))


# -- ssd_scan ---------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, g, n, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (x, dt, A, B, C)]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return t


SSD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk",
    [(2, 128, 4, 16, 1, 8, 16), (2, 128, 4, 16, 2, 8, 32),
     (2, 128, 4, 16, 2, 8, 64), (2, 96, 4, 50, 1, 16, 32),
     (1, 128, 6, 50, 2, 16, 64), (1, 512, 4, 64, 1, 128, 256),
     (1, 80, 2, 8, 1, 4, 80)])
def test_cuda_ssd_scan_matches_plain(cuda, b, l, h, p, g, n, chunk, dtype):
    """Reference-test shapes (p 16, n 8, g 1/2, chunks 16-64), hymba's
    p 50 / n 16, mamba2's p 64 / n 128 with chunk 256, and a chunk that
    is not a multiple of the kernel's 64-row tile."""
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, l + p, cuda, dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, sr = tref.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, yr, **SSD_TOL)
    torch.testing.assert_close(st, sr, **SSD_TOL)


@pytest.mark.gpu
def test_cuda_ssd_scan_reads_projection_slices(cuda):
    """x, B and C as ``ssm_forward`` hands them: strided slices of one
    (b, l, conv_dim) tensor."""
    b, l, h, p, n = 2, 64, 4, 16, 8
    rng = np.random.default_rng(9)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, l, h * p + 2 * n)).astype(np.float32)).to(cuda)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, l, 1, n)
    C = xbc[..., h * p + n:].reshape(b, l, 1, n)
    _, dt, A, _, _ = _ssd_inputs(b, l, h, p, 1, n, 3, cuda)
    y, st = ssd_scan(x, dt, A, B, C, chunk=32)
    yr, sr = tref.ssd_scan(x, dt, A, B, C, chunk=32)
    torch.testing.assert_close(y, yr, **SSD_TOL)
    torch.testing.assert_close(st, sr, **SSD_TOL)


def _ssd_rel_err(y, st, yr, sr):
    """Errors relative to max |y| and max |state| (``chip_smoke.py``'s
    measure), each held at 2e-4."""
    return ((y - yr).abs().max() / yr.abs().max()).item(), \
        ((st - sr).abs().max() / sr.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk",
    [(1, 4096, 64, 64, 1, 128, 256),  # one long prompt: a 16-chunk chain
     (4, 1024, 64, 64, 1, 128, 256),  # mamba2's prefill in chip_smoke.py
     (1, 1024, 8, 64, 1, 128, 16), (1, 1024, 8, 64, 1, 128, 32),
     (2, 512, 8, 64, 1, 128, 64),
     (1, 96, 8, 64, 1, 128, 48),  # a chunk that is not a power of two
     (2, 512, 64, 50, 1, 16, 256),  # hymba-1.5b's widths and chunk
     (2, 512, 8, 64, 2, 128, 128)])  # two groups
def test_cuda_ssd_scan_chunk_chain_matches_plain(cuda, b, l, h, p, g, n,
                                                 chunk, dtype):
    """The chunk-parallel kernel, whose blocks chain the state from chunk
    to chunk, at mamba2's widths (chains of 4 to 64 chunks) and hymba's,
    against the plain scan: 2e-4 of max |y| and of max |state|. (Not
    elementwise: over thousands of tokens the plain version's own float32
    cumulative sums differ from any other order of sums by more than 2e-4
    at some small |y|, for the float32 CUDA-core form as well.)"""
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, l + chunk, cuda, dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, sr = tref.ssd_scan(x, dt, A, B, C, chunk=chunk)
    y_err, s_err = _ssd_rel_err(y, st, yr, sr)
    assert y_err <= 2e-4 and s_err <= 2e-4, (y_err, s_err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_reads_mamba2_projection_slices(cuda, dtype):
    """x, B and C as mamba2-1.3b's ``ssm_forward`` hands them at full
    width: strided slices of one (b, l, 4096 + 2 x 128) conv output, read
    in place (16-byte aligned rows, so the bf16 form stages them by
    cp.async); and the same with the slices one element off alignment."""
    b, l, h, p, n = 2, 512, 64, 64, 128
    _, dt, A, _, _ = _ssd_inputs(b, l, h, p, 1, n, 11, cuda)
    rng = np.random.default_rng(12)
    for lead in (0, 1):
        xbc = torch.from_numpy(rng.standard_normal(
            (b, l, lead + h * p + 2 * n)).astype(np.float32)).to(cuda)
        xbc = xbc.to(dtype)[..., lead:]
        x = xbc[..., :h * p].reshape(b, l, h, p)
        B = xbc[..., h * p:h * p + n].reshape(b, l, 1, n)
        C = xbc[..., h * p + n:].reshape(b, l, 1, n)
        y, st = ssd_scan(x, dt, A, B, C, chunk=256)
        yr, sr = tref.ssd_scan(x, dt, A, B, C, chunk=256)
        y_err, s_err = _ssd_rel_err(y, st, yr, sr)
        assert y_err <= 2e-4 and s_err <= 2e-4, (lead, y_err, s_err)


@pytest.mark.gpu
def test_cuda_ssd_scan_raises_instead_of_falling_back(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 48, 2, 8, 1, 4, 0, cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(x, dt, A, B, C, chunk=32)
    with pytest.raises(TypeError):  # float64 has no kernel
        ssd_scan(x.double(), dt, A, B.double(), C.double(), chunk=16)
    x, dt, A, B, C = _ssd_inputs(1, 32, 2, 80, 1, 4, 0, cuda)
    with pytest.raises(ValueError):  # p above the kernel's tile
        ssd_scan(x, dt, A, B, C, chunk=16)


@pytest.mark.gpu
def test_cuda_ssd_scan_bf16_raises_on_what_it_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 64, 4, 16, 2, 8, 0, cuda, torch.bfloat16)
    before = ssd_scan.launches
    with pytest.raises(TypeError):  # B and C must share x's dtype
        ssd_scan(x, dt, A, B.float(), C.float(), chunk=32)
    with pytest.raises(TypeError):  # dt must be float32
        ssd_scan(x, dt.to(torch.bfloat16), A, B, C, chunk=32)
    with pytest.raises(ValueError):  # dense trailing axes only
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B,
                 C, chunk=32)
    x3, dt3, A3, B3, C3 = _ssd_inputs(1, 64, 3, 16, 2, 8, 0, cuda,
                                      torch.bfloat16)
    with pytest.raises(ValueError):  # g must divide h
        ssd_scan(x3, dt3, A3, B3, C3, chunk=32)
    xn, dtn, An, Bn, Cn = _ssd_inputs(1, 64, 2, 16, 1, 136, 0, cuda,
                                      torch.bfloat16)
    with pytest.raises(ValueError):  # n above the kernel's tile
        ssd_scan(xn, dtn, An, Bn, Cn, chunk=32)
    assert ssd_scan.launches == before


# -- the paths through the kernels ---------------------------------------------------

@pytest.mark.gpu
def test_cuda_paths_launch_the_kernels(cuda):
    """The engine's prefill chunks launch flash_prefill once per layer and
    chunk; the SSM model's prefill launches ssd_scan once per layer."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    engine = PagedEngine(cfg, params, EngineConfig(
        num_pages=64, page_size=8, max_slots=2, max_tokens_per_iter=32),
        device=cuda)
    before = flash_prefill.launches
    outs = LLMService(engine).generate([list(range(1, 70))],
                                       SamplingParams(max_new_tokens=3))
    assert len(outs[0].token_ids) == 3 and engine.prefill_chunks >= 3
    assert flash_prefill.launches - before == \
        cfg.num_layers * engine.prefill_chunks

    cfg = smoke_config("mamba2-1.3b")
    params = init_params(cfg, seed=0, device=cuda)
    before = ssd_scan.launches
    logits, caches = Model(cfg).prefill(
        params, torch.arange(64, device=cuda).reshape(2, 32) % 500)
    assert ssd_scan.launches - before == cfg.num_layers
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    assert caches[0].state.shape == (2, 2, cfg.ssm_heads, 32, 16)
