"""The port's CUDA kernels (paged_attention, flash_prefill, ssd_scan)
against their plain PyTorch versions, and the engine's host-tier movers
(pinned host pools, stream order, no host synchronisation), on the card.
Every test here needs a CUDA device and skips without one (a kernel has no
CPU mode). This file imports no JAX, so it runs on a machine with the
card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 3e-2; the float32
partials m to 2e-5 and l (a sum of up to a few hundred terms) to 1e-4.
The engine form of flash_prefill rounds its probabilities to bfloat16, so
a one-ulp float32 difference in a score can flip a rounding (2**-8
relative): it is held at 3e-2 in float32 too, and its non-causal form
relative to the largest output (NC_TOL). ssd_scan returns float32
from the same upcast inputs in both versions, in another order of sums:
2e-4, as ``tests/test_kernels.py`` holds the Pallas kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               prefill_attention,
                                               prefill_attention_paged)
from repro_torch.kernels.paged_attention import SPLIT_TOKENS, paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
# a bf16 result of float32 math against the plain version's: at most one
# bf16 rounding apart (2**-7 of the value) plus the float32 difference
BF16_OUT = dict(rtol=2.0 ** -7, atol=1e-5)
# prefill_attention(causal=False) against its plain version, of the largest
# |plain| value: (worst, median) by dtype. Both sides round q, k, v and the
# probabilities to bf16 alike; a bf16 output may differ by one ulp (at most
# 2**-7 of the largest value). On an H100 the kernel came within 9.8e-4
# (float32) and 3.3e-3 (bf16) worst, 1.5e-7 and 0 in the median; a key
# count off by one breaks both limits (tests/test_torch_encdec.py::
# test_non_causal_limits_catch_a_key_count_off_by_one).
NC_TOL = {torch.float32: (5e-3, 1e-6), torch.bfloat16: (1e-2, 1e-5)}


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


# GQA groups outside {1, 2, 4, 8}: the decode kernel takes them 8 heads at
# a time with guards. (H, Hkv): llama4-scout's G 5, G 6, mistral-large's
# G 12 and granite's MQA G 48, all at head_dim 128
_GROUPS = [(40, 8), (12, 2), (96, 8), (48, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("h,hkv", _GROUPS,
                         ids=[f"g{h // hkv}" for h, hkv in _GROUPS])
def test_cuda_kernel_gqa_groups_match_plain(cuda, h, hkv, window, dtype):
    """Decode at G 5, 6, 12 and 48 with head_dim 128: ragged contexts, an
    empty row, and contexts split over several blocks (merged on the
    card); out, m and l against the plain version."""
    dh, ps = 128, 16
    q, kp, vp, bt, lens = _split_inputs(
        [37, 0, _SPLIT + 5, 3 * _SPLIT - 9, 16], h, hkv, dh, ps,
        seed=h + hkv)
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
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), wo.float(), **BF16_OUT)
    torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
    empty = args[4] == 0
    assert (out[empty] == 0).all() and (l[empty] == 0).all()


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
    "b,s,skv,h,hkv,dh,causal,window,layout",
    [(1, 128, 128, 4, 4, 64, True, None, "dense"),
     (2, 256, 256, 8, 2, 64, True, None, "dense"),
     (2, 256, 256, 8, 2, 64, True, 64, "dense"),
     (1, 128, 128, 4, 1, 32, False, None, "dense"),
     (2, 192, 192, 6, 2, 80, True, None, "dense"),
     (1, 100, 100, 32, 8, 80, False, 16, "dense"),
     (2, 300, 300, 10, 2, 64, True, 64, "dense"),      # G 5
     (1, 200, 200, 12, 2, 128, True, None, "dense"),   # G 6, Dh 128
     (1, 70, 70, 48, 1, 128, True, None, "dense"),     # G 48, Dh 128
     (1, 257, 257, 4, 2, 32, True, None, "dense"),     # S % 128 != 0
     (2, 150, 150, 8, 2, 80, True, 40, "dense"),
     (2, 100, 333, 8, 2, 64, False, None, "dense"),    # Skv > S
     (2, 300, 77, 10, 2, 80, False, None, "dense"),    # Skv < S
     (1, 256, 100, 4, 2, 64, True, 32, "dense"),       # rows see no key
     (4, 200, 200, 10, 2, 64, True, None, "head_slice"),
     (2, 130, 130, 6, 3, 80, True, None, "offset_slice"),
     (2, 2048, 2048, 8, 2, 64, True, None, "dense"),   # items > SMs
     (1, 1500, 1500, 12, 2, 128, True, 256, "dense")])
def test_cuda_flash_prefill_matches_plain(cuda, b, s, skv, h, hkv, dh,
                                          causal, window, layout, dtype):
    """The contiguous entry (bf16: the wgmma body, float32: the CUDA-core
    body) at chip_smoke.py's FLASH_SWEEP and FLASH_CASES: G 1-48, Dh 32 /
    64 / 80 / 128, S not a multiple of the 128-row tile, Skv above and
    below S, rows that see no key (zeros), and K/V as strided views: a head
    slice (TMA) and a column slice 2 bytes off alignment (staged through
    registers); more items than the card has SMs, the last round
    partial."""
    rng = np.random.default_rng(b * s + dh + skv)

    def kv():
        wide = {"head_slice": (b, skv, hkv + 2, dh),
                "offset_slice": (b, skv, hkv, dh + 8)}.get(
                    layout, (b, skv, hkv, dh))
        t = torch.from_numpy(rng.standard_normal(wide).astype(
            np.float32)).to(cuda, dtype)
        if layout == "head_slice":
            return t[:, :, 1:hkv + 1]
        return t[..., 1:dh + 1] if layout == "offset_slice" else t

    q = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    k, v = kv(), kv()
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = tref.flash_prefill(q, k, v, causal=causal, window=window)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    qpos = torch.arange(s, device=cuda)[:, None]
    kpos = torch.arange(skv, device=cuda)[None]
    seen = torch.ones((s, skv), dtype=torch.bool, device=cuda)
    if causal:
        seen &= kpos <= qpos
    if window is not None:
        seen &= kpos > qpos - window
    assert (got[:, ~seen.any(-1)] == 0).all()


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
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("h,hkv", _GROUPS,
                         ids=[f"g{h // hkv}" for h, hkv in _GROUPS])
def test_cuda_prefill_attention_paged_gqa_groups(cuda, h, hkv, window,
                                                 dtype):
    """The engine form at G 5, 6, 12 and 48 with head_dim 128: a 64-row
    tile holds 64 // G positions x G heads (12 x 5, 10 x 6, 5 x 12, 1 x
    48), so 4, 4, 4 and 16 of its rows are idle; a chunk of 100 queries at
    offset 37, then a single query far into the context."""
    dh, ps = 128, 16
    rng = np.random.default_rng(h * 3 + hkv)
    for s, q_offset in ((100, 37), (1, 300)):
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
        want = tref.prefill_attention_paged(q, kp, vp, pages,
                                            q_offset=q_offset, window=window)
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


# -- Model.prefill's attention: the engine form over a batch of sequences -----

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("b,s", [(4, 2048), (2, 1000), (3, 77)])
def test_cuda_prefill_attention_matches_plain(cuda, b, s, window, dtype):
    """hymba's widths (25 heads over 5 KV heads, Dh 64): one launch per
    sequence, K/V read in place as a pool of B pages of S tokens, against
    the plain ``blockwise_attention``; S 2048 takes the TMA path in bf16,
    1000 and 77 (no multiple of the 128-key tile) the staged one."""
    rng = np.random.default_rng(b * s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((b, s, 25, 64), (b, s, 5, 64), (b, s, 5, 64)))
    before = flash_prefill.launches
    got = prefill_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + b
    want = tref.prefill_attention(q, k, v, window=window)
    # bf16 roundings of the probabilities may flip: 3e-2 in both types
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.gpu
def test_cuda_prefill_attention_raises_instead_of_falling_back(cuda):
    q = torch.zeros(2, 8, 4, 32, device=cuda)
    kv = torch.zeros(2, 8, 2, 32, device=cuda)
    with pytest.raises(TypeError):  # float64 has no kernel
        prefill_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError):  # K/V of another length
        prefill_attention(q, kv[:, :4], kv[:, :4])
    with pytest.raises(ValueError):  # q must be contiguous
        prefill_attention(q.transpose(1, 2), kv, kv)


# the encoder's self-attention (S = Skv) and a decoder's cross-attention
# (S queries over Skv encoder positions): (S, Skv)
NON_CAUSAL = [(64, 64), (1000, 1000), (1024, 1024)] + [
    (s, skv) for s in (1, 64, 130) for skv in (16, 1000, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", [(16, 16, 64), (12, 2, 128)])
@pytest.mark.parametrize("s,skv", NON_CAUSAL)
def test_cuda_prefill_attention_non_causal_matches_plain(cuda, s, skv, h,
                                                         hkv, dh, dtype):
    """``prefill_attention(causal=False)``: seamless's widths (16 heads,
    G 1, Dh 64) and a G 6 at Dh 128, every key valid, Skv a multiple of
    the 128-key tile (the TMA path in bf16), not one (1000: the last tile
    masked, staged through registers) or below one tile (16), against the
    plain ``blockwise_attention`` within NC_TOL."""
    rng = np.random.default_rng(s * 7 + skv + h)
    b = 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((b, s, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    before = flash_prefill.launches
    got = prefill_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + b
    want = tref.prefill_attention(q, k, v, causal=False)
    d = (got.float() - want.float()).abs() / want.float().abs().max()
    worst, median = NC_TOL[dtype]
    assert d.max() <= worst and d.median() <= median, \
        (d.max().item(), d.median().item())


@pytest.mark.gpu
def test_cuda_prefill_attention_non_causal_refuses(cuda):
    q = torch.zeros(2, 8, 4, 32, device=cuda)
    kv = torch.zeros(2, 5, 2, 32, device=cuda)
    with pytest.raises(ValueError):  # no windowed non-causal form
        prefill_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(TypeError):  # float64 has no kernel
        prefill_attention(q.double(), kv.double(), kv.double(),
                          causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_cuda_encdec_and_media_model_matches_cpu(cuda, arch):
    """Smoke seamless (2 encoder and 2 decoder layers, 8 audio frames in
    the encoder) and smoke internvl2 (8 patch embeddings in the decoder),
    float32: ``Model.prefill`` on the card launches ``flash_prefill`` per
    layer and sequence (seamless: the encoder's layers, then each decoder
    layer's self- and cross-attention) and ``paged_attention`` never; its
    logits and caches, then 4 decode steps' (the CPU run's greedy tokens
    fed to both), equal the CPU run's within 1e-2 of each quantity's
    largest magnitude in the worst element and 1e-4 in the median, as the
    hybrid model is held above; positions exactly."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              logits_fp32=True)
    model = Model(cfg)
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(5)
    b, s = 2, 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    media = torch.from_numpy((rng.standard_normal(
        (b, cfg.num_media_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    enc = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 72))) \
        if cfg.is_encdec else None
    runs, fed = [], []
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        kw = dict(media=media.to(dev))
        if enc is not None:
            kw["encoder_tokens"] = enc.to(dev)
        before = (flash_prefill.launches, paged_attention.launches)
        logits, caches = model.prefill(p, toks.to(dev), seq_capacity=48,
                                       **kw)
        if torch.device(dev).type == "cuda":
            per_seq = cfg.encoder_layers + cfg.num_layers * (
                2 if cfg.is_encdec else 1)
            assert flash_prefill.launches - before[0] == per_seq * b
            assert paged_attention.launches == before[1]
        steps = [(logits, caches)]
        for i in range(4):
            if len(fed) <= i:
                fed.append(logits[:, :cfg.vocab_size].argmax(-1))
            logits, caches = model.decode_step(
                p, fed[i][:, None].to(dev),
                torch.full((b,), s + i, device=dev), caches)
            steps.append((logits, caches))
        runs.append(steps)
    for (lc, cc), (lg, cg) in zip(*runs):
        for a, bb in zip(_cache_leaves([lc, cc]), _cache_leaves([lg, cg])):
            bb = bb.cpu()
            if a.dtype == torch.int32:
                assert torch.equal(a, bb)
                continue
            d = (a.float() - bb.float()).abs() / a.float().abs().max()
            assert d.max() <= 1e-2 and d.median() <= 1e-4, \
                (float(d.max()), float(d.median()))


@pytest.mark.gpu
def test_cuda_hybrid_model_prefill_matches_cpu(cuda):
    """Smoke hymba at 4 layers (a global layer, then a window segment of
    3) with 10 heads over 2 KV heads, float32: ``Model.prefill`` on the
    card launches ``flash_prefill`` once per layer and sequence and
    ``ssd_scan`` once per layer, and its logits and ring caches equal the
    CPU run's (plain versions) within 1e-2 of each quantity's largest
    magnitude in the worst element and 1e-4 in the median: the two
    devices' float32 sums differ in order, which can flip a bf16 rounding
    of the attention (2**-8 relative) that later layers inherit; positions
    exactly. Then 4 decode steps on each device, held alike."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), dtype="float32",
                              logits_fp32=True, num_layers=4,
                              global_attn_every=4, num_heads=10,
                              num_kv_heads=2)
    model = Model(cfg)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 96)))
    runs, fed = [], []  # both devices take the CPU run's greedy tokens
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        before = (flash_prefill.launches, ssd_scan.launches,
                  paged_attention.launches)
        logits, caches = model.prefill(p, toks.to(dev), seq_capacity=104)
        after = (flash_prefill.launches, ssd_scan.launches,
                 paged_attention.launches)
        if torch.device(dev).type == "cuda":
            assert after[0] - before[0] == cfg.num_layers * 2
            assert after[1] - before[1] == cfg.num_layers
            assert after[2] == before[2]
        steps = [(logits, caches)]
        for i in range(4):
            if len(fed) <= i:
                fed.append(logits[:, :cfg.vocab_size].argmax(-1))
            logits, caches = model.decode_step(
                p, fed[i][:, None].to(dev),
                torch.full((2,), 96 + i, device=dev), caches)
            steps.append((logits, caches))
        runs.append(steps)
    for (lc, cc), (lg, cg) in zip(*runs):
        for a, b in zip(_cache_leaves([lc, cc]), _cache_leaves([lg, cg])):
            b = b.cpu()
            if a.dtype == torch.int32:
                assert torch.equal(a, b)
                continue
            d = (a.float() - b.float()).abs() / a.float().abs().max()
            assert d.max() <= 1e-2 and d.median() <= 1e-4, \
                (float(d.max()), float(d.median()))


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _cache_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _cache_leaves(t)]
    return [tree]


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
    chunk, dense and MoE, and its decode steps paged_attention once per
    layer and step; the SSM model's prefill launches ssd_scan once per
    layer."""
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

    # MoE on GQA (llama4-scout at smoke size, 5 query heads per KV head):
    # both attention kernels once per layer and call
    cfg = dataclasses.replace(smoke_config("llama4-scout-17b-a16e"),
                              num_heads=10, num_kv_heads=2)
    params = init_params(cfg, seed=0, device=cuda)
    engine = PagedEngine(cfg, params, EngineConfig(
        num_pages=64, page_size=16, max_slots=4, max_tokens_per_iter=48),
        device=cuda)
    before = (flash_prefill.launches, paged_attention.launches)
    outs = LLMService(engine).generate(
        [list(range(1, 100)), list(range(7, 30))],
        SamplingParams(max_new_tokens=4))
    assert all(len(o.token_ids) == 4 for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids)
    assert flash_prefill.launches - before[0] == \
        cfg.num_layers * engine.prefill_chunks
    assert paged_attention.launches - before[1] == \
        cfg.num_layers * engine.decode_steps > 0

    cfg = smoke_config("mamba2-1.3b")
    params = init_params(cfg, seed=0, device=cuda)
    before = ssd_scan.launches
    logits, caches = Model(cfg).prefill(
        params, torch.arange(64, device=cuda).reshape(2, 32) % 500,
        seq_capacity=32)
    assert ssd_scan.launches - before == cfg.num_layers
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    assert caches[0].state.shape == (2, 2, cfg.ssm_heads, 32, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["paper-opt-13b", "h2o-danube-1.8b"])
def test_cuda_graph_decode_equals_eager(cuda, arch, dtype):
    """The paged GQA decode step replayed from its piecewise CUDA graphs
    against the eager layers on the same engine state (OPT-shaped, and
    danube-shaped with its window of 64): every step's logits and the
    pools it leaves are the same bits, through rows joining and leaving,
    tables widening over page boundaries, preemption with recompute and a
    COW fork. ``paged_attention`` is still launched once per layer and
    step; without the oracle every decode step is a graphed one."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from test_torch_decode_graphs import ECFG, checked_against_eager, \
        serve_scenario

    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    engine = PagedEngine(cfg, init_params(cfg, 0, device=cuda),
                         EngineConfig(**ECFG), device=cuda)
    L = cfg.num_layers
    launches = paged_attention.launches
    checked = checked_against_eager(engine)
    serve_scenario(engine)
    assert engine.preemptions > 0
    assert len(checked) >= 20 and all(checked)
    assert engine._graphs.graphs is not None
    assert engine.decode_steps == 2 * len(checked)
    assert paged_attention.launches - launches == L * engine.decode_steps
    del engine._decode  # the engine alone
    steps, graphed = engine.decode_steps, engine.graph_decode_steps
    launches = paged_attention.launches
    outs = serve_scenario(engine)
    torch.cuda.synchronize()
    steps = engine.decode_steps - steps
    assert steps > 0 and engine.graph_decode_steps - graphed == steps
    assert paged_attention.launches - launches == L * steps
    assert all(0 <= t < cfg.vocab_size for o in outs for s in o.samples
               for t in s.token_ids)


@pytest.mark.gpu
def test_cuda_graph_decode_skips_mla_and_leased_steps(cuda):
    """An MLA engine never replays the graphs; behind a router with
    zero-copy leases, an engine replays them on every decode step but those
    that merge remote partials."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from test_torch_decode_graphs import ECFG, serve_scenario

    cfg = smoke_config("deepseek-v2-236b")
    engine = PagedEngine(cfg, init_params(cfg, 0, device=cuda),
                         EngineConfig(**ECFG), device=cuda)
    serve_scenario(engine)
    assert engine.decode_steps > 0 and engine.graph_decode_steps == 0
    assert engine._graphs is None

    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              sliding_window=None)
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, 512, 16).tolist()
    prompts = [prefix + rng.integers(0, 512, n).tolist() for n in (3, 5, 21)]
    _, engines = _zero_copy_runs(cfg, init_params(cfg, 0, device=cuda),
                                 cuda, prompts, 6)
    assert sum(e.leased_decode_steps for e in engines) > 0
    assert sum(e.graph_decode_steps for e in engines) > 0
    for e in engines:
        assert e.graph_decode_steps == e.decode_steps - e.leased_decode_steps


@pytest.mark.gpu
def test_cuda_mla_engine_matches_cpu_engine(cuda):
    """deepseek-v2-236b at smoke size, float32, on the MLA engine: the
    card's greedy tokens equal the CPU engine's, through chunked prefill,
    a late join and a best-of-2 fork. The two devices' float32 sums differ
    in order, which can flip a bf16 rounding inside the attention (2**-8
    relative): a token may differ only where ``Model.forward``'s top-2
    logits lie within 2**-7 of the largest |logit|, and comparing that
    request stops there. The MLA path is the reference's plain one: it
    launches neither attention kernel."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              dtype="float32", logits_fp32=True)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).tolist() for n in (45, 9, 30)]
    runs = {}
    before = (flash_prefill.launches, paged_attention.launches)
    for dev in ("cpu", cuda):
        engine = PagedEngine(cfg, _to(params, dev), EngineConfig(
            num_pages=64, page_size=8, max_slots=4, max_tokens_per_iter=16),
            device=dev)
        svc = LLMService(engine)
        outs = svc.generate(prompts[:2], SamplingParams(max_new_tokens=8,
                                                        n=2))
        outs += svc.generate(prompts[2:], SamplingParams(max_new_tokens=8))
        runs[str(dev)] = [s.token_ids for o in outs for s in o.samples]
        assert engine.kv_layout.schema == "mla:ckv64+krope16:f32"
    assert (flash_prefill.launches, paged_attention.launches) == before
    model = Model(cfg)
    compared = 0
    for prompt, a, b in zip([prompts[0]] * 2 + [prompts[1]] * 2 +
                            [prompts[2]], runs["cpu"], runs[str(cuda)]):
        for i, (x, y) in enumerate(zip(a, b)):
            compared += 1
            if x == y:
                continue
            logits, _ = model.forward(params, torch.tensor([prompt + a[:i]]))
            last = logits[0, -1, :cfg.vocab_size]
            top = torch.topk(last, 2).values
            assert top[0] - top[1] < 2.0 ** -7 * last.abs().max(), (i, x, y)
            break
    assert compared >= 20


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# -- cluster serving: the zero-copy decode's partials --------------------------------

def _table(rng, lens, ps, first_page):
    """A block table of distinct pages from ``first_page`` on, covering the
    longest of ``lens``."""
    n = max(1, max(-(-x // ps) for x in lens))
    pages = first_page + rng.permutation(len(lens) * n)
    return pages.reshape(len(lens), n).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(8, 8), (16, 4), (40, 8), (48, 1)],
                         ids=["g1", "g4", "g5", "g48"])
def test_cuda_kernel_partials_merge_to_the_whole_context(cuda, h, hkv,
                                                         dtype):
    """The zero-copy decode's use of the partials: a local context read
    from one pool and a leased one (whole pages) from another, each through
    the kernel with ``return_partials``, merged by ``merge_partials_tree``
    after ``o = out * l``, equal the plain version over the union of the
    two contexts. Rows hold a local context only, a leased one only, both,
    or neither (context 0 in both partials); contexts run over several
    splits. Each partial's out, m and l is also held against the plain
    version."""
    from repro_torch.core.distkv.dist_attention import merge_partials_tree
    dh, ps = 128, 16
    rng = np.random.default_rng(h + hkv)
    loc = np.array([37, 0, _SPLIT + 5, 0, 2 * _SPLIT + 9, 16], np.int32)
    rem = np.array([0, 3 * ps, 2 * _SPLIT, 0, _SPLIT, 4 * ps], np.int32)
    lbt = _table(rng, loc, ps, 0)
    rbt = _table(rng, rem, ps, 0)
    npages = max(lbt.max(), rbt.max()) + 1
    q = rng.standard_normal((len(loc), h, dh)).astype(np.float32)
    kv = rng.standard_normal((4, npages, ps, hkv, dh)).astype(np.float32)
    q, kv, lbt, rbt, loc_t, rem_t = [t.to(cuda) for t in _torch(
        q, kv, lbt, rbt, loc, rem)]
    q, kv = q.to(dtype), kv.to(dtype)
    own_k, own_v, home_k, home_v = kv  # two instances' pools
    before = (paged_attention.launches, paged_attention.partial_launches)
    parts = []
    for k, v, bt, lens in ((own_k, own_v, lbt, loc_t),
                           (home_k, home_v, rbt, rem_t)):
        out, m, l = paged_attention(q, k, v, bt, lens, page_size=ps,
                                    return_partials=True)
        torch.cuda.synchronize()
        wo, wm, wl = tref.paged_attention(q, k, v, bt, lens, page_size=ps,
                                          return_partials=True)
        tol = F32 if dtype == torch.float32 else BF16
        torch.testing.assert_close(out.float(), wo.float(), **tol)
        torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
        assert (l[lens == 0] == 0).all() and (out[lens == 0] == 0).all()
        parts.append((out.float() * l[..., None], m, l))
    assert (paged_attention.launches, paged_attention.partial_launches) == \
        (before[0] + 2, before[1] + 2)
    merged = merge_partials_tree(*zip(*parts))
    # the plain version over one pool holding both instances' pages: the
    # leased pages first (positions [0, rem)), then the local ones
    pool_k = torch.cat([home_k, own_k])
    pool_v = torch.cat([home_v, own_v])
    width = rbt.shape[1] + lbt.shape[1]
    union = torch.zeros((len(loc), width), dtype=torch.int32, device=cuda)
    for i, (r, n_loc) in enumerate(zip(rem.tolist(), loc.tolist())):
        nr, nl = r // ps, -(-n_loc // ps)
        union[i, :nr] = rbt[i, :nr]
        union[i, nr:nr + nl] = lbt[i, :nl] + npages
    want = tref.paged_attention(q.float(), pool_k.float(), pool_v.float(),
                                union, loc_t + rem_t, page_size=ps)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(merged, want, **tol)
    assert (merged[(loc_t + rem_t) == 0] == 0).all()


def _zero_copy_runs(cfg, params, dev, prompts, n_new):
    """Zero-copy prefix sharing (the third prompt borrows the first two's
    prefix) and zero-copy handoff over two engines on ``dev``; returns
    the greedy tokens of both and the engines."""
    from repro_torch.core.scheduling.request import Request
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from repro_torch.serving.router import RouterBackend

    class Scripted:
        def __init__(self):
            self.order = [0, 0, 1]

        def choose(self, req, children):
            return self.order.pop(0)

    tokens, engines = [], []
    for kw in (dict(policy=Scripted(), prefix_share=True,
                    share_mode="zero_copy", hot_threshold=1),
               dict(roles="1p1d", handoff_mode="zero_copy")):
        pair = [PagedEngine(cfg, params, EngineConfig(
            num_pages=64, page_size=8, max_slots=4, max_tokens_per_iter=16,
            enable_prefix_cache=True), device=dev) for _ in range(2)]
        router = RouterBackend(pair, **kw)
        reqs = [Request(i, 0.0, list(p), max_new_tokens=n_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            router.add_request(r)
            while router.has_work:
                router.step()
        assert router.pages_borrowed > 0 and not router.g.ledger
        tokens.append([r.full_output for r in reqs])
        engines += pair
    return tokens, engines


def _assert_tokens_near(cfg, params, prompts, a_runs, b_runs):
    """Greedy tokens of two devices, equal but where ``Model.forward``'s
    top-2 logits lie within 2**-7 of the largest |logit| (comparing that
    request stops there)."""
    from repro_torch.models.transformer import Model
    model = Model(cfg)
    compared = 0
    for a_run, b_run in zip(a_runs, b_runs):
        for prompt, a, b in zip(prompts, a_run, b_run):
            for i, (x, y) in enumerate(zip(a, b)):
                compared += 1
                if x == y:
                    continue
                logits, _ = model.forward(params,
                                          torch.tensor([prompt + a[:i]]))
                last = logits[0, -1, :cfg.vocab_size]
                top = torch.topk(last, 2).values
                assert top[0] - top[1] < 2.0 ** -7 * last.abs().max(), \
                    (i, x, y)
                break
    return compared


@pytest.mark.gpu
def test_cuda_zero_copy_engine_matches_cpu_engine(cuda):
    """h2o-danube-1.8b at smoke size without its window, float32: zero-copy
    prefix sharing over chunked suffixes and a zero-copy handoff give the
    CPU engines' greedy tokens (by the near-tie rule). The decode launches
    paged_attention with partials once per layer for its local context and
    once per layer and creditor; a leased chunk takes the plain partials,
    every other chunk the prefill kernel."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32", logits_fp32=True,
                              sliding_window=None)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, 512, 16).tolist()
    prompts = [prefix + rng.integers(0, 512, n).tolist() for n in (3, 5, 21)]
    runs = {}
    before = (paged_attention.launches, paged_attention.partial_launches,
              flash_prefill.launches)
    for dev in ("cpu", cuda):
        runs[str(dev)] = _zero_copy_runs(cfg, _to(params, dev), dev,
                                         prompts, 6)
    engines = runs[str(cuda)][1]
    L = cfg.num_layers
    leased = sum(e.leased_decode_steps for e in engines)
    remote = sum(e.remote_partials for e in engines)
    assert leased > 0 and remote >= leased
    assert paged_attention.launches - before[0] == L * (
        sum(e.decode_steps for e in engines) + remote)
    assert paged_attention.partial_launches - before[1] == \
        L * (leased + remote)
    assert flash_prefill.launches - before[2] == L * sum(
        e.prefill_chunks - e.leased_chunks for e in engines)
    assert _assert_tokens_near(cfg, params, prompts, runs["cpu"][0],
                               runs[str(cuda)][0]) >= 30


@pytest.mark.gpu
def test_cuda_mla_zero_copy_engine_matches_cpu_engine(cuda):
    """deepseek-v2-236b at smoke size, float32: zero-copy sharing and
    handoff over latent pages on the card give the CPU engines' greedy
    tokens (by the near-tie rule), and launch neither attention kernel."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              dtype="float32", logits_fp32=True)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, 512, 16).tolist()
    prompts = [prefix + rng.integers(0, 512, n).tolist() for n in (3, 5, 21)]
    runs = {}
    before = (paged_attention.launches, flash_prefill.launches)
    for dev in ("cpu", cuda):
        runs[str(dev)] = _zero_copy_runs(cfg, _to(params, dev), dev,
                                         prompts, 6)
    assert (paged_attention.launches, flash_prefill.launches) == before
    assert sum(e.leased_decode_steps for e in runs[str(cuda)][1]) > 0
    assert _assert_tokens_near(cfg, params, prompts, runs["cpu"][0],
                               runs[str(cuda)][0]) >= 30


# -- the host tier: swap and spill movers -------------------------------------------

def _mover_engine(dev, dtype=torch.bfloat16, host_pages=48):
    """A PagedEngine at h2o-danube-1.8b's pool widths (24 layers, 8 KV
    heads of 80, pages of 16) with a host tier, its pools filled from a
    seed. The movers read no weights, so the engine gets none."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              dtype={torch.bfloat16: "bfloat16",
                                     torch.float32: "float32"}[dtype])
    params = {"embed": {"table": torch.empty(0, device=dev)}}
    engine = PagedEngine(cfg, params, EngineConfig(
        num_pages=64, page_size=16, host_pages=host_pages), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for pool in (engine.k_pages, engine.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=g, device=dev))
    return engine


def _pages(engine, dev_pages):
    return [pool[:, dev_pages].clone() for pool in (engine.k_pages,
                                                    engine.v_pages)]


def _host(engine, host_pages):
    return [torch.stack([engine.host_page(h)[i] for h in host_pages], 1)
            for i in (0, 1)]


@pytest.mark.gpu
def test_cuda_swap_movers_round_trip_bit_exact(cuda):
    """bf16 pages out to pinned host pages (runs of consecutive host
    pages and gaps) and back onto other device pages, by the swap and the
    spill movers, bit for bit; no mover synchronises the host (the sync
    debug mode raises on any synchronising call)."""
    engine = _mover_engine(cuda)
    assert engine.h_k_pages.is_pinned() and engine.h_v_pages.is_pinned()
    assert engine.h_k_pages.shape == (48, 24, 16, 8, 80)
    src = [3, 4, 9, 20, 21, 22]
    hosts = [7, 8, 9, 30, 2, 3]
    dst = [40, 41, 50, 12, 13, 60]
    want = _pages(engine, src)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._swap_out_copy(list(zip(src[:4], hosts[:4])))
        engine._pages_out(list(zip(src[4:], hosts[4:])))  # spill
        engine._swap_in_copy(list(zip(hosts[:4], dst[:4])))
        engine._pages_in(list(zip(hosts[4:], dst[4:])))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert engine.swapped_out == engine.swapped_in == 1
    for got, w in zip(_host(engine, hosts), want):
        assert torch.equal(got.to(cuda), w)
    for got, w in zip(_pages(engine, dst), want):
        assert torch.equal(got, w)


@pytest.mark.gpu
def test_cuda_swap_out_lands_before_same_iteration_writes(cuda):
    """What ``schedule()`` and the step may do to pages right after a
    swap-out, queued behind a busy stream: the freed device pages are
    written in place (a chunk's scatter) and a swap-in lands on them, and
    a host page a swap-in just read is reused by a swap-out. The host keeps
    the pre-write contents, and the swap-in reads the host page before the
    swap-out overwrites it."""
    engine = _mover_engine(cuda)
    victim, host = [5, 6, 7], [10, 11, 12]
    before = _pages(engine, victim)
    # host page 20 holds page 30's contents: the swap-in's source
    engine._pages_out([(30, 20)])
    parked = _pages(engine, [30])
    # no host wait after the sleep: the index is on the card already and
    # the fill's value is a kernel argument
    idx = torch.tensor(victim, device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # the stream is busy ~0.1 s
    engine._swap_out_copy(list(zip(victim, host)))
    for pool in (engine.k_pages, engine.v_pages):
        pool.index_fill_(1, idx, 7.0)  # reallocated and written
    engine._swap_in_copy([(20, 6)])  # lands on a page just freed
    engine._swap_out_copy([(40, 20)])  # reuses the host page just read
    torch.cuda.synchronize()
    for got, w in zip(_host(engine, host), before):
        assert torch.equal(got.to(cuda), w)
    for got, w in zip(_pages(engine, [6]), parked):
        assert torch.equal(got, w)
    for got, w in zip(_host(engine, [20]), _pages(engine, [40])):
        assert torch.equal(got.to(cuda), w)


@pytest.mark.gpu
def test_cuda_speculative_swap_out_is_in_flight(cuda):
    """A speculative issue copies on the side stream after the pages' last
    write on the current stream, and is still in flight when the issue
    returns (the current stream is busy); once the step joins it, writes to
    the pages no longer reach the host copy. Neither half synchronises the
    host."""
    engine = _mover_engine(cuda)
    pages, host = [8, 9, 10, 11], [0, 1, 2, 3]
    idx = torch.tensor(pages, device=cuda)  # as above
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for pool in (engine.k_pages, engine.v_pages):
        pool.index_fill_(1, idx, 3.0)  # the victim's last write
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._swap_out_issue(list(zip(pages, host)))
        assert len(engine._in_flight) == 1
        assert not engine._in_flight[0].query(), "the copy did not wait"
        engine._join_swaps()
        engine._swap_out_complete(list(zip(pages, host)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for pool in (engine.k_pages, engine.v_pages):
        pool.index_fill_(1, idx, -1.0)  # the next owner, after the complete
    torch.cuda.synchronize()
    assert engine.swapped_out == 1 and not engine._in_flight
    for got in _host(engine, host):
        assert bool((got == 3.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [dict(swap_mode="swap"),
                                  dict(swap_mode="swap",
                                       speculative_swap=True)],
                         ids=["swap", "speculative"])
def test_cuda_swap_engine_matches_cpu_engine(cuda, mode):
    """Smoke h2o-danube-1.8b without its window, float32, under the
    reference's crunch (8 pages of 8, 2 slots, 16 host pages): the card
    swaps and resumes without recomputing, and its greedy tokens equal
    the CPU engine's but at a near-tie of ``Model.forward`` (2**-7 of the
    largest |logit|; comparing that request stops there)."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.core.scheduling.request import Request
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              sliding_window=None, dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist()
               for _ in range(2)]
    runs = {}
    for dev in ("cpu", cuda):
        engine = PagedEngine(cfg, _to(params, dev), EngineConfig(
            num_pages=8, page_size=8, max_slots=2, host_pages=16, **mode),
            device=dev)
        reqs = [Request(i, 0.0, list(p), max_new_tokens=20)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.add_request(r)
        engine.run_to_completion()
        assert engine.swapped_out == engine.swapped_in > 0
        assert engine.preemptions == 0
        a = engine.allocator
        assert a.num_free == a.num_blocks and a.swapped_pages == 0
        assert a.pending_out_pages == 0
        runs[str(dev)] = [r.full_output for r in reqs]
    model = Model(cfg)
    for prompt, a, b in zip(prompts, runs["cpu"], runs[str(cuda)]):
        for i, (x, y) in enumerate(zip(a, b)):
            if x == y:
                continue
            logits, _ = model.forward(params, torch.tensor([prompt + a[:i]]))
            last = logits[0, -1, :cfg.vocab_size]
            top = torch.topk(last, 2).values
            assert top[0] - top[1] < 2.0 ** -7 * last.abs().max(), (i, x, y)
            break


# a train step on the card against the CPU's, from the same float32
# weights: the loss as tests/test_torch_train_grads.py holds it (2e-5), the
# gradient norm and the parameters as tests/test_torch_training.py holds a
# float32 step (1e-3; within 2 lr (1 + wd |p|) everywhere, beyond 0.1 lr on
# at most 1%)
TRAIN_FAMILIES = ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                  "deepseek-v2-236b", "mamba2-1.3b", "hymba-1.5b",
                  "seamless-m4t-medium", "internvl2-26b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_cuda_train_step_matches_cpu_and_launches_no_kernel(cuda, arch):
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              logits_fp32=True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.num_media_tokens:
        batch["media"] = (rng.standard_normal(
            (2, cfg.num_media_tokens, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    if cfg.is_encdec:
        batch["encoder_tokens"] = rng.integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(Model(cfg), ocfg)
    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda, copy=True), cpu)
    counts = (flash_prefill.launches, paged_attention.launches,
              ssd_scan.launches)
    gpu, _, gm = step(gpu, optimizer.init(gpu),
                      {k: torch.from_numpy(v).to(cuda)
                       for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (flash_prefill.launches, paged_attention.launches,
            ssd_scan.launches) == counts
    cpu, _, cm = step(cpu, optimizer.init(cpu),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(gm["grad_norm"]),
                               float(cm["grad_norm"]), rtol=1e-3)
    lr = float(cm["lr"])
    far = total = 0
    for g, c in zip(leaves(gpu), leaves(cpu)):
        d = (g.cpu() - c).abs()
        assert (d <= 2 * lr * (1 + ocfg.weight_decay * c.abs()) * (1 + 2e-4)
                + 1e-7).all()
        far += int((d > 0.1 * lr).sum())
        total += d.numel()
    assert far <= 0.01 * total, (far, total)


# -- the mesh on one card: a one-rank NCCL group ------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group and its (1, 1) ``("data", "model")`` mesh;
    the group is destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    init_distributed(cuda)
    try:
        yield make_host_mesh(1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_one_rank_mesh_train_step_equals_plain(nccl_mesh):
    """Smoke danube in float32 on the card: one ``make_train_step`` under a
    ``MeshPolicy`` with DTensor parameters and batch on the one-rank NCCL
    mesh against the plain step from the same weights: loss and grad_norm
    within 1e-6 relative (one rank splits no sum), every updated parameter
    within 1e-6 of the largest; no kernel launches."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    plain = init_params(cfg, seed=2, device=dev)
    sharded = shd.distribute(tree_map(lambda t: t.clone(), plain),
                             shd.param_specs(plain, nccl_mesh, cfg),
                             nccl_mesh)
    counts = (flash_prefill.launches, paged_attention.launches,
              ssd_scan.launches)
    plain, _, pm = make_train_step(Model(cfg), ocfg)(
        plain, optimizer.init(plain), batch)
    policy = shd.MeshPolicy(nccl_mesh, cfg)
    sharded, _, sm = make_train_step(Model(cfg), ocfg, policy)(
        sharded, optimizer.init(sharded),
        shd.distribute(batch, shd.batch_specs(batch, nccl_mesh, cfg),
                       nccl_mesh))
    torch.cuda.synchronize()
    assert (flash_prefill.launches, paged_attention.launches,
            ssd_scan.launches) == counts
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(sm[k]), float(pm[k]), rtol=1e-6)
    for s, p in zip(leaves(sharded), leaves(plain)):
        s = s.full_tensor()
        assert s.shape == p.shape
        assert float((s - p).abs().max()) <= 1e-6 * max(
            float(p.abs().max()), 1e-30)


@pytest.mark.gpu
def test_cuda_dist_attention_on_one_rank_mesh(nccl_mesh):
    """``dist_attention`` on the one-rank NCCL mesh against
    ``dist_attention_ref`` (float32 on the same bf16 inputs, 4096 keys,
    lengths 1 / 100 / 4096 / 2049): within 1e-4."""
    from repro_torch.core.distkv.dist_attention import (dist_attention,
                                                        dist_attention_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(torch.bfloat16)

    q, k, v = t(4, 32, 128), t(4, 4096, 8, 128), t(4, 4096, 8, 128)
    lens = torch.tensor([1, 100, 4096, 2049], dtype=torch.int32, device=dev)
    got = dist_attention(nccl_mesh, q, k, v, lens).to_local()
    want = dist_attention_ref(q, k, v, lens)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_cuda_sample_draws_from_the_top_k_softmax(cuda):
    """``sampling.sample`` on the card with a CUDA generator: greedy rows
    equal the CPU's; draws lie in the top-k set, ties at the k-th value
    kept and drawn; at temperature 0.7 the frequencies of 40,000 draws lie
    within five binomial standard deviations (+1e-4) of softmax(logits /
    T) over the filtered logits (``tests/test_torch_engine_stats.py``'s
    bound on the CPU)."""
    from repro_torch.models.sampling import sample

    rng = np.random.default_rng(3)
    x = np.round(rng.standard_normal((6, 40)) * 2).astype(np.float32)
    x[0] = -4.0
    x[0, :5] = 1.0  # 5 tokens tie at the 3rd value
    xc = torch.from_numpy(x).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    assert torch.equal(sample(xc, gen, temperature=0.0).cpu(),
                       sample(torch.from_numpy(x), None, temperature=0.0))
    kth = np.sort(x, axis=1)[:, -3:-2]
    allowed = x >= kth
    rows = np.arange(6)
    drawn = np.zeros_like(allowed)
    for _ in range(300):
        tok = sample(xc, gen, temperature=1.5, top_k=3).cpu().numpy()
        assert allowed[rows, tok].all()
        drawn[rows, tok] = True
    assert (drawn[0] == allowed[0]).all()
    t, n = 0.7, 40_000
    z = torch.from_numpy(x[1]) / t
    p = torch.softmax(z.masked_fill(z < torch.topk(z, 5).values[-1],
                                    float("-inf")), 0).double().numpy()
    tok = sample(xc[1:2].expand(n, -1).contiguous(), gen, temperature=t,
                 top_k=5).cpu().numpy()
    freq = np.bincount(tok, minlength=x.shape[1]) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4).all()


@pytest.mark.gpu
def test_cuda_engine_stats_equal_cpu_engine(cuda):
    """``kv_utilization()`` and ``prefix_cache_stats()`` of a prefix-cache
    engine on the card equal the CPU engine's after every step, on
    ``tests/test_prefix_cache.py``'s 8 sessions over a 2-page system
    prompt (smoke danube without its window, float32); the card's engine
    launches both attention kernels."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.core.scheduling.request import Request
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = dataclasses.replace(smoke_config("h2o-danube-1.8b"),
                              dtype="float32", logits_fp32=True,
                              sliding_window=None)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    system = rng.integers(0, 512, 16).tolist()
    prompts = [system + rng.integers(0, 512, 6).tolist() for _ in range(8)]
    engines = [PagedEngine(cfg, _to(params, dev), EngineConfig(
        num_pages=64, page_size=8, max_slots=4, enable_prefix_cache=True),
        device=dev) for dev in ("cpu", cuda)]
    before = (paged_attention.launches, flash_prefill.launches)
    for i, p in enumerate(prompts):
        for e in engines:
            e.add_request(Request(i, 0.0, list(p), max_new_tokens=4))
        while any(e.has_work for e in engines):
            for e in engines:
                e.step()
            a, b = engines
            assert b.kv_utilization() == a.kv_utilization()
            assert b.prefix_cache_stats() == a.prefix_cache_stats()
    assert engines[1].prefix_cache_stats()["hit_tokens"] == 7 * 16
    assert paged_attention.launches > before[0]
    assert flash_prefill.launches > before[1]
