"""The CUDA paged-attention kernel against its plain PyTorch version, on
the card. Every test here needs a CUDA device and skips without one (the
kernel has no CPU mode). This file imports no JAX, so it runs on a machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_kernels.py``: float32 2e-5, bfloat16 3e-2; the float32
partials m to 2e-5 and l (a sum of up to a few hundred terms) to 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_attention

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


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
     (2, 4, 4, 80, 8, 6)])
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
