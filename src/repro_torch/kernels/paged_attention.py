"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py: paged_attention``).

The kernel splits each context into runs of ``SPLIT_TOKENS`` tokens, one
block each, and merges the runs' partials on the card; the wrapper
allocates their scratch. It dispatches by the device of its tensors. CPU
tensors take the plain version (``kernels.ref.paged_attention``); CUDA
tensors launch the kernel or raise: there is no fallback from one to the
other. On every device it raises where autograd would record the call
(``_build.refuse_grad``): the kernel has no backward. Each call that launches adds one to ``paged_attention.launches``,
and one that also returns the partials ``(m, l)`` (the zero-copy decode's
calls) to ``paged_attention.partial_launches`` too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # four head dims a lane, two quads: 4 x 32 lanes x 2
SPLIT_TOKENS = 256  # context tokens per block (rounded to whole pages)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, p, p,
                       i32, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64,
                       i32, i32, i32, ctypes.c_float, i32, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_devices(q, k_pages, v_pages, block_tables, context_lens):
    d = q.get_device()  # -1 off the card: then compare the whole device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.get_device() != d or (d < 0 and t.device != q.device):
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def _check(q, k_pages, v_pages, block_tables, context_lens, page_size):
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"paged_attention: unsupported dtype {dtype}")
    if k_pages.dtype != dtype or v_pages.dtype != dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        f"a dtype, got {dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    qs, ks = q.shape, k_pages.shape
    if len(qs) != 3 or not q.is_contiguous():
        raise ValueError("paged_attention: q must be a contiguous (B, H, Dh)")
    b, h, dh = qs
    if len(ks) != 4 or ks != v_pages.shape:
        raise ValueError("paged_attention: pools must be (P, ps, Hkv, Dh) "
                         f"of one shape, got {tuple(ks)} and "
                         f"{tuple(v_pages.shape)}")
    _, ps, hkv, dhk = ks
    if ps != page_size or dhk != dh:
        raise ValueError(f"paged_attention: pool pages {ps}x{dhk}, expected "
                         f"{page_size}x{dh}")
    if h % hkv:
        raise ValueError(f"paged_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: Dh={dh} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    if k_pages.stride(3) != 1 or v_pages.stride(3) != 1:
        raise ValueError("paged_attention: pools need a unit head_dim stride")
    bs = block_tables.shape
    if block_tables.dtype != torch.int32 or len(bs) != 2 or bs[0] != b \
            or block_tables.stride(1) != 1:
        raise ValueError("paged_attention: block_tables must be (B, n) int32 "
                         "with unit column stride")
    if context_lens.dtype != torch.int32 or context_lens.shape != (b,) \
            or not context_lens.is_contiguous():
        raise ValueError("paged_attention: context_lens must be a contiguous "
                         "(B,) int32")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    page_size: int, window: Optional[int] = None,
                    return_partials: bool = False,
                    out: Optional[torch.Tensor] = None):
    """Decode attention over a paged KV cache. Arguments and results as
    :func:`repro_torch.kernels.ref.paged_attention`; ``out``, where given,
    receives the result (a contiguous tensor of q's shape, dtype and
    device) and is returned in its place.

    On CUDA: q, the pools and the output share one dtype (float32 or
    bfloat16); the pools may be any strided view with a unit head_dim
    stride (a layer slice of the engine's ``(L, P+1, ps, Hkv, Dh)`` pool
    is read in place). Every block-table entry below ``ceil(ctx / ps)``
    must be a valid page of the pool; the kernel reads no other entry.
    """
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
    _build.refuse_dtensor("paged_attention", q, k_pages, v_pages)
    _check_devices(q, k_pages, v_pages, block_tables, context_lens)
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window must be >= 1, got "
                         f"{window}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError("paged_attention: out must be a contiguous tensor "
                         f"of q's shape, dtype and device, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if q.is_cpu:
        res = ref.paged_attention(q, k_pages, v_pages, block_tables,
                                  context_lens, page_size=page_size,
                                  window=window,
                                  return_partials=return_partials)
        if out is None:
            return res
        if return_partials:
            return (out.copy_(res[0]),) + res[1:]
        return out.copy_(res)
    if not q.is_cuda:
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens, page_size)
    b, h, dh = q.shape
    if out is None:
        out = torch.empty_like(q)
    split = max(1, SPLIT_TOKENS // page_size) * page_size
    splits = max(1, -(-block_tables.shape[1] * page_size // split))
    # one float32 scratch: the returned m and l, then per split the
    # unnormalised o (Dh floats), m and l of every row
    n_ml = 2 * b * h if return_partials else 0
    n_part = b * h * splits * (dh + 2) if splits > 1 else 0
    m = l = m_ptr = l_ptr = part_ptr = None
    if n_ml + n_part:
        scratch = torch.empty(n_ml + n_part, dtype=torch.float32,
                              device=q.device)
        ptr = scratch.data_ptr()
        if return_partials:
            m, l = scratch[:b * h].view(b, h), scratch[b * h:n_ml].view(b, h)
            m_ptr, l_ptr = ptr, ptr + 4 * b * h
        if n_part:
            part_ptr = ptr + 4 * n_ml
    if b:
        lib = _lib()
        ks, vs = k_pages.stride(), v_pages.stride()
        err = _build.call(
            lib.paged_attention_fwd, q.get_device(),
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            out.data_ptr(), m_ptr, l_ptr, part_ptr,
            b, h, k_pages.shape[2], dh, page_size, k_pages.shape[0],
            ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            block_tables.stride(0), window or 0, split, splits,
            1.0 / dh ** 0.5, _DTYPES[q.dtype])
        if err != 0:
            msg = lib.paged_attention_error_string(err).decode()
            raise RuntimeError(f"paged_attention kernel launch failed: "
                               f"error {err} ({msg})")
        paged_attention.launches += 1
        paged_attention.partial_launches += return_partials
    if return_partials:
        return out, m, l
    return out


paged_attention.launches = 0
paged_attention.partial_launches = 0
