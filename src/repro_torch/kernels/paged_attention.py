"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py: paged_attention``).

The wrapper dispatches by the device of its tensors. CPU tensors take the
plain version (``kernels.ref.paged_attention``); CUDA tensors launch the
kernel or raise: there is no fallback from one to the other. Each launch
adds one to ``paged_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, p,
                       i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64,
                       i32, ctypes.c_float, i32, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_devices(q, k_pages, v_pages, block_tables, context_lens):
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")


def _check(q, k_pages, v_pages, block_tables, context_lens, page_size):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        f"a dtype, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("paged_attention: q must be a contiguous (B, H, Dh)")
    b, h, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_attention: pools must be (P, ps, Hkv, Dh) "
                         f"of one shape, got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    _, ps, hkv, dhk = k_pages.shape
    if ps != page_size or dhk != dh:
        raise ValueError(f"paged_attention: pool pages {ps}x{dhk}, expected "
                         f"{page_size}x{dh}")
    if h % hkv:
        raise ValueError(f"paged_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError("paged_attention: pools need a unit head_dim stride")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b or block_tables.stride(1) != 1:
        raise ValueError("paged_attention: block_tables must be (B, n) int32 "
                         "with unit column stride")
    if context_lens.dtype != torch.int32 or context_lens.shape != (b,) \
            or not context_lens.is_contiguous():
        raise ValueError("paged_attention: context_lens must be a contiguous "
                         "(B,) int32")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    page_size: int, window: Optional[int] = None,
                    return_partials: bool = False):
    """Decode attention over a paged KV cache. Arguments and results as
    :func:`repro_torch.kernels.ref.paged_attention`.

    On CUDA: q, the pools and the output share one dtype (float32 or
    bfloat16); the pools may be any strided view with a unit head_dim
    stride (a layer slice of the engine's ``(L, P+1, ps, Hkv, Dh)`` pool
    is read in place). Every block-table entry below ``ceil(ctx / ps)``
    must be a valid page of the pool; the kernel reads no other entry.
    """
    _check_devices(q, k_pages, v_pages, block_tables, context_lens)
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window must be >= 1, got "
                         f"{window}")
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   context_lens, page_size=page_size,
                                   window=window,
                                   return_partials=return_partials)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens, page_size)
    b, h, dh = q.shape
    out = torch.empty_like(q)
    m = l = None
    if return_partials:
        m = torch.empty((b, h), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if b:
        lib = _lib()
        hkv = k_pages.shape[2]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.paged_attention_fwd(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), m.data_ptr() if m is not None else None,
                l.data_ptr() if l is not None else None,
                b, h, hkv, dh, page_size,
                k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
                v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
                block_tables.stride(0), window or 0,
                1.0 / dh ** 0.5, _DTYPES[q.dtype], stream)
        if err != 0:
            msg = lib.paged_attention_error_string(err).decode()
            raise RuntimeError(f"paged_attention kernel launch failed: "
                               f"CUDA error {err} ({msg})")
        paged_attention.launches += 1
    if return_partials:
        return out, m, l
    return out


paged_attention.launches = 0
