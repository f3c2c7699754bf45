"""Mamba2 SSD chunked scan: wrapper of the CUDA kernel ``csrc/ssd_scan.cu``
(replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py: ssd_scan``).

The wrapper dispatches by the device of its tensors. CPU tensors take the
plain version (``kernels.ref.ssd_scan``); CUDA tensors launch the kernel or
raise: there is no fallback from one to the other. Each launch adds one to
``ssd_scan.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64  # P: the kernel's y tile
MAX_STATE = 128  # N: the kernel's state-update tile


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                       i32, i32, i64, i64, i64, i64, i32, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B, C):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B and C must share a dtype of "
                        f"float32 or bfloat16, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if dt.shape != (b, l, h) or not dt.is_contiguous() or \
            A.shape != (h,) or not A.is_contiguous():
        raise ValueError("ssd_scan: dt must be a contiguous (b, l, h) and A "
                         "a contiguous (h,)")
    if B.shape != C.shape or B.shape[:2] != (b, l) or B.stride() != \
            C.stride():
        raise ValueError("ssd_scan: B and C must be (b, l, g, n) views of "
                         "one shape and layout")
    if g < 1 or h % g or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: needs h % g == 0, p <= {MAX_HEAD_DIM} "
                         f"and n <= {MAX_STATE}; got h={h}, g={g}, p={p}, "
                         f"n={n}")
    # the kernel takes batch and sequence strides; heads and the last dim
    # must be dense (slices of a projection's last axis are)
    if x.stride(3) != 1 or x.stride(2) != p or B.stride(3) != 1 or \
            B.stride(2) != n:
        raise ValueError("ssd_scan: x and B/C need dense trailing (heads, "
                         "dim) axes")


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """SSD chunked scan. Arguments and results as
    :func:`repro_torch.kernels.ref.ssd_scan`: y (b, l, h, p) float32 and the
    final state (b, h, p, n) float32. Raises when ``l % chunk != 0``.

    On CUDA: x, B and C share one dtype (float32 or bfloat16) and may be
    views with dense trailing (heads, dim) axes (a slice of the conv
    output is read in place); p <= 64 and n <= 128.
    """
    b, l, h, p = x.shape
    n = B.shape[3]
    if chunk < 1 or l % chunk:
        raise ValueError(f"ssd_scan: sequence {l} is not a multiple of "
                         f"chunk {chunk}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return ref.ssd_scan(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    _check(x, dt, A, B, C)
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    if not (b and l and h):
        return y, torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device)
    # the kernel writes all of the state; the bf16 form chains it from
    # chunk to chunk through per-(b, h) flags and a ticket, zeroed here
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    sync = torch.zeros(b * h + 1, dtype=torch.int32, device=x.device) \
        if x.dtype == torch.bfloat16 else None
    lib = _lib()
    err = _build.call(
        lib.ssd_scan_fwd, x.get_device(),
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if sync is None else sync.data_ptr(), b, l, h, p,
        B.shape[2], n, chunk, x.stride(0), x.stride(1), B.stride(0),
        B.stride(1), _DTYPES[x.dtype])
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
