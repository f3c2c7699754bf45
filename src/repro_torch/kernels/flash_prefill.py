"""Prefill attention: wrappers of the CUDA kernel ``csrc/flash_prefill.cu``
(replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py:
flash_prefill``).

Two entry points of one kernel:

* :func:`flash_prefill` is the TPU kernel's function on contiguous K/V
  (a float32 softmax with unrounded probabilities; in bf16 the kernel
  rounds them once, for their product with V);
* :func:`prefill_attention_paged` is one prefill chunk of the serving
  engine: it reads K/V in place from a per-layer pool slice through the
  chunk's page ids, with the numerics of ``blockwise_attention`` (bf16
  rounding of q, k, v and the normalised probabilities).

:func:`prefill_attention` is ``Model.prefill``'s full-sequence attention
on the second entry point's body: the batch's K/V (B, Skv, Hkv, Dh) is
read in place as a pool of B pages of Skv tokens, one launch per sequence
over its own page, so any length is taken. It is causal self-attention
(Skv = S) or attention over all Skv keys: an encoder's self-attention and
a decoder's cross-attention over the encoder's positions.

Each dispatches by the device of its tensors. CPU tensors take the plain
version (``kernels.ref``); CUDA tensors launch the kernel or raise: there
is no fallback from one to the other. On every device each raises where
autograd would record the call (``_build.refuse_grad``): the kernel has no
backward. Each launch, through any entry
point, adds one to ``flash_prefill.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128  # the kernel's output tile
MAX_GROUP = 64  # query heads per KV head: one 64-row tile


def _lib():
    lib = _build.load("flash_prefill")
    if lib.flash_prefill_paged.argtypes is None:
        p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
            ctypes.c_float
        lib.flash_prefill_contiguous.argtypes = [
            p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32,
            i64, i64, i64, i64, i64, i64, f32, i32, p]
        lib.flash_prefill_paged.argtypes = [
            p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, i64, i64, i64, i64, i64, i64, f32, i32, p]
        lib.flash_prefill_contiguous.restype = ctypes.c_int
        lib.flash_prefill_paged.restype = ctypes.c_int
        lib.flash_prefill_error_string.argtypes = [ctypes.c_int]
        lib.flash_prefill_error_string.restype = ctypes.c_char_p
    return lib


def _same_device(fn, q, **named):
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on "
                             f"{q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {q.device}")


def _check_common(fn, q, k, v):
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"{fn}: q must be a contiguous (B, S, H, Dh)")
    h, dh = q.shape[2], q.shape[3]
    hkv = k.shape[-2]
    if k.shape != v.shape or k.shape[-1] != dh:
        raise ValueError(f"{fn}: k and v must share a shape ending in "
                         f"Dh={dh}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv < 1 or h % hkv or h // hkv > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: needs H % Hkv == 0, H / Hkv <= "
                         f"{MAX_GROUP} and Dh <= {MAX_HEAD_DIM}; got H={h}, "
                         f"Hkv={hkv}, Dh={dh}")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{fn}: k and v need a unit head_dim stride")


def _raise_on(lib, err):
    if err != 0:
        msg = lib.flash_prefill_error_string(err).decode()
        raise RuntimeError(f"flash_prefill kernel launch failed: error "
                           f"{err} ({msg})")


def flash_prefill(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """Flash-attention forward. Arguments and result as
    :func:`repro_torch.kernels.ref.flash_prefill`.

    On CUDA: q contiguous; k and v any strided views with a unit head_dim
    stride; one dtype (float32 or bfloat16) for q, k, v and the output.
    bfloat16 runs the tensor-core body (one pass, the probabilities
    rounded to bfloat16 for P V), float32 the CUDA-core body; one launch
    either way.
    """
    _build.refuse_grad("flash_prefill", q, k, v)
    _build.refuse_dtensor("flash_prefill", q, k, v)
    _same_device("flash_prefill", q, k=k, v=v)
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill: window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return ref.flash_prefill(q, k, v, causal=causal, window=window,
                                 scale=scale)
    _check_common("flash_prefill", q, k, v)
    b, s, h, dh = q.shape
    if k.dim() != 4 or k.shape[0] != b:
        raise ValueError("flash_prefill: k and v must be (B, Skv, Hkv, Dh)")
    out = torch.empty_like(q)
    if q.numel():  # with no keys the kernel writes zeros
        lib = _lib()
        err = _build.call(
            lib.flash_prefill_contiguous, q.get_device(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], dh, k.shape[1], int(causal),
            window or 0, k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / dh ** 0.5 if scale is None else scale, _DTYPES[q.dtype])
        _raise_on(lib, err)
        flash_prefill.launches += 1
    return out


def prefill_attention_paged(q, k_pool, v_pool, page_ids, *, q_offset: int,
                            window: Optional[int] = None,
                            scale: Optional[float] = None):
    """One engine prefill chunk's causal attention over a paged pool.
    Arguments and result as
    :func:`repro_torch.kernels.ref.prefill_attention_paged` (``scale`` the
    softmax scale, 1/sqrt(Dh) where None).

    On CUDA: q a contiguous (1, S, H, Dh); the pools any (P, ps, Hkv, Dh)
    views with a unit head_dim stride (a layer slice of the engine's
    ``(L, P+1, ps, Hkv, Dh)`` pool is read in place); page_ids a contiguous
    int32 (n,) with ``q_offset + S <= n * ps``, every entry a page of the
    pool. Keys are read only at positions ``< q_offset + S``.
    """
    _build.refuse_grad("prefill_attention_paged", q, k_pool, v_pool)
    _build.refuse_dtensor("prefill_attention_paged", q, k_pool, v_pool)
    _same_device("prefill_attention_paged", q, k_pool=k_pool, v_pool=v_pool,
                 page_ids=page_ids)
    if window is not None and window < 1:
        raise ValueError(f"prefill_attention_paged: window must be >= 1, "
                         f"got {window}")
    if q.device.type == "cpu":
        return ref.prefill_attention_paged(q, k_pool, v_pool, page_ids,
                                           q_offset=q_offset, window=window,
                                           scale=scale)
    fn = "prefill_attention_paged"
    _check_common(fn, q, k_pool, v_pool)
    _, s, h, dh = q.shape
    if q.shape[0] != 1 or k_pool.dim() != 4:
        raise ValueError(f"{fn}: q must be (1, S, H, Dh) and the pools "
                         "(P, ps, Hkv, Dh)")
    ps = k_pool.shape[1]
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1 or \
            not page_ids.is_contiguous():
        raise ValueError(f"{fn}: page_ids must be a contiguous (n,) int32")
    if q_offset < 0 or q_offset + s > page_ids.shape[0] * ps:
        raise ValueError(f"{fn}: positions up to {q_offset + s} need "
                         f"{-(-(q_offset + s) // ps)} pages, got "
                         f"{page_ids.shape[0]}")
    out = torch.empty_like(q)
    if s:
        _launch_paged(q, k_pool, v_pool, page_ids, out, q_offset,
                      q_offset + s, True, window, scale)
    return out


def _launch_paged(q, k_pool, v_pool, page_ids, out, q_offset, kv_len,
                  causal, window, scale=None):
    """One launch of the engine form over the first ``kv_len`` keys,
    checked by the caller."""
    lib = _lib()
    _, s, h, dh = q.shape
    ks, vs = k_pool.stride(), v_pool.stride()
    err = _build.call(
        lib.flash_prefill_paged, q.get_device(),
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_ids.data_ptr(), out.data_ptr(), s, h, k_pool.shape[2],
        dh, k_pool.shape[1], k_pool.shape[0], q_offset, kv_len, int(causal),
        window or 0, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        1.0 / dh ** 0.5 if scale is None else scale, _DTYPES[q.dtype])
    _raise_on(lib, err)
    flash_prefill.launches += 1


def prefill_attention(q, k, v, *, window: Optional[int] = None,
                      causal: bool = True, scale: Optional[float] = None):
    """Attention of whole sequences, with ``blockwise_attention``'s
    numerics: causal self-attention (k, v of q's length), or with
    ``causal=False`` attention over every key of k, v of any length Skv.
    Arguments and result as :func:`repro_torch.kernels.ref.
    prefill_attention`. A window is taken with ``causal`` only (nothing
    runs a windowed non-causal attention on this path; the contiguous
    :func:`flash_prefill` computes one).

    On CUDA: q a contiguous (B, S, H, Dh); k and v (B, Skv, Hkv, Dh) with
    a unit head_dim stride. Sequence ``b`` is one launch of the engine
    form with k and v as a pool of B pages of Skv tokens and page ids
    ``[b]``: B launches, no copy of K/V.
    """
    _build.refuse_grad("prefill_attention", q, k, v)
    _build.refuse_dtensor("prefill_attention", q, k, v)
    _same_device("prefill_attention", q, k=k, v=v)
    if window is not None and window < 1:
        raise ValueError(f"prefill_attention: window must be >= 1, got "
                         f"{window}")
    if window is not None and not causal:
        raise ValueError("prefill_attention: a window needs causal=True")
    if k.dim() != 4 or k.shape[0] != q.shape[0] or \
            (causal and k.shape[1] != q.shape[1]):
        raise ValueError(f"prefill_attention: k and v must be (B, "
                         f"{'S' if causal else 'Skv'}, Hkv, Dh) with q's "
                         f"B={q.shape[0]}" + (f" and S={q.shape[1]}"
                                              if causal else "") +
                         f", got {tuple(k.shape)}")
    if q.device.type == "cpu":
        return ref.prefill_attention(q, k, v, window=window, causal=causal,
                                     scale=scale)
    _check_common("prefill_attention", q, k, v)
    b, s = q.shape[:2]
    skv = k.shape[1]
    out = torch.empty_like(q) if skv else torch.zeros_like(q)
    if s and skv:  # with no keys every row is zeros
        pages = torch.arange(b, dtype=torch.int32, device=q.device)
        for i in range(b):
            _launch_paged(q[i:i + 1], k, v, pages[i:i + 1], out[i:i + 1], 0,
                          skv, causal, window, scale)
    return out


flash_prefill.launches = 0
