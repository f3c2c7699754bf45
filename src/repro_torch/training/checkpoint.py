"""Checkpoints in the reference's layout and bytes
(``repro.training.checkpoint``): ``<dir>/step_<n:08d>/ckpt.msgpack`` and a
``manifest.json``. The payload is ``{"leaves": [{"dt", "shape", "data"},
...]}`` over the tree's leaves in ``jax.tree.flatten`` order
(:mod:`repro_torch.training.tree`): ``dt`` the numpy ``dtype.str`` (or
``"bfloat16"``, whose data are the ``uint16`` bits), ``shape`` a list of
ints, ``data`` the raw bytes. A checkpoint written by either package
restores in the other, and both write the same bytes.

msgpack itself is not a dependency of the port: :func:`packb` /
:func:`unpackb` encode and decode the subset the reference writes (maps,
arrays, str, bin and non-negative ints), each in the smallest form, as
``msgpack.packb(..., use_bin_type=True)`` chooses.

A tree of DTensors (a mesh's parameters) is saved whole: every rank
gathers each leaf and rank 0 writes the same bytes as one device would.
:func:`restore` lays a leaf out as the DTensor in its place in ``like``
is, each rank keeping its slice.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.training.tree import leaves, unflatten


# -- the msgpack subset -------------------------------------------------------

def _head(n: int, fix: Optional[int], fix_max: int, forms) -> bytes:
    """The header of a value of length ``n``: the fix form where it fits,
    else the first ``(code, struct format, max)`` of ``forms`` that does."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, most in forms:
        if n <= most:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


_U8, _U16, _U32 = 0xff, 0xffff, 0xffffffff


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack subset: cannot pack {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"msgpack subset: negative int {obj}")
        out.append(_head(obj, 0x00, 0x7f, [
            (0xcc, ">B", _U8), (0xcd, ">H", _U16), (0xce, ">I", _U32),
            (0xcf, ">Q", 2 ** 64 - 1)]))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_head(len(raw), 0xa0, 31, [
            (0xd9, ">B", _U8), (0xda, ">H", _U16), (0xdb, ">I", _U32)]))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_head(len(raw), None, 0, [
            (0xc4, ">B", _U8), (0xc5, ">H", _U16), (0xc6, ">I", _U32)]))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, [(0xdc, ">H", _U16),
                                              (0xdd, ">I", _U32)]))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, [(0xde, ">H", _U16),
                                              (0xdf, ">I", _U32)]))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` (dicts in their order, lists, str, bytes, ints >= 0) as
    ``msgpack.packb(obj, use_bin_type=True)`` encodes it."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# code -> (kind, struct format of the length or value)
_CODES = {0xcc: ("int", ">B"), 0xcd: ("int", ">H"), 0xce: ("int", ">I"),
          0xcf: ("int", ">Q"), 0xd9: ("str", ">B"), 0xda: ("str", ">H"),
          0xdb: ("str", ">I"), 0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"),
          0xc6: ("bin", ">I"), 0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack(buf, i: int):
    code = buf[i]
    i += 1
    if code <= 0x7f:
        return code, i
    if 0x80 <= code <= 0x8f:
        kind, n = "map", code & 0x0f
    elif 0x90 <= code <= 0x9f:
        kind, n = "array", code & 0x0f
    elif 0xa0 <= code <= 0xbf:
        kind, n = "str", code & 0x1f
    elif code in _CODES:
        kind, fmt = _CODES[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack subset: unsupported code {code:#x}")
    if kind == "int":
        return n, i
    if kind in ("str", "bin"):
        raw = bytes(buf[i:i + n])
        return (raw.decode() if kind == "str" else raw), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """The object :func:`packb` (or the reference's msgpack) encoded."""
    buf = memoryview(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack subset: {len(buf) - end} trailing bytes")
    return obj


# -- leaves -------------------------------------------------------------------

def _pack_leaf(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"dt": "bfloat16", "shape": list(t.shape),
                "data": t.view(torch.int16).numpy().tobytes()}
    x = t.numpy()
    return {"dt": x.dtype.str, "shape": list(x.shape), "data": x.tobytes()}


def _unpack_leaf(d: dict, device) -> torch.Tensor:
    if d["dt"] == "bfloat16":
        arr = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16) \
            .to(device)
    arr = np.frombuffer(d["data"], np.dtype(d["dt"])).reshape(d["shape"])
    return torch.from_numpy(arr.copy()).to(device)


def save(path: str, step: int, tree: Any) -> str:
    """Write ``tree``'s leaves as step ``step`` under ``path``; returns the
    step's directory."""
    d = os.path.join(path, f"step_{step:08d}")
    flat = [t.full_tensor() if isinstance(t, DTensor) else t
            for t in leaves(tree)]
    ranks = dist.is_initialized()
    if not ranks or dist.get_rank() == 0:
        os.makedirs(d, exist_ok=True)
        payload = packb({"leaves": [_pack_leaf(t) for t in flat]})
        with open(os.path.join(d, "ckpt.msgpack"), "wb") as f:
            f.write(payload)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(flat)}, f)
    if ranks:
        dist.barrier()  # no rank reads it before it is whole
    return d


def latest_step(path: str) -> Optional[int]:
    """The largest step saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(path)
             if n.startswith("step_")]
    return max(steps) if steps else None


def restore(path: str, step: int, like: Any) -> Any:
    """Step ``step`` under ``path`` as a tree of ``like``'s structure, each
    leaf on the device of ``like``'s leaf in its place (a DTensor leaf's
    mesh and placements)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "ckpt.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    like_leaves = leaves(like)
    if len(payload["leaves"]) != len(like_leaves):
        raise ValueError(f"restore: the checkpoint holds "
                         f"{len(payload['leaves'])} leaves, the tree "
                         f"{len(like_leaves)}")
    out = []
    for p, t in zip(payload["leaves"], like_leaves):
        leaf = _unpack_leaf(p, t.device)
        if isinstance(t, DTensor):
            from repro_torch.launch.sharding import shard_tensor
            leaf = shard_tensor(leaf, t.device_mesh, t.placements)
        out.append(leaf)
    return unflatten(like, out)
