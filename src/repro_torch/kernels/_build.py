"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/<name>-<hash>.so`` at the root of
the checkout (``build/`` is git-ignored). The hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and a stale library is never loaded. Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_RAW_STREAM = []  # torch's getter of a device's current cudaStream_t


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def _paths(name: str) -> Tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    # the shared headers of csrc/ count as part of every source
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so", \
        BUILD_DIR / f"{name}-{digest}.log"


def build(name: str) -> str:
    """Build kernel ``name`` unless it is built already. Returns the
    compiler output (registers, shared memory and spills from
    ``-Xptxas -v``); raises if the build fails."""
    src, lib, log = _paths(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.write_text(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib


def _raw_stream(device: int) -> int:
    if not _RAW_STREAM:
        # the raw handle without a Stream object: the getter torch's own
        # generated kernels use, where this build of torch has it
        _RAW_STREAM.append(getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda d: torch.cuda.current_stream(d).cuda_stream))
    return _RAW_STREAM[0](device)


def refuse_grad(fn: str, *tensors) -> None:
    """Raise if autograd would record a call of kernel wrapper ``fn``. A
    kernel writes into outputs that carry no graph, so a gradient through
    it would be silently dropped; the check is the same on every device,
    so the CPU's differentiable plain versions cannot hide a training path
    that reaches a wrapper. Training runs the plain ops of
    ``repro_torch.models`` (``blockwise_attention``, ``ssd_chunked``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{fn}: the kernel has no backward; call it "
                           "under torch.no_grad() or with inputs that do "
                           "not require grad")


def refuse_dtensor(fn: str, *tensors) -> None:
    """Raise for a DTensor argument of kernel wrapper ``fn``, on every
    device. A kernel reads one device's memory through raw pointers: a
    sharded tensor's pointer is one shard, so the call would compute on
    a shard as if it were the whole. The mesh paths (a ``MeshPolicy``)
    run the plain versions instead; nothing falls back here."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{fn}: a DTensor argument; the kernel takes one "
                        "device's tensors (a mesh runs the plain path: "
                        "blockwise_attention, ssd_chunked)")


def call(fn, device: int, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and then the current
    stream of CUDA device ``device``, with that device current (a kernel
    launches on the current device). Returns what ``fn`` returns."""
    if torch.cuda.current_device() != device:
        with torch.cuda.device(device):
            return fn(*args, _raw_stream(device))
    return fn(*args, _raw_stream(device))
