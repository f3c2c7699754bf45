"""The host side of a configuration's deployment: its ``host`` key.

    "host": {"intra_op_threads": 1, "engine_core": "last"}

``intra_op_threads`` is the CPU thread count of the serving process's
math libraries (OpenMP, MKL, OpenBLAS and PyTorch's intra-op pool), set
before ``torch`` is imported. ``engine_core`` pins the thread that drives
the engine to one CPU core for the traffic: ``"last"`` is the highest core
the process may use. A configuration without the key runs at the
libraries' defaults. This module imports nothing but the standard
library, so that ``run.py`` can apply the threads before ``torch`` loads.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Set

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def settings(root: Path, workload: str) -> dict:
    """The ``host`` key of the configuration that ``workload`` runs, read
    from ``BENCHMARK.json`` and the configuration's file alone."""
    root = Path(root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(c for c in doc["workloads"] if c["name"] == workload)
    entry = next(c for c in doc["configs"] if c["name"] == cell["config"])
    return json.loads((root / entry["file"]).read_text()).get("host", {})


def set_thread_env(host: dict) -> None:
    """Before ``torch`` is imported: the libraries' thread counts."""
    n = host.get("intra_op_threads")
    if n is not None:
        for var in THREAD_VARS:
            os.environ[var] = str(int(n))


def set_torch_threads(host: dict) -> None:
    n = host.get("intra_op_threads")
    if n is not None:
        import torch
        torch.set_num_threads(int(n))


def pin(host: dict) -> Optional[Set[int]]:
    """Pins the calling thread to the configured core; returns the cores
    it was allowed before (for :func:`unpin`), or None where nothing is
    pinned."""
    core = host.get("engine_core")
    if core is None or not hasattr(os, "sched_setaffinity"):
        return None
    before = os.sched_getaffinity(0)
    if core != "last":
        raise ValueError(f"engine_core {core!r}: only 'last' is known")
    os.sched_setaffinity(0, {max(before)})
    return before


def unpin(before: Optional[Set[int]]) -> None:
    if before is not None:
        os.sched_setaffinity(0, before)
