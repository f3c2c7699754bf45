"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the
cell asks for (``BENCHMARK.json``: ``workloads``). One run builds the
port's serving engine for the cell's configuration, draws its weights on
the device from ``--seed``, warms up, serves the cell's traffic through
``LLMService`` for a warm-up and then for ``--seconds``, checks the served
tokens against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiled stretch of the window), ``device`` and, traced, a
``breakdown``; its last key, ``check``, holds each number compared with
its limit, which also end standard error. Without enough CUDA cards, or
if the run loaded JAX or the JAX package, it exits non-zero and prints no
result. See ``perfbench/harness.py`` for what a run does, and PERF.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of pure-Python work: the host's speed
    beside each run's numbers (this cell's pace is the host's)."""
    t = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return 1e3 * (time.perf_counter() - t)


def _finite(x):
    """JSON has no infinity: an unmet number prints as 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import host
    deployment = host.settings(ROOT, args.workload)
    host.set_thread_env(deployment)  # before torch loads

    import torch
    from perfbench.harness import Bench, run_cell
    host.set_torch_threads(deployment)

    chips = Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = _card()
    print(f"perfbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr, flush=True)
    probe = [host_probe_ms()]
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START)
    probe.append(host_probe_ms())
    if out["leaked_modules"]:
        print("perfbench: the run loaded " + ", ".join(out["leaked_modules"]),
              file=sys.stderr)
        return 3
    del out["leaked_modules"]
    out["card"] = card
    out["host_probe_ms"] = probe
    out["check"] = out.pop("check")  # last, as the result's own key
    from perfbench.check import stderr_lines
    for line in stderr_lines(out["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
