"""Readings the correctness limits are set from (PERF.md, section 2).

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control <n,n,...>]

One process, one CUDA card: for each seed a whole run of the cell as
``run.py`` makes it (weights, engine, warm-up, traffic, window, check),
printing one JSON line with the numbers the check can compare
(``perfbench.check.readings``) over the served tokens (``served``); for the
seeds in ``--control`` also over the control, the reference on float8
operands in the program's place (``control``), and the control's verdict
by the configuration's limits (``control_correct``, which has to be
false). The process has the configuration's host settings, as ``run.py``
gives it (:mod:`perfbench.host`); the kernels are built once for all
seeds. Every token's gaps and the reference's margins go to
``chiprun_out/calib_<cell>_<seed>.json``. Ends with a line of the largest
served and the smallest control reading of each.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import host
    deployment = host.settings(ROOT, args.workload)
    host.set_thread_env(deployment)  # as run.py, before torch loads
    import torch
    from perfbench.harness import run_cell
    host.set_torch_threads(deployment)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    served, low = [], []
    for seed in seeds + sorted(control - set(seeds)):
        t0 = time.perf_counter()
        rec = {}
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       device="cuda", t_start=time.perf_counter(),
                       control=seed in control, record=rec)
        row = {"seed": seed, "correct": out["correct"],
               "served": out["served_readings"],
               "control": out.get("control_readings"),
               "control_correct": out.get("control_correct"),
               "tokens": out["tokens_compared"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "wall_s": time.perf_counter() - t0}
        dump = ROOT / "chiprun_out" / f"calib_{args.workload}_{seed}.json"
        dump.parent.mkdir(exist_ok=True)
        dump.write_text(json.dumps(rec.get("gaps", {})))
        if seed in seeds:
            served.append(row["served"])
        if seed in control:
            low.append(row["control"])
        print(json.dumps(row), flush=True)
    names = sorted({k for r in served + low for k in r})
    print(json.dumps({"workload": args.workload, "seeds": len(served),
                      "controls": len(low),
                      "served_max": {k: max(r[k] for r in served)
                                     for k in names},
                      "control_min": {k: min(r[k] for r in low)
                                      for k in names} if low else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
