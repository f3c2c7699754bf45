"""Roofline table of the port's dry-run records (the counterpart of
``benchmarks/roofline_report.py``): one row per (arch, input shape) on
the 16 x 16 mesh, the three terms in seconds on the H100 data sheet's
peaks (``repro_torch.roofline.analysis``; not times measured on a card),
the bottleneck, ``useful_flop_frac``, memory per rank, and whether the
2 x 16 x 16 record exists.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--cap 2]
  PYTHONPATH=src python benchmarks/torch_roofline_report.py \\
      [--dir bench_out/torch_dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.dryrun import OUT_DIR


def load(outdir: str = OUT_DIR):
    recs = {}
    for f in glob.glob(os.path.join(outdir, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def run(outdir: str = OUT_DIR, verbose: bool = True):
    recs = load(outdir)
    rows = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            r = recs.get((arch, shape, "16x16"))
            if r is None:
                continue
            if r["status"] == "skipped":
                rows.append(dict(arch=arch, shape=shape, status="skipped"))
                continue
            roof = r["roofline"]
            multi = recs.get((arch, shape, "2x16x16"))
            rows.append(dict(
                arch=arch, shape=shape, status="ok",
                t_comp=roof["t_compute_s"], t_mem=roof["t_memory_s"],
                t_coll=roof["t_collective_s"],
                bottleneck=roof["bottleneck"],
                useful=r.get("useful_flop_frac", float("nan")),
                hbm=r.get("hbm_per_device_gib", float("nan")),
                fits=r.get("fits_80gb"),
                multi_pod_ok=multi is not None and
                multi["status"] in ("ok", "skipped")))
    if verbose:
        hdr = (f"{'arch':24s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
               f"{'t_coll':>9s} {'bound':>10s} {'useful':>7s} "
               f"{'HBM/dev':>8s} fits mp")
        print("H100 data-sheet terms (989 TFLOP/s bf16, 3.35 TB/s, "
              "50 GB/s a link); seconds a step, not measured")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            if r["status"] == "skipped":
                print(f"{r['arch']:24s} {r['shape']:12s} "
                      f"{'(skipped: long-ctx n/a)':>40s}")
                continue
            print(f"{r['arch']:24s} {r['shape']:12s} {r['t_comp']:9.4f} "
                  f"{r['t_mem']:9.4f} {r['t_coll']:9.4f} "
                  f"{r['bottleneck']:>10s} {r['useful']:7.2f} "
                  f"{r['hbm']:7.1f}G {'Y' if r['fits'] else '-':>4s} "
                  f"{'Y' if r['multi_pod_ok'] else '-'}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    run(ap.parse_args().dir)
