"""Paper Fig. 9 on the port: vLLM (paged) vs Orca (Oracle/Pow2/Max) —
normalized latency vs request rate, ShareGPT- and Alpaca-like workloads,
OPT-13B cost model.

A copy of ``benchmarks/serving_fig9.py`` that imports only ``repro_torch``,
so it runs on a machine without JAX; ``run(...)`` takes the reference's
arguments and returns its rows. The paged system runs through the
LLMService front-end over a SimBackend (the same API the real engine serves
behind); the Orca baselines keep their contiguous-prealloc simulator, which
has no paged backend to front. Every time here is the virtual clock of
``CostModel``'s defaults (the reference's assumed A100-like terms), not a
time measured on any card.

  PYTHONPATH=src python benchmarks/torch_serving_fig9.py
"""

from __future__ import annotations

from repro_torch.serving.api import LLMService
from repro_torch.serving.simulator import (SimBackend, make_workload,
                                           simulate_prealloc)

# memory sized as the reference sizes it, like the paper's A100-40G serving
# OPT-13B: ~13 GB free for KV at ~800 KiB/token -> ~16k token slots
TOKEN_SLOTS = 16_384
BLOCK_SIZE = 16


def run(n_requests: int = 400, verbose: bool = True):
    results = {}
    for dist, rates in (("sharegpt", (2.0, 4.0, 6.0, 8.0, 10.0, 14.0,
                                      18.0, 24.0)),
                        ("alpaca", (8.0, 16.0, 32.0, 48.0, 64.0, 96.0))):
        rows = []
        for rate in rates:
            def wl():
                return make_workload(n_requests, rate=rate, dist=dist,
                                     seed=7)
            row = {"rate": rate}
            svc = LLMService(SimBackend(
                num_blocks=TOKEN_SLOTS // BLOCK_SIZE,
                block_size=BLOCK_SIZE))
            _, stats = svc.replay(wl())
            row["vLLM-paged"] = stats.mean_normalized_latency
            for pol in ("oracle", "pow2", "max"):
                r = simulate_prealloc(wl(), total_slots=TOKEN_SLOTS,
                                      policy=pol)
                row[f"orca-{pol}"] = r.mean_normalized_latency
            rows.append(row)
            if verbose:
                print(f"{dist} rate={rate:5.1f} req/s: " + "  ".join(
                    f"{k}={1e3*v:7.1f}ms" for k, v in row.items()
                    if k != "rate"))
        results[dist] = rows
        if verbose:
            # sustainable rate at a latency SLO, the paper's headline ratio
            slo = 0.040  # 40 ms/token
            sus = {}
            for sysname in ("vLLM-paged", "orca-oracle", "orca-pow2",
                            "orca-max"):
                ok = [r["rate"] for r in rows if r[sysname] <= slo]
                sus[sysname] = max(ok) if ok else 0.0
            base = max(sus["orca-max"], 1e-9)
            print(f"  sustainable@{slo*1e3:.0f}ms/tok: "
                  + "  ".join(f"{k}={v:.0f}" for k, v in sus.items())
                  + f"  -> paged/orca-max = "
                    f"{sus['vLLM-paged']/base:.1f}x")
    return results


if __name__ == "__main__":
    run()
