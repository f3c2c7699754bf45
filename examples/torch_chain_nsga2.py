"""The paper's §II contribution on the port, end to end: build a
PETALS-style swarm, find chains with the Dijkstra baseline and with the
NSGA-II Latency-Throughput-Tradeoff mode, and print the Pareto front. The
port of ``examples/chain_nsga2.py``; chain selection runs on the host, so
``--device`` is only resolved (``cuda`` raises where there is no GPU).

  PYTHONPATH=src python examples/torch_chain_nsga2.py [--device cpu]
"""

import argparse

from repro_torch.core.chain import (find_best_chain, knee_chain,
                                    latency_throughput_tradeoff, make_fleet)
from repro_torch.device import resolve_device


def describe(chain, label):
    spans = " -> ".join(f"s{s.server_id}[{a}:{b}]" for s, a, b in chain)
    print(f"{label:18s} time={chain.total_time:6.2f}s "
          f"lat={chain.total_latency:5.2f}s "
          f"thr(bottleneck)={chain.bottleneck_throughput:6.1f} blk/s  "
          f"{spans}")


def main(device="cuda") -> dict:
    resolve_device(device)
    fleet = make_fleet(num_blocks=24, num_servers=20, seed=42)
    print(f"swarm: {len(fleet.servers)} servers hosting "
          f"{fleet.num_blocks} transformer blocks\n")

    best = find_best_chain(fleet)
    describe(best, "dijkstra (PETALS)")
    describe(find_best_chain(fleet, mode="max_throughput"), "max-throughput")

    res = latency_throughput_tradeoff(fleet, pop_size=80, generations=50,
                                      seed=0)
    print(f"\nNSGA-II: {res.evaluations} evaluations, "
          f"{len(res.chains)} Pareto-optimal chains")
    shown = sorted(res.chains, key=lambda c: c.total_time)[:5]
    for i, c in enumerate(shown):
        describe(c, f"pareto[{i}]")
    knee = knee_chain(res)
    describe(knee, "knee (default)")
    return dict(dijkstra_time=best.total_time, pareto=len(res.chains),
                evaluations=res.evaluations, knee_time=knee.total_time)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    main(ap.parse_args().device)
