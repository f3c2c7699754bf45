"""How often the serve traffic swaps: a CPU scan of engine geometries.

``chip_smoke.py`` measures the host tier on paper-opt-13b under its serve
traffic (``SERVE_PROMPTS``, 32 new tokens, one best-of-2) on a pool tight
enough to swap. The scheduler decides from token counts alone (fixed
``max_new_tokens``, no early stop), so how many swap-outs a pool makes can
be found on the CPU at smoke width: this script serves that traffic in
``swap`` mode on the port's engine over a grid of page sizes, decode
slots, token budgets, victim policies and pool sizes (from the smallest
pool that holds the 1056-token request up), and prints the most
swap-outs any geometry made and every geometry that reached ``--target``.

    PYTHONPATH=src python benchmarks/torch_swap_scan.py   # ~35 min, 6 procs
    PYTHONPATH=src python benchmarks/torch_swap_scan.py --page-sizes 8
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import multiprocessing
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LONGEST = 1024 + 32  # SERVE_PROMPTS' longest prompt + its new tokens


def scan(page_size: int, slots: int, budgets, policies, span: int,
         target: int):
    """Swap-outs of the serve traffic at each pool of this page size and
    slot count: (most swap-outs, [geometries with >= target])."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke
    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.serving.api import LLMService
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    torch.set_num_threads(1)
    cfg = dataclasses.replace(smoke_config("paper-opt-13b"),
                              max_seq_len=8192)
    params = init_params(cfg, seed=0, device="cpu")
    requests = chip_smoke.serve_requests(cfg.vocab_size, 10)
    first = -(-LONGEST // page_size) + 2
    best, hits = 0, []
    for budget, policy, pages in itertools.product(
            budgets, policies, range(first, first + span // page_size)):
        engine = PagedEngine(cfg, params, EngineConfig(
            num_pages=pages, page_size=page_size, max_slots=slots,
            max_tokens_per_iter=budget, host_pages=8 * pages,
            swap_mode="swap", victim_policy=policy), device="cpu")
        svc = LLMService(engine)
        for prompt, sp in requests:
            svc.submit(prompt, sp)
        while svc.pending:
            svc.poll()
        best = max(best, engine.swapped_out)
        if engine.swapped_out >= target:
            hits.append(dict(page_size=page_size, slots=slots, budget=budget,
                             policy=policy, pages=pages,
                             swap_outs=engine.swapped_out))
    return best, hits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--page-sizes", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--slots", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--budgets", type=int, nargs="+", default=[512, 2048])
    ap.add_argument("--policies", nargs="+", default=["lifo", "fifo"])
    ap.add_argument("--span", type=int, default=1280,
                    help="tokens of pool scanned past the smallest one")
    ap.add_argument("--target", type=int, default=4)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    jobs = list(itertools.product(args.page_sizes, args.slots))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.workers,
                                                mp_context=ctx) as pool:
        futures = {pool.submit(scan, ps, slots, args.budgets, args.policies,
                               args.span, args.target): (ps, slots)
                   for ps, slots in jobs}
        best = 0
        for fut in concurrent.futures.as_completed(futures):
            ps, slots = futures[fut]
            most, hits = fut.result()
            best = max(best, most)
            print(f"pages of {ps}, {slots} slots: at most {most} swap-outs",
                  flush=True)
            for hit in hits:
                print(f"  reaches {args.target}: {hit}", flush=True)
    print(f"the serve traffic swapped out at most {best} times over "
          f"{len(jobs)} (page size, slots) pairs x budgets {args.budgets} x "
          f"victims {args.policies}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
