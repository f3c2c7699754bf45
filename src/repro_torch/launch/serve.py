"""Serving launcher: ``LLMService`` over the port's ``PagedEngine`` with a
synthetic open-loop request stream (the engine path of
``repro.launch.serve``). Runs on the GPU; ``--device cpu`` runs the plain
PyTorch path on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --rate 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

The default is h2o-danube-1.8b at full width with random weights from
``--seed``; ``--reduced`` serves its smoke config. The simulator backend, the
cluster router, disaggregated roles, host swap and trace export come with
later slices of the port, and so do their flags.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bridge import init_params
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core.scheduling import CHUNK_POLICIES
from repro_torch.device import resolve_device
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine


def build_instance(args) -> PagedEngine:
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=device)
    return PagedEngine(cfg, params, EngineConfig(
        num_pages=args.pages, page_size=args.page_size,
        max_slots=args.slots, enable_prefix_cache=args.prefix_cache,
        chunk_policy=args.chunk_policy), device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--best-of", type=int, default=1,
                    help="n parallel samples per prompt (COW-forked KV)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix KV cache (cross-request reuse)")
    ap.add_argument("--chunk-policy", default="decode_first",
                    choices=CHUNK_POLICIES,
                    help="chunked-prefill budget policy: decode_first "
                         "(Sarathi stall-free), prefill_first (TTFT-"
                         "optimal), monolithic (whole prompt in one "
                         "iteration next to the decodes), or solo (legacy: "
                         "over-budget prompts wait for an idle engine)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine = build_instance(args)
    svc = LLMService(engine)
    vocab = engine.cfg.vocab_size

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        svc.submit(rng.integers(0, vocab, plen).tolist(),
                   SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  n=args.best_of,
                                  max_new_tokens=int(rng.integers(
                                      2, args.max_new)),
                                  seed=int(i)),
                   arrival_time=float(arrivals[i]))

    t0 = time.monotonic()
    while svc.pending:
        now = time.monotonic() - t0
        for ch in svc.poll(now):
            if ch.finished:
                t = ch.time if ch.time is not None else now
                print(f"[{t:7.2f}s] req {ch.request_id} done: "
                      f"{ch.n_generated} tokens ({ch.finish_reason})")
        if not engine.has_work and svc.pending:
            time.sleep(0.005)  # wait for the next wall-clock arrival

    stats = svc.stats()
    dt = time.monotonic() - t0
    print(f"served {stats.n_finished}/{stats.n_requests} requests, "
          f"{stats.total_tokens} tokens in {dt:.1f}s "
          f"({stats.total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{engine.iterations} iterations) on {engine.device}; "
          f"mean ttft {stats.mean_ttft * 1e3:.1f}ms, "
          f"mean norm-lat {stats.mean_normalized_latency:.3f}s/tok")
    if stats.p99_tbt != float("inf"):
        print(f"p99 worst inter-token gap {stats.p99_tbt * 1e3:.1f}ms, "
              f"prefill stall {stats.prefill_stall_ms:.1f}ms "
              f"(chunk policy: {args.chunk_policy})")
    if stats.prefix_hit_rate is not None:
        print(f"prefix-cache hit-rate {stats.prefix_hit_rate:.1%}")
    return stats


if __name__ == "__main__":
    main()
