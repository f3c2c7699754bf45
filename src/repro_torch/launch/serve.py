"""Serving launcher: ``LLMService`` over the port's ``PagedEngine`` with a
synthetic open-loop request stream (the engine path of
``repro.launch.serve``). ``--instances N`` puts a cluster ``RouterBackend``
in front of N engines that share one set of weights on the card
(placement via ``--policy``, cross-instance prefix sharing via
``--prefix-share``), and ``--roles`` splits them into prefill and decode
instances. Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on
the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --rate 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-opt-13b \
      --instances 2 --prefix-cache --prefix-share --share-mode zero_copy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-opt-13b \
      --roles 1p1d --handoff-mode zero_copy
  PYTHONPATH=src python -m repro_torch.launch.serve --pages 64 \
      --host-pages 128 --swap-mode swap --speculative-swap --trace t.json

The default is h2o-danube-1.8b at full width with random weights from
``--seed``; ``--reduced`` serves its smoke config. Zero-copy modes need a
config without a sliding window (danube's is 4096 tokens). ``--host-pages``
gives each engine a pinned host tier for swap-to-host preemption
(``--swap-mode``, ``--victim-policy``, ``--speculative-swap``) and
prefix-cache spill (``--cache-spill-pages``); ``--trace`` and
``--metrics-csv`` turn telemetry on and export it after the run. The
simulator backend and its flags come with a later slice of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bridge import init_params
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core.distkv.netmodel import NetworkModel
from repro_torch.core.scheduling import CHUNK_POLICIES
from repro_torch.core.scheduling.iteration import SWAP_MODES, VICTIM_POLICIES
from repro_torch.device import resolve_device
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.disagg import HANDOFF_MODES, parse_role_spec
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.router import POLICIES, SHARE_MODES, RouterBackend


def build_instance(args, cfg, params, device) -> PagedEngine:
    return PagedEngine(cfg, params, EngineConfig(
        num_pages=args.pages, page_size=args.page_size,
        max_slots=args.slots, enable_prefix_cache=args.prefix_cache,
        chunk_policy=args.chunk_policy,
        enable_telemetry=bool(args.trace or args.metrics_csv),
        host_pages=args.host_pages, swap_mode=args.swap_mode,
        victim_policy=args.victim_policy,
        speculative_swap=args.speculative_swap,
        cache_spill_pages=args.cache_spill_pages), device=device)


def build_netmodel(args):
    """No --net-gbps: network accounting stays off for copy and zero_copy
    alike; share-mode auto needs a model to decide."""
    if args.net_gbps is None and args.share_mode != "auto":
        return None
    return NetworkModel(gbps=args.net_gbps) if args.net_gbps is not None \
        else NetworkModel()


def parse_roles_arg(args):
    """Validate --roles with a launcher-grade error (SystemExit, not a
    traceback), and reconcile it with --instances."""
    if args.roles is None:
        return None
    try:
        roles = parse_role_spec(args.roles)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    if args.instances > 1 and args.instances != len(roles):
        raise SystemExit(
            f"error: --roles {args.roles!r} names {len(roles)} instances "
            f"but --instances is {args.instances} — drop --instances (the "
            f"spec sets the count) or make them agree")
    return roles


def build_backend(args):
    """One engine, or a RouterBackend over --instances engines built on
    one ``params`` dict."""
    if args.prefix_share and not args.prefix_cache:
        raise SystemExit("--prefix-share requires --prefix-cache")
    if args.prefix_share and args.instances <= 1:
        raise SystemExit("--prefix-share requires --instances >= 2 "
                         "(there is no peer to share with)")
    if args.share_mode != "copy" and not args.prefix_share:
        raise SystemExit("--share-mode zero_copy/auto requires "
                         "--prefix-share")
    roles = parse_roles_arg(args)
    if roles is not None:
        args.instances = len(roles)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, seed=args.seed, device=device)
    if args.instances <= 1:
        return build_instance(args, cfg, params, device)
    children = [build_instance(args, cfg, params, device)
                for _ in range(args.instances)]
    try:
        return RouterBackend(children, policy=args.policy,
                             prefix_share=args.prefix_share,
                             share_mode=args.share_mode,
                             board_pages=args.board_pages,
                             net=build_netmodel(args), roles=roles,
                             handoff_mode=args.handoff_mode)
    except ValueError as e:  # e.g. a role spec with no decode instance
        raise SystemExit(f"error: {e}")


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
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host (CPU) KV pages backing swap-to-host "
                         "preemption and prefix-cache spill, pinned on the "
                         "card's engines (0 = no host tier, preemption "
                         "always recomputes)")
    ap.add_argument("--swap-mode", default="sacrifice", choices=SWAP_MODES,
                    help="what preemption does to a victim's computed KV: "
                         "sacrifice (free + re-prefill later), swap (move "
                         "to host pages, resume without re-prefill), or "
                         "auto (per-victim cost decision)")
    ap.add_argument("--victim-policy", default="lifo",
                    choices=VICTIM_POLICIES,
                    help="which running request is preempted/swapped under "
                         "memory pressure: lifo (newest), fifo (oldest), "
                         "lru (least recently scheduled), or cost (cheapest "
                         "modeled eviction per freed page)")
    ap.add_argument("--speculative-swap", action="store_true",
                    help="issue decode swap-outs one iteration early when "
                         "free pages trend under the decodes' growth, the "
                         "copy overlapping that iteration's compute, and "
                         "cancel if pressure recedes")
    ap.add_argument("--cache-spill-pages", type=int, default=0,
                    help="host pages the prefix cache may use to spill "
                         "cold cached prefixes instead of evicting them "
                         "(bounded LRU; needs --host-pages and "
                         "--prefix-cache)")
    ap.add_argument("--instances", type=int, default=1,
                    help="serving instances behind the cluster router "
                         "(1 = no router)")
    ap.add_argument("--policy", default="round_robin",
                    choices=tuple(POLICIES), help="router placement policy")
    ap.add_argument("--roles", default=None, metavar="SPEC",
                    help="disaggregated prefill/decode roles as "
                         "<count><p|d|m> groups, e.g. '1p1d' = 1 prefill + "
                         "1 decode instance; implies the instance count. "
                         "Prompts land on prefill instances, finished KV "
                         "is handed to decode instances")
    ap.add_argument("--handoff-mode", default="auto", choices=HANDOFF_MODES,
                    help="how prefill->decode KV handoff moves the prompt "
                         "KV: migrate page payloads, zero_copy lease the "
                         "prefill host's pages in place, or auto "
                         "(per-request network-cost decision)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="publish hot radix paths through the distkv board "
                         "so instances adopt each other's cached prefixes "
                         "(needs --prefix-cache)")
    ap.add_argument("--board-pages", type=int, default=None,
                    help="size cap (pages) for the cross-instance "
                         "publication board; LRU pages are evicted past it "
                         "(default: unbounded)")
    ap.add_argument("--share-mode", default="copy", choices=SHARE_MODES,
                    help="how a published prefix reaches a peer instance: "
                         "copy its page payloads once, zero_copy serve it "
                         "in place over borrowed rBlocks (DistAttention "
                         "partial merge), or auto (per-request network-"
                         "cost decision)")
    ap.add_argument("--net-gbps", type=float, default=None,
                    help="interconnect bandwidth for the network cost "
                         "model (engines record modeled copy and lease "
                         "time as net_time; default: no network "
                         "accounting, except share-mode auto which needs "
                         "the model)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="enable telemetry and export a Chrome/Perfetto "
                         "trace-event JSON (open in ui.perfetto.dev or "
                         "chrome://tracing) after the run")
    ap.add_argument("--metrics-csv", metavar="PATH", default=None,
                    help="enable telemetry and dump per-iteration metric "
                         "timelines (one row per instance-iteration) as "
                         "CSV after the run")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    backend = build_backend(args)
    svc = LLMService(backend)
    kids = getattr(backend, "children", [backend])
    vocab = kids[0].cfg.vocab_size

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
        if not backend.has_work and svc.pending:
            time.sleep(0.005)  # wait for the next wall-clock arrival

    stats = svc.stats()
    dt = time.monotonic() - t0
    print(f"served {stats.n_finished}/{stats.n_requests} requests, "
          f"{stats.total_tokens} tokens in {dt:.1f}s "
          f"({stats.total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{backend.iterations} iterations) on {kids[0].device}; "
          f"mean ttft {stats.mean_ttft * 1e3:.1f}ms, "
          f"mean norm-lat {stats.mean_normalized_latency:.3f}s/tok")
    if stats.p99_tbt != float("inf"):
        print(f"p99 worst inter-token gap {stats.p99_tbt * 1e3:.1f}ms, "
              f"prefill stall {stats.prefill_stall_ms:.1f}ms "
              f"(chunk policy: {args.chunk_policy})")
    if stats.prefix_hit_rate is not None:
        print(f"prefix-cache hit-rate {stats.prefix_hit_rate:.1%}")
    n_so = sum(k.swapped_out for k in kids)
    n_si = sum(k.swapped_in for k in kids)
    if n_so or n_si:
        print(f"host swap: {n_so} swap-outs, {n_si} swap-ins "
              f"(mode: {args.swap_mode}, victims: {args.victim_policy}, "
              f"{args.host_pages} host pages)")
    if getattr(backend, "pages_borrowed", 0):
        print(f"zero-copy: {backend.leases_granted} leases, "
              f"{backend.pages_borrowed} pages served remotely "
              f"(share mode: {args.share_mode})")
    ho = getattr(backend, "handoff", None)
    if ho is not None:
        print(f"disagg: {ho.handoffs_migrated} migrated + "
              f"{ho.handoffs_leased} leased KV handoffs "
              f"({ho.pages_copied} pages copied, {ho.pages_leased} leased, "
              f"{ho.deferrals} deferrals, {ho.fallbacks} fallbacks; "
              f"mode: {args.handoff_mode})")
    if stats.per_instance:
        for i, row in sorted(stats.per_instance.items()):
            extra = ""
            if "prefix_hit_rate" in row:
                extra = (f", hit {row['prefix_hit_rate']:.1%}, "
                         f"{row['adopted_pages']} adopted pages")
            print(f"  instance {i}: {row['requests']} reqs, "
                  f"{row['iterations']} iters{extra}")
    if args.trace:
        n = svc.export_trace(args.trace)
        print(f"wrote {n} trace events to {args.trace} "
              f"(open in https://ui.perfetto.dev)")
    if args.metrics_csv:
        n = svc.export_metrics_csv(args.metrics_csv)
        print(f"wrote {n} metric rows to {args.metrics_csv}")
    return stats


if __name__ == "__main__":
    main()
