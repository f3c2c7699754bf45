"""Where a serving run of the PyTorch port spends its time on the GPU.

    python3 benchmarks/torch_decode_profile.py
    python3 benchmarks/torch_decode_profile.py \
        --arch llama4-scout-17b-a16e --layers 12
    python3 benchmarks/torch_decode_profile.py \
        --arch deepseek-v2-236b --layers 8

Needs one CUDA card. Serves the traffic of ``chip_smoke.py``'s serve phase
(full-width h2o-danube-1.8b in bf16 by default, or ``--arch`` at full
width, cut to ``--layers`` layers where given; random weights from a seed,
8 requests at once with prompts of 64-1024 tokens, one best-of-2, 32 new
tokens each)
through ``LLMService`` three times: to warm up (kernel build, cuBLAS
start-up), timed without a profiler, and under ``torch.profiler``. Prints
the card's name and power limit, the wall time of the unprofiled run and
of its decode-only and prefill-carrying iterations (from the engine's
telemetry), the device time by CUDA kernel from the profiled run, and the
device's idle share: 1 - (kernel time of the profiled run) / (wall time of
the unprofiled run); the traffic is the same, so both runs launch the same
kernels, and the profiler's own host cost stays out of the wall time. In
the profiled run the engine's model functions are named spans
(``SPANS``): each span's device time is that of the kernels its ops
launched, and within ``moe_forward`` the ``aten::bmm`` ops' (the expert
products) are read apart, so that the expert products and the attention
(the kernels, or MLA's plain latent attention: ``blockwise_attention`` in
a prefill chunk, ``attention_partial`` + ``merge_partials_tree`` in a
decode step) have their own rows. Then one JSON line with the same
numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import SERVE_ENGINE, serve_requests  # noqa: E402


# the engine's model functions read apart in the profiled run
SPANS = ("moe_forward", "prefill_attention_paged", "paged_attention",
         "blockwise_attention", "attention_partial", "merge_partials_tree")


def name_spans():
    """Wrap each of SPANS in the engine module in a profiler range."""
    from torch.profiler import record_function
    from repro_torch.serving import engine as engine_mod
    for name in SPANS:
        def spanned(*args, _fn=getattr(engine_mod, name), _name=name,
                    **kwargs):
            with record_function(f"span::{_name}"):
                return _fn(*args, **kwargs)
        setattr(engine_mod, name, spanned)


def _device_us(ev):
    """Device microseconds of the kernels an op and its children
    launched."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(ev, name):
            return getattr(ev, name)
    return 0.0


def _subtree(ev):
    yield ev
    for ch in ev.cpu_children:
        yield from _subtree(ch)


def span_times(prof):
    """{span: (device ms, calls)} and the device ms of the ``aten::bmm``
    ops inside ``moe_forward``, from the host-side range of each span (the
    profiler also records each range on the device, as the time from its
    first kernel's start to its last one's end, idle gaps included: those
    are left out)."""
    from torch.autograd import DeviceType
    spans, bmm_us = {}, 0.0
    for ev in prof.events():
        if not ev.name.startswith("span::") or \
                ev.device_type != DeviceType.CPU:
            continue
        name = ev.name[len("span::"):]
        us, calls = spans.get(name, (0.0, 0))
        spans[name] = (us + _device_us(ev), calls + 1)
        if name == "moe_forward":
            bmm_us += sum(_device_us(c) for c in _subtree(ev)
                          if c.name == "aten::bmm")
    return {k: dict(device_ms=us / 1e3, calls=c)
            for k, (us, c) in spans.items()}, bmm_us / 1e3


def serve(cfg, params, dev, seed):
    from repro_torch.serving.api import LLMService
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    engine = PagedEngine(cfg, params, EngineConfig(
        **SERVE_ENGINE, seed=seed, enable_telemetry=True), device=dev)
    svc = LLMService(engine)
    for prompt, sp in serve_requests(cfg.vocab_size, seed):
        svc.submit(prompt, sp)
    t0 = time.monotonic()
    while svc.pending:
        svc.poll()
    torch.cuda.synchronize()
    return engine, time.monotonic() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    params = init_params(cfg, seed=0, device=dev)
    serve(cfg, params, dev, seed=0)  # warm-up
    engine, wall = serve(cfg, params, dev, seed=0)
    name_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_profiled = serve(cfg, params, dev, seed=0)

    iters = [e for e in engine.trace.events() if e.name == "iteration"]
    decode_only = [e.dur for e in iters if e.args.get("chunks") == 0]
    with_prefill = [e.dur for e in iters if e.args.get("chunks", 0) > 0]

    def dev_time(ev):  # microseconds of device time spent in this kernel
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, name):
                return getattr(ev, name)
        return 0.0

    # device-side kernel events only: an aten op's own entry repeats the
    # device time of the kernels it launched, and a span's device-side
    # range spans its kernels and the gaps between them
    kernels = [(ev.key, dev_time(ev), ev.count)
               for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and dev_time(ev) > 0 and not ev.key.startswith("span::")]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(t for _, t, _ in kernels)
    host = sorted(((ev.key, ev.self_cpu_time_total, ev.count)
                   for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == DeviceType.CPU),
                  key=lambda k: -k[1])[:10]
    spans, expert_bmm_ms = span_times(prof)
    out = dict(
        card=card, arch=cfg.arch_id, layers=cfg.num_layers, wall_s=wall,
        wall_profiled_s=wall_profiled,
        iterations=len(iters),
        decode_only_iterations=len(decode_only),
        decode_only_ms_mean=1e3 * float(np.mean(decode_only))
        if decode_only else None,
        prefill_iterations=len(with_prefill),
        prefill_iteration_ms_mean=1e3 * float(np.mean(with_prefill))
        if with_prefill else None,
        device_busy_s=busy_us / 1e6,
        kernel_launches=sum(c for _, _, c in kernels),
        launches_per_iteration=sum(c for _, _, c in kernels) / len(iters),
        spans=spans, expert_bmm_device_ms=expert_bmm_ms,
        device_idle_share=1.0 - busy_us / 1e6 / wall if busy_us else None,
        top_kernels=[dict(name=k[:90], device_ms=t / 1e3, calls=c,
                          share=t / busy_us)
                     for k, t, c in kernels[:12]] if busy_us else [],
        top_host_ops_profiled=[dict(name=k[:60], self_cpu_ms=t / 1e3,
                                    calls=c) for k, t, c in host])
    print(f"card: {card}; {cfg.arch_id}, {cfg.num_layers} layers")
    print(f"serve run: {wall:.3f} s wall ({wall_profiled:.3f} s under the "
          f"profiler), {len(iters)} iterations "
          f"({len(decode_only)} decode-only, mean "
          f"{out['decode_only_ms_mean']} ms; {len(with_prefill)} with "
          f"prefill chunks, mean {out['prefill_iteration_ms_mean']} ms)")
    if not busy_us:
        print("the profiler recorded no device time on this machine")
    else:
        print(f"device busy {busy_us / 1e6:.3f} s of {wall:.3f} s wall "
              f"(idle share {out['device_idle_share']:.3f}), "
              f"{out['kernel_launches']} kernel launches")
        for k in out["top_kernels"]:
            print(f"  {k['device_ms']:10.3f} ms {k['share']:6.1%} "
                  f"{k['calls']:6d}x  {k['name']}")
        print("device time by span of the engine's model functions:")
        for name, sp in spans.items():
            print(f"  {sp['device_ms']:10.3f} ms {sp['calls']:6d}x  {name}")
        print(f"  {expert_bmm_ms:10.3f} ms          expert products "
              "(aten::bmm inside moe_forward)")
    print("host time by op under the profiler (self CPU):")
    for h in out["top_host_ops_profiled"]:
        print(f"  {h['self_cpu_ms']:10.3f} ms {h['calls']:6d}x  {h['name']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
