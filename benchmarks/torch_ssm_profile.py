"""Where full-width mamba2-1.3b's prefill and decode steps spend their time
on the GPU, in the PyTorch port.

    python3 benchmarks/torch_ssm_profile.py [--steps 8]

Needs one CUDA card. Builds the port's kernels, puts full-width
mamba2-1.3b (48 layers, random weights from a seed, bfloat16) on the card
and runs ``chip_smoke.py``'s mamba2 traffic: ``Model.prefill`` of 4 prompts
x 1024 tokens, then ``--steps`` greedy ``decode_step``s. Three passes: a
warm-up (kernel loads, cuBLAS start-up), one timed without a profiler, and
one under ``torch.profiler``, the prefill and the decode steps in separate
profiler windows. Prints the card's name and power limit, the wall time of
the unprofiled prefill and of each decode step, and for each window the
device time by CUDA kernel, the kernels launched (per decode step for the
decode window) and the device's idle share: 1 - (kernel time of the
profiled window) / (wall time of the same work unprofiled); the work is the
same, so both launch the same kernels, and the profiler's own host cost
stays out of the wall time. Then one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
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

from chip_smoke import MAMBA_BATCH, MAMBA_PROMPT  # noqa: E402


def run(model, params, toks, steps):
    """Prefill, then ``steps`` greedy decode steps. Returns the wall time of
    the prefill and of each step (seconds, each ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, caches = model.prefill(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    vocab = model.cfg.vocab_size
    tok = logits[:, :vocab].argmax(-1)
    pos = torch.full((toks.shape[0],), toks.shape[1], device=toks.device)
    step_s = []
    for i in range(steps):
        t0 = time.monotonic()
        logits, caches = model.decode_step(params, tok[:, None], pos + i,
                                           caches)
        tok = logits[:, :vocab].argmax(-1)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
    return prefill_s, step_s


def kernel_table(prof):
    """(name, device us, calls) of each CUDA kernel, largest first."""
    from torch.autograd import DeviceType

    def dev_time(ev):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, name):
                return getattr(ev, name)
        return 0.0

    rows = [(ev.key, dev_time(ev), ev.count) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA
            and dev_time(ev) > 0]
    return sorted(rows, key=lambda r: -r[1])


def summary(rows, wall_s, per=1):
    busy_us = sum(t for _, t, _ in rows)
    return dict(
        wall_ms=wall_s * 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / wall_s if busy_us else None,
        kernel_launches=sum(c for _, _, c in rows) / per,
        top_kernels=[dict(name=k[:90], device_ms=t / 1e3 / per,
                          calls=c / per, share=t / busy_us)
                     for k, t, c in rows[:12]] if busy_us else [])


def show(title, s, unit):
    print(f"{title}: {s['wall_ms']:.3f} ms wall {unit}, device busy "
          f"{s['device_busy_ms']:.3f} ms (idle share "
          f"{s['device_idle_share']}), {s['kernel_launches']:.0f} kernel "
          f"launches {unit}")
    for k in s["top_kernels"]:
        print(f"  {k['device_ms']:10.4f} ms {k['share']:6.1%} "
              f"{k['calls']:7.1f}x  {k['name']}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ssm_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.transformer import Model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build("ssd_scan")
    dev = torch.device("cuda", 0)
    cfg = get_config("mamba2-1.3b")  # full width, all 48 layers
    params = init_params(cfg, seed=3, device=dev)
    model = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT)), device=dev)

    run(model, params, toks, args.steps)  # warm-up
    prefill_s, step_s = run(model, params, toks, args.steps)
    launches = ssd_scan.launches
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_prefill:
        _, caches = model.prefill(params, toks)
        torch.cuda.synchronize()
    assert ssd_scan.launches == launches + cfg.num_layers
    tok = toks[:, -1]
    pos = torch.full((MAMBA_BATCH,), MAMBA_PROMPT, device=dev)
    with profile(activities=acts) as prof_decode:
        for i in range(args.steps):
            logits, caches = model.decode_step(params, tok[:, None], pos + i,
                                               caches)
            tok = logits[:, :cfg.vocab_size].argmax(-1)
        torch.cuda.synchronize()

    pre = summary(kernel_table(prof_prefill), prefill_s)
    dec = summary(kernel_table(prof_decode), sum(step_s), per=args.steps)
    dec["wall_ms"] /= args.steps
    dec["device_busy_ms"] /= args.steps
    out = dict(card=card, batch=MAMBA_BATCH, prompt=MAMBA_PROMPT,
               decode_steps=args.steps, prefill=pre, decode_step=dec,
               decode_step_wall_ms=[s * 1e3 for s in step_s])
    print(f"card: {card}")
    if not pre["device_busy_ms"]:
        print("the profiler recorded no device time on this machine")
    show(f"prefill of {MAMBA_BATCH} x {MAMBA_PROMPT} tokens", pre, "")
    show(f"decode step of {MAMBA_BATCH} sequences (mean of {args.steps})",
         dec, "per step")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
