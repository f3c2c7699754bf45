"""Where a full-width training step of the PyTorch port spends its time
on the GPU: h2o-danube-1.8b (or ``--arch``) at the train launcher's
defaults.

    python3 benchmarks/torch_train_profile.py [--steps 4]

Needs one CUDA card. Puts the whole model on the card (random weights from
seed 0, bfloat16), with the launcher's optimizer settings, remat on and 8
x 256 tokens a step from the synthetic corpus, and runs the launcher's
train step split in its three parts: ``Model.loss`` (the forward), its
backward, and ``optimizer.apply`` (AdamW in place). Each step's batch is
drawn and put on the card before its timed region, as the launcher times
its steps (drawing it is host work of its own: ``data_ms``). Two warm-up
steps, then ``--steps`` steps timed by CUDA events at the parts'
boundaries (each part's time includes the card's idle gaps inside it),
then one step under ``torch.profiler``: device time by CUDA kernel,
kernels launched, and the device's idle share over that step, 1 -
(kernel time of the profiled step) / (the median step's wall time
unprofiled). No kernel of the port may launch (training runs plain
PyTorch). Prints the card's name and power limit, the parts' medians, the
kernel table and one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from torch_ssm_profile import kernel_table, show, summary  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.train_loop import batch_to
    from repro_torch.training.tree import leaves, unflatten

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)  # full width and depth
    model = Model(cfg, remat=True)
    total = 2 + args.steps + 1
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=max(total // 10, 5),
                               total_steps=total)
    params = init_params(cfg, seed=0, device=dev)
    state = optimizer.init(params)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq_len,
                                        global_batch=args.batch)).batches()
    launches = (flash_prefill.launches, paged_attention.launches,
                ssd_scan.launches)

    data_s = []

    def next_batch():
        t0 = time.monotonic()
        batch = batch_to(next(corpus), dev)
        torch.cuda.synchronize()
        data_s.append(time.monotonic() - t0)
        return batch

    def step(batch, events=None):
        """The launcher's train step (``make_train_step``), with an event
        recorded before it and after each of its parts."""
        nonlocal params, state
        mark = (lambda: events.append(torch.cuda.Event(enable_timing=True))
                or events[-1].record()) if events is not None \
            else (lambda: None)
        mark()
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = model.loss(unflatten(params, flat), batch)
        mark()
        loss.backward()
        grads = unflatten(params, [p.grad for p in flat])
        mark()
        del flat
        params, state, m = optimizer.apply(ocfg, params, grads, state)
        mark()
        return float(loss.detach()), float(m["grad_norm"])

    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        step(next_batch())
    parts, walls, losses = [], [], []
    for _ in range(args.steps):
        events = []
        batch = next_batch()
        t0 = time.monotonic()
        losses.append(step(batch, events)[0])
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        parts.append([a.elapsed_time(b) for a, b in
                      zip(events[:-1], events[1:])])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = next_batch()
    with profile(activities=acts) as prof:
        step(batch)
        torch.cuda.synchronize()
    if (flash_prefill.launches, paged_attention.launches,
            ssd_scan.launches) != launches:
        raise AssertionError("a kernel of the port launched in training")

    wall_s = statistics.median(walls)
    prof_sum = summary(kernel_table(prof), wall_s)
    names = ("forward (Model.loss)", "backward", "optimizer.apply")
    med = {n: statistics.median(p[i] for p in parts)
           for i, n in enumerate(names)}
    out = dict(card=card, arch=cfg.arch_id, batch=args.batch,
               seq_len=args.seq_len, remat=True, steps=args.steps,
               step_wall_ms=[w * 1e3 for w in walls],
               step_median_ms=wall_s * 1e3,
               tokens_per_s=args.batch * args.seq_len / wall_s,
               parts_median_ms=med, losses=losses,
               data_ms=statistics.median(data_s) * 1e3,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               profiled_step=prof_sum)
    print(f"card: {card}")
    print(f"{cfg.arch_id} train step of {args.batch} x {args.seq_len} "
          f"tokens, remat: {wall_s * 1e3:.1f} ms median of {args.steps} "
          f"({out['tokens_per_s']:.0f} tokens/s), max_memory_allocated "
          f"{out['peak_gib']:.2f} GiB")
    for n, ms in med.items():
        print(f"  {n}: {ms:.1f} ms")
    print(f"  (drawing a batch on the host: {out['data_ms']:.1f} ms, "
          f"outside the step)")
    if not prof_sum["device_busy_ms"]:
        print("the profiler recorded no device time on this machine")
    show("profiled step", prof_sum, "")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
