"""Training launcher (the port of ``repro.launch.train``): the synthetic
corpus, ``Model.loss`` with its backward and AdamW, on one device. The
default is h2o-danube-1.8b at full width with random weights (seed 0),
8 x 256 tokens a step, each layer recomputed in the backward (``remat``,
off with ``--reduced``). It runs on the GPU; ``--device cpu`` runs it on
the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

Each logged step prints its loss and gradient norm; the run ends with the
median step time over the steps after the first two, tokens per second and
``max_memory_allocated``. ``--ckpt-dir`` saves the final parameters as a
checkpoint the reference can restore. ``--model-parallel`` above 1 and
``--production-mesh`` need the sharding slice of the port (mesh, DTensor
sharding, the dry-run) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.bridge import init_params
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.train_loop import batch_to, make_train_step
from repro_torch.training.tree import leaves


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 pod mesh (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    return ap


def main(argv=None) -> dict:
    """Train as the flags say. Returns the per-step losses, gradient norms
    and wall seconds, the median step time, tokens per second and the
    device's ``max_memory_allocated`` (None off the GPU)."""
    args = build_parser().parse_args(argv)
    if args.model_parallel > 1 or args.production_mesh:
        raise NotImplementedError(
            "--model-parallel > 1 and --production-mesh need the mesh and "
            "sharding slice of the port (launch/mesh.py, launch/"
            "sharding.py), which is not ported yet")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, remat=not args.reduced)
    ocfg = optimizer.OptConfig(lr=args.lr,
                               warmup_steps=max(args.steps // 10, 5),
                               total_steps=args.steps)
    params = init_params(cfg, seed=0, device=dev)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, ocfg)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq_len,
                                        global_batch=args.batch))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"train {cfg.arch_id}{' (reduced)' if args.reduced else ''} on "
          f"{dev}: {sum(p.numel() for p in leaves(params)):,} parameters, "
          f"{args.batch} x {args.seq_len} tokens a step, remat "
          f"{model.remat}")
    losses, gnorms, step_s = [], [], []
    t0 = time.monotonic()
    for step, batch in enumerate(corpus.batches()):
        if step >= args.steps:
            break
        t_step = time.monotonic()
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_to(batch, dev))
        losses.append(float(m["loss"]))  # waits for the step
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.monotonic() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} ({time.monotonic() - t0:.1f}s)")
    timed = step_s[2:] or step_s
    out = dict(arch=cfg.arch_id, steps=len(losses), losses=losses,
               grad_norms=gnorms, step_s=step_s,
               step_median_s=statistics.median(timed) if timed else None,
               tokens_per_step=args.batch * args.seq_len,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else None))
    out["tokens_per_s"] = (out["tokens_per_step"] / out["step_median_s"]
                           if out["step_median_s"] else None)
    if timed:
        print(f"step time {out['step_median_s'] * 1e3:.1f} ms (median of "
              f"{len(timed)}), {out['tokens_per_s']:.0f} tokens/s"
              + (f", max_memory_allocated {out['peak_gib']:.2f} GiB"
                 if cuda else ""))
    if args.ckpt_dir:
        path = checkpoint.save(args.ckpt_dir, args.steps, {"params": params})
        print("checkpoint:", path)
    return out


if __name__ == "__main__":
    main()
