"""Training launcher (the port of ``repro.launch.train``): the synthetic
corpus, ``Model.loss`` with its backward and AdamW, SPMD over a device
mesh. The default is h2o-danube-1.8b at full width with random weights
(seed 0), 8 x 256 tokens a step, each layer recomputed in the backward
(``remat``, off with ``--reduced``). It runs on the GPU; ``--device cpu``
runs it on the CPU.

As the reference does, it always builds a mesh: the 16 x 16 production
mesh with ``--production-mesh`` (256 ranks), else ``(world /
model_parallel, model_parallel)`` over the ranks there are, one rank
included. Parameters are DTensors laid out by ``param_specs`` and each
batch by ``batch_specs``: every rank draws the same seeded corpus and
keeps its shard. Under ``torchrun`` (NCCL on the GPU, each rank on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) only rank 0 prints:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
      --device cpu --model-parallel 2
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10

Each logged step prints its loss and gradient norm; the run ends with the
median step time over the steps after the first two, tokens per second and
``max_memory_allocated``. ``--ckpt-dir`` saves the final parameters as a
checkpoint the reference can restore (gathered, written by rank 0).
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_host_mesh, \
    make_production_mesh
from repro_torch.models.layers import NO_POLICY
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
                    help="the 16x16 pod mesh (needs 256 ranks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    return ap


def main(argv=None) -> dict:
    """Train as the flags say, on a mesh. Returns the per-step losses,
    gradient norms and wall seconds, the median step time, tokens per
    second, the device's ``max_memory_allocated`` (None off the GPU) and
    the mesh."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    owned = not dist.is_initialized()
    rank = init_distributed(dev)
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = (make_production_mesh(device=dev) if args.production_mesh
                else make_host_mesh(args.model_parallel, device=dev))
        return run(args, dev=dev, mesh=mesh, verbose=rank == 0)
    finally:
        if owned:  # a group this call made ends with it
            dist.destroy_process_group()


def run(args, *, dev, mesh=None, verbose: bool = True) -> dict:
    """The training loop of :func:`main` on ``mesh``, or, with no mesh,
    the single-device loop of plain tensors (no policy: the oracle a mesh
    run is held to)."""
    cfg = smoke_config(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, remat=not args.reduced)
    ocfg = optimizer.OptConfig(lr=args.lr,
                               warmup_steps=max(args.steps // 10, 5),
                               total_steps=args.steps)
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    policy = NO_POLICY
    if mesh is not None:
        policy = shd.MeshPolicy(mesh, cfg)
        params = shd.distribute(params, shd.param_specs(params, mesh, cfg),
                                mesh)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, ocfg, policy)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq_len,
                                        global_batch=args.batch))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    say = print if verbose else (lambda *a, **k: None)
    where = "no mesh" if mesh is None else "mesh " + " x ".join(
        f"{n} {s}" for n, s in zip(mesh.mesh_dim_names, mesh.shape))
    say(f"train {cfg.arch_id}{' (reduced)' if args.reduced else ''} on "
        f"{dev}, {where}: {n_params:,} parameters, {args.batch} x "
        f"{args.seq_len} tokens a step, remat {model.remat}")
    losses, gnorms, step_s = [], [], []
    t0 = time.monotonic()
    for step, batch in enumerate(corpus.batches()):
        if step >= args.steps:
            break
        t_step = time.monotonic()
        batch = batch_to(batch, dev)
        if mesh is not None:
            batch = shd.distribute(batch, shd.batch_specs(batch, mesh, cfg),
                                   mesh)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.monotonic() - t_step)
        if step % 10 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {gnorms[-1]:.3f} ({time.monotonic() - t0:.1f}s)")
    timed = step_s[2:] or step_s
    out = dict(arch=cfg.arch_id, steps=len(losses), losses=losses,
               grad_norms=gnorms, step_s=step_s,
               step_median_s=statistics.median(timed) if timed else None,
               tokens_per_step=args.batch * args.seq_len,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else None),
               mesh=None if mesh is None else dict(
                   zip(mesh.mesh_dim_names, mesh.shape)))
    out["tokens_per_s"] = (out["tokens_per_step"] / out["step_median_s"]
                           if out["step_median_s"] else None)
    if timed:
        say(f"step time {out['step_median_s'] * 1e3:.1f} ms (median of "
            f"{len(timed)}), {out['tokens_per_s']:.0f} tokens/s"
            + (f", max_memory_allocated {out['peak_gib']:.2f} GiB"
               if cuda else ""))
    if args.ckpt_dir:
        path = checkpoint.save(args.ckpt_dir, args.steps, {"params": params})
        say("checkpoint:", path)
    return out


if __name__ == "__main__":
    main()
