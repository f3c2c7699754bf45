"""End-to-end training on the port: a ~100M-parameter dense model (the
danube family scaled down, 8 layers, d_model 768), a few hundred steps on
the packed synthetic corpus, with checkpoints, and a resume from the last
one. The port of ``examples/train_small.py``; it runs on the GPU unless
``--device cpu`` says otherwise.

  PYTHONPATH=src python examples/torch_train_small.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_small.py --smoke --device cpu

``--smoke`` shrinks the model (2 layers, d_model 128, vocab 512) and the
batch for a quick run on the CPU.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                             make_train_step, train)


def config(smoke: bool):
    """~100M parameters: h2o-danube-1.8b at 8 layers, d_model 768."""
    cfg = dataclasses.replace(
        get_config("h2o-danube-1.8b"),
        num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32000, sliding_window=512)
    if smoke:
        cfg = dataclasses.replace(cfg, num_layers=2, d_model=128,
                                  num_heads=4, num_kv_heads=2, head_dim=32,
                                  d_ff=256, vocab_size=512,
                                  sliding_window=64)
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model and batch (the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config(args.smoke)
    print(f"model: {cfg.n_params() / 1e6:.1f}M params")
    batch = ({"seq_len": 64, "global_batch": 4} if args.smoke
             else {"seq_len": 256, "global_batch": 8})
    every = max(args.steps // 3, 1)
    tcfg = TrainConfig(
        steps=args.steps, log_every=max(args.steps // 15, 1),
        ckpt_every=every, ckpt_dir=args.ckpt_dir,
        opt=OptConfig(lr=6e-4, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps))
    res = train(cfg, tcfg, batch_override=batch, device=dev)
    first, last = res["losses"][0][1], res["losses"][-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} in {res['wall_s']:.0f}s")
    step = checkpoint.latest_step(args.ckpt_dir)
    print(f"latest checkpoint: step {step}")
    # resume: the latest checkpoint's parameters and moments, one more step
    like = {"params": res["params"], "opt": optimizer.init(res["params"])}
    state = checkpoint.restore(args.ckpt_dir, step, like)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        **batch))
    step_fn = make_train_step(Model(cfg), tcfg.opt)
    _, _, m = step_fn(state["params"], state["opt"], batch_to(
        next(corpus.batches(start_step=step + 1)), dev))
    print(f"resumed from step {step}: loss {float(m['loss']):.3f}")
    return dict(losses=res["losses"], latest=step,
                resumed_loss=float(m["loss"]))


if __name__ == "__main__":
    main()
