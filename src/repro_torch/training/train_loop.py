"""Training loop: loss, backward and AdamW in one step, on the synthetic
corpus (``repro.training.train_loop``)."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.bridge import init_params
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import NO_POLICY, ShardingPolicy
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.tree import leaves, unflatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 0  # 0 = never
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    opt: optimizer.OptConfig = dataclasses.field(
        default_factory=optimizer.OptConfig)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A corpus batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: optimizer.OptConfig,
                    policy: ShardingPolicy = NO_POLICY) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    {"loss", "grad_norm", "lr"})``: ``model.loss`` and its gradient with
    respect to every leaf of ``params`` (``loss.backward()`` on detached
    copies of the leaves, so the caller's tensors never require grad), then
    :func:`optimizer.apply`, which updates ``params`` and ``opt_state`` in
    place. Metrics are 0-dim tensors on the parameters' device. Under a
    mesh ``policy`` (DTensor parameters and batch) every rank calls it;
    the loss is the global one, a plain tensor on every rank."""

    def train_step(params, opt_state, batch):
        with policy.scope():
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            loss = model.loss(unflatten(params, flat), batch, policy=policy)
            loss.backward()
            grads = unflatten(params, [
                p.grad if p.grad is not None else torch.zeros_like(p)
                for p in flat])
            del flat
            params, opt_state, m = optimizer.apply(opt_cfg, params, grads,
                                                   opt_state)
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return params, opt_state, {"loss": loss, **m}

    return train_step


def train(cfg: ArchConfig, tcfg: TrainConfig, *, seed: int = 0,
          batch_override: Optional[Dict] = None, verbose: bool = True,
          device="cuda") -> Dict[str, Any]:
    """Single-device training on the synthetic corpus (8 x 128 tokens a
    step unless ``batch_override`` says otherwise), weights from
    :func:`repro_torch.bridge.init_params` with ``seed``. Returns the
    logged ``(step, loss)`` pairs, the final parameters and the wall
    seconds. Runs on the GPU unless ``device`` names the CPU."""
    dev = resolve_device(device)
    model = Model(cfg, remat=False)
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, tcfg.opt)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                      global_batch=8, seed=seed)
    if batch_override:
        dcfg = dataclasses.replace(dcfg, **batch_override)
    corpus = SyntheticCorpus(dcfg)
    losses = []
    t0 = time.monotonic()
    for step, batch in enumerate(corpus.batches()):
        if step >= tcfg.steps:
            break
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_to(batch, dev))
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            if verbose:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
        if tcfg.ckpt_every and step and step % tcfg.ckpt_every == 0:
            checkpoint.save(tcfg.ckpt_dir, step,
                            {"params": params, "opt": opt_state})
    return {"losses": losses, "params": params,
            "wall_s": time.monotonic() - t0}
