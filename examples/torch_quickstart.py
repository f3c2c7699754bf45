"""Quickstart on the port: train a small model on the synthetic corpus,
checkpoint it, and serve a few requests through the LLMService front-end
(continuous batching on the paged engine). The port of
``examples/quickstart.py``; it runs on the GPU unless ``--device cpu``
says otherwise.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = smoke_config("h2o-danube-1.8b")

    print("== training 120 steps on the synthetic corpus ==")
    res = train(cfg, TrainConfig(
        steps=120, log_every=30,
        opt=OptConfig(lr=1e-3, warmup_steps=15, total_steps=120)),
        device=dev)
    first, last = res["losses"][0][1], res["losses"][-1][1]
    print(f"loss: {first:.3f} -> {last:.3f}")
    assert last < first - 0.3, "model failed to learn"

    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = checkpoint.save(ckpt_dir, 120, {"params": res["params"]})
        print(f"checkpoint written to {path}")

        print("\n== serving the trained model (LLMService, continuous "
              "batching) ==")
        restored = checkpoint.restore(ckpt_dir, 120,
                                      {"params": res["params"]})
    eng = PagedEngine(cfg, restored["params"],
                      EngineConfig(num_pages=128, page_size=8, max_slots=4),
                      device=dev)
    svc = LLMService(eng)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, 8).tolist() for _ in range(4)]
    outs = svc.generate(prompts, SamplingParams(max_new_tokens=8))
    for out in outs:
        print(f"req {out.request_id}: {out.token_ids} "
              f"({out.finish_reason}, ttft {out.metrics.ttft:.2f}s)")
    print(f"kv pages free: {eng.allocator.num_free}/{eng.allocator.num_blocks}")
    return dict(first_loss=first, last_loss=last,
                outputs=[o.token_ids for o in outs],
                pages_free=eng.allocator.num_free)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    main(ap.parse_args().device)
