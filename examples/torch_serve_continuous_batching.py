"""ORCA iteration-level scheduling + vLLM paging on a real model, behind the
LLMService front-end, on the port: requests arrive over time, join
mid-flight, finish early, and (with tight memory) get preempted and
recomputed — watch the service stream chunks as the engine iterates. The
port of ``examples/serve_continuous_batching.py``; it runs on the GPU
unless ``--device cpu`` says otherwise.

  PYTHONPATH=src python examples/torch_serve_continuous_batching.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.bridge import init_params
from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = smoke_config("h2o-danube-1.8b")
    params = init_params(cfg, seed=0, device=dev)
    eng = PagedEngine(cfg, params, EngineConfig(
        num_pages=48, page_size=8, max_slots=3,  # tight: shows preemption
        max_tokens_per_iter=256), device=dev)
    svc = LLMService(eng)

    rng = np.random.default_rng(7)
    for i in range(8):
        plen = int(rng.integers(6, 20))
        rid = svc.submit(
            rng.integers(2, cfg.vocab_size, plen).tolist(),
            SamplingParams(max_new_tokens=int(rng.integers(4, 16))),
            arrival_time=i * 0.5)
        print(f"submitted request {rid} (prompt {plen} tok)")

    it = 0
    while svc.pending and it < 500:
        # virtual time: 2 engine iterations ~ 1 "second" of arrivals
        for ch in svc.poll(now=it / 2):
            if ch.finished:
                print(f"[iter {it:3d}] - request {ch.request_id} done: "
                      f"{ch.n_generated} tokens ({ch.finish_reason})")
        it += 1
    print(f"\n{it} iterations, kv pages free "
          f"{eng.allocator.num_free}/{eng.allocator.num_blocks}")
    out = svc.stats()
    print(f"served {out.n_finished}/{out.n_requests} requests, "
          f"{out.preemptions} preemptions")
    return dict(iterations=it, n_finished=out.n_finished,
                n_requests=out.n_requests, preemptions=out.preemptions,
                pages_free=eng.allocator.num_free,
                pages=eng.allocator.num_blocks)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    main(ap.parse_args().device)
