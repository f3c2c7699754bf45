"""Radix prefix-cache serving through the LLMService front-end, on the
port: N chat sessions over one shared system prompt.

Runs the same traffic through two `PagedEngine` backends — cold (no cache)
and with the radix-tree prefix cache — and prints per-request prefill work,
the cache hit-rate, and KV page usage. With the cache, every request after
the first computes only its own suffix tokens; the shared system-prompt pages
are prefilled once and increfed into each request's block table. The port
of ``examples/serve_shared_prefix.py``; it runs on the GPU unless
``--device cpu`` says otherwise.

  PYTHONPATH=src python examples/torch_serve_shared_prefix.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.bridge import init_params
from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.serving.api import LLMService, SamplingParams
from repro_torch.serving.engine import EngineConfig, PagedEngine

N_SESSIONS = 8
PAGE_SIZE = 8
SYSTEM_PROMPT_PAGES = 2


def drive(eng, prompts, label):
    print(f"\n--- {label} ---")
    svc = LLMService(eng, default_params=SamplingParams(max_new_tokens=4))
    outputs = []
    for i, prompt in enumerate(prompts):
        # sequential sessions: each generate() call sees the pages the
        # previous session left in the radix tree
        out = svc.generate([prompt])[0]
        cached = out.metrics.num_cached_tokens
        print(f"session {i}: prompt {out.prompt_len:2d} tok, "
              f"prefilled {out.prompt_len - cached:2d}, "
              f"served from cache {cached:2d}")
        outputs.append(out.token_ids)
    used = eng.allocator.num_used
    print(f"kv pages in use after drain: {used}/{eng.allocator.num_blocks} "
          f"(cache-resident pages keep the shared prefix warm)")
    stats = eng.prefix_cache_stats()
    if stats:
        print(f"hit-rate {stats['hit_rate']:.1%} "
              f"({stats['hit_tokens']:.0f}/{stats['lookup_tokens']:.0f} "
              f"prompt tokens), {stats['cached_pages']:.0f} cached pages")
    return outputs, stats


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = smoke_config("h2o-danube-1.8b")
    params = init_params(cfg, seed=0, device=dev)

    rng = np.random.default_rng(42)
    system = rng.integers(2, cfg.vocab_size,
                          SYSTEM_PROMPT_PAGES * PAGE_SIZE).tolist()
    prompts = [system + rng.integers(2, cfg.vocab_size, 6).tolist()
               for _ in range(N_SESSIONS)]

    def engine(enable):
        return PagedEngine(cfg, params, EngineConfig(
            num_pages=64, page_size=PAGE_SIZE, max_slots=4,
            enable_prefix_cache=enable), device=dev)

    cold, _ = drive(engine(False), prompts, "cold start (no prefix cache)")
    warm, stats = drive(engine(True), prompts, "radix prefix cache")
    match = cold == warm
    print(f"\noutputs identical across both engines: {match}")
    assert match, "prefix-cache path must be a pure optimization"
    return dict(outputs=warm, stats=stats)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never a fallback")
    main(ap.parse_args().device)
