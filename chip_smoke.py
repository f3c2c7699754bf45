"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (it uses
device 0) and the CUDA toolkit. It imports only ``repro_torch`` (never JAX
or the JAX package) and:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the CUDA kernel of the serving path from ``src/repro_torch/
   csrc``;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at h2o-danube-1.8b's widths (H 32, Hkv 8, Dh 80, page 16), in
   float32 and bfloat16, with and without a sliding window, ragged context
   lengths including 0, a strided layer slice of a pool, and the (m, l)
   partials. Tolerances are ``tests/test_kernels.py``'s: float32 2e-5,
   bfloat16 3e-2;
4. serve phase: serves full-width h2o-danube-1.8b (24 layers, random
   weights from a seed, bfloat16) through ``LLMService`` on the port's
   ``PagedEngine``: 8 requests, one of them best-of-2, prompts of 64-1024
   tokens chunked across iterations, greedy and sampled, 32 new tokens
   each. The kernel's launch count is read around this phase alone and
   must equal 24 x the engine's decode steps;
5. oracle phase: serves a few greedy requests in float32 (``logits_fp32``)
   and checks every generated token against the argmax of the port's
   ``Model.forward`` over prompt + generated tokens;
6. times each kernel at the serve phase's shapes beside its plain version,
   one PyTorch library call computing the same function, and the least
   time the card could take (its bound), and prints them as one JSON line.

Any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# bytes/s, and bf16 tensor-core and float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}

# danube decode-attention widths
H, HKV, DH, PS = 32, 8, 80, 16

SERVE_PROMPTS = [64, 1024, 333, 512, 777, 128, 900, 200]
SERVE_NEW = 32
ORACLE_PROMPTS = [64, 300, 700]
ORACLE_NEW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- kernel phase ---------------------------------------------------------------

def paged_inputs(gen, dev, dtype, lens, layers=1, extra_pages=3,
                 page_major=False):
    """Pools of ``layers`` layers, a (B, n) block table of distinct pages
    in random order, q. ``page_major`` lays the pool out as (P, L, ...),
    so a layer slice has a page stride of L pages."""
    b = len(lens)
    n = max(1, max(-(-x // PS) for x in lens))
    npages = b * n + extra_pages
    shape = (npages, layers, PS, HKV, DH) if page_major else \
        (layers, npages, PS, HKV, DH)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npages, generator=gen, device=dev)[:b * n]
    bt = perm.reshape(b, n).to(torch.int32)
    q = torch.randn((b, H, DH), generator=gen, device=dev).to(dtype)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, ctx


def kernel_phase(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lens = [0, 1, 15, 16, 17, 300, 0, 1056]  # ragged, two empty rows
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 24):
            for layout in ("layer_slice", "page_major_slice"):
                q, kp, vp, bt, ctx = paged_inputs(
                    gen, dev, dtype, lens, layers=3,
                    page_major=layout == "page_major_slice")
                k = kp[:, 1] if layout == "page_major_slice" else kp[1]
                v = vp[:, 1] if layout == "page_major_slice" else vp[1]
                out, m, l = paged_attention(q, k, v, bt, ctx, page_size=PS,
                                            window=window,
                                            return_partials=True)
                torch.cuda.synchronize()
                wo, wm, wl = ref.paged_attention(
                    q, k.contiguous(), v.contiguous(), bt, ctx,
                    page_size=PS, window=window, return_partials=True)
                torch.testing.assert_close(out.float(), wo.float(),
                                           **TOL[dtype])
                torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
                torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
                empty = ctx == 0
                assert (out[empty] == 0).all() and (l[empty] == 0).all()
                err = (out.float() - wo.float()).abs().max().item()
                cases.append(dict(dtype=str(dtype).split(".")[-1],
                                  window=window, layout=layout,
                                  max_abs_err=err))
                log(f"kernel phase: paged_attention {cases[-1]} ok")
    return cases


# -- serve phase ------------------------------------------------------------------

# the serve phase's engine geometry and traffic; benchmarks/
# torch_decode_profile.py imports both, so that it profiles the same run
SERVE_ENGINE = dict(num_pages=1024, page_size=PS, max_slots=8,
                    max_tokens_per_iter=512)


def serve_requests(vocab_size: int, seed: int):
    """(prompt, SamplingParams) of each request: prompts of SERVE_PROMPTS
    tokens drawn from ``seed``, SERVE_NEW new tokens each; the first is a
    sampled best-of-2, then sampled (top-k 50, top-p 0.95) and greedy in
    turn."""
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i, plen in enumerate(SERVE_PROMPTS):
        prompt = rng.integers(0, vocab_size, plen).tolist()
        if i == 0:  # first, so that its sibling finds a slot to fork into
            sp = SamplingParams(temperature=1.0, max_new_tokens=SERVE_NEW,
                                n=2, seed=i)
        elif i % 2:
            sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                max_new_tokens=SERVE_NEW, seed=i)
        else:
            sp = SamplingParams(max_new_tokens=SERVE_NEW)
        reqs.append((prompt, sp))
    return reqs


def serve_phase(dev, seed: int):
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.api import LLMService
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    cfg = get_config("h2o-danube-1.8b")  # full width, all 24 layers
    t0 = time.monotonic()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"serve phase: {cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} "
        f"{cfg.dtype} weights on the card in {time.monotonic() - t0:.1f}s")
    engine = PagedEngine(cfg, params, EngineConfig(**SERVE_ENGINE,
                                                   seed=seed), device=dev)
    svc = LLMService(engine)
    ids = [(svc.submit(prompt, sp), sp)
           for prompt, sp in serve_requests(cfg.vocab_size, seed)]

    paged_attention.launches = 0  # read around this phase alone
    decode0 = engine.decode_steps
    t0 = time.monotonic()
    while svc.pending:
        svc.poll()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = paged_attention.launches
    decode_steps = engine.decode_steps - decode0

    outs = [svc._take_result(rid) for rid, _ in ids]
    n_tokens = 0
    ttfts = []
    for (rid, sp), out in zip(ids, outs):
        assert len(out.samples) == sp.n, (rid, len(out.samples))
        for s in out.samples:
            assert len(s.token_ids) == SERVE_NEW and \
                s.finish_reason == "length", (rid, s)
            assert all(0 <= t < cfg.vocab_size for t in s.token_ids)
            assert all(math.isfinite(x) for x in s.token_logprobs)
            n_tokens += len(s.token_ids)
        ttfts.append(out.metrics.ttft)
    assert decode_steps > 0
    assert launches == cfg.num_layers * decode_steps, \
        f"paged_attention launched {launches} times over {decode_steps} " \
        f"decode steps of {cfg.num_layers} layers"
    log(f"serve phase: {len(outs)} requests ({n_tokens} tokens) in "
        f"{engine.iterations} iterations, {decode_steps} decode steps; "
        f"paged_attention launches {launches} = {cfg.num_layers} x "
        f"{decode_steps}")
    stats = dict(requests=len(outs), tokens=n_tokens, wall_s=wall,
                 tokens_per_s=n_tokens / wall,
                 ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
                 iterations=engine.iterations, decode_steps=decode_steps,
                 launches=launches)
    del engine, params, svc
    torch.cuda.empty_cache()
    return stats


# -- oracle phase -----------------------------------------------------------------

def oracle_phase(dev, seed: int):
    """Greedy tokens of the float32 engine against the argmax of the port's
    Model.forward over prompt + generated tokens. The engine's decode
    attention is float32 (the kernel); the oracle's, like the reference's
    prefill, rounds q, k, v and the probabilities to bf16. A mismatch is
    allowed only where the oracle's top-2 logits are closer than eps = 2**-7
    of the largest |logit| at that position (one bf16 ulp, with room for an
    exponent step, as ``tests/test_engine.py`` allows) and the engine chose
    the runner-up; comparing that request stops there. The smallest top-2
    gap over the compared positions, relative to the largest |logit|, is
    returned, to show how near the run came to a tie."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    eps = 2.0 ** -7

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              dtype="float32", logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    engine = PagedEngine(cfg, params, EngineConfig(
        num_pages=256, page_size=PS, max_slots=4, max_tokens_per_iter=512),
        device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ORACLE_PROMPTS]
    outs = LLMService(engine).generate(
        prompts, SamplingParams(max_new_tokens=ORACLE_NEW))
    del engine
    model = Model(cfg)
    compared = mismatches = 0
    min_gap_rel = math.inf
    for prompt, out in zip(prompts, outs):
        full = torch.tensor(prompt + out.token_ids[:-1], device=dev)
        logits, _ = model.forward(params, full[None])
        # the rows that predict each new token, over the real vocab: the
        # padded entries hold the type's lowest value, which would swamp
        # the largest |logit| that scales eps
        lg = logits[0, len(prompt) - 1:, :cfg.vocab_size].float()
        for i, tok in enumerate(out.token_ids):
            top2 = torch.topk(lg[i], 2)
            want = int(top2.indices[0])
            gap = float(top2.values[0] - top2.values[1])
            top = float(lg[i].abs().max())
            min_gap_rel = min(min_gap_rel, gap / top)
            compared += 1
            if tok == want:
                continue
            bound = eps * top
            assert tok == int(top2.indices[1]) and gap < bound, \
                f"token {i} of a {len(prompt)}-token prompt: engine {tok}, " \
                f"oracle {want}, top-2 gap {gap} >= {bound}"
            mismatches += 1
            log(f"oracle phase: near-tie at token {i} of a {len(prompt)}-"
                f"token prompt (gap {gap:.3g} < {bound:.3g}); stop there")
            break
    total = len(prompts) * ORACLE_NEW
    assert compared >= total // 2, f"only {compared}/{total} compared"
    log(f"oracle phase: {compared}/{total} float32 tokens compared with "
        f"Model.forward, {mismatches} near-tie stops, smallest top-2 gap "
        f"{min_gap_rel:.3g} of the largest |logit| (eps {eps:.3g})")
    del params, model
    torch.cuda.empty_cache()
    return dict(compared=compared, total=total, near_tie_stops=mismatches,
                eps_rel=eps, min_gap_rel=min_gap_rel)


# -- timing at the serve phase's shapes -----------------------------------------

def timing_phase(dev, seed: int, launches: int):
    """paged_attention at the serve phase's decode shapes: 8 slots, each
    context at its request's prompt + half the new tokens, bf16 pools of the
    engine's geometry for all 24 layers, cycled so that every call reads
    its layer's K/V from device memory as a decode step does."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    cfg = get_config("h2o-danube-1.8b")
    L, dtype, window = cfg.num_layers, torch.bfloat16, cfg.sliding_window
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = [p + SERVE_NEW // 2 for p in SERVE_PROMPTS]
    q, kp, vp, bt, ctx = paged_inputs(gen, dev, dtype, lens, layers=L)
    b, smax = len(lens), bt.shape[1] * PS

    out = paged_attention(q, kp[0], vp[0], bt, ctx, page_size=PS,
                          window=window)
    want = ref.paged_attention(q, kp[0], vp[0], bt, ctx, page_size=PS,
                               window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    err = (out.float() - want.float()).abs().max().item()

    # the library yardstick: SDPA over K/V gathered per layer beforehand
    # (the gather is not timed), GQA heads shared, a key mask per row
    idx = bt.long()
    kg = [kp[i][idx].reshape(b, smax, HKV, DH).transpose(1, 2)
          for i in range(L)]
    vg = [vp[i][idx].reshape(b, smax, HKV, DH).transpose(1, 2)
          for i in range(L)]
    pos = torch.arange(smax, device=dev)
    valid = (pos[None] < ctx[:, None]) & \
        (pos[None] > ctx[:, None] - 1 - window)
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kg[0], vg[0], attn_mask=mask,
                                         enable_gqa=True)
    torch.testing.assert_close(lib[:, :, 0].float(), want.float(),
                               **TOL[dtype])

    iters = 5 * L
    before = paged_attention.launches
    ms = cuda_ms(lambda i: paged_attention(
        q, kp[i % L], vp[i % L], bt, ctx, page_size=PS, window=window),
        iters)
    paged_attention.launches = before  # timing launches are not the path's
    plain_ms = cuda_ms(lambda i: ref.paged_attention(
        q, kp[i % L], vp[i % L], bt, ctx, page_size=PS, window=window),
        iters)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, kg[i % L], vg[i % L], attn_mask=mask, enable_gqa=True), iters)

    # the least the card could take: each input byte read once, the output
    # written once (K/V of the valid positions only), or the operations
    esz = torch.finfo(dtype).bits // 8
    valid_tokens = sum(min(x, window) for x in lens)
    n_pages = sum(-(-x // PS) for x in lens)
    nbytes = valid_tokens * HKV * DH * 2 * esz + 2 * b * H * DH * esz \
        + 4 * (n_pages + b)
    flops = 4 * H * DH * valid_tokens
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:103",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms), \
        dict(batch=b, context_lens=lens, bytes=nbytes, flops=flops,
             dtype="bfloat16", window=window)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build  # fails outside a checkout

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    build_log = _build.build("paged_attention")
    log(f"build: paged_attention in {time.monotonic() - t0:.1f}s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  paged_attention: {line.strip()}")

    cases = kernel_phase(dev)
    serve = serve_phase(dev, seed=0)
    oracle = oracle_phase(dev, seed=1)
    kernel, shapes = timing_phase(dev, seed=2, launches=serve["launches"])

    card = card_line()
    log(f"serve phase on {card}: {serve['tokens_per_s']:.1f} tokens/s "
        f"({serve['tokens']} tokens in {serve['wall_s']:.2f}s), mean TTFT "
        f"{serve['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
        f"{serve['ttft_max_s'] * 1e3:.1f} ms")
    log(f"paged_attention on {card} at {shapes}: kernel {kernel['ms']:.4f} "
        f"ms, plain {kernel['plain_ms']:.4f} ms, SDPA "
        f"{kernel['library_ms']:.4f} ms, bound {kernel['bound_ms']:.4f} ms")
    log("detail " + json.dumps(dict(card=card, serve=serve, oracle=oracle,
                                    kernel_cases=cases, timing=shapes)))
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
