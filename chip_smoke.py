"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (it uses
device 0) and the CUDA toolkit. It imports only ``repro_torch`` (never JAX
or the JAX package) and:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the port's CUDA kernels from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernel phases: hold each kernel against its plain PyTorch version on
   the card. ``paged_attention`` at h2o-danube-1.8b's widths (H 32, Hkv 8,
   Dh 80, page 16), float32 and bfloat16, with and without a sliding
   window, ragged context lengths including 0, a strided layer slice of a
   pool, and the (m, l) partials; then contexts split over several blocks
   (at a split's edges, over several splits, and past danube's 4096-token
   window, with and without it). ``flash_prefill`` in both entry points:
   the contiguous form at ``tests/test_kernels.py``'s sweep (causal,
   non-causal, windowed), and the engine form at danube's widths over a
   strided layer slice of a ``(L, P, ps, Hkv, Dh)`` pool, chunks at offset 0
   and past it. ``ssd_scan`` at the reference test's shapes and at
   mamba2-1.3b's full width, float32 and bfloat16 x. Tolerances: float32
   2e-5 and bfloat16 3e-2 (``tests/test_kernels.py``); 3e-2 for the
   engine form of flash_prefill in both types (it rounds its probabilities
   to bfloat16, so a one-ulp score difference can flip a rounding); 2e-4
   for ssd_scan (the Pallas kernel's test), relative to max |y| at full
   width;
4. serve phase: serves full-width h2o-danube-1.8b (24 layers, random
   weights from a seed, bfloat16) through ``LLMService`` on the port's
   ``PagedEngine``: 8 requests, one of them best-of-2, prompts of 64-1024
   tokens chunked across iterations, greedy and sampled, 32 new tokens
   each. The launch counts are read around this phase alone:
   ``paged_attention`` must equal 24 x the engine's decode steps and
   ``flash_prefill`` 24 x its prefill chunks;
5. oracle phase: serves a few greedy requests in float32 (``logits_fp32``)
   and checks every generated token against the argmax of the port's
   ``Model.forward`` over prompt + generated tokens;
6. mamba2 phase: full-width mamba2-1.3b (48 layers, d 2048, 64 SSD heads
   of 64, state 128, random weights from a seed, bfloat16): ``Model.
   prefill`` of 4 prompts x 1024 tokens, ``ssd_scan`` launched 48 times,
   then 32 greedy ``decode_step``s; prints the prefill time and the decode
   tokens/s. Then a float32 oracle: for 2 prompts x 512 tokens, the
   prefill's last logits and final SSM states (through the kernel) against
   stepping ``decode_step`` token by token from ``init_cache`` (no kernel),
   and the greedy tokens that follow from each;
7. times each kernel at its path's shapes beside its plain version, one
   PyTorch library call computing the same function where there is one,
   and the least time the card could take (its bound), and prints them as
   one JSON line; ``flash_prefill``'s engine form is also timed at each of
   the kernel phase's chunk shapes, beside SDPA, one line each. The times
   in the JSON line are of calls launched back to back from Python, as a
   caller meets them; the card's time alone and the host's time per call
   are printed beside them and kept in the detail line.

``python3 chip_smoke.py --host-cost SRC`` runs only the timing of the two
attention kernels, for the ``repro_torch`` package under ``SRC`` (e.g. an
unpacked earlier commit's ``src``), to compare two trees' host cost per
call on one card.

Any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import statistics
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
TOL_ENGINE = dict(rtol=3e-2, atol=3e-2)  # flash_prefill's engine form
# a bf16 result of float32 math against the plain version's: the two
# float32 values differ by ~1e-6, so their roundings differ by at most one
# bf16 ulp (2**-7 of the value) plus that float32 difference
TOL_BF16_OUT = dict(rtol=2.0 ** -7, atol=1e-5)
SSD_TOL = 2e-4  # of max |y| (max |state|)
KERNELS = ("paged_attention", "flash_prefill", "ssd_scan")

# danube decode-attention widths
H, HKV, DH, PS = 32, 8, 80, 16

SERVE_PROMPTS = [64, 1024, 333, 512, 777, 128, 900, 200]
SERVE_NEW = 32
ORACLE_PROMPTS = [64, 300, 700]
ORACLE_NEW = 16
NEAR_TIE = 2.0 ** -7  # of the largest |logit| (tests/test_engine.py)

# tests/test_kernels.py's flash_prefill sweep: b, s, h, hkv, dh, causal,
# window
FLASH_SWEEP = [(1, 128, 4, 4, 64, True, None), (2, 256, 8, 2, 64, True, None),
               (2, 256, 8, 2, 64, True, 64), (1, 128, 4, 1, 32, False, None),
               (2, 192, 6, 2, 80, True, None)]
# the engine form: (chunk length, chunk start); the serve phase's largest
# chunk is 512 tokens, its longest context 1040
ENGINE_CHUNKS = [(512, 0), (512, 512), (300, 37), (16, 1024)]
# ssd_scan: b, l, h, p, g, n, chunk; the reference test's, then mamba2's
# prefill (4 prompts x 1024 tokens)
SSD_SHAPES = [(2, 128, 4, 16, 1, 8, 16), (2, 128, 4, 16, 2, 8, 32),
              (2, 128, 4, 16, 2, 8, 64), (4, 1024, 64, 64, 1, 128, 256)]
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_NEW = 4, 1024, 32
MAMBA_ORACLE_BATCH, MAMBA_ORACLE_PROMPT, MAMBA_ORACLE_NEW = 2, 512, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3, bursts: int = 5):
    """Time of ``fn(i)`` per call over ``iters`` calls, by CUDA events, two
    ways. Returns (ms, device_ms, host_us):

    * ms: the calls launched back to back from the host, as a caller meets
      them. Where the host takes longer to make a call than the card to run
      it, this is the host's pace. The kernels line reports this time.
    * device_ms: the same calls queued behind a device-side sleep that
      outlasts the host's launching, so that the events time the card's
      work alone; the median of ``bursts`` such bursts.
    * host_us: the host's time to make one call, read while the card
      sleeps (no call waits for the card); the median of the bursts, since
      the host's pace drifts from burst to burst.
    Where a call waits for the card, device_ms and host_us are None.
    """
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ms = start.elapsed_time(stop) / iters
    slept = torch.cuda.Event(enable_timing=True)
    device, host = [], []
    misses = 0  # bursts whose launching outlasted the sleep
    while len(device) < bursts and misses < 3:
        # cycles at the H100's top SM clock (1.98 GHz): a slower clock
        # only lengthens the sleep
        t0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(int(2 * host_s * 1.98e9) + 2_000_000)
        start.record()
        t1 = time.perf_counter()
        for i in range(iters):
            fn(i)
        t2 = time.perf_counter()
        stop.record()
        torch.cuda.synchronize()
        if slept.elapsed_time(start) > (t2 - t0) * 1e3:
            # the sleep outlasted the launching
            device.append(start.elapsed_time(stop) / iters)
            host.append((t2 - t1) / iters * 1e6)
        else:
            misses += 1
            host_s *= 4
    if len(device) < bursts:
        return ms, None, None  # fn waits for the card: not measured
    return ms, statistics.median(device), statistics.median(host)


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
    from repro_torch.kernels.paged_attention import (SPLIT_TOKENS,
                                                     paged_attention)
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
    # contexts split over several blocks: at a split's edges, over several
    # splits beside an empty row, and past danube's 4096-token window
    split = SPLIT_TOKENS
    lens = [split - 1, split, split + 1, 3 * split + 5, 0, 4096 + 300]
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 4096):
            q, k, v, bt, ctx = paged_inputs(gen, dev, dtype, lens)
            k, v = k[0], v[0]
            out, m, l = paged_attention(q, k, v, bt, ctx, page_size=PS,
                                        window=window, return_partials=True)
            torch.cuda.synchronize()
            wo, wm, wl = ref.paged_attention(q, k, v, bt, ctx, page_size=PS,
                                             window=window,
                                             return_partials=True)
            torch.testing.assert_close(out.float(), wo.float(), **TOL[dtype])
            if dtype == torch.bfloat16:
                # outputs over long contexts are small (|o| ~ 0.05), under
                # TOL's 3e-2: hold them to one bf16 rounding of the plain
                # result as well
                torch.testing.assert_close(out.float(), wo.float(),
                                           **TOL_BF16_OUT)
            torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
            err = (out.float() - wo.float()).abs().max().item()
            cases.append(dict(dtype=str(dtype).split(".")[-1],
                              window=window, layout="split_contexts",
                              context_lens=lens, max_abs_err=err,
                              max_abs_ref=wo.float().abs().max().item()))
            log(f"kernel phase: paged_attention {cases[-1]} ok")
    return cases


def flash_phase(dev):
    """flash_prefill in both entry points against its plain versions."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   prefill_attention_paged)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hkv, dh, causal, window in FLASH_SWEEP:
            q = torch.randn((b, s, h, dh), generator=gen, device=dev)
            k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            out = flash_prefill(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.flash_prefill(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL[dtype])
            cases.append(dict(form="contiguous", dtype=str(dtype)[6:],
                              shape=[b, s, h, hkv, dh], causal=causal,
                              window=window, max_abs_err=(
                                  out.float() - want.float()).abs().max()
                              .item()))
            log(f"kernel phase: flash_prefill {cases[-1]} ok")
        for s, q_offset in ENGINE_CHUNKS:
            for window in (None, 24):
                ctx = q_offset + s
                # a 3-layer pool with room for the context in random pages
                q, kp, vp, bt, _ = paged_inputs(
                    gen, dev, dtype, [ctx], layers=3)
                q = torch.randn((1, s, H, DH), generator=gen,
                                device=dev).to(dtype)
                pages = bt[0]
                out = prefill_attention_paged(q, kp[1], vp[1], pages,
                                              q_offset=q_offset,
                                              window=window)
                torch.cuda.synchronize()
                want = ref.prefill_attention_paged(
                    q, kp[1], vp[1], pages, q_offset=q_offset,
                    window=window)
                torch.testing.assert_close(out.float(), want.float(),
                                           **TOL_ENGINE)
                cases.append(dict(form="engine", dtype=str(dtype)[6:],
                                  chunk=s, q_offset=q_offset, window=window,
                                  max_abs_err=(out.float() - want.float())
                                  .abs().max().item()))
                log(f"kernel phase: flash_prefill {cases[-1]} ok")
    return cases


def ssd_inputs(gen, dev, dtype, b, l, h, p, g, n):
    """x, dt (softplus of a normal), A (-exp of a normal / 2), B, C."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (rand(b, l, h, p).to(dtype),
            torch.nn.functional.softplus(rand(b, l, h)),
            -torch.exp(0.5 * rand(h)), rand(b, l, g, n).to(dtype),
            rand(b, l, g, n).to(dtype))


def ssd_phase(dev):
    """ssd_scan against its plain version: errors relative to max |y| and
    max |state|, held at 2e-4."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, h, p, g, n, chunk in SSD_SHAPES:
            args = ssd_inputs(gen, dev, dtype, b, l, h, p, g, n)
            y, st = ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            yr, sr = ref.ssd_scan(*args, chunk=chunk)
            y_err = ((y - yr).abs().max() / yr.abs().max()).item()
            s_err = ((st - sr).abs().max() / sr.abs().max()).item()
            cases.append(dict(dtype=str(dtype)[6:],
                              shape=[b, l, h, p, g, n], chunk=chunk,
                              y_rel_err=y_err, state_rel_err=s_err,
                              max_abs_y=yr.abs().max().item()))
            assert y_err <= SSD_TOL and s_err <= SSD_TOL, cases[-1]
            log(f"kernel phase: ssd_scan {cases[-1]} ok")
            del args, y, st, yr, sr
    torch.cuda.empty_cache()
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
    from repro_torch.kernels.flash_prefill import flash_prefill
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
    flash_prefill.launches = 0
    decode0, chunks0 = engine.decode_steps, engine.prefill_chunks
    t0 = time.monotonic()
    while svc.pending:
        svc.poll()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = paged_attention.launches
    prefill_launches = flash_prefill.launches
    decode_steps = engine.decode_steps - decode0
    chunks = engine.prefill_chunks - chunks0

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
    assert chunks > 0
    assert prefill_launches == cfg.num_layers * chunks, \
        f"flash_prefill launched {prefill_launches} times over {chunks} " \
        f"prefill chunks of {cfg.num_layers} layers"
    log(f"serve phase: {len(outs)} requests ({n_tokens} tokens) in "
        f"{engine.iterations} iterations, {decode_steps} decode steps, "
        f"{chunks} prefill chunks; paged_attention launches {launches} = "
        f"{cfg.num_layers} x {decode_steps}; flash_prefill launches "
        f"{prefill_launches} = {cfg.num_layers} x {chunks}")
    stats = dict(requests=len(outs), tokens=n_tokens, wall_s=wall,
                 tokens_per_s=n_tokens / wall,
                 ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
                 iterations=engine.iterations, decode_steps=decode_steps,
                 prefill_chunks=chunks, launches=launches,
                 prefill_launches=prefill_launches)
    del engine, params, svc
    torch.cuda.empty_cache()
    return stats


# -- oracle phase -----------------------------------------------------------------

def oracle_phase(dev, seed: int):
    """Greedy tokens of the float32 engine against the argmax of the port's
    Model.forward over prompt + generated tokens. The engine's prefill
    attention (the engine form of flash_prefill) rounds q, k, v and the
    probabilities to bf16 as the oracle's blockwise_attention does, in
    another order of sums; its decode attention (paged_attention) is
    float32 throughout. A mismatch is
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
    eps = NEAR_TIE

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


# -- mamba2 phase -----------------------------------------------------------------

def greedy_compare(a_logits, b_logits, vocab, what):
    """Token ``a`` against the argmax of oracle logits ``b``, by the oracle
    phase's rule. Returns (equal, near_tie, gap / largest |logit|)."""
    la, lb = a_logits[:vocab].float(), b_logits[:vocab].float()
    top2 = torch.topk(lb, 2)
    tok = int(la.argmax())
    gap = float(top2.values[0] - top2.values[1])
    scale = float(lb.abs().max())
    if tok == int(top2.indices[0]):
        return True, False, gap / scale
    assert tok == int(top2.indices[1]) and gap < NEAR_TIE * scale, \
        f"{what}: kernel path {tok}, recurrence {int(top2.indices[0])}, " \
        f"top-2 gap {gap} >= {NEAR_TIE * scale}"
    return False, True, gap / scale


def mamba_phase(dev, seed: int):
    """Full-width mamba2-1.3b: bf16 prefill of 4 x 1024 tokens through the
    ssd_scan kernel and 32 greedy decode steps, then the float32 oracle."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.transformer import Model

    cfg = get_config("mamba2-1.3b")  # full width, all 48 layers
    t0 = time.monotonic()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"mamba2 phase: {cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} "
        f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, {n_params / 1e9:.3f} B params {cfg.dtype} on "
        f"the card in {time.monotonic() - t0:.1f}s")
    model = Model(cfg)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT)), device=dev)
    # warm-up at the timed shapes: the first calls load kernels and pick
    # GEMM algorithms
    _, warm = model.prefill(params, toks)
    model.decode_step(params, toks[:, :1], toks[:, 0], warm)
    del warm
    torch.cuda.synchronize()

    ssd_scan.launches = 0  # read around this prefill alone
    t0 = time.monotonic()
    logits, caches = model.prefill(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    launches = ssd_scan.launches
    assert launches == cfg.num_layers, \
        f"ssd_scan launched {launches} times in one prefill of " \
        f"{cfg.num_layers} layers"
    assert logits.shape == (MAMBA_BATCH, pad_vocab(cfg.vocab_size))
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    assert all(torch.isfinite(c.state).all() for c in caches)

    tok = logits[:, :cfg.vocab_size].argmax(-1)
    pos = torch.full((MAMBA_BATCH,), MAMBA_PROMPT, device=dev)
    t0 = time.monotonic()
    generated = []
    for i in range(MAMBA_NEW):
        logits, caches = model.decode_step(params, tok[:, None], pos + i,
                                           caches)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t0
    gen = torch.stack(generated, 1)
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    prompt_tokens = MAMBA_BATCH * MAMBA_PROMPT
    log(f"mamba2 phase: prefill of {MAMBA_BATCH} x {MAMBA_PROMPT} tokens "
        f"in {prefill_s * 1e3:.1f} ms ({prompt_tokens / prefill_s:.0f} "
        f"tokens/s); ssd_scan launches {launches} = "
        f"{cfg.num_layers} x 1 prefill; {MAMBA_NEW} greedy decode steps in "
        f"{decode_s * 1e3:.1f} ms ({MAMBA_BATCH * MAMBA_NEW / decode_s:.1f} "
        f"tokens/s)")
    del params, caches, logits
    torch.cuda.empty_cache()
    oracle = mamba_oracle(dev, seed)
    return dict(params=n_params, batch=MAMBA_BATCH, prompt=MAMBA_PROMPT,
                prefill_ms=prefill_s * 1e3,
                prefill_tokens_per_s=prompt_tokens / prefill_s,
                decode_steps=MAMBA_NEW, decode_ms=decode_s * 1e3,
                decode_tokens_per_s=MAMBA_BATCH * MAMBA_NEW / decode_s,
                launches=launches, oracle=oracle)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def mamba_oracle(dev, seed: int):
    """Float32 mamba2-1.3b: ``Model.prefill`` (the ssd_scan kernel, 2
    chunks of 256) against stepping ``decode_step`` token by token from
    ``init_cache`` (the plain recurrence, no kernel). The last-position
    logits, the final SSM states and the conv tails of all 48 layers must
    agree to 1e-3 of their largest magnitude: both are float32, and only
    the order of sums differs, over 48 layers of 512 steps. Then 8 greedy tokens follow from
    each path's caches; they must be equal, except at a near-tie of the
    recurrence's logits (2**-7 of the largest |logit|), where comparing
    stops."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.transformer import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    model = Model(cfg)
    b, s, v = MAMBA_ORACLE_BATCH, MAMBA_ORACLE_PROMPT, cfg.vocab_size
    rng = np.random.default_rng(seed + 1)
    toks = torch.as_tensor(rng.integers(0, v, (b, s)), device=dev)
    before = ssd_scan.launches
    lk, ck = model.prefill(params, toks)
    assert ssd_scan.launches == before + cfg.num_layers
    lr, cr = None, model.init_cache(b, device=dev)
    launches = ssd_scan.launches
    for t in range(s):
        lr, cr = model.decode_step(params, toks[:, t:t + 1],
                                   torch.full((b,), t, device=dev), cr)
    assert ssd_scan.launches == launches  # the recurrence has no kernel
    logit_err = ((lk[:, :v] - lr[:, :v]).abs().max()
                 / lr[:, :v].abs().max()).item()
    state_err = ((ck[0].state - cr[0].state).abs().max()
                 / cr[0].state.abs().max()).item()
    conv_err = ((ck[0].conv - cr[0].conv).abs().max()
                / cr[0].conv.abs().max()).item()
    log(f"mamba2 oracle: {b} x {s} tokens float32, kernel prefill vs "
        f"token-by-token recurrence: last logits {logit_err:.3g}, final "
        f"states {state_err:.3g}, conv tails {conv_err:.3g} of their "
        f"largest magnitude")
    assert max(logit_err, state_err, conv_err) <= 1e-3, \
        (logit_err, state_err, conv_err)

    compared = near_ties = 0
    min_gap = math.inf
    live = [True] * b
    pos = torch.full((b,), s, device=dev)
    for i in range(MAMBA_ORACLE_NEW):
        for r in range(b):
            if not live[r]:
                continue
            equal, tie, gap = greedy_compare(lk[r], lr[r], v,
                                             f"row {r} token {i}")
            compared += 1
            min_gap = min(min_gap, gap)
            if tie:
                near_ties += 1
                live[r] = False
                log(f"mamba2 oracle: near-tie at token {i} of row {r}; "
                    "stop there")
        tk = lk[:, :v].argmax(-1)
        tr = lr[:, :v].argmax(-1)
        lk, ck = model.decode_step(params, tk[:, None], pos + i, ck)
        lr, cr = model.decode_step(params, tr[:, None], pos + i, cr)
    total = b * MAMBA_ORACLE_NEW
    assert compared >= total // 2, f"only {compared}/{total} compared"
    log(f"mamba2 oracle: {compared}/{total} greedy tokens equal, "
        f"{near_ties} near-tie stops, smallest top-2 gap {min_gap:.3g} of "
        f"the largest |logit|")
    del params, ck, cr
    torch.cuda.empty_cache()
    return dict(batch=b, prompt=s, logit_rel_err=logit_err,
                state_rel_err=state_err, conv_rel_err=conv_err,
                compared=compared, total=total, near_tie_stops=near_ties,
                min_gap_rel=min_gap)


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
    ms, device_ms, host_us = cuda_ms(lambda i: paged_attention(
        q, kp[i % L], vp[i % L], bt, ctx, page_size=PS, window=window),
        iters)
    paged_attention.launches = before  # timing launches are not the path's
    plain_ms, plain_device_ms, _ = cuda_ms(lambda i: ref.paged_attention(
        q, kp[i % L], vp[i % L], bt, ctx, page_size=PS, window=window),
        iters)
    library_ms, library_device_ms, library_host_us = cuda_ms(
        lambda i: F.scaled_dot_product_attention(
            q4, kg[i % L], vg[i % L], attn_mask=mask, enable_gqa=True),
        iters)

    # the least the card could take: each input byte read once, the output
    # written once (K/V of the valid positions only), or the operations
    esz = torch.finfo(dtype).bits // 8
    valid_tokens = sum(min(x, window) for x in lens)
    n_pages = sum(-(-x // PS) for x in lens)
    nbytes = valid_tokens * HKV * DH * 2 * esz + 2 * b * H * DH * esz \
        + 4 * (n_pages + b)
    flops = 4 * H * DH * valid_tokens
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:103",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms), \
        dict(batch=b, context_lens=lens, bytes=nbytes, flops=flops,
             dtype="bfloat16", window=window, device_ms=device_ms,
             plain_device_ms=plain_device_ms,
             library_device_ms=library_device_ms, host_us=host_us,
             library_host_us=library_host_us)


def bound(nbytes: int, flops: int, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger. Returns (ms,
    what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_timing(dev, seed: int, launches: int):
    """The engine form of flash_prefill at a serve-phase chunk: the second
    512-token chunk of the 1024-token prompt (positions 512..1023 over 1024
    keys), bf16 pools of the serve engine's geometry for all 24 layers,
    cycled so that every call reads its layer's K/V from device memory.
    Then the kernel and SDPA at each ``ENGINE_CHUNKS`` shape."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   prefill_attention_paged)
    cfg = get_config("h2o-danube-1.8b")
    L, dtype, window = cfg.num_layers, torch.bfloat16, cfg.sliding_window
    s, q_offset = 512, 512
    ctx = q_offset + s
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (L, SERVE_ENGINE["num_pages"] + 1, PS, HKV, DH)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    n = ctx // PS
    pages = torch.randperm(shape[1] - 1, generator=gen, device=dev)[:n] \
        .to(torch.int32)
    q = torch.randn((1, s, H, DH), generator=gen, device=dev).to(dtype)

    out = prefill_attention_paged(q, kp[0], vp[0], pages, q_offset=q_offset,
                                  window=window)
    want = ref.prefill_attention_paged(q, kp[0], vp[0], pages,
                                       q_offset=q_offset, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL_ENGINE)
    err = (out.float() - want.float()).abs().max().item()

    # the library yardstick: SDPA over K/V gathered per layer beforehand
    # (the gather is not timed), GQA heads shared, the causal mask at the
    # chunk's offset
    idx = pages.long()
    kg = [kp[i][idx].reshape(1, ctx, HKV, DH).transpose(1, 2)
          for i in range(L)]
    vg = [vp[i][idx].reshape(1, ctx, HKV, DH).transpose(1, 2)
          for i in range(L)]
    qpos = q_offset + torch.arange(s, device=dev)
    kpos = torch.arange(ctx, device=dev)
    mask = (kpos[None] <= qpos[:, None]) & (kpos[None] > qpos[:, None] -
                                            window)
    q4 = q.transpose(1, 2)
    lib = F.scaled_dot_product_attention(q4, kg[0], vg[0], attn_mask=mask,
                                         enable_gqa=True)
    torch.testing.assert_close(lib.transpose(1, 2).float(), want.float(),
                               **TOL_ENGINE)

    iters = 2 * L
    before = flash_prefill.launches
    ms, device_ms, host_us = cuda_ms(lambda i: prefill_attention_paged(
        q, kp[i % L], vp[i % L], pages, q_offset=q_offset, window=window),
        iters)
    flash_prefill.launches = before  # timing launches are not the path's
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.prefill_attention_paged(
            q, kp[i % L], vp[i % L], pages, q_offset=q_offset,
            window=window), iters)
    library_ms, library_device_ms, library_host_us = cuda_ms(
        lambda i: F.scaled_dot_product_attention(
            q4, kg[i % L], vg[i % L], attn_mask=mask, enable_gqa=True),
        iters)

    # bytes: q and the output once, K/V of the context once, the page ids;
    # operations: QK^T and PV over the valid (query, key) pairs
    esz = torch.finfo(dtype).bits // 8
    pairs = int(mask.sum())
    nbytes = 2 * s * H * DH * esz + 2 * ctx * HKV * DH * esz + 4 * n
    flops = 4 * H * DH * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)

    # the kernel alone at each of the kernel phase's engine chunk shapes,
    # beside SDPA on the same chunk (the mix a serve run launches)
    chunks = []
    all_pages = torch.randperm(shape[1] - 1, generator=gen, device=dev) \
        .to(torch.int32)
    for cs, co in ENGINE_CHUNKS:
        cctx = co + cs
        cn = -(-cctx // PS)
        cpages = all_pages[:cn]
        cq = q[:, :cs].contiguous()
        cms, cdev, _ = cuda_ms(lambda i: prefill_attention_paged(
            cq, kp[i % L], vp[i % L], cpages, q_offset=co, window=window),
            iters)
        cpos = co + torch.arange(cs, device=dev)
        ckpos = torch.arange(cctx, device=dev)
        cmask = (ckpos[None] <= cpos[:, None]) & \
            (ckpos[None] > cpos[:, None] - window)
        cidx = cpages.long()
        ck = [kp[i][cidx].reshape(1, cn * PS, HKV, DH)[:, :cctx]
              .transpose(1, 2) for i in range(L)]
        cv = [vp[i][cidx].reshape(1, cn * PS, HKV, DH)[:, :cctx]
              .transpose(1, 2) for i in range(L)]
        cq4 = cq.transpose(1, 2)
        clib, clib_dev, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
            cq4, ck[i % L], cv[i % L], attn_mask=cmask, enable_gqa=True),
            iters)
        cpairs = int(cmask.sum())
        cb, _ = bound(2 * cs * H * DH * esz + 2 * cctx * HKV * DH * esz,
                      4 * H * DH * cpairs, dtype)
        chunks.append(dict(chunk=cs, q_offset=co, valid_pairs=cpairs,
                           ms=cms, library_ms=clib, device_ms=cdev,
                           library_device_ms=clib_dev, bound_ms=cb))
    flash_prefill.launches = before
    return dict(name="flash_prefill", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill.py:73",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms), \
        dict(chunk=s, q_offset=q_offset, keys=ctx, valid_pairs=pairs,
             bytes=nbytes, flops=flops, dtype="bfloat16", window=window,
             engine_chunks=chunks, device_ms=device_ms,
             plain_device_ms=plain_device_ms,
             library_device_ms=library_device_ms, host_us=host_us,
             library_host_us=library_host_us)


def ssd_timing(dev, seed: int, launches: int):
    """ssd_scan at mamba2-1.3b's prefill shapes (4 x 1024 tokens, 64 heads
    of 64, state 128, one group, chunk 256), bf16 x / B / C; three input
    sets, cycled, so that no call finds its inputs in the 50 MB L2. No
    single PyTorch call computes this function: library_ms is null."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, l, h, p, g, n, chunk = SSD_SHAPES[-1]
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sets = [ssd_inputs(gen, dev, dtype, b, l, h, p, g, n) for _ in range(3)]
    y, st = ssd_scan(*sets[0], chunk=chunk)
    yr, sr = ref.ssd_scan(*sets[0], chunk=chunk)
    err = (y - yr).abs().max().item()
    assert err <= SSD_TOL * yr.abs().max().item()
    del y, st, yr, sr

    before = ssd_scan.launches
    ms, device_ms, host_us = cuda_ms(
        lambda i: ssd_scan(*sets[i % 3], chunk=chunk), 9)
    ssd_scan.launches = before  # timing launches are not the path's
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.ssd_scan(*sets[i % 3], chunk=chunk), 6, warmup=1)

    # bytes: x, dt, A, B, C read once, y and the state written once;
    # operations: per (sequence, head, chunk) the masked scores C_i.B_j and
    # their product with xdt over the j <= i pairs, C S^T and the state
    # update
    esz = torch.finfo(dtype).bits // 8
    nbytes = b * l * h * p * esz + b * l * h * 4 + h * 4 \
        + 2 * b * l * g * n * esz + b * l * h * p * 4 + b * h * p * n * 4
    pairs = chunk * (chunk + 1) // 2
    flops = b * h * (l // chunk) * (2 * pairs * (n + p) + 4 * chunk * n * p)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    del sets
    torch.cuda.empty_cache()
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:68",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), \
        dict(shape=[b, l, h, p, g, n], chunk=chunk, bytes=nbytes,
             flops=flops, dtype="bfloat16", device_ms=device_ms,
             plain_device_ms=plain_device_ms, host_us=host_us)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def log_timings(card: str, timed) -> None:
    """One line per kernel: back to back (the kernels line's times), then
    the card's time alone and the host's per call."""
    for k, shapes in timed:
        for c in shapes.get("engine_chunks", ()):
            log(f"flash_prefill engine chunk on {card}: {c['chunk']} queries "
                f"at offset {c['q_offset']} ({c['valid_pairs']} valid pairs "
                f"x {H} heads): back to back kernel {c['ms']:.4f} ms, SDPA "
                f"{c['library_ms']:.4f} ms; device kernel "
                f"{fmt_ms(c['device_ms'])}, SDPA "
                f"{fmt_ms(c['library_device_ms'])}; bound "
                f"{c['bound_ms']:.5f} ms")
        lib = "null" if k["library_ms"] is None \
            else f"{k['library_ms']:.4f} ms"
        host = f"{shapes['host_us']:.1f} us" \
            if shapes["host_us"] is not None else "not measured"
        log(f"{k['name']} on {card}: back to back kernel {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, library {lib}; device kernel "
            f"{fmt_ms(shapes['device_ms'])}, plain "
            f"{fmt_ms(shapes['plain_device_ms'])}, library "
            f"{fmt_ms(shapes.get('library_device_ms'))}; host {host} per "
            f"call; bound {k['bound_ms']:.4f} ms ({k['bound_by']}) at "
            f"{shapes}")


def host_cost(src: Path) -> int:
    """``--host-cost SRC``: the timing of the two attention wrappers alone
    (paged_attention at the serve decode shape, flash_prefill's engine form
    at its chunks), for the ``repro_torch`` under ``SRC``, e.g. an unpacked
    earlier commit's ``src``, so that two trees' host cost per call can be
    compared on one card, the trees run in turns."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import _build
    for name in KERNELS[:2]:
        _build.build(name)
    dev = torch.device("cuda", 0)
    card = card_line()
    paged, paged_shapes = timing_phase(dev, seed=2, launches=0)
    flash, flash_shapes = flash_timing(dev, seed=5, launches=0)
    log(f"host cost of {src} on {card}")
    log_timings(card, [(paged, paged_shapes), (flash, flash_shapes)])
    log("host_cost " + json.dumps(dict(
        src=str(src), card=card,
        paged_attention=dict(ms=paged["ms"], library_ms=paged["library_ms"],
                             **paged_shapes),
        flash_prefill=dict(ms=flash["ms"], library_ms=flash["library_ms"],
                           **flash_shapes))))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if len(sys.argv) == 3 and sys.argv[1] == "--host-cost":
        return host_cost(Path(sys.argv[2]))
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build  # fails outside a checkout

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    log(f"build: {', '.join(KERNELS)} in {time.monotonic() - t0:.1f}s")
    for name, build_log in builds.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cases = kernel_phase(dev) + flash_phase(dev) + ssd_phase(dev)
    serve = serve_phase(dev, seed=0)
    oracle = oracle_phase(dev, seed=1)
    mamba = mamba_phase(dev, seed=3)
    paged, paged_shapes = timing_phase(dev, seed=2,
                                       launches=serve["launches"])
    flash, flash_shapes = flash_timing(dev, seed=5,
                                       launches=serve["prefill_launches"])
    ssd, ssd_shapes = ssd_timing(dev, seed=6, launches=mamba["launches"])

    card = card_line()
    log(f"serve phase on {card}: {serve['tokens_per_s']:.1f} tokens/s "
        f"({serve['tokens']} tokens in {serve['wall_s']:.2f}s), mean TTFT "
        f"{serve['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
        f"{serve['ttft_max_s'] * 1e3:.1f} ms")
    log(f"mamba2 phase on {card}: prefill {mamba['prefill_ms']:.1f} ms "
        f"for {MAMBA_BATCH} x {MAMBA_PROMPT} tokens, decode "
        f"{mamba['decode_tokens_per_s']:.1f} tokens/s")
    log_timings(card, [(paged, paged_shapes), (flash, flash_shapes),
                       (ssd, ssd_shapes)])
    log("detail " + json.dumps(dict(
        card=card, serve=serve, oracle=oracle, mamba=mamba,
        kernel_cases=cases, timing=dict(paged_attention=paged_shapes,
                                        flash_prefill=flash_shapes,
                                        ssd_scan=ssd_shapes))))
    log(card)
    log(json.dumps({"kernels": [paged, flash, ssd]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
