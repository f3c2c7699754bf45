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
   and past it. ``ssd_scan`` at the reference test's shapes, at
   mamba2-1.3b's full width (4 x 1024 tokens, and one 4096-token prompt:
   a chain of 16 chunks) and at hymba-1.5b's widths (P 50, N 16), float32
   and bfloat16 x. Both attention kernels also at the GQA groups of the
   configs served below that lie outside {1, 2, 4, 8}: G 5, 6, 12 and 48
   at head_dim 128, float32 and bfloat16, window none and 24.
   ``prefill_attention(causal=False)`` (an encoder's self-attention and
   a decoder's cross-attention) at S = Skv in {64, 1000, 1024} and S in
   {1, 64, 130} over Skv in {16, 1000, 1024}, at seamless-m4t's widths
   (G 1, Dh 64) and internvl2's (G 6, Dh 128), float32 and bfloat16.
   ``paged_attention``'s (m, l) as the zero-copy decode uses them, at
   danube's widths and at G 1 (OPT), 5 and 48, float32 and bfloat16: a
   local and a leased context in two pools (several splits, rows with
   context 0 in either), each partial's out, m and l against the plain
   version, and their merge against the plain version over both. Tolerances:
   float32 2e-5 and bfloat16 3e-2 (``tests/test_kernels.py``); 3e-2 for the
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
   ``flash_prefill`` 24 x its prefill chunks; every logit must be finite;
5. oracle phase: serves a few greedy requests in float32 (``logits_fp32``)
   and checks every generated token against the argmax of the port's
   ``Model.forward`` over prompt + generated tokens;
6. slice-1 phase: danube in float32 on what the serve phase bypasses: a
   prefix-cache engine resuming mid-page, whose greedy tokens must equal a
   cold engine's, and whose ``prefix_cache_stats()`` must count as hits
   the tokens its requests were served from cache (no more than it looked
   up), its ``kv_utilization()`` in (0, 1] after the run; a context past the 4096-token window, through both
   kernels; a pool too small for its requests, which forces preemption
   and recompute; the last two against ``Model.forward``. Then the host
   tier on the same weights and preemption traffic, with 128 pinned host
   pages, in three configurations (``swap`` with lifo victims, the same
   with speculative swap-outs, ``auto`` with cost victims): each swaps out
   and back in where its mode swaps (``swap`` recomputing nothing), runs
   no prefill chunk after a decode-phase swap-in, exports a trace that
   passes ``validate_trace_events`` and ``validate_swap_balance``, holds
   its tokens against ``Model.forward`` and empties the allocator's
   device, host and pending ledgers; and a prefix spill round trip: a page
   of the cached 1000-token prefix spilled to a host page bit for bit and
   restored by the next hit, whose tokens equal a cold engine's;
7. mamba2 phase: full-width mamba2-1.3b (48 layers, d 2048, 64 SSD heads
   of 64, state 128, random weights from a seed, bfloat16): ``Model.
   prefill`` of 4 prompts x 1024 tokens, ``ssd_scan`` launched 48 times,
   then 32 greedy ``decode_step``s; prints the prefill time and the decode
   tokens/s. Then a float32 oracle: for 2 prompts x 512 tokens, the
   prefill's last logits and final SSM states (through the kernel) against
   stepping ``decode_step`` token by token from ``init_cache`` (no kernel),
   and the greedy tokens that follow from each. Then the ring caches:
   full-width hymba-1.5b, whole (32 layers: attention over 5 KV heads
   (G 5, Dh 64) and 64 SSD heads of 50 side by side in every layer, a
   1024-token window but in layers 0 and 16, bf16), ``Model.prefill`` of 4
   prompts x 2048 tokens (``flash_prefill`` launched 32 x 4 times,
   ``ssd_scan`` 32, ``paged_attention`` never), then 32 greedy
   ``decode_step``s on its ring caches (the window rings wrap; no kernel);
   prints the prefill time and tokens/s, the decode tokens/s and
   ``max_memory_allocated``. Its float32 oracle at full width, 2 prompts x
   1280 tokens: the kernel prefill's last logits against
   ``Model.forward``, and against stepping ``decode_step`` token by token
   from ``init_cache`` (last logits, every SSM state and conv tail, ring
   K/V slot by slot), the first decode step against ``Model.forward`` over
   2 x 1280 tokens, each within 1e-2 of its largest magnitude, and 16
   greedy tokens from both paths' caches (equal but at a near-tie).
   deepseek-v2-236b's latent ring at full width and 2 layers, float32:
   ``Model.prefill`` and 16 greedy ``decode_step``s through ``mla_decode``
   against ``Model.forward`` by the oracle phase's rule;
   The encoder-decoder and media families, whole: seamless-m4t-medium
   (12 encoder + 12 decoder layers, d 1024, 16 heads, bf16): 4 requests
   of 1024 encoder positions, the first 512 of them audio frame
   embeddings (normal x 0.02 from a seeded ``torch.Generator``), and a
   64-token decoder prompt through ``Model.prefill`` (``flash_prefill``
   launched (12 + 2 x 12) x 4 = 144 times: the encoder's non-causal
   self-attention, each decoder layer's self- and cross-attention), then
   64 greedy ``decode_step``s; its float32 oracle at full width: the ring's
   greedy tokens against ``Model.forward``'s argmax over prompt +
   generated tokens with the same encoder input, but at a near-tie.
   internvl2-26b (48 layers, d 6144, 48 heads over 8 KV heads, ~38.6 GB
   bf16): ``Model.prefill`` of 4 x 1024 positions, the first 256 patch
   embeddings (``flash_prefill`` 48 x 4 = 192 times), 32 greedy
   ``decode_step``s; the same weights serve 4 short text-only requests on
   the paged engine; then its float32 oracles at 2 layers (the ring with
   patches, and the engine). Each prints its prefill ms, decode tokens/s,
   ``max_memory_allocated`` and seconds;
8. MoE phases: llama4-scout-17b-a16e at full width (d 5120, 40 heads over
   8 KV heads, 16 experts of 8192 + 1 shared, top-1, capacity factor
   1.25), cut to 12 of its 48 layers, bf16, served as in the serve phase;
   then its float32 oracle at 2 layers with capacity factor 16 (no token
   dropped), prompts as in the oracle phase: beyond a logit near-tie, a
   mismatch is allowed only where a second oracle run with the engine's
   float32 decode attention routes a position otherwise and chooses the
   engine's token;
9. dense phases: paper-opt-13b whole (40 layers) under the serve traffic;
   granite-20b (52 layers) and command-r-35b (40) whole and
   mistral-large-123b at 20 of 88 layers, 4 greedy requests of 8 new
   tokens each; each one's float32 oracle at 2 layers. Every phase from
   the serve phase on prints its seconds and ``max_memory_allocated`` on
   a line of its own, and frees its model before the next;
   cluster phase, on the OPT serve phase's weights (initialised once, and
   shared by every instance): two full-width 40-layer bf16 engines of 512
   pages of 16 behind ``RouterBackend``, greedy, 32 new tokens a request,
   in four modes. Zero-copy share (round robin, ``prefix_share``,
   ``share_mode="zero_copy"``, ``hot_threshold=1``): a warm request of a
   512-token prefix + 32 tokens, then 8 requests of the prefix + 32-256
   distinct tokens at t = 0; the 4 on instance 1 lease the prefix's 32
   pages from instance 0 and read them in place (decode partials through
   ``paged_attention(..., return_partials=True)``), copying no payload.
   Copy share: the same traffic, the pages adopted as payloads.
   Disaggregated prefill/decode (``roles=["prefill", "decode"]``),
   ``handoff_mode`` "migrate" and "zero_copy": the serve phase's 8
   prompts. Each mode prints its tokens/s, TTFT, leases, handoffs, the
   debt ledger (empty at the end), the kernels' launches (with partials)
   and ``max_memory_allocated``; the launch counts must equal layers x
   the engines' decode steps, remote partials and unleased chunks. Then
   the float32 gate: the four modes at full width and 2 layers, and a peer
   spill mode (a prefix page of instance 0 parked in instance 1's free
   device memory and restored by the next hit, every loan repaid), whose
   tokens must equal a single float32 engine's but at a near-tie. Between
   the OPT serve phase and the cluster phase, the host tier measured: the
   serve traffic on a 94-page pool in four modes (sacrifice; ``swap``;
   speculative swap-outs; ``auto`` with cost victims, 188 pinned host
   pages), each with its tokens/s, TTFT, swap events and pages, memory,
   and the movers' device->host and host->device GB/s from CUDA events
   around them, beside the copied ``NetworkModel``'s 32 GB/s. After the
   cluster phase, the sim phase on the same weights: (a) the paper's
   studies on the port's benchmarks at reduced sizes (Fig. 9's paged vs
   ORCA oracle / pow2 / max, Fig. 10's DistKV, the batch-level baseline,
   the NSGA-II chain comparison), with the invariants the reference's tests
   assert of them; their rows are the virtual clock of ``CostModel``'s
   defaults, not card times. (b) ``RouterBackend`` over a full-width OPT
   engine of the serve geometry and a ``SimBackend`` of the same pages,
   round robin, the serve prompts greedy: placements alternate, the
   simulator child's logprobs are None, the engine child's kernels launch
   40 x its decode steps and chunks. (c) the same prompts twice on a fresh
   engine, each iteration's plan recorded as the simulator charges it and
   each step timed: ``t_fixed``, ``c_token`` and ``c_ctx`` fitted by
   non-negative least squares (printed beside the defaults with R^2), and
   the simulator with the fitted terms must plan the same iterations; the
   swap lane (``--pcie-gbps``, ``--t-swap-fixed``) fitted to the host
   tier's timed mover calls;
10. MLA phases: deepseek-v2-236b at full width (d 5120, 128 heads, latent
   r 512 + rope 64, q_lora 1536, 160 experts of 1536 top-6 + 2 shared, a
   dense first layer of 12288), cut to 8 of its 60 layers, bf16, served
   as in the serve phase from latent pools (schema
   ``mla:ckv512+krope64:bf16``); the MLA path is the reference's plain
   one, so neither attention kernel may launch in it. Then its float32
   oracle at 2 layers (the dense one and one MoE) with capacity factor 27
   (every expert has a place for every token), by the MoE oracle's rule,
   the witness's generated rows attending as the engine's MLA decode does
   (absorbed, over the latent, float32);
11. training phase: full-width h2o-danube-1.8b (1.75 B parameters, bf16,
   random weights from seed 0) trained whole through
   ``repro_torch.launch.train``'s ``main`` at its defaults (8 x 256 tokens
   a step from the synthetic corpus, each layer recomputed in the
   backward, AdamW in place) for 10 steps: every loss finite and the last
   below the first; prints the loss at each step, the step time (median
   of the steps after the first two), tokens/s and max_memory_allocated;
   the same run again at a peak learning rate of 3e-4, its losses printed.
   Then one train step of each plan family at smoke width in float32
   (danube, llama4-scout, deepseek-v2, mamba2, hymba, seamless-m4t with
   its encoder tokens, internvl2 with its media) on the card and on the
   CPU from the same weights and batch: loss at 2e-5, grad_norm at 1e-3,
   every parameter within the bound of ``tests/test_torch_training.py``.
   No kernel launches in the phase (training runs plain attention and
   ``ssd_chunked``: the kernels have no backward). Then a smoke-width
   ``{"params", "opt"}`` checkpoint saved and restored bit for bit in a
   temporary directory under ``build/``, removed after;
12. mesh phase (sharding, the dry-run and the roofline): the train
   launcher's ``main`` at its defaults again, now SPMD on a one-rank NCCL
   group through ``make_host_mesh(1)``, ``MeshPolicy`` and DTensor
   parameters and batches, for 10 steps: every loss finite, step 0's loss
   and grad_norm within 1e-4 relative of the train phase's plain run from
   the same seed (``repro_torch.launch.train.run`` without a mesh), each
   step's loss printed beside the plain one, the median step time (the
   DTensor dispatch's cost is its difference from the plain run's),
   tokens/s and max_memory_allocated; no kernel launches. Then
   ``dist_attention`` on the one-rank mesh against ``dist_attention_ref``
   at a long decode (B 4, S 32768, H 32 over Hkv 8, Dh 128, bf16, 0.54 GB
   of K/V). Then the dry-run in three child processes at once on the CPU
   (each rank 0 of a fake process group of 256, no device, each segment
   counted at 2 and 4 layers and extrapolated): h2o-danube-1.8b train_4k, llama4-scout-17b-a16e
   train_4k (the ``local_map`` MoE) and h2o-danube-1.8b decode_32k (the
   DistAttention layout) on 16 x 16, each record's per-rank FLOPs, bytes,
   collective bytes by kind, the three roofline terms (the H100 data
   sheet's, not measured), the bottleneck, ``useful_flop_frac`` and
   memory per rank printed;
13. examples phase: the five ``examples/torch_*.py`` (chain selection,
   the distributed KV cluster, the quickstart, continuous batching, the
   shared prefix) through their ``main(device="cuda")`` in this process,
   at the reference examples' sizes on smoke h2o-danube-1.8b, with their
   own assertions; each one's wall seconds and kernel launches, counted
   from 0 around it. Each of the three that serve must launch
   ``paged_attention`` and ``flash_prefill``; the DistAttention demo runs
   on the mesh phase's one-rank NCCL group, its merge error at most 1e-5;
14. times each kernel at its path's shapes beside its plain version, one
   PyTorch library call computing the same function where there is one,
   and the least time the card could take (its bound), and prints them as
   one JSON line; ``flash_prefill``'s engine form is also timed at each of
   the kernel phase's chunk shapes, beside SDPA, one line each, and
   ``ssd_scan`` at one 4096-token prompt beside its timing shape. Both
   kernels of hymba's prefill at its shape (``prefill_attention``: 4
   launches over 4 x 2048 tokens, window 1024 and none, beside SDPA and
   the contiguous entry's float32 body; ``ssd_scan`` at 64 heads of 50,
   state 16): their entries' ``at_hymba``. ``prefill_attention`` at
   seamless's encoder (4 x 1024, non-causal), its cross-attention (4 x 64
   queries over 1024 keys) and internvl2's prefill (4 x 1024, causal, G
   6, Dh 128), beside its plain version and SDPA: ``flash_prefill``'s
   ``at_seamless_encoder``, ``at_seamless_cross`` and ``at_internvl2``.
   The two attention kernels are also timed at llama4-scout's (G 5),
   granite's (G 48), paper-opt-13b's (G 1, 40 heads) and internvl2's
   (G 6) decode and chunk shapes, beside SDPA, one line each. The times
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
import gc
import json
import math
import os
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
# the examples' engines: smoke danube's (H, Hkv, Dh) and sliding window, on
# pages of 8. Decode contexts up to ~40 tokens, one past the window and one
# over several blocks; prefill chunks (length, start) of a cold prompt, a
# suffix after the 16-token cached system prompt, a recompute after
# preemption, and one past the window
EXAMPLE_WIDTHS, EXAMPLE_PS, EXAMPLE_WINDOW = (4, 4, 64), 8, 64
EXAMPLE_LENS = [0, 1, 7, 8, 9, 22, 34, 100]
EXAMPLE_CHUNKS = [(8, 0), (22, 0), (6, 16), (34, 0), (40, 60)]

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
# the contiguous entry beyond that sweep: b, s, skv, h, hkv, dh, causal,
# window, K/V layout ("dense"; "head_slice": heads 1..Hkv of a tensor of
# Hkv + 2 heads, which TMA reads; "offset_slice": columns 1..Dh of a
# last dimension of Dh + 8, not 16-byte aligned, staged through registers)
FLASH_CASES = [
    (2, 300, 300, 10, 2, 64, True, 64, "dense"),      # G 5, hymba's group
    (1, 200, 200, 12, 2, 128, True, None, "dense"),   # G 6, Dh 128
    (1, 70, 70, 48, 1, 128, True, None, "dense"),     # G 48, Dh 128
    (1, 257, 257, 4, 2, 32, True, None, "dense"),     # Dh 32, S % 128 != 0
    (2, 150, 150, 8, 2, 80, True, 40, "dense"),       # Dh 80
    (2, 100, 333, 8, 2, 64, False, None, "dense"),    # non-causal, Skv > S
    (2, 300, 77, 10, 2, 80, False, None, "dense"),    # non-causal, Skv < S
    (1, 256, 100, 4, 2, 64, True, 32, "dense"),       # rows 131.. see no key
    (4, 200, 200, 10, 2, 64, True, None, "head_slice"),  # B 4
    (2, 130, 130, 6, 3, 80, True, None, "offset_slice"),
    # more items than SMs, the last round partial (the bf16 body is
    # persistent): 172 items of 192 rows, 144 of 128
    (2, 2048, 2048, 8, 2, 64, True, None, "dense"),
    (1, 1500, 1500, 12, 2, 128, True, 256, "dense"),
]
# the engine form: (chunk length, chunk start); the serve phase's largest
# chunk is 512 tokens, its longest context 1040
ENGINE_CHUNKS = [(512, 0), (512, 512), (300, 37), (16, 1024)]
# ssd_scan: b, l, h, p, g, n, chunk; mamba2's prefill (4 prompts x 1024
# tokens: the timing shape) and one 4096-token prompt (a chain of 16
# chunks); the reference test's shapes first, hymba-1.5b's widths last
SSD_TIMING = (4, 1024, 64, 64, 1, 128, 256)
SSD_LONG = (1, 4096, 64, 64, 1, 128, 256)
SSD_SHAPES = [(2, 128, 4, 16, 1, 8, 16), (2, 128, 4, 16, 2, 8, 32),
              (2, 128, 4, 16, 2, 8, 64), SSD_TIMING, SSD_LONG,
              (2, 1024, 64, 50, 1, 16, 256)]
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_NEW = 4, 1024, 32
MAMBA_ORACLE_BATCH, MAMBA_ORACLE_PROMPT, MAMBA_ORACLE_NEW = 2, 512, 8
# hymba-1.5b whole, through Model.prefill / decode_step: prompts past its
# 1024-token window and a multiple of its 256-token SSM chunk; the float32
# oracle's prompt is five chunks. The MLA ring: deepseek-v2's float32
# oracle configuration, 2 prompts, greedy tokens through the latent ring
HYMBA_ARCH = "hymba-1.5b"
HYMBA_BATCH, HYMBA_PROMPT, HYMBA_NEW = 4, 2048, 32
HYMBA_ORACLE_BATCH, HYMBA_ORACLE_PROMPT, HYMBA_ORACLE_NEW = 2, 1280, 16
MLA_RING_PROMPT, MLA_RING_NEW = 300, 16
# prefill_attention(causal=False): an encoder's self-attention (S = Skv)
# and a decoder's cross-attention (S queries over Skv encoder positions),
# at (H, Hkv, Dh) of seamless-m4t-medium (G 1, Dh 64) and internvl2-26b
# (G 6, Dh 128)
NON_CAUSAL = [(64, 64), (1000, 1000), (1024, 1024)] + [
    (s, skv) for s in (1, 64, 130) for skv in (16, 1000, 1024)]
NON_CAUSAL_WIDTHS = [(16, 16, 64), (48, 8, 128)]
# prefill_attention(causal=False) against its plain version, of the largest
# |plain| value: (worst, median) by dtype. Both sides round q, k, v and the
# probabilities to bf16 alike; a bf16 output may differ by one ulp (at most
# 2**-7 of the largest value). On an H100 the kernel came within 9.8e-4
# (float32) and 3.3e-3 (bf16) worst, 1.5e-7 and 0 in the median; a key
# count off by one breaks both limits (tests/test_torch_encdec.py::
# test_non_causal_limits_catch_a_key_count_off_by_one).
NC_TOL = {torch.float32: (5e-3, 1e-6), torch.bfloat16: (1e-2, 1e-5)}
# the encoder-decoder and media families through Model.prefill /
# decode_step, whole: seamless-m4t-medium (4 requests of ENC_LEN encoder
# positions, the first num_media_tokens of them audio frames, and a
# SEAMLESS_PROMPT-token decoder prompt) and internvl2-26b (4 prompts of
# INTERNVL_PROMPT positions, the first num_media_tokens of them patches);
# each one's float32 oracle (seamless whole, internvl2 at ORACLE_LAYERS)
SEAMLESS_ARCH, INTERNVL_ARCH = "seamless-m4t-medium", "internvl2-26b"
MEDIA_BATCH = 4
ENC_LEN, SEAMLESS_PROMPT, SEAMLESS_NEW = 1024, 64, 64
SEAMLESS_ORACLE_NEW = 32
INTERNVL_PROMPT, INTERNVL_NEW = 1024, 32
INTERNVL_ORACLE_PROMPT, INTERNVL_ORACLE_NEW = 300, 16
# the float32 oracles' engine and depth (the full width is kept)
ORACLE_ENGINE = dict(num_pages=256, page_size=PS, max_slots=4,
                     max_tokens_per_iter=512)
ORACLE_LAYERS = 2
# slice 1's paths that the serve phase bypasses (danube, float32): a
# shared prefix that ends mid-page, a prompt whose context passes the
# 4096-token window, a pool too small for its requests
PREFIX_COMMON, PREFIX_SUFFIXES = 1000, (50, 70)
LONG_PROMPT, LONG_NEW, LONG_PAGES = 4200, 24, 512
PREEMPT_PROMPTS, PREEMPT_NEW, PREEMPT_PAGES = [500] * 4, 40, 100
# the host tier on the same traffic (danube, float32): host pages, the three
# swap configurations, and the prefix spill round trip's budget
SWAP_HOST_PAGES = 128
HOST_TIER_MODES = {
    "swap": dict(swap_mode="swap", victim_policy="lifo"),
    "speculative swap": dict(swap_mode="swap", victim_policy="lifo",
                             speculative_swap=True),
    "auto, cost victims": dict(swap_mode="auto", victim_policy="cost"),
}
SPILL_BUDGET = 8
# the host tier measured on paper-opt-13b under the serve traffic: a pool of
# pages of 16 tight enough to swap (at the engine's default budget of 2048
# tokens), twice its pages on the host so every victim fits there, and the
# four preemption modes (sacrifice without a host tier)
OPT_SWAP_ENGINE = dict(num_pages=94, page_size=PS, max_slots=8,
                       max_tokens_per_iter=2048)
OPT_HOST_PAGES = 188
OPT_SWAP_MODES = {"sacrifice": {}, **HOST_TIER_MODES}
# the modelled device<->host lane of the copied NetworkModel: 256 Gb/s
NETMODEL_PCIE_GB_S = 32.0
# GQA groups of the configs beyond {1, 2, 4, 8}, at head_dim 128: (H, Hkv)
# of llama4-scout (G 5), a G 6, mistral-large (G 12), granite (G 48)
GQA_GROUPS = [(40, 8), (12, 2), (96, 8), (48, 1)]
GQA_DH = 128
# MoE on GQA, served at full width cut in depth to fit one card (bf16
# weights: 4.40 GB a layer with all 16 experts)
MOE_ARCH, MOE_LAYERS = "llama4-scout-17b-a16e", 12
# the other dense GQA configs, whole (None) or cut in depth; paper-opt-13b
# is served whole under the serve traffic
DENSE_LAYERS = {"granite-20b": None, "command-r-35b": None,
                "mistral-large-123b": 20}
SHORT_PROMPTS, SHORT_NEW = [64, 333, 512, 900], 8
SHORT_ENGINE = dict(num_pages=256, page_size=PS, max_slots=4,
                    max_tokens_per_iter=512)
# MLA + MoE at full width cut in depth (bf16: 7.94 GB a MoE layer, 57.3 GB
# at 8 layers), and its float32 oracle's capacity factor: 160/6 can round a
# chunk's capacity to T - 1 places, 27 gives every expert T
MLA_ARCH, MLA_LAYERS, MLA_ORACLE_FACTOR = "deepseek-v2-236b", 8, 27.0
MLA_SCHEMA = "mla:ckv512+krope64:bf16"
# the attention kernels also timed at these configs' widths (G 5, 48, 1,
# 6), pools of TIMING_LAYERS layers cycled
GQA_TIMING = ("llama4-scout-17b-a16e", "granite-20b", "paper-opt-13b",
              "internvl2-26b")
TIMING_LAYERS = 8
# the zero-copy decode's partials: (H, Hkv, Dh) of danube (G 4), OPT (G 1),
# llama4-scout (G 5) and granite (G 48)
PARTIAL_WIDTHS = [(H, HKV, DH), (40, 40, 128), (40, 8, 128), (48, 1, 128)]
# cluster serving on paper-opt-13b (no window, so it may borrow): two
# engines of CLUSTER_ENGINE on one set of weights. The sharing modes serve
# a warm request (the prefix + CLUSTER_WARM tokens), then 8 requests of the
# prefix + a distinct suffix; the handoff modes the serve phase's prompts
CLUSTER_ARCH = "paper-opt-13b"
CLUSTER_ENGINE = dict(num_pages=512, page_size=PS, max_slots=8,
                      enable_prefix_cache=True)
CLUSTER_PREFIX, CLUSTER_WARM, CLUSTER_NEW = 512, 32, 32
CLUSTER_SUFFIXES = [32, 64, 96, 128, 160, 192, 224, 256]
# the sim phase: the paper's two studies at reduced sizes (the port's
# benchmarks' run() arguments), a simulator child beside a full-width OPT
# engine behind one router, and the CostModel terms fitted on a second
SIM_STUDIES = {
    "torch_serving_fig9": dict(n_requests=80),
    "torch_serving_fig10": dict(n_requests=40),
    "torch_chain_compare": dict(n_fleets=2, blocks=12, servers=12,
                                generations=10),
}
SIM_CHILD = dict(max_running=8, max_tokens_per_iter=512)
# the float32 gate's peer spill mode: a cold prefix page of instance 0
# parked in instance 1's free device memory and restored on the next hit
PEER_SPILL = dict(policy="round_robin", peer_spill=True)
PEER_SPILL_ENGINE = dict(CLUSTER_ENGINE, host_pages=16, cache_spill_pages=4)
CLUSTER_MODES = {
    "zero-copy share": dict(policy="round_robin", prefix_share=True,
                            share_mode="zero_copy", hot_threshold=1),
    "copy share": dict(policy="round_robin", prefix_share=True,
                       share_mode="copy", hot_threshold=1),
    "migrate handoff": dict(roles=["prefill", "decode"],
                            handoff_mode="migrate"),
    "zero-copy handoff": dict(roles=["prefill", "decode"],
                              handoff_mode="zero_copy"),
}


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
                 page_major=False, widths=(H, HKV, DH), page_size=PS):
    """Pools of ``layers`` layers, a (B, n) block table of distinct pages
    in random order, q. ``page_major`` lays the pool out as (P, L, ...),
    so a layer slice has a page stride of L pages. ``widths``: (H, Hkv,
    Dh), danube's by default."""
    h, hkv, dh = widths
    b = len(lens)
    n = max(1, max(-(-x // page_size) for x in lens))
    npages = b * n + extra_pages
    shape = (npages, layers, page_size, hkv, dh) if page_major else \
        (layers, npages, page_size, hkv, dh)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npages, generator=gen, device=dev)[:b * n]
    bt = perm.reshape(b, n).to(torch.int32)
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
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
    # the examples' decode: smoke danube's widths on pages of 8, at their
    # contexts and at one over several blocks
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, EXAMPLE_WINDOW):
            lens = EXAMPLE_LENS + [SPLIT_TOKENS + 3]
            q, k, v, bt, ctx = paged_inputs(gen, dev, dtype, lens,
                                            layers=2, widths=EXAMPLE_WIDTHS,
                                            page_size=EXAMPLE_PS)
            k, v = k[1], v[1]
            out, m, l = paged_attention(q, k, v, bt, ctx,
                                        page_size=EXAMPLE_PS, window=window,
                                        return_partials=True)
            torch.cuda.synchronize()
            wo, wm, wl = ref.paged_attention(q, k, v, bt, ctx,
                                             page_size=EXAMPLE_PS,
                                             window=window,
                                             return_partials=True)
            torch.testing.assert_close(out.float(), wo.float(), **TOL[dtype])
            torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
            empty = ctx == 0
            assert (out[empty] == 0).all() and (l[empty] == 0).all()
            cases.append(dict(dtype=str(dtype).split(".")[-1],
                              window=window, layout="examples",
                              widths=list(EXAMPLE_WIDTHS),
                              page_size=EXAMPLE_PS, context_lens=lens,
                              max_abs_err=(out.float() - wo.float()).abs()
                              .max().item()))
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
    sweep = [(b, s, s, h, hkv, dh, causal, window, "dense")
             for b, s, h, hkv, dh, causal, window in FLASH_SWEEP]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, skv, h, hkv, dh, causal, window, layout in \
                sweep + FLASH_CASES:
            q = torch.randn((b, s, h, dh), generator=gen, device=dev)
            if layout == "head_slice":
                k, v = (torch.randn((b, skv, hkv + 2, dh), generator=gen,
                                    device=dev).to(dtype)[:, :, 1:hkv + 1]
                        for _ in range(2))
            elif layout == "offset_slice":
                k, v = (torch.randn((b, skv, hkv, dh + 8), generator=gen,
                                    device=dev).to(dtype)[..., 1:dh + 1]
                        for _ in range(2))
            else:
                k, v = (torch.randn((b, skv, hkv, dh), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
            q = q.to(dtype)
            before = flash_prefill.launches
            out = flash_prefill(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            assert flash_prefill.launches == before + 1
            want = ref.flash_prefill(q, k, v, causal=causal, window=window)
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL[dtype])
            # positions that see no key return zeros
            qpos = torch.arange(s, device=dev)[:, None]
            kpos = torch.arange(skv, device=dev)[None]
            seen = torch.ones((s, skv), dtype=torch.bool, device=dev)
            if causal:
                seen &= kpos <= qpos
            if window is not None:
                seen &= kpos > qpos - window
            blind = ~seen.any(-1)
            assert (out[:, blind] == 0).all()
            cases.append(dict(form="contiguous", dtype=str(dtype)[6:],
                              shape=[b, s, skv, h, hkv, dh], causal=causal,
                              window=window, layout=layout,
                              blind_rows=int(blind.sum()), max_abs_err=(
                                  out.float() - want.float()).abs().max()
                              .item()))
            log(f"kernel phase: flash_prefill {cases[-1]} ok")
        # danube's chunks on pages of 16, then the examples' on pages of 8
        engine_cases = [(c, w, (H, HKV, DH), PS) for c in ENGINE_CHUNKS
                        for w in (None, 24)] + [
            (c, w, EXAMPLE_WIDTHS, EXAMPLE_PS) for c in EXAMPLE_CHUNKS
            for w in (None, EXAMPLE_WINDOW)]
        for (s, q_offset), window, widths, ps in engine_cases:
            ctx = q_offset + s
            # a 3-layer pool with room for the context in random pages
            q, kp, vp, bt, _ = paged_inputs(gen, dev, dtype, [ctx], layers=3,
                                            widths=widths, page_size=ps)
            q = torch.randn((1, s, widths[0], widths[2]), generator=gen,
                            device=dev).to(dtype)
            pages = bt[0]
            out = prefill_attention_paged(q, kp[1], vp[1], pages,
                                          q_offset=q_offset, window=window)
            torch.cuda.synchronize()
            want = ref.prefill_attention_paged(
                q, kp[1], vp[1], pages, q_offset=q_offset, window=window)
            torch.testing.assert_close(out.float(), want.float(),
                                       **TOL_ENGINE)
            cases.append(dict(form="engine", dtype=str(dtype)[6:],
                              chunk=s, q_offset=q_offset, window=window,
                              widths=list(widths), page_size=ps,
                              max_abs_err=(out.float() - want.float())
                              .abs().max().item()))
            log(f"kernel phase: flash_prefill {cases[-1]} ok")
    return cases


def gqa_group_phase(dev):
    """Both attention kernels at the GQA groups of this slice's configs
    that lie outside {1, 2, 4, 8} (``GQA_GROUPS``, head_dim 128), float32
    and bfloat16, window none and 24, against their plain versions:
    decode over ragged contexts (an empty row, rows split over several
    blocks), the engine form at a 100-query chunk at offset 37 and one
    query at 300."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import prefill_attention_paged
    from repro_torch.kernels.paged_attention import (SPLIT_TOKENS,
                                                     paged_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    lens = [37, 0, SPLIT_TOKENS + 5, 3 * SPLIT_TOKENS - 9, 16]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 24):
            for h, hkv in GQA_GROUPS:
                widths = (h, hkv, GQA_DH)
                q, k, v, bt, ctx = paged_inputs(gen, dev, dtype, lens,
                                                widths=widths)
                k, v = k[0], v[0]
                out, m, l = paged_attention(q, k, v, bt, ctx, page_size=PS,
                                            window=window,
                                            return_partials=True)
                torch.cuda.synchronize()
                wo, wm, wl = ref.paged_attention(
                    q, k, v, bt, ctx, page_size=PS, window=window,
                    return_partials=True)
                torch.testing.assert_close(out.float(), wo.float(),
                                           **TOL[dtype])
                if dtype == torch.bfloat16:  # |o| can lie under TOL's 3e-2
                    torch.testing.assert_close(out.float(), wo.float(),
                                               **TOL_BF16_OUT)
                torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
                torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
                assert (out[ctx == 0] == 0).all()
                case = dict(g=h // hkv, heads=h, kv_heads=hkv,
                            head_dim=GQA_DH, dtype=str(dtype)[6:],
                            window=window,
                            paged_attention_max_abs_err=(
                                out.float() - wo.float()).abs().max().item())
                for s, q_offset in ((100, 37), (1, 300)):
                    _, kp, vp, pbt, _ = paged_inputs(
                        gen, dev, dtype, [q_offset + s], widths=widths)
                    cq = torch.randn((1, s, h, GQA_DH), generator=gen,
                                     device=dev).to(dtype)
                    got = prefill_attention_paged(
                        cq, kp[0], vp[0], pbt[0], q_offset=q_offset,
                        window=window)
                    torch.cuda.synchronize()
                    want = ref.prefill_attention_paged(
                        cq, kp[0], vp[0], pbt[0], q_offset=q_offset,
                        window=window)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **TOL_ENGINE)
                    case[f"flash_prefill_{s}_at_{q_offset}_max_abs_err"] = \
                        (got.float() - want.float()).abs().max().item()
                cases.append(case)
                log(f"kernel phase: GQA group {case} ok")
    return cases


def rel_close(got, want, worst: float, median: float, what: str):
    """|got - want| of the largest |want|: at most ``worst`` anywhere and
    ``median`` in the median. Returns the two measured."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().clamp_min(1e-30)
    w, m = (d.max() / scale).item(), (d.median() / scale).item()
    assert w <= worst and m <= median, \
        f"{what}: {w:.3g} worst, {m:.3g} median of max |want|"
    return w, m


def non_causal_phase(dev):
    """``prefill_attention(causal=False)`` against its plain version at
    NON_CAUSAL x NON_CAUSAL_WIDTHS, float32 and bfloat16, two sequences,
    within NC_TOL: every key valid, Skv a multiple of the 128-key tile (the
    TMA path in bf16), not one (1000: the last tile masked, staged through
    registers) and below one tile (16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   prefill_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for h, hkv, dh in NON_CAUSAL_WIDTHS:
            errs = {}
            for s, skv in NON_CAUSAL:
                q = torch.randn((2, s, h, dh), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((2, skv, hkv, dh), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                before = flash_prefill.launches
                got = prefill_attention(q, k, v, causal=False)
                torch.cuda.synchronize()
                assert flash_prefill.launches == before + 2
                want = ref.prefill_attention(q, k, v, causal=False)
                worst, median = rel_close(got, want, *NC_TOL[dtype],
                                          f"non-causal {s}x{skv}")
                errs[f"{s}x{skv}"] = dict(
                    max_abs_err=(got.float() - want.float()).abs().max()
                    .item(), worst_rel=worst, median_rel=median)
            cases.append(dict(form="non-causal", dtype=str(dtype)[6:],
                              g=h // hkv, heads=h, kv_heads=hkv,
                              head_dim=dh, errors=errs))
            log(f"kernel phase: prefill_attention {cases[-1]} ok")
    return cases


def partials_phase(dev):
    """paged_attention's (m, l) as the zero-copy decode uses them, at
    PARTIAL_WIDTHS, float32 and bfloat16: a local context in one pool and a
    leased one (whole pages) in another, contexts over several splits, rows
    with either, both or neither (context 0). Each partial's out, m and l
    against the plain version; then the two merged by
    ``merge_partials_tree`` (o = out * l) against the plain version over
    both contexts in one pool, with TOL."""
    from repro_torch.core.distkv.dist_attention import merge_partials_tree
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (SPLIT_TOKENS,
                                                     paged_attention)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    loc = [37, 0, SPLIT_TOKENS + 5, 0, 2 * SPLIT_TOKENS + 9, 16]
    rem = [0, 3 * PS, 2 * SPLIT_TOKENS, 0, SPLIT_TOKENS, 32 * PS]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for widths in PARTIAL_WIDTHS:
            h, hkv, dh = widths
            q, kl, vl, lbt, lctx = paged_inputs(gen, dev, dtype, loc,
                                                widths=widths)
            _, kr, vr, rbt, rctx = paged_inputs(gen, dev, dtype, rem,
                                                widths=widths)
            kl, vl, kr, vr = kl[0], vl[0], kr[0], vr[0]
            parts, errs = [], {}
            for side, k, v, bt, ctx in (("local", kl, vl, lbt, lctx),
                                        ("leased", kr, vr, rbt, rctx)):
                out, m, l = paged_attention(q, k, v, bt, ctx, page_size=PS,
                                            return_partials=True)
                torch.cuda.synchronize()
                wo, wm, wl = ref.paged_attention(q, k, v, bt, ctx,
                                                 page_size=PS,
                                                 return_partials=True)
                torch.testing.assert_close(out.float(), wo.float(),
                                           **TOL[dtype])
                torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
                torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
                assert (out[ctx == 0] == 0).all() and (l[ctx == 0] == 0).all()
                errs[side] = dict(
                    out=(out.float() - wo.float()).abs().max().item(),
                    m=(m - wm).abs().max().item(),
                    l=((l - wl).abs() / wl.clamp_min(1e-30)).max().item())
                parts.append((out.float() * l[..., None], m, l))
            merged = merge_partials_tree(*zip(*parts))
            # both instances' pages in one pool: leased first, then local
            npr = kr.shape[0]
            pool_k, pool_v = torch.cat([kr, kl]), torch.cat([vr, vl])
            union = torch.zeros((len(loc), rbt.shape[1] + lbt.shape[1]),
                                dtype=torch.int32, device=dev)
            for i, (r, n_loc) in enumerate(zip(rem, loc)):
                nr, nl = r // PS, -(-n_loc // PS)
                union[i, :nr] = rbt[i, :nr]
                union[i, nr:nr + nl] = lbt[i, :nl] + npr
            want = ref.paged_attention(q.float(), pool_k.float(),
                                       pool_v.float(), union, lctx + rctx,
                                       page_size=PS)
            torch.testing.assert_close(merged, want, **TOL[dtype])
            case = dict(g=h // hkv, heads=h, kv_heads=hkv, head_dim=dh,
                        dtype=str(dtype)[6:], local=loc, leased=rem,
                        partial_errs=errs,
                        merged_max_abs_err=(merged - want).abs().max().item())
            cases.append(case)
            log(f"kernel phase: paged_attention partials {case} ok")
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


def phase_end(label: str, t0: float) -> dict:
    """The phase's seconds and peak device memory (since the phase reset
    the peak), on a line of their own. The phase's model is gone by now:
    whatever a reference cycle still holds is collected and the cache
    returned, so that the next phase has the card."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out = dict(seconds=time.monotonic() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"{label}: {out['seconds']:.1f} s, max_memory_allocated "
        f"{out['peak_gib']:.2f} GiB")
    return out


def short_requests(vocab_size: int, seed: int):
    """SHORT_PROMPTS greedy requests of SHORT_NEW new tokens each."""
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab_size, n).tolist(),
             SamplingParams(max_new_tokens=SHORT_NEW))
            for n in SHORT_PROMPTS]


def serve_phase(dev, seed: int):
    """Full-width h2o-danube-1.8b, all 24 layers, under the serve
    traffic."""
    from repro_torch.configs import get_config
    cfg = get_config("h2o-danube-1.8b")
    return serve_model("serve phase", cfg, dev, seed,
                       serve_requests(cfg.vocab_size, seed), SERVE_ENGINE)


def watch_finite(engines, vocab: int, dev):
    """Wrap each engine's chunk and decode so that every logit they return
    is checked finite, into a running flag on the card (no sync in the
    loop). Returns the flag; ``del engine._prefill_chunk, engine._decode``
    takes the watches off (they hold the engine)."""
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def watch(fn):
        def watched(*args, **kw):
            logits = fn(*args, **kw)
            finite.logical_and_(torch.isfinite(logits[..., :vocab]).all())
            return logits
        return watched

    for engine in engines:
        engine._prefill_chunk = watch(engine._prefill_chunk)
        engine._decode = watch(engine._decode)
    return finite


def unwatch(engines) -> None:
    """Take ``watch_finite``'s wrappers off again. (A loop over the engines
    in the caller's frame would keep the last one, and through the router's
    reference cycles every engine of the run, alive into the next run.)"""
    for engine in engines:
        del engine._prefill_chunk, engine._decode


def serve_model(label: str, cfg, dev, seed: int, requests, engine_kw,
                params=None, instrument=None):
    """Serve ``requests`` ((prompt, SamplingParams) pairs) through
    LLMService on a PagedEngine of ``engine_kw``, with ``cfg``'s weights
    drawn from ``seed`` on the card (or ``params``, already there). The
    launch counts are read around this run alone: on a GQA engine
    paged_attention must equal layers x the engine's decode steps and
    flash_prefill layers x its prefill chunks; on an MLA engine (the
    reference's plain latent path) both must be 0. Every logit the engine
    returns must be finite, every token in the vocab. ``instrument(engine)``
    runs before the requests and returns a function whose dict joins the
    stats after them."""
    from repro_torch.bridge import init_params
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.api import LLMService
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: {cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, "
        f"{n_params / 1e9:.2f} B params {cfg.dtype} on the card in "
        f"{time.monotonic() - t_phase:.1f}s")
    engine = PagedEngine(cfg, params, EngineConfig(**engine_kw, seed=seed),
                         device=dev)
    schema = engine.kv_layout.schema
    log(f"{label}: {engine.flavor} engine, pool schema {schema}, "
        f"{(engine.k_pages.nbytes + engine.v_pages.nbytes) / 2 ** 20:.1f} "
        "MiB of pages")
    # launches of each attention kernel per layer and engine call
    per_layer = cfg.num_layers if engine.flavor == "gqa" else 0
    finite = watch_finite([engine], cfg.vocab_size, dev)
    read_instrument = instrument(engine) if instrument is not None else None
    svc = LLMService(engine)
    ids = [(svc.submit(prompt, sp), sp) for prompt, sp in requests]

    paged_attention.launches = 0  # read around this run alone
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
    unwatch([engine])  # the watches hold the engine

    outs = [svc._take_result(rid) for rid, _ in ids]
    n_tokens = 0
    ttfts = []
    for (rid, sp), out in zip(ids, outs):
        assert len(out.samples) == sp.n, (rid, len(out.samples))
        for s in out.samples:
            assert len(s.token_ids) == sp.max_new_tokens and \
                s.finish_reason == "length", (rid, s)
            assert all(0 <= t < cfg.vocab_size for t in s.token_ids)
            assert all(math.isfinite(x) for x in s.token_logprobs)
            n_tokens += len(s.token_ids)
        ttfts.append(out.metrics.ttft)
    assert bool(finite), f"{label}: a logit was not finite"
    assert decode_steps > 0
    assert launches == per_layer * decode_steps, \
        f"paged_attention launched {launches} times over {decode_steps} " \
        f"decode steps of {cfg.num_layers} {engine.flavor} layers"
    assert chunks > 0
    assert prefill_launches == per_layer * chunks, \
        f"flash_prefill launched {prefill_launches} times over {chunks} " \
        f"prefill chunks of {cfg.num_layers} {engine.flavor} layers"
    log(f"{label}: {len(outs)} requests ({n_tokens} tokens) in "
        f"{engine.iterations} iterations, {decode_steps} decode steps, "
        f"{chunks} prefill chunks; paged_attention launches {launches} = "
        f"{per_layer} x {decode_steps}; flash_prefill launches "
        f"{prefill_launches} = {per_layer} x {chunks}")
    stats = dict(arch=cfg.arch_id, layers=cfg.num_layers, params=n_params,
                 schema=schema,
                 requests=len(outs), tokens=n_tokens, wall_s=wall,
                 tokens_per_s=n_tokens / wall,
                 ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
                 iterations=engine.iterations, decode_steps=decode_steps,
                 prefill_chunks=chunks, launches=launches,
                 prefill_launches=prefill_launches)
    if read_instrument is not None:
        stats.update(read_instrument())
    del engine, params, svc, read_instrument
    torch.cuda.empty_cache()
    stats.update(phase_end(label, t_phase))
    return stats


# -- oracle phases ----------------------------------------------------------------

def oracle_phase(dev, seed: int):
    """The float32 oracle at full-width h2o-danube-1.8b, all 24 layers."""
    from repro_torch.configs import get_config
    return oracle_model("oracle phase", get_config("h2o-danube-1.8b"), dev,
                        seed)


def oracle_model(label: str, cfg, dev, seed: int):
    """Greedy tokens of ``cfg``'s engine in float32 (``logits_fp32``) for
    ORACLE_PROMPTS, one longer than the 512-token chunk budget, against
    the port's Model.forward (``oracle_check``)."""
    from repro_torch.bridge import init_params
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, dtype="float32", logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    engine = PagedEngine(cfg, params, EngineConfig(**ORACLE_ENGINE),
                         device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ORACLE_PROMPTS]
    outs = LLMService(engine).generate(
        prompts, SamplingParams(max_new_tokens=ORACLE_NEW))
    del engine
    stats = oracle_check(label, cfg, params, prompts,
                         [o.token_ids for o in outs], dev)
    del params
    torch.cuda.empty_cache()
    stats.update(arch=cfg.arch_id, layers=cfg.num_layers,
                 **phase_end(label, t0))
    return stats


def f32_attention(q, k, v, q_offset: int, window):
    """Causal attention of queries at ``q_offset``.. over all of k / v, in
    float32 without rounding q, k, v or the probabilities to bf16: the
    numerics of the engine's decode kernel (paged_attention)."""
    dh, g = q.shape[-1], q.shape[2] // k.shape[2]
    k = k.float().repeat_interleave(g, dim=2)
    v = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k) / math.sqrt(dh)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhst,bthd->bshd", probs, v).to(q.dtype)


def mla_decode_layer(cfg, p, x, positions, decode_from: int, mlp_fn):
    """An MLA layer as ``Model.forward`` runs it (``mla_forward``, the
    decompressed form), except that the rows at positions >= decode_from
    attend as the engine's MLA decode does: absorbed (``mla_attention``),
    over the latent of every position up to theirs, in one float32
    ``attention_partial`` and its merge."""
    from repro_torch.core.distkv.dist_attention import (attention_partial,
                                                        merge_partials_tree)
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import mlp, rms_norm

    def attend_latent(q_lat, qr, ckv, krope):
        q_eff, k_eff, v_eff = attn.mla_effective_kv(q_lat, qr, ckv, krope)
        causal = (positions[None, :] <= positions[:, None])[None]
        o, m, l = attention_partial(q_eff, k_eff, v_eff, causal,
                                    scale=attn._mla_scale(cfg))
        ctx = merge_partials_tree([o], [m], [l])
        return ctx[..., :cfg.kv_lora_rank].to(q_lat.dtype)

    hn = rms_norm(p["ln1"], x, cfg.norm_eps)
    out = attn.mla_forward(cfg, p["attn"], hn, positions)
    out[:, decode_from:] = attn.mla_attention(
        cfg, p["attn"], hn, positions, attend_latent)[:, decode_from:]
    x = x + out
    h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + (mlp(p["mlp"], h2) if mlp_fn is None else mlp_fn(p["mlp"], h2))


@torch.no_grad()
def oracle_forward(model, params, tokens, decode_from=None):
    """Model.forward over ``tokens`` (1, S), layer by layer as it runs, with
    each MoE layer's float32 router logits (S, E), computed from the
    layer's input as ``moe_forward`` computes them. With ``decode_from``,
    the query rows at positions >= decode_from attend as the engine's
    decode does: a GQA layer's as its kernel does (``f32_attention``), an
    MLA layer's as its plain latent decode does (``mla_decode_layer``);
    the rows before them, as Model.forward does. Returns (logits, router
    logits per MoE layer)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed
    from repro_torch.models.moe import moe_forward
    from repro_torch.models.transformer import mla_forward_layer, seg_window
    cfg = model.cfg
    x = embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    routers = []

    def moe_fn(pm, h):
        routers.append(h.reshape(-1, h.shape[-1]).float() @
                       pm["router"]["w"])
        return moe_forward(cfg, pm, h, return_aux=True)[0]

    for seg, _, p in model.layers(params):
        mlp_fn = moe_fn if seg.mlp_kind == "moe" else None
        if seg.mixer == "mla":
            x = mla_forward_layer(cfg, p, x, positions, mlp_fn) \
                if decode_from is None else \
                mla_decode_layer(cfg, p, x, positions, decode_from, mlp_fn)
            continue

        def attend(q, k, v, window=seg_window(cfg, seg)):
            out = attn.blockwise_attention(q, k, v, causal=True,
                                           window=window)
            if decode_from is not None:
                out[:, decode_from:] = f32_attention(
                    q[:, decode_from:], k, v, decode_from, window)
            return out
        x = attn.gqa_layer(cfg, p, x, positions, attend, mlp_fn)
    return model._logits(params, x), routers


def routed(z, k: int):
    """The experts a router's logits ``z`` (S, E) choose at each position,
    as ``moe_forward`` chooses them (a stable descending sort), as sets."""
    return torch.sort(z, dim=-1, descending=True, stable=True).indices[:, :k] \
        .sort(-1).values


def oracle_check(label: str, cfg, params, prompts, token_lists, dev):
    """Each request's greedy tokens against the argmax of the port's
    Model.forward over prompt + generated tokens. The engine's prefill
    attention (the engine form of flash_prefill) rounds q, k, v and the
    probabilities to bf16 as the oracle's blockwise_attention does, in
    another order of sums; its decode attention (paged_attention) is
    float32 throughout. A mismatch is allowed only where the oracle's top-2
    logits are closer than eps = 2**-7 of the largest |logit| at that
    position (one bf16 ulp, with room for an exponent step, as
    ``tests/test_engine.py`` allows) and the engine chose the runner-up;
    comparing that request stops there.

    A MoE layer's routing is a discrete choice, and the bf16 rounding of
    the oracle's attention probabilities, which the engine's decode does
    not make, moves router logits by ~2**-9 of their size (an MLA engine
    also attends in the absorbed form, over the latent, where the oracle
    decompresses: other roundings again). So for a MoE
    config the oracle runs a second time with the engine's decode
    numerics at the generated positions (``oracle_forward`` with
    ``decode_from``; the first run must equal Model.forward bit for bit).
    Any other mismatch is allowed only where that witness routes some
    position up to the differing one to other experts than Model.forward
    does and chooses the engine's token (or the runner-up within eps);
    comparing that request stops there. The positions the two runs route
    differently and their router gaps are reported."""
    from repro_torch.models.transformer import Model
    eps = NEAR_TIE
    model = Model(cfg)
    n_moe = sum(seg.n for seg in model.plan if seg.mlp_kind == "moe")
    compared = mismatches = router_stops = total = 0
    flipped = router_rows = 0  # (generated position, MoE layer) pairs
    flip_gaps = []  # Model.forward's router gap at each flip, relative
    min_gap_rel = math.inf
    for prompt, tokens in zip(prompts, token_lists):
        total += len(tokens)
        plen = len(prompt)
        full = torch.tensor(prompt + tokens[:-1], device=dev)[None]
        logits, _ = model.forward(params, full)
        if n_moe:
            lo, ro = oracle_forward(model, params, full)
            assert torch.equal(lo, logits) and len(ro) == n_moe, \
                f"{label}: oracle_forward is not Model.forward"
            lw, rw = oracle_forward(model, params, full, decode_from=plen)
            lw = lw[0, plen - 1:, :cfg.vocab_size].float()
            del lo
            flips = []  # (layer, position) routed differently
            for layer, (zo, zw) in enumerate(zip(ro, rw)):
                diff = (routed(zo, cfg.moe_top_k) !=
                        routed(zw, cfg.moe_top_k)).any(-1)
                for pos in diff.nonzero().flatten().tolist():
                    zk = torch.sort(zo[pos], descending=True).values
                    gap = float(zk[cfg.moe_top_k - 1] - zk[cfg.moe_top_k])
                    flips.append((layer, pos))
                    flip_gaps.append(gap / float(zo[pos].abs().max()))
                router_rows += zo.shape[0] - plen
            assert all(pos >= plen for _, pos in flips), \
                f"{label}: the witness routes a prompt position otherwise"
            flipped += len(flips)
        # the rows that predict each new token, over the real vocab: the
        # padded entries hold the type's lowest value, which would swamp
        # the largest |logit| that scales eps
        lg = logits[0, plen - 1:, :cfg.vocab_size].float()
        del logits
        for i, tok in enumerate(tokens):
            top2 = torch.topk(lg[i], 2)
            want = int(top2.indices[0])
            gap = float(top2.values[0] - top2.values[1])
            top = float(lg[i].abs().max())
            min_gap_rel = min(min_gap_rel, gap / top)
            compared += 1
            if tok == want:
                continue
            bound = eps * top
            if tok == int(top2.indices[1]) and gap < bound:
                mismatches += 1
                log(f"{label}: near-tie at token {i} of a {plen}-token "
                    f"prompt (gap {gap:.3g} < {bound:.3g}); stop there")
                break
            pos = plen - 1 + i
            before = [f for f in flips if f[1] <= pos] if n_moe else []
            w2 = torch.topk(lw[i], 2) if n_moe else None
            witness = bool(before) and (tok == int(w2.indices[0]) or (
                tok == int(w2.indices[1]) and float(
                    w2.values[0] - w2.values[1]) < eps * float(
                        lw[i].abs().max())))
            assert witness, \
                f"{label}: token {i} of a {plen}-token prompt: engine " \
                f"{tok}, oracle {want}, top-2 gap {gap} >= {bound}" + (
                    f"; with the engine's decode numerics the oracle routes "
                    f"(layer, position) {before} otherwise and chooses "
                    f"{int(w2.indices[0])}" if n_moe else "")
            router_stops += 1
            log(f"{label}: routing flip before token {i} of a {plen}-token "
                f"prompt: with the engine's decode numerics the oracle "
                f"routes (MoE layer, position) {before} to other experts "
                f"and chooses the engine's token {tok} (Model.forward: "
                f"{want}, top-2 gap {gap:.3g}); stop there")
            break
    assert compared >= total // 2, f"only {compared}/{total} compared"
    routing = f", the two numerics route {flipped} of {router_rows} " \
        f"(generated position, MoE layer) pairs otherwise, at router gaps " \
        f"{[float(f'{g:.3g}') for g in flip_gaps]} of the largest router " \
        "logit" if n_moe else ""
    log(f"{label}: {compared}/{total} float32 tokens compared with "
        f"Model.forward, {mismatches} near-tie stops, {router_stops} "
        f"routing-flip stops, smallest top-2 gap {min_gap_rel:.3g} of the "
        f"largest |logit| (eps {eps:.3g}){routing}")
    return dict(compared=compared, total=total, near_tie_stops=mismatches,
                routing_flip_stops=router_stops, eps_rel=eps,
                min_gap_rel=min_gap_rel, routing_flips=flipped,
                router_rows=router_rows, flip_router_gaps_rel=flip_gaps)


# -- slice 1 on the card: prefix cache, window, preemption -----------------------

def slice1_phase(dev, seed: int):
    """What the serve phase bypasses, on full-width h2o-danube-1.8b in
    float32 (``logits_fp32``):

    * the prefix cache: a prompt that shares PREFIX_COMMON tokens (62 pages
      and 8 tokens of the 63rd) with a finished one resumes its prefill
      mid-page from the cached pages; its greedy tokens must equal a cold
      engine's, except at a near-tie of the oracle's logits;
    * the window: one prompt of LONG_PROMPT tokens decoding past 4096
      positions, so both kernels apply danube's 4096-token window on the
      engine path; its tokens against Model.forward;
    * preemption: PREEMPT_PROMPTS on a PREEMPT_PAGES-page pool, too small
      for all of them, so requests are preempted and recomputed; their
      tokens against Model.forward."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              dtype="float32", logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    stats = {}

    # the prefix cache, against a cold engine
    common = rng.integers(0, v, PREFIX_COMMON).tolist()
    prompts = [common + rng.integers(0, v, n).tolist()
               for n in PREFIX_SUFFIXES]
    runs = {}
    for cached in (True, False):
        engine = PagedEngine(cfg, params, EngineConfig(
            **ORACLE_ENGINE, enable_prefix_cache=cached), device=dev)
        svc = LLMService(engine)
        runs[cached] = [svc.generate([p], SamplingParams(
            max_new_tokens=ORACLE_NEW))[0] for p in prompts]
        if cached:
            cache_stats = check_cache_stats(engine, runs[True])
        del engine, svc
    hit = runs[True][1].metrics.num_cached_tokens
    assert hit == PREFIX_COMMON and hit % PS, \
        f"the second prompt hit {hit} cached tokens, not {PREFIX_COMMON}"
    assert runs[False][1].metrics.num_cached_tokens == 0
    cold_check = oracle_check("slice-1 phase, prefix cache (cold engine)",
                              cfg, params, prompts,
                              [o.token_ids for o in runs[False]], dev)
    for p, a, b in zip(prompts, runs[True], runs[False]):
        a, b = a.token_ids, b.token_ids
        if a != b:  # the first difference must be a near-tie of the oracle
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            oracle_check("slice-1 phase, prefix cache (cached engine)", cfg,
                         params, [p], [a[:i + 1]], dev)
            oracle_check("slice-1 phase, prefix cache (cold engine)", cfg,
                         params, [p], [b[:i + 1]], dev)
    same = all(a.token_ids == b.token_ids
               for a, b in zip(runs[True], runs[False]))
    log(f"slice-1 phase: prefix cache: the second prompt resumed after "
        f"{hit} cached tokens ({hit // PS} pages + {hit % PS} tokens); "
        f"greedy tokens {'equal' if same else 'differ at a near-tie'} "
        f"to a cold engine's")
    stats["prefix_cache"] = dict(cached_tokens=hit, equal_to_cold=same,
                                 oracle=cold_check, stats=cache_stats)
    spill_prompt, spill_cold = prompts[1], runs[False][1]

    # a context past the window, in both kernels
    engine = PagedEngine(cfg, params, EngineConfig(
        **dict(ORACLE_ENGINE, num_pages=LONG_PAGES)), device=dev)
    prompt = rng.integers(0, v, LONG_PROMPT).tolist()
    (out,) = LLMService(engine).generate(
        [prompt], SamplingParams(max_new_tokens=LONG_NEW))
    chunks = engine.prefill_chunks
    del engine
    ctx = LONG_PROMPT + LONG_NEW - 1
    assert ctx > cfg.sliding_window
    stats["window"] = dict(prompt=LONG_PROMPT, context=ctx,
                           prefill_chunks=chunks, oracle=oracle_check(
                               "slice-1 phase, window", cfg, params,
                               [prompt], [out.token_ids], dev))
    log(f"slice-1 phase: window: a {LONG_PROMPT}-token prompt in {chunks} "
        f"chunks, decoded to context {ctx} past the {cfg.sliding_window}-"
        "token window")

    # preemption and recompute on a tight pool
    engine = PagedEngine(cfg, params, EngineConfig(
        **dict(ORACLE_ENGINE, num_pages=PREEMPT_PAGES)), device=dev)
    prompts = [rng.integers(0, v, n).tolist() for n in PREEMPT_PROMPTS]
    outs = LLMService(engine).generate(
        prompts, SamplingParams(max_new_tokens=PREEMPT_NEW))
    preemptions = engine.preemptions
    del engine
    assert preemptions > 0, "the tight pool forced no preemption"
    stats["preemption"] = dict(pages=PREEMPT_PAGES, prompts=PREEMPT_PROMPTS,
                               preemptions=preemptions,
                               oracle=oracle_check(
                                   "slice-1 phase, preemption", cfg, params,
                                   prompts, [o.token_ids for o in outs],
                                   dev))
    log(f"slice-1 phase: preemption: {len(prompts)} prompts of "
        f"{PREEMPT_PROMPTS[0]} tokens + {PREEMPT_NEW} new on "
        f"{PREEMPT_PAGES} pages of {PS}: {preemptions} preemptions, "
        "recomputed")
    stats["host_tier"] = host_tier_phase(cfg, params, dev, prompts, common,
                                         spill_prompt, spill_cold)
    del params
    torch.cuda.empty_cache()
    stats.update(phase_end("slice-1 phase", t0))
    return stats


def check_cache_stats(engine, outs) -> dict:
    """The prefix-cache engine's ``prefix_cache_stats()`` and
    ``kv_utilization()`` after serving ``outs``: the hits are the served
    requests' cached tokens, no more than the tokens looked up, and the
    utilization lies in (0, 1]."""
    st = engine.prefix_cache_stats()
    kv = engine.kv_utilization()
    served = sum(o.metrics.num_cached_tokens for o in outs)
    if st["hit_tokens"] != served:
        raise AssertionError(f"slice-1 phase: prefix_cache_stats hit_tokens "
                             f"{st['hit_tokens']}, the requests' cached "
                             f"tokens {served}")
    if not st["lookup_tokens"] >= st["hit_tokens"]:
        raise AssertionError(f"slice-1 phase: lookup_tokens "
                             f"{st['lookup_tokens']} < hit_tokens "
                             f"{st['hit_tokens']}")
    if not 0 < kv <= 1:
        raise AssertionError(f"slice-1 phase: kv_utilization {kv} after the "
                             "run")
    log(f"slice-1 phase: prefix_cache_stats {st}; kv_utilization {kv!r} "
        "after the run")
    return dict(st, kv_utilization=kv)


# -- the host tier: swap-to-host preemption and prefix spill ------------------------

def swap_spy(engine):
    """Count the swap events and pages of ``engine``'s plans as it runs, and
    check that a request swapped in while decoding runs no prefill chunk
    afterwards unless it was preempted since (it resumes, it does not
    re-prefill). Returns the counts, filled in place."""
    counts = dict(swap_outs=0, swap_ins=0, issues=0, completes=0,
                  cancels=0, pages_out=0, pages_in=0, pages_issued=0)
    resumed = set()
    schedule = engine.scheduler.schedule

    def spied():
        plan = schedule()
        for ch in plan.chunks:
            assert ch.req.request_id not in resumed, \
                f"request {ch.req.request_id} re-prefilled after its swap-in"
        resumed.difference_update(r.request_id for r in plan.preempted)
        resumed.update(r.request_id for r, _ in plan.swap_in if r.output)
        for key, name in (("swap_out", "swap_outs"), ("swap_in", "swap_ins"),
                          ("swap_issue", "issues"),
                          ("swap_complete", "completes"),
                          ("swap_cancel", "cancels")):
            counts[name] += len(getattr(plan, key))
        counts["pages_out"] += sum(len(p) for _, p in plan.swap_out)
        counts["pages_issued"] += sum(len(p) for _, p in plan.swap_issue)
        counts["pages_in"] += sum(len(p) for _, p in plan.swap_in)
        return plan

    engine.scheduler.schedule = spied
    return counts


def time_movers(engine):
    """CUDA events around each swap mover of ``engine`` (the scheduler's
    hooks), on the stream its copies run on: the current stream, or for a
    speculative issue the side stream once it has caught up with
    everything queued before. Returns ``{"out": [...], "in": [...]}`` of
    (pages, start, end), filled as the engine runs."""
    timed = {"out": [], "in": []}
    sch = engine.scheduler

    def wrap(fn, way, side):
        def run(pairs):
            stream = torch.cuda.current_stream()
            if side:
                engine._swap_stream.wait_stream(stream)
                stream = engine._swap_stream
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(pairs)
            end.record(stream)
            timed[way].append((len(pairs), start, end))
        return run

    sch.swap_out_hook = wrap(sch.swap_out_hook, "out", False)
    sch.swap_issue_hook = wrap(sch.swap_issue_hook, "out", True)
    sch.swap_in_hook = wrap(sch.swap_in_hook, "in", False)
    return timed


def mover_rates(timed, page_bytes: int) -> dict:
    """Pages, milliseconds and GB/s of each direction of ``time_movers``'s
    record (read after a synchronize), and each call's (pages, ms)."""
    out = {}
    for way, rec in timed.items():
        each = [(n, start.elapsed_time(end)) for n, start, end in rec]
        pages = sum(n for n, _ in each)
        ms = sum(m for _, m in each)
        out[way] = dict(calls=len(rec), pages=pages, ms=ms, each=each,
                        gb_per_s=pages * page_bytes / ms / 1e6 if ms else None)
    return out


def host_tier_phase(cfg, params, dev, prompts, common, spill_prompt,
                    cold):
    """The host tier on full-width h2o-danube-1.8b in float32, on the
    slice-1 phase's weights and preemption traffic (``prompts`` on
    PREEMPT_PAGES pages of 16), with SWAP_HOST_PAGES pinned host pages, in
    each of HOST_TIER_MODES. Each run must swap out at least once where
    the mode swaps (``auto`` may sacrifice instead, and what it picked is
    reported), swap every page back in, recompute nothing in ``swap``
    mode, run no prefill chunk after a decode-phase swap-in, export a
    trace that passes ``validate_trace_events`` and
    ``validate_swap_balance``, hold its tokens against Model.forward, and
    leave the allocator's device, host and pending ledgers empty.

    Then the prefix spill round trip: a prompt of the PREFIX_COMMON shared
    tokens is cached (its 62 full pages), the cache frees one page as the
    scheduler's eviction does under pool pressure (called directly: under
    real pressure the copied radix cache cannot evict past a spilled page,
    ROADMAP §3), which spills the prefix's last full page to a host page
    bit for bit, and ``spill_prompt`` (the prefix + 70 tokens) hits all 62
    pages, the last restored from host; its tokens must equal ``cold``
    (the slice-1 phase's cold engine on that prompt) but at a near-tie."""
    from repro_torch.core.telemetry import (to_chrome_trace,
                                            validate_swap_balance,
                                            validate_trace_events)
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    t0 = time.monotonic()
    stats = dict(host_pages=SWAP_HOST_PAGES, pages=PREEMPT_PAGES, modes={})
    launches = prefill_launches = 0
    for label, mode in HOST_TIER_MODES.items():
        engine = PagedEngine(cfg, params, EngineConfig(
            **dict(ORACLE_ENGINE, num_pages=PREEMPT_PAGES),
            host_pages=SWAP_HOST_PAGES, enable_telemetry=True, **mode),
            device=dev)
        assert engine.h_k_pages.is_pinned() and engine.h_v_pages.is_pinned()
        counts = swap_spy(engine)
        l0, p0 = paged_attention.launches, flash_prefill.launches
        outs = LLMService(engine).generate(
            prompts, SamplingParams(max_new_tokens=PREEMPT_NEW))
        torch.cuda.synchronize()
        launches += paged_attention.launches - l0
        prefill_launches += flash_prefill.launches - p0
        trace = to_chrome_trace(engine.trace.events())
        problems = validate_trace_events(trace) + \
            validate_swap_balance(trace)
        assert not problems, f"host tier, {label}: {problems[:5]}"
        assert engine.swapped_out == engine.swapped_in
        if mode["swap_mode"] == "swap":
            assert engine.swapped_out >= 1 and engine.preemptions == 0, \
                f"host tier, {label}: {engine.swapped_out} swap-outs, " \
                f"{engine.preemptions} preemptions"
        if mode.get("speculative_swap"):
            assert counts["issues"] == counts["completes"] + \
                counts["cancels"] >= 1, counts
        a = engine.allocator
        drained = a.num_free == a.num_blocks and a.swapped_pages == 0 \
            and a.pending_out_pages == 0 and a.host_num_free == SWAP_HOST_PAGES
        assert drained, f"host tier, {label}: ledgers not empty"
        st = dict(counts, swapped_out=engine.swapped_out,
                  swapped_in=engine.swapped_in,
                  preemptions=engine.preemptions,
                  iterations=engine.iterations, trace_events=len(
                      trace["traceEvents"]), drained=drained)
        del engine
        st["oracle"] = oracle_check(f"host tier, {label}", cfg, params,
                                    prompts, [o.token_ids for o in outs],
                                    dev)
        stats["modes"][label] = st
        picked = "swapped" if st["swapped_out"] else "sacrificed"
        log(f"host tier, {label}: {st['swapped_out']} swap-outs, "
            f"{st['swapped_in']} swap-ins ({st['pages_out']} + "
            f"{st['pages_issued']} issued pages out, {st['pages_in']} in), "
            f"{st['issues']} issues, {st['completes']} completes, "
            f"{st['cancels']} cancels, {st['preemptions']} preemptions "
            f"({picked}); trace of {st['trace_events']} events valid; "
            "ledgers empty")

    # the prefix spill round trip
    engine = PagedEngine(cfg, params, EngineConfig(
        **dict(ORACLE_ENGINE, num_pages=PREEMPT_PAGES),
        enable_prefix_cache=True, host_pages=SWAP_HOST_PAGES,
        cache_spill_pages=SPILL_BUDGET), device=dev)
    svc = LLMService(engine)
    svc.generate([common], SamplingParams(max_new_tokens=1))
    pc = engine.prefix_cache
    full = PREFIX_COMMON // PS
    assert pc.num_pages == full, pc.num_pages
    (leaf,) = pc._lru_leaves()
    before = [pool[:, leaf.block].clone() for pool in (engine.k_pages,
                                                       engine.v_pages)]
    assert pc.evict(1) == 1 and leaf.host_block >= 0
    for got, want in zip(engine.host_page(leaf.host_block), before):
        assert torch.equal(got.to(dev), want), "the spilled page changed"
    prompt = spill_prompt
    (out,) = svc.generate([prompt], SamplingParams(max_new_tokens=ORACLE_NEW))
    hit = out.metrics.num_cached_tokens
    assert hit == full * PS and pc.spilled_pages == pc.restored_pages == 1, \
        (hit, pc.spilled_pages, pc.restored_pages)
    if out.token_ids != cold.token_ids:
        i = next(j for j, (x, y) in enumerate(zip(out.token_ids,
                                                  cold.token_ids)) if x != y)
        for label, toks in (("restored", out.token_ids),
                            ("cold", cold.token_ids)):
            oracle_check(f"host tier, spill ({label} engine)", cfg, params,
                         [prompt], [toks[:i + 1]], dev)
    pc.clear()
    a = engine.allocator
    assert a.num_free == a.num_blocks and a.swapped_pages == 0
    del engine, svc
    stats["spill"] = dict(cached_tokens=hit, spilled_pages=1,
                          restored_pages=1,
                          equal_to_cold=out.token_ids == cold.token_ids)
    log(f"host tier, spill: a {len(prompt)}-token prompt hit {hit} cached "
        f"tokens, the last of {full} pages restored from a host page; greedy "
        f"tokens {'equal' if stats['spill']['equal_to_cold'] else 'differ at a near-tie'}"
        " to a cold engine's")
    stats.update(launches=launches, prefill_launches=prefill_launches,
                 seconds=time.monotonic() - t0)
    return stats


def host_tier_measure(cfg, params, dev, seed: int) -> dict:
    """The host tier on full-width paper-opt-13b in bf16 (the OPT serve
    phase's weights) under the serve traffic, on OPT_SWAP_ENGINE's pool
    with OPT_HOST_PAGES pinned host pages, in each of OPT_SWAP_MODES (the
    sacrifice mode has no host tier): tokens/s, TTFT, preemptions, swap
    events and pages, max_memory_allocated, the pinned host bytes, and the
    device->host and host->device GB/s of the movers from CUDA events
    around them. A finding, not a claim: no limit is checked but that
    every run serves every token."""
    page_bytes = 2 * cfg.num_layers * PS * cfg.num_kv_heads * cfg.head_dim \
        * torch.tensor([], dtype=cfg.torch_dtype).element_size()
    modes = {}
    for label, mode in OPT_SWAP_MODES.items():
        host = OPT_HOST_PAGES if mode else 0

        def instrument(engine, host=host):
            counts = swap_spy(engine)
            timed = time_movers(engine) if host else None
            pinned = engine.h_k_pages.nbytes + engine.h_v_pages.nbytes \
                if host else 0
            if host:
                assert engine.h_k_pages.is_pinned()

            def read():
                return dict(counts, swapped_out=engine.swapped_out,
                            swapped_in=engine.swapped_in,
                            preemptions=engine.preemptions,
                            pinned_host_bytes=pinned, page_bytes=page_bytes,
                            movers=mover_rates(timed, page_bytes)
                            if timed is not None else None)
            return read

        st = serve_model(f"OPT host tier, {label}", cfg, dev, seed,
                         serve_requests(cfg.vocab_size, seed),
                         dict(OPT_SWAP_ENGINE, host_pages=host, **mode),
                         params=params, instrument=instrument)
        modes[label] = st
        rates = st["movers"] or {}
        log(f"OPT host tier, {label}: {st['tokens_per_s']:.1f} tokens/s, TTFT "
            f"mean {st['ttft_mean_s'] * 1e3:.1f} ms, max "
            f"{st['ttft_max_s'] * 1e3:.1f} ms, {st['preemptions']} "
            f"preemptions, {st['swapped_out']} swap-outs / "
            f"{st['swapped_in']} swap-ins / {st['issues']} issues / "
            f"{st['cancels']} cancels, pages out {st['pages_out']} + "
            f"{st['pages_issued']} issued, in {st['pages_in']}, "
            f"max_memory_allocated {st['peak_gib']:.2f} GiB, pinned host "
            f"{st['pinned_host_bytes'] / 2 ** 30:.2f} GiB" + "".join(
                f"; {way} {r['pages']} pages in {r['ms']:.2f} ms = "
                f"{r['gb_per_s']:.1f} GB/s" for way, r in rates.items()
                if r["ms"]) + (f" (NetworkModel assumes "
                               f"{NETMODEL_PCIE_GB_S:.0f} GB/s)"
                               if rates else ""))
    return dict(arch=cfg.arch_id, engine=OPT_SWAP_ENGINE,
                host_pages=OPT_HOST_PAGES, modes=modes,
                launches=sum(m["launches"] for m in modes.values()),
                prefill_launches=sum(m["prefill_launches"]
                                     for m in modes.values()))


# -- MoE and the dense GQA configs --------------------------------------------------

def moe_phases(dev, seed: int):
    """llama4-scout at full width: served in bf16 at MOE_LAYERS of its 48
    layers under the serve traffic, then its float32 oracle at
    ORACLE_LAYERS layers with the capacity factor at E / top_k, so that no
    token is dropped and the chunked engine and the monolithic oracle
    route alike."""
    from repro_torch.configs import get_config
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    serve = serve_model("MoE serve phase", cfg, dev, seed,
                        serve_requests(cfg.vocab_size, seed), SERVE_ENGINE)
    oracle = oracle_model("MoE oracle", dataclasses.replace(
        full, num_layers=ORACLE_LAYERS,
        capacity_factor=full.num_experts / full.moe_top_k), dev, seed + 1)
    return dict(serve=serve, oracle=oracle)


def mla_phases(dev, seed: int):
    """deepseek-v2-236b at full width: served in bf16 at MLA_LAYERS of its
    60 layers under the serve traffic from latent pools (MLA_SCHEMA), with
    neither attention kernel launched, then its float32 oracle at
    ORACLE_LAYERS layers (the dense layer and one MoE layer) at capacity
    factor MLA_ORACLE_FACTOR, so that no token is dropped and the chunked
    engine and the monolithic oracle route alike."""
    from repro_torch.configs import get_config
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, num_layers=MLA_LAYERS)
    serve = serve_model("MLA serve phase", cfg, dev, seed,
                        serve_requests(cfg.vocab_size, seed), SERVE_ENGINE)
    assert serve["schema"] == MLA_SCHEMA, serve["schema"]
    assert serve["launches"] == serve["prefill_launches"] == 0
    oracle = oracle_model("MLA oracle", dataclasses.replace(
        full, num_layers=ORACLE_LAYERS, capacity_factor=MLA_ORACLE_FACTOR),
        dev, seed + 1)
    return dict(serve=serve, oracle=oracle)


def dense_phases(dev, seed: int):
    """paper-opt-13b whole under the serve traffic, then its host tier,
    cluster and sim phases on the same weights; granite-20b,
    command-r-35b and mistral-large-123b at DENSE_LAYERS under
    SHORT_PROMPTS; then each one's float32 oracle at ORACLE_LAYERS."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    serves, oracles = {}, {}
    cfg = get_config(CLUSTER_ARCH)
    # one set of weights for the serve, cluster and sim phases
    t0 = time.monotonic()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"OPT weights on the card in {time.monotonic() - t0:.1f}s, for the "
        "serve, cluster and sim phases")
    serves[cfg.arch_id] = serve_model(
        "OPT serve phase", cfg, dev, seed,
        serve_requests(cfg.vocab_size, seed), SERVE_ENGINE, params=params)
    host_tier = host_tier_measure(cfg, params, dev, seed)
    cluster = cluster_phase(cfg, params, dev, seed)
    sim = sim_phase(cfg, params, dev, seed, host_tier)
    del params
    cluster["gate"] = cluster_gate(dev, seed + 1)
    for arch, layers in DENSE_LAYERS.items():
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)
        serves[arch] = serve_model(f"{arch} serve phase", cfg, dev, seed,
                                   short_requests(cfg.vocab_size, seed),
                                   SHORT_ENGINE)
    for arch in ["paper-opt-13b", *DENSE_LAYERS]:
        oracles[arch] = oracle_model(f"{arch} oracle", dataclasses.replace(
            get_config(arch), num_layers=ORACLE_LAYERS), dev, seed + 1)
    return dict(serve=serves, oracle=oracles, cluster=cluster,
                host_tier=host_tier, sim=sim)


# -- cluster serving on paper-opt-13b ----------------------------------------------

def cluster_traffic(vocab_size: int, seed: int):
    """The sharing modes' warm prompt and 8 prompts (CLUSTER_PREFIX shared
    tokens + CLUSTER_SUFFIXES distinct ones), and the handoff modes' 8
    prompts of SERVE_PROMPTS tokens, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, CLUSTER_PREFIX).tolist()
    warm = prefix + rng.integers(0, vocab_size, CLUSTER_WARM).tolist()
    shared = [prefix + rng.integers(0, vocab_size, n).tolist()
              for n in CLUSTER_SUFFIXES]
    handoff = [rng.integers(0, vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    return warm, shared, handoff


def cluster_run(label: str, cfg, params, dev, mode_kw, warm, prompts,
                new: int, engine_kw=None, warm_new=None, after_warm=None):
    """One cluster mode: RouterBackend(**mode_kw) over two PagedEngines of
    ``engine_kw`` (default CLUSTER_ENGINE) built on ``params`` (shared, not
    copied). ``warm`` (or None) runs to completion first, with
    ``warm_new`` (default ``new``) tokens, then ``after_warm(engines,
    router)`` where given; then ``prompts`` arrive together, with
    ``new`` greedy tokens each, through a fresh LLMService (TTFT from its
    first poll). The launch counts are zeroed before the warm request and
    read after the last: paged_attention must equal layers x (decode steps
    + remote partials), its calls with partials layers x (decode steps
    that merged leases + remote partials), flash_prefill layers x the
    chunks that held no lease, summed over both engines. Every logit must
    be finite, every token in the vocab, every lease repaid. Returns the
    tokens and the run's numbers."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from repro_torch.serving.router import RouterBackend

    t_mode = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    engines = [PagedEngine(cfg, params, EngineConfig(
        **(engine_kw or CLUSTER_ENGINE)), device=dev) for _ in range(2)]
    assert engines[0].params is engines[1].params is params
    finite = watch_finite(engines, cfg.vocab_size, dev)
    router = RouterBackend(engines, **mode_kw)
    sp = SamplingParams(max_new_tokens=new)
    paged_attention.launches = paged_attention.partial_launches = 0
    flash_prefill.launches = 0
    if warm is not None:
        warm_new = warm_new or new
        (out,) = LLMService(router).generate(
            [warm], SamplingParams(max_new_tokens=warm_new))
        assert len(out.token_ids) == warm_new
        if after_warm is not None:
            after_warm(engines, router)
    svc = LLMService(router)
    ids = [svc.submit(prompt, sp) for prompt in prompts]
    delivered = {}  # request id -> wall s until its first token came back
    t0 = time.monotonic()
    while svc.pending:
        for chunk in svc.poll():
            delivered.setdefault(chunk.request_id, time.monotonic() - t0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = paged_attention.launches
    partial_launches = paged_attention.partial_launches
    prefill_launches = flash_prefill.launches
    unwatch(engines)

    outs = [svc._take_result(rid) for rid in ids]
    for out in outs:
        (s,) = out.samples
        assert len(s.token_ids) == new and s.finish_reason == "length", \
            (label, s)
        assert all(0 <= t < cfg.vocab_size for t in s.token_ids)
    assert bool(finite), f"{label}: a logit was not finite"
    assert not router.g.ledger, f"{label}: leases outstanding {router.g.ledger}"
    total = {k: sum(getattr(e, k) for e in engines)
             for k in ("decode_steps", "prefill_chunks", "leased_chunks",
                       "leased_decode_steps", "remote_partials")}
    L = cfg.num_layers
    assert launches == L * (total["decode_steps"] + total["remote_partials"])
    assert partial_launches == L * (total["leased_decode_steps"]
                                    + total["remote_partials"])
    assert prefill_launches == L * (total["prefill_chunks"]
                                    - total["leased_chunks"])
    # TTFT as the serve phase reads it (the engine stamps a token with the
    # start of the iteration that made it), and the wall time until the
    # poll that made it returned
    ttfts = [o.metrics.ttft for o in outs]
    firsts = [delivered[rid] for rid in ids]
    n_tokens = sum(len(o.token_ids) for o in outs)
    stats = dict(
        mode=label, requests=len(outs), tokens=n_tokens, wall_s=wall,
        tokens_per_s=n_tokens / wall, ttft_mean_s=sum(ttfts) / len(ttfts),
        ttft_max_s=max(ttfts), first_token_mean_s=sum(firsts) / len(firsts),
        first_token_max_s=max(firsts), iterations=router.iterations,
        launches=launches, partial_launches=partial_launches,
        prefill_launches=prefill_launches,
        leases_granted=router.leases_granted,
        pages_borrowed=router.pages_borrowed,
        adopted_pages=[e.prefix_cache.adopted_pages for e in engines],
        cached_tokens=[o.metrics.num_cached_tokens for o in outs],
        instances=[o.metrics.instance_id for o in outs],
        net_time_s=sum(e.net_time for e in engines),
        ledger=[(e.creditor, e.debtor, e.blocks) for e in router.g.ledger],
        peer_spilled_pages=sum(e.prefix_cache.peer_spilled_pages
                               for e in engines if e.prefix_cache),
        peer_restored_pages=sum(e.prefix_cache.peer_restored_pages
                                for e in engines if e.prefix_cache),
        **total)
    if router.handoff is not None:
        stats.update({k: getattr(router.handoff, k) for k in (
            "handoffs_migrated", "handoffs_leased", "pages_copied",
            "pages_leased", "deferrals", "fallbacks")})
    tokens = [o.token_ids for o in outs]
    del engines, router, svc, outs
    stats.update(phase_end(f"cluster phase, {label}", t_mode))
    return tokens, stats


def check_cluster_mode(label: str, st: dict, handoff) -> None:
    """What each mode must have done, beyond ``cluster_run``'s checks."""
    ps = CLUSTER_ENGINE["page_size"]
    if label.endswith("share"):
        borrowers = [i for i, inst in enumerate(st["instances"]) if inst == 1]
        assert borrowers and all(st["cached_tokens"][i] == CLUSTER_PREFIX
                                 for i in borrowers), st
    if label == "zero-copy share":
        assert st["leases_granted"] == len(borrowers), st
        assert st["pages_borrowed"] >= (CLUSTER_PREFIX // ps) * \
            st["leases_granted"], st
        assert st["adopted_pages"][1] == 0, "zero-copy copied a payload"
        assert st["partial_launches"] > 0 and st["leased_chunks"] > 0
    if label == "copy share":
        assert st["adopted_pages"][1] > 0 and st["leases_granted"] == 0
        assert st["partial_launches"] == 0
    if label == "migrate handoff":
        assert st["handoffs_migrated"] == len(handoff), st
        assert st["handoffs_leased"] == 0 and st["pages_copied"] > 0
    if label == "zero-copy handoff":
        assert st["handoffs_leased"] == len(handoff), st
        assert st["pages_leased"] == sum(len(p) // ps for p in handoff), st
        assert st["partial_launches"] > 0
    if label.endswith("handoff"):
        assert st["instances"] == [1] * len(handoff), st


def cluster_phase(cfg, params, dev, seed: int):
    """Cluster serving on full-width paper-opt-13b (40 layers, bf16), on
    the weights of the OPT serve phase: the four CLUSTER_MODES in turn,
    each over two engines of CLUSTER_ENGINE, greedy, CLUSTER_NEW new
    tokens a request. Zero-copy share: a warm request, then 8 requests of
    the shared prefix + a distinct suffix arrive at t = 0; round robin
    puts 4 on each instance, and those on instance 1 borrow the prefix's
    32 pages from instance 0 in place (decode partials through
    paged_attention). Copy share: the same traffic, the pages adopted as
    payloads. The handoff modes: the serve phase's 8 prompts, prefilled on
    instance 0 and decoded on instance 1."""
    t0 = time.monotonic()
    warm, shared, handoff = cluster_traffic(cfg.vocab_size, seed)
    modes = {}
    for label, kw in CLUSTER_MODES.items():
        share = label.endswith("share")
        _, st = cluster_run(label, cfg, params, dev, kw,
                            warm if share else None,
                            shared if share else handoff, CLUSTER_NEW)
        check_cluster_mode(label, st, handoff)
        modes[label] = st
        log(f"cluster phase, {label}: {st['tokens']} tokens in "
            f"{st['wall_s']:.2f}s ({st['tokens_per_s']:.1f} tokens/s), mean "
            f"TTFT {st['ttft_mean_s'] * 1e3:.1f} ms, max "
            f"{st['ttft_max_s'] * 1e3:.1f} ms, first token back mean "
            f"{st['first_token_mean_s'] * 1e3:.1f} ms, max "
            f"{st['first_token_max_s'] * 1e3:.1f} ms; leases "
            f"{st['leases_granted']}"
            f", pages borrowed {st['pages_borrowed']}, adopted pages "
            f"{st['adopted_pages']}, ledger {st['ledger']}; paged_attention "
            f"launches {st['launches']} ({st['partial_launches']} with "
            f"partials), flash_prefill {st['prefill_launches']}; "
            + ", ".join(f"{k} {st[k]}" for k in (
                "handoffs_migrated", "handoffs_leased", "pages_copied",
                "pages_leased") if k in st))
    return dict(arch=cfg.arch_id, layers=cfg.num_layers, modes=modes,
                launches=sum(m["launches"] for m in modes.values()),
                prefill_launches=sum(m["prefill_launches"]
                                     for m in modes.values()),
                seconds=time.monotonic() - t0)


def park_prefix_page(engines, router) -> None:
    """The peer spill mode's step after its warm request (the shared
    prefix + half a page, one new token, so that its 32 full cached pages
    are the prefix's): engine 0's cache frees one page as its eviction
    does under pressure (called directly, ROADMAP §3), which parks the
    prefix's last page in engine 1's free device memory (a lent block)."""
    pc = engines[0].prefix_cache
    assert pc.num_pages == CLUSTER_PREFIX // PS, pc.num_pages
    assert pc.evict(1) == 1 and pc.peer_spilled_pages == 1
    assert router.g.lent_by(1) == 1


def cluster_gate(dev, seed: int):
    """The four cluster modes in float32 (``logits_fp32``) on paper-opt-13b
    at full width and ORACLE_LAYERS layers, and a peer spill mode
    (``RouterBackend(peer_spill=True)`` over engines with a spill budget:
    a prefix page of instance 0 parked on instance 1 and restored by the
    next hit, every loan repaid), against a single float32
    engine that serves each prompt alone: a token may differ only where
    Model.forward over the prompt and the single engine's tokens puts the
    two on top within NEAR_TIE of the largest |logit| (a zero-copy run
    merges two partials, a float32 sum in another order), and comparing
    that request stops there. The single engine's tokens are held against
    Model.forward first (``oracle_check``)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine

    t0 = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(CLUSTER_ARCH),
                              num_layers=ORACLE_LAYERS, dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    warm, shared, handoff = cluster_traffic(cfg.vocab_size, seed)
    engine = PagedEngine(cfg, params, EngineConfig(**dict(
        CLUSTER_ENGINE, enable_prefix_cache=False)), device=dev)
    single_svc = LLMService(engine)
    sp = SamplingParams(max_new_tokens=ORACLE_NEW)
    single = {tuple(p): single_svc.generate([p], sp)[0].token_ids
              for p in shared + handoff}
    del engine, single_svc
    prompts = shared + handoff
    oracle = oracle_check("cluster gate, single engine", cfg, params,
                          prompts, [single[tuple(p)] for p in prompts], dev)
    model = Model(cfg)
    stats = dict(oracle=oracle, modes={})
    for label, kw in [*CLUSTER_MODES.items(), ("peer spill", PEER_SPILL)]:
        share = label.endswith("share")
        mode_prompts = shared if share or label == "peer spill" else handoff
        if label == "peer spill":
            tokens, st = cluster_run(
                f"float32 {label}", cfg, params, dev, kw,
                warm[:CLUSTER_PREFIX + PS // 2], mode_prompts, ORACLE_NEW,
                engine_kw=PEER_SPILL_ENGINE, warm_new=1,
                after_warm=park_prefix_page)
            assert st["peer_spilled_pages"] == st["peer_restored_pages"] \
                == 1, st
            assert all(st["cached_tokens"][i] == CLUSTER_PREFIX
                       for i, inst in enumerate(st["instances"])
                       if inst == 0), st
        else:
            tokens, st = cluster_run(f"float32 {label}", cfg, params, dev,
                                     kw, warm if share else None,
                                     mode_prompts, ORACLE_NEW)
            check_cluster_mode(label, st, handoff)
        compared = stops = 0
        for prompt, got in zip(mode_prompts, tokens):
            want = single[tuple(prompt)]
            for i, (x, y) in enumerate(zip(got, want)):
                compared += 1
                if x == y:
                    continue
                logits, _ = model.forward(params, torch.tensor(
                    [prompt + want[:i]], device=dev))
                last = logits[0, -1, :cfg.vocab_size].float()
                top = torch.topk(last, 2)
                gap = float(top.values[0] - top.values[1])
                bound = NEAR_TIE * float(last.abs().max())
                assert {x, y} == set(top.indices.tolist()) and gap < bound, \
                    f"cluster gate, {label}: token {i} of a {len(prompt)}-" \
                    f"token prompt: cluster {x}, single engine {y}, " \
                    f"Model.forward's top-2 {top.indices.tolist()} gap {gap}"
                stops += 1
                log(f"cluster gate, {label}: near-tie at token {i} of a "
                    f"{len(prompt)}-token prompt (gap {gap:.3g} < "
                    f"{bound:.3g}); stop there")
                break
        total = len(mode_prompts) * ORACLE_NEW
        assert compared >= total // 2, f"only {compared}/{total} compared"
        stats["modes"][label] = dict(compared=compared, total=total,
                                     near_tie_stops=stops,
                                     leases_granted=st["leases_granted"],
                                     pages_borrowed=st["pages_borrowed"],
                                     partial_launches=st["partial_launches"],
                                     peer_spilled_pages=st[
                                         "peer_spilled_pages"],
                                     peer_restored_pages=st[
                                         "peer_restored_pages"],
                                     ledger=st["ledger"])
        log(f"cluster gate, {label}: {compared}/{total} float32 tokens equal "
            f"to the single engine's, {stops} near-tie stops")
    del params
    stats.update(phase_end("cluster gate", t0))
    return stats


# -- sim phase: the paper's studies, an engine beside a simulator, card terms -

def load_benchmark(name: str):
    """``benchmarks/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def non_dominated(points) -> bool:
    """No point of ``points`` (minimised objectives) dominates another."""
    pts = np.asarray(points, float)
    return not any(np.all(a <= b) and np.any(a < b)
                   for i, a in enumerate(pts) for j, b in enumerate(pts)
                   if i != j)


def sim_studies() -> dict:
    """The paper's serving study (Fig. 9, Fig. 10) and its chain study on
    the port's benchmarks at SIM_STUDIES' sizes, with what the reference's
    tests assert of the same machinery: paged beats orca-max at the
    highest rate and orca-oracle is never worse than orca-max
    (tests/test_simulator.py), DistKV serves every request of the regime
    whose long contexts exceed one instance while the local baseline
    rejects some, batch-level scheduling has a worse normalised latency
    than iteration-level paging; every tradeoff chain covers every block,
    the NSGA-II front is mutually non-dominated and the knee is a valid
    chain (tests/test_chain.py). Runs on the host: no tensor, no device."""
    from repro_torch.core.chain import (knee_chain,
                                        latency_throughput_tradeoff,
                                        make_fleet, nsga2)
    from repro_torch.serving.simulator import (make_workload,
                                               simulate_batch_level,
                                               simulate_paged)
    t0 = time.monotonic()
    log("sim phase, studies: the rows below are virtual-clock results of "
        "CostModel's defaults (the reference's assumed A100-like terms), "
        "not times on this card")
    fig9 = load_benchmark("torch_serving_fig9").run(
        **SIM_STUDIES["torch_serving_fig9"])
    for dist, rows in fig9.items():
        assert all(r["orca-oracle"] <= r["orca-max"] + 1e-9 for r in rows), \
            (dist, rows)
        assert rows[-1]["vLLM-paged"] < rows[-1]["orca-max"], (dist, rows[-1])
    fig10 = load_benchmark("torch_serving_fig10").run(
        **SIM_STUDIES["torch_serving_fig10"])
    exceeds = [r for r in fig10 if r["regime"] == "exceeds"]
    assert all(r["distkv_done"] == 1.0 for r in exceeds), exceeds
    assert any(r["local_rejected"] > 0 for r in exceeds), exceeds
    # the pre-ORCA batch-level baseline against iteration-level paging, on
    # tests/test_simulator.py's workload
    paged = simulate_paged(make_workload(100, rate=4.0, seed=6),
                           num_blocks=4096)
    batch = simulate_batch_level(make_workload(100, rate=4.0, seed=6),
                                 max_batch=16)
    assert batch.mean_normalized_latency > paged.mean_normalized_latency
    log(f"sim phase, studies: batch level "
        f"{batch.mean_normalized_latency * 1e3:.1f} ms/token against paged "
        f"{paged.mean_normalized_latency * 1e3:.1f} (virtual)")
    rows, agg = load_benchmark("torch_chain_compare").run(
        **SIM_STUDIES["torch_chain_compare"])
    assert all(r["pareto"] > 0 for r in rows), rows
    # tests/test_chain.py's invariants on the module itself
    fleet = make_fleet(10, 12, seed=5)
    res = latency_throughput_tradeoff(fleet, pop_size=30, generations=15,
                                      seed=5)
    assert res.chains and non_dominated(res.pareto_front)
    for chain in res.chains:
        covered = []
        for s, a, b in chain:
            assert s.start_block <= a and b <= s.end_block
            covered.extend(range(a, b))
        assert covered == list(range(fleet.num_blocks)), chain
    knee = knee_chain(res)
    assert knee is not None and knee.total_time > 0

    def toy(x):
        return np.array([float(x.sum()),
                         float(len(x) - x.sum() + x[0] * 3)]), 0.0

    front = nsga2(toy, n_var=12, pop_size=20, generations=10, seed=5).pareto
    assert non_dominated([ind.f for ind in front])
    seconds = time.monotonic() - t0
    log(f"sim phase, studies: fig9 {sum(map(len, fig9.values()))} rows, "
        f"fig10 {len(fig10)} rows, chain {len(rows)} fleets (HV paper "
        f"{agg['hv_ga']:.1f}, realized {agg['hv_real']:.1f}, baseline "
        f"{agg['hv_base']:.1f}); tradeoff front of {len(res.chains)} chains "
        f"non-dominated, knee {knee.total_time:.3f} s/step (virtual); "
        f"{seconds:.1f} s on the host")
    return dict(fig9=fig9, fig10=fig10, chain_rows=rows, chain_mean=agg,
                batch_level_norm_latency=batch.mean_normalized_latency,
                paged_norm_latency=paged.mean_normalized_latency,
                tradeoff_chains=len(res.chains), seconds=seconds)


def sim_prompts(vocab_size: int, seed: int):
    """Greedy prompts of SERVE_PROMPTS tokens drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, n).tolist() for n in SERVE_PROMPTS]


def mixed_router_run(cfg, params, dev, seed: int) -> dict:
    """RouterBackend([a full-width PagedEngine of SERVE_ENGINE, a
    SimBackend of the same pages and SIM_CHILD], round robin) through
    LLMService: the serve prompts, greedy, SERVE_NEW new tokens each. The
    router's clock is None (a wall-clock child), placements alternate, every
    request ends with ``length``; the engine child's tokens lie in the
    vocabulary with finite logprobs, the simulator child's have none; the
    engine's kernels launch layers x its decode steps and chunks."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from repro_torch.serving.router import RouterBackend
    from repro_torch.serving.simulator import SimBackend

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    engine = PagedEngine(cfg, params, EngineConfig(**SERVE_ENGINE, seed=seed),
                         device=dev)
    child = SimBackend(num_blocks=SERVE_ENGINE["num_pages"],
                       block_size=SERVE_ENGINE["page_size"], **SIM_CHILD)
    router = RouterBackend([engine, child], policy="round_robin")
    assert router.clock() is None
    finite = watch_finite([engine], cfg.vocab_size, dev)
    svc = LLMService(router)
    sp = SamplingParams(max_new_tokens=SERVE_NEW)
    ids = [svc.submit(p, sp) for p in sim_prompts(cfg.vocab_size, seed)]
    paged_attention.launches = flash_prefill.launches = 0
    t_run = time.monotonic()
    while svc.pending:
        svc.poll()
    torch.cuda.synchronize()
    wall = time.monotonic() - t_run
    launches, prefill_launches = paged_attention.launches, \
        flash_prefill.launches
    unwatch([engine])
    outs = [svc._take_result(rid) for rid in ids]
    placed = [o.metrics.instance_id for o in outs]
    assert placed == [i % 2 for i in range(len(outs))], placed
    for o in outs:
        (s,) = o.samples
        assert s.finish_reason == "length" and \
            len(s.token_ids) == SERVE_NEW, s
        if o.metrics.instance_id == 0:
            assert all(0 <= x < cfg.vocab_size for x in s.token_ids)
            assert all(math.isfinite(x) for x in s.token_logprobs)
        else:
            assert s.token_logprobs is None, s
    assert bool(finite), "sim phase, mixed router: a logit was not finite"
    L = cfg.num_layers
    assert engine.decode_steps > 0 and engine.prefill_chunks > 0
    assert launches == L * engine.decode_steps, (launches, engine.decode_steps)
    assert prefill_launches == L * engine.prefill_chunks, \
        (prefill_launches, engine.prefill_chunks)
    mine = [o for o in outs if o.metrics.instance_id == 0]
    ttfts = [o.metrics.ttft for o in mine]
    n_tokens = sum(len(o.token_ids) for o in mine)
    st = dict(requests=len(outs), engine_requests=len(mine),
              engine_tokens=n_tokens, wall_s=wall,
              engine_tokens_per_s=n_tokens / wall,
              ttft_mean_s=sum(ttfts) / len(ttfts), ttft_max_s=max(ttfts),
              engine_iterations=engine.iterations,
              sim_iterations=child.iterations,
              decode_steps=engine.decode_steps,
              prefill_chunks=engine.prefill_chunks, launches=launches,
              prefill_launches=prefill_launches,
              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del engine, child, router, svc, outs, mine
    st["seconds"] = phase_end("sim phase, mixed router", t0)["seconds"]
    log(f"sim phase, mixed router: {st['engine_tokens']} engine tokens in "
        f"{wall:.2f}s ({st['engine_tokens_per_s']:.1f} tokens/s), TTFT mean "
        f"{st['ttft_mean_s'] * 1e3:.1f} ms, max {st['ttft_max_s'] * 1e3:.1f}"
        f" ms; {st['engine_iterations']} engine / {st['sim_iterations']} "
        f"simulator iterations; paged_attention launches {launches} = {L} x "
        f"{st['decode_steps']}, flash_prefill {prefill_launches} = {L} x "
        f"{st['prefill_chunks']}; max_memory_allocated "
        f"{st['peak_gib']:.2f} GiB")
    return st


def plan_spy(backend, cost):
    """Record each plan of ``backend``'s scheduler as ``SimBackend.step``
    charges it: (tokens, decodes, chunks, attention reads), the reads being
    each decode's context and ``cost.prefill_read_tokens`` of each chunk
    (no lease here, so no remote reads). ``del backend.scheduler.schedule``
    takes the spy off."""
    rec = []
    schedule = backend.scheduler.schedule

    def spied():
        plan = schedule()
        reads = sum(r.context_len for r in plan.decode) + sum(
            cost.prefill_read_tokens(c.start, c.length) for c in plan.chunks)
        rec.append((plan.token_count(), len(plan.decode), len(plan.chunks),
                    reads))
        return plan

    backend.scheduler.schedule = spied
    return rec


def drive(backend, prompts, timed: bool):
    """The prompts as requests at t = 0 (SERVE_NEW greedy tokens each),
    stepped to the end; with ``timed``, each step's wall seconds, closed by
    a synchronize."""
    from repro_torch.core.scheduling.request import Request
    for i, p in enumerate(prompts):
        backend.add_request(Request(i, 0.0, list(p),
                                    max_new_tokens=SERVE_NEW))
    seconds = []
    while backend.has_work:
        if timed:
            torch.cuda.synchronize()
            t = time.perf_counter()
        backend.step()
        if timed:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
    return seconds


def fit_cost_model(cfg, params, dev, seed: int) -> dict:
    """The card's own CostModel terms: the serve prompts (greedy) on a
    fresh full-width PagedEngine of SERVE_ENGINE, twice (the first pass
    warms the engine), each plan recorded as the simulator charges it and
    each step timed; t_fixed, c_token and c_ctx fitted to the second pass by
    non-negative least squares. Then the same requests on the port's
    SimBackend with the engine's scheduler settings and the fitted terms:
    it must plan the same iterations."""
    from scipy.optimize import nnls

    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    from repro_torch.serving.simulator import CostModel, SimBackend

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    default = CostModel()
    prompts = sim_prompts(cfg.vocab_size, seed + 1)
    engine = PagedEngine(cfg, params, EngineConfig(**SERVE_ENGINE, seed=seed),
                         device=dev)
    paged_attention.launches = flash_prefill.launches = 0
    passes = []
    for _ in range(2):
        plans = plan_spy(engine, default)
        seconds = drive(engine, prompts, timed=True)
        del engine.scheduler.schedule  # the spy holds the plans
        assert len(seconds) == len(plans)
        passes.append(dict(plans=plans, seconds=seconds))
    L = cfg.num_layers
    launches, prefill_launches = paged_attention.launches, \
        flash_prefill.launches
    assert launches == L * engine.decode_steps, launches
    assert prefill_launches == L * engine.prefill_chunks, prefill_launches
    assert passes[0]["plans"] == passes[1]["plans"]
    a = engine.allocator
    assert a.num_free == a.num_blocks
    del engine, a
    plans, seconds = passes[1]["plans"], np.array(passes[1]["seconds"])
    A = np.array([[1.0, tok, reads] for tok, _, _, reads in plans])
    scale = A.max(axis=0)
    coef, _ = nnls(A / scale, seconds)
    t_fixed, c_token, c_ctx = (coef / scale).tolist()
    pred = A @ (coef / scale)
    r2 = 1.0 - float(((seconds - pred) ** 2).sum()) / \
        float(((seconds - seconds.mean()) ** 2).sum())
    fitted = CostModel(t_fixed=t_fixed, c_token=c_token, c_ctx=c_ctx)
    # a reading the CostModel cannot express: the engine runs one forward
    # for its decodes and one per chunk, so a fixed cost per forward in
    # place of one per iteration
    F = np.array([[n_chunks + (n_dec > 0), tok, reads]
                  for tok, n_dec, n_chunks, reads in plans], float)
    f_scale = F.max(axis=0)
    f_coef, _ = nnls(F / f_scale, seconds)
    t_forward, f_token, f_ctx = (f_coef / f_scale).tolist()
    f_r2 = 1.0 - float(((seconds - F @ (f_coef / f_scale)) ** 2).sum()) / \
        float(((seconds - seconds.mean()) ** 2).sum())

    # the replay: the same requests on the simulator, the fitted terms
    child = SimBackend(num_blocks=SERVE_ENGINE["num_pages"],
                       block_size=SERVE_ENGINE["page_size"],
                       max_running=SERVE_ENGINE["max_slots"],
                       max_tokens_per_iter=SERVE_ENGINE["max_tokens_per_iter"],
                       cost=fitted)
    sim_plans = plan_spy(child, fitted)
    drive(child, prompts, timed=False)
    assert sim_plans == plans, "the simulator planned other iterations"
    # the iterations apart: decode-only ones, and those that ran chunks
    # (their excess over the decode-only median, per chunk token)
    decode_only = [s for (_, _, n_chunks, _), s in zip(plans, seconds)
                   if n_chunks == 0]
    floor = statistics.median(decode_only) if decode_only else 0.0
    with_chunks = [(tok - n_dec, s) for (tok, n_dec, n_chunks, _), s
                   in zip(plans, seconds) if n_chunks]
    st = dict(iterations=len(plans), t_fixed=t_fixed, c_token=c_token,
              c_ctx=c_ctx, r2=r2, default=dataclasses.asdict(default),
              wall_s=float(seconds.sum()), sim_makespan_s=child.clock(),
              warm_wall_s=float(sum(passes[0]["seconds"])),
              decode_only_iterations=len(decode_only),
              decode_only_ms_median=float(floor) * 1e3
              if decode_only else None,
              chunk_iterations=len(with_chunks),
              chunk_iteration_ms_median=float(statistics.median(
                  s for _, s in with_chunks)) * 1e3,
              chunk_tokens=sum(n for n, _ in with_chunks),
              chunk_excess_us_per_token=float(
                  sum(s - floor for _, s in with_chunks)
                  / sum(n for n, _ in with_chunks)) * 1e6,
              per_forward=dict(t_forward=t_forward, c_token=f_token,
                               c_ctx=f_ctx, r2=f_r2),
              rows=[[*plan, s] for plan, s in zip(plans, seconds.tolist())],
              tokens=int(A[:, 1].sum()), reads=int(A[:, 2].sum()),
              launches=launches, prefill_launches=prefill_launches,
              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    st["seconds"] = phase_end("sim phase, CostModel fit", t0)["seconds"]
    log(f"sim phase, CostModel fit: {len(plans)} iterations of "
        f"{cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} (R^2 {r2:.4f}): "
        f"t_fixed {t_fixed * 1e3:.3f} ms "
        f"(default {default.t_fixed * 1e3:.3f}), c_token "
        f"{c_token * 1e6:.3f} us (default {default.c_token * 1e6:.3f}), "
        f"c_ctx {c_ctx * 1e9:.3f} ns (default {default.c_ctx * 1e9:.3f}); "
        f"{st['decode_only_iterations']} decode-only iterations, median "
        f"{fmt_ms(st['decode_only_ms_median'])}; {st['chunk_iterations']} "
        f"with chunks ({st['chunk_tokens']} chunk tokens), median "
        f"{st['chunk_iteration_ms_median']:.3f} ms, "
        f"{st['chunk_excess_us_per_token']:.2f} us a chunk token above the "
        f"decode-only median; per forward instead of per iteration: "
        f"{t_forward * 1e3:.3f} ms a forward, {f_token * 1e6:.3f} us a "
        f"token, {f_ctx * 1e9:.3f} ns a read (R^2 {f_r2:.4f}); launches "
        f"paged_attention {launches}, "
        f"flash_prefill {prefill_launches} over both passes; the simulator with these terms planned the same {len(plans)} "
        f"iterations, makespan {st['sim_makespan_s']:.3f} s (virtual) "
        f"against the engine's {st['wall_s']:.3f} s of timed steps")
    return st


def fmt_gbps(x) -> str:
    return "not measured" if x is None else f"{x:.1f}"


def swap_lane(host_tier: dict) -> dict:
    """The swap lane the OPT host tier's movers imply, in the launcher's
    units: each timed mover call (pages of ``page_bytes``, ms) of every
    mode, each way and both, fitted as ``t_swap_fixed + bytes * 8 /
    (pcie_gbps * 1e9)`` (``NetworkModel.swap_time``) by non-negative least
    squares where the calls have two sizes or more, else the aggregate
    rate alone; and each way's aggregate GB/s."""
    from scipy.optimize import nnls

    from repro_torch.core.distkv.netmodel import NetworkModel
    calls = {"out": [], "in": []}
    page_bytes = None
    for st in host_tier["modes"].values():
        if st["movers"] is None:
            continue
        page_bytes = st["page_bytes"]
        for way, r in st["movers"].items():
            calls[way] += r["each"]
    default = NetworkModel()
    out = dict(page_bytes=page_bytes, default_pcie_gbps=default.pcie_gbps,
               default_t_swap_fixed=default.t_swap_fixed)
    for way, rec in (*calls.items(), ("both", calls["out"] + calls["in"])):
        pages = sum(n for n, _ in rec)
        ms = sum(m for _, m in rec)
        row = dict(calls=len(rec), pages=pages, ms=ms,
                   gb_per_s=pages * page_bytes / ms / 1e6 if ms else None,
                   t_swap_fixed=None, pcie_gbps=None)
        if len({n for n, _ in rec}) >= 2:  # two sizes separate the terms
            A = np.array([[1.0, n * page_bytes] for n, _ in rec])
            scale = A.max(axis=0)
            coef, _ = nnls(A / scale, np.array([m * 1e-3 for _, m in rec]))
            t_fix, s_per_byte = coef / scale
            row["t_swap_fixed"] = float(t_fix)
            if s_per_byte > 0:
                row["pcie_gbps"] = 8.0 / (float(s_per_byte) * 1e9)
        elif row["gb_per_s"]:
            row["pcie_gbps"] = row["gb_per_s"] * 8.0
        out[way] = row
    both = out["both"]
    log("sim phase, swap lane from the OPT host tier's movers: "
        + "; ".join(f"{way} {r['calls']} calls, {r['pages']} pages, "
                    f"{fmt_gbps(r['gb_per_s'])} GB/s aggregate, fitted "
                    f"{fmt_gbps(r['pcie_gbps'])} Gb/s"
                    + (f" + {r['t_swap_fixed'] * 1e6:.1f} us a call"
                       if r["t_swap_fixed"] is not None else
                       " (one call size: no fixed term)")
                    for way, r in out.items() if isinstance(r, dict))
        + f"; NetworkModel's defaults --pcie-gbps {default.pcie_gbps:.0f} "
          f"--t-swap-fixed {default.t_swap_fixed:g}, this card's "
          f"--pcie-gbps {fmt_gbps(both['pcie_gbps'])}"
        + (f" --t-swap-fixed {both['t_swap_fixed']:.3g}"
           if both["t_swap_fixed"] is not None else ""))
    return out


def sim_phase(cfg, params, dev, seed: int, host_tier: dict) -> dict:
    """The simulator, the batch-level baseline and chain selection on the
    card's machine, on the OPT serve phase's weights: (a) the paper's
    studies (``sim_studies``); (b) one router over a full-width OPT engine
    and a simulator child (``mixed_router_run``); (c) the card's own
    CostModel terms (``fit_cost_model``) and the swap lane the host tier's
    movers imply (``swap_lane``)."""
    t0 = time.monotonic()
    studies = sim_studies()
    router = mixed_router_run(cfg, params, dev, seed)
    fit = fit_cost_model(cfg, params, dev, seed)
    lane = swap_lane(host_tier)
    return dict(studies=studies, router=router, fit=fit, swap_lane=lane,
                launches=router["launches"] + fit["launches"],
                prefill_launches=router["prefill_launches"]
                + fit["prefill_launches"], seconds=time.monotonic() - t0)


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
    t_phase = t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
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
    cap = MAMBA_PROMPT + MAMBA_NEW  # an SSM segment ignores it
    _, warm = model.prefill(params, toks, seq_capacity=cap)
    model.decode_step(params, toks[:, :1], toks[:, 0], warm)
    del warm
    torch.cuda.synchronize()

    ssd_scan.launches = 0  # read around this prefill alone
    t0 = time.monotonic()
    logits, caches = model.prefill(params, toks, seq_capacity=cap)
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
    return dict(**phase_end("mamba2 phase", t_phase),
                params=n_params, batch=MAMBA_BATCH, prompt=MAMBA_PROMPT,
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
    lk, ck = model.prefill(params, toks, seq_capacity=s)
    assert ssd_scan.launches == before + cfg.num_layers
    lr, cr = None, model.init_cache(b, s, device=dev)
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


# -- ring caches: hymba-1.5b and the MLA latent ring --------------------------

def launch_counts():
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return dict(flash_prefill=flash_prefill.launches,
                paged_attention=paged_attention.launches,
                ssd_scan=ssd_scan.launches)


def reset_launch_counts():
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    flash_prefill.launches = paged_attention.launches = ssd_scan.launches = 0


def hymba_phase(dev, seed: int):
    """Full-width hymba-1.5b (32 layers: attention and SSM heads side by
    side in every layer, window 1024 but layers 0 and 16), random weights
    from a seed, bf16: ``Model.prefill`` of HYMBA_BATCH prompts x
    HYMBA_PROMPT tokens (past the window: the window rings are seeded from
    the last 1024 positions) with capacity HYMBA_PROMPT + HYMBA_NEW, then
    HYMBA_NEW greedy ``decode_step``s (the window rings wrap). The launch
    counts are read around the prefill alone: ``flash_prefill`` once per
    layer and sequence (``prefill_attention``), ``ssd_scan`` once per
    layer, ``paged_attention`` never; the decode launches no kernel. Every
    logit and cache leaf must be finite. Then the float32 oracle
    (``hymba_oracle``) and the MLA ring (``mla_ring_check``)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    cfg = get_config(HYMBA_ARCH)  # full width and depth, no cut
    t_phase = t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    model = Model(cfg)
    plan = [(s.n, s.attn_kind) for s in model.plan]
    log(f"hymba phase: {cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, window "
        f"{cfg.sliding_window}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, plan {plan}, "
        f"{n_params / 1e9:.3f} B params {cfg.dtype} on the card in "
        f"{time.monotonic() - t0:.1f}s")
    b, s, new = HYMBA_BATCH, HYMBA_PROMPT, HYMBA_NEW
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           device=dev)
    want = dict(flash_prefill=cfg.num_layers * b, paged_attention=0,
                ssd_scan=cfg.num_layers)
    _, run, caches = ring_run("hymba phase", cfg, params, dev, toks, {}, new,
                              want)
    # the window rings wrapped: they hold the last 1024 positions
    cap = run["capacity"]
    for seg, c in zip(model.plan, caches):
        kv_pos = c[0].pos
        lo = cap - cfg.sliding_window if seg.attn_kind == "swa" else 0
        assert int(kv_pos.min()) == lo and int(kv_pos.max()) == cap - 1, \
            (seg, int(kv_pos.min()), int(kv_pos.max()))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"hymba phase: prefill of {b} x {s} tokens in "
        f"{run['prefill_ms']:.1f} ms ({run['prefill_tokens_per_s']:.0f} "
        f"tokens/s); launches {run['launches']}; {new} greedy decode steps "
        f"in {run['decode_ms']:.1f} ms ({run['decode_tokens_per_s']:.1f} "
        f"tokens/s); max_memory_allocated {peak_gib:.2f} GiB")
    del params, caches
    torch.cuda.empty_cache()
    oracle = hymba_oracle(dev, seed + 1)
    mla_ring = mla_ring_check(dev, seed + 2)
    return dict(**phase_end("hymba phase", t_phase), params=n_params,
                measure_peak_gib=peak_gib, oracle=oracle, mla_ring=mla_ring,
                **run)


def hymba_oracle(dev, seed: int):
    """Float32 hymba-1.5b at full width and depth (6.4 GB), 2 prompts of
    HYMBA_ORACLE_PROMPT tokens (five chunks of 256, past the window),
    capacity prompt + HYMBA_ORACLE_NEW:

    (i) the kernel prefill's last logits against ``Model.forward`` (plain
        attention);
    (ii) the kernel prefill against stepping ``decode_step`` token by
        token from ``init_cache`` (no kernel): the last logits, every SSM
        state and conv tail, and the ring K/V slot by slot (equal
        capacities give equal slots; their positions must be equal);
    (iii) the first decode step after the kernel prefill (position S)
        against ``Model.forward`` over 2S tokens at S;
    (iv) HYMBA_ORACLE_NEW greedy tokens from each path's caches: equal,
        except at a near-tie of the recurrence's logits (2**-7 of the
        largest |logit|), where comparing that row stops.

    Tolerance of (i)-(iii): 1e-2 of the largest magnitude of each
    compared quantity (logits, each state, conv tail, K, V): both sides
    are float32 and round q, k, v and the attention probabilities to
    bf16, so a one-ulp difference upstream can flip a rounding (2**-8
    relative) that every later layer inherits (the level ROADMAP §3 holds
    deeper-layer K/V to); the medians are printed beside."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config(HYMBA_ARCH), dtype="float32",
                              logits_fp32=True)
    params = init_params(cfg, seed=seed, device=dev)
    model = Model(cfg)
    b, s, v = HYMBA_ORACLE_BATCH, HYMBA_ORACLE_PROMPT, cfg.vocab_size
    cap = s + HYMBA_ORACLE_NEW
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, v, (b, s)), device=dev)
    reset_launch_counts()
    lk, ck = model.prefill(params, toks, seq_capacity=cap)
    assert launch_counts() == dict(flash_prefill=cfg.num_layers * b,
                                   paged_attention=0,
                                   ssd_scan=cfg.num_layers), launch_counts()
    errs, medians = {}, {}

    def check(what, got, want):
        d = (got.float() - want.float()).abs()
        scale = want.float().abs().max().clamp_min(1e-30)
        errs[what] = max(errs.get(what, 0.0), (d.max() / scale).item())
        medians[what] = max(medians.get(what, 0.0),
                            (d.median() / scale).item())

    full, _ = model.forward(params, toks)
    check("(i) last logits vs forward", lk[:, :v], full[:, -1, :v])
    del full

    reset_launch_counts()
    cr = model.init_cache(b, cap, device=dev)
    t1 = time.monotonic()
    for t in range(s):
        lr, cr = model.decode_step(params, toks[:, t:t + 1],
                                   torch.full((b,), t, device=dev), cr)
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t1) / s
    assert launch_counts() == dict(flash_prefill=0, paged_attention=0,
                                   ssd_scan=0), "the recurrence launched"
    check("(ii) last logits vs recurrence", lk[:, :v], lr[:, :v])
    for seg, a, r in zip(model.plan, ck, cr):
        (ka, sa), (kr, sr) = a, r
        assert torch.equal(ka.pos, kr.pos), f"ring positions differ: {seg}"
        check("(ii) ring K", ka.k, kr.k)
        check("(ii) ring V", ka.v, kr.v)
        check("(ii) SSM state", sa.state, sr.state)
        check("(ii) conv tail", sa.conv, sr.conv)

    nxt = torch.as_tensor(rng.integers(0, v, (b, 1)), device=dev)
    ext = torch.cat([toks, nxt, torch.zeros_like(toks[:, 1:])], 1)
    full2, _ = model.forward(params, ext)
    got, _ = model.decode_step(params, nxt, torch.full((b,), s, device=dev),
                               ck)
    check("(iii) decode at S vs forward", got[:, :v], full2[:, s, :v])
    del full2, ext
    log(f"hymba oracle: {b} x {s} tokens float32 (a decode step "
        f"{step_s * 1e3:.1f} ms); worst / median difference over the "
        f"largest magnitude: " + ", ".join(
            f"{k} {errs[k]:.3g} / {medians[k]:.3g}" for k in errs))
    bad = {k: e for k, e in errs.items() if not e <= 1e-2}
    assert not bad, f"hymba oracle beyond 1e-2: {bad}"

    compared = near_ties = 0
    min_gap = math.inf
    live = [True] * b
    pos = torch.full((b,), s, device=dev)
    for i in range(HYMBA_ORACLE_NEW):
        for r in range(b):
            if not live[r]:
                continue
            equal, tie, gap = greedy_compare(lk[r], lr[r], v,
                                             f"hymba row {r} token {i}")
            compared += 1
            min_gap = min(min_gap, gap)
            if tie:
                near_ties += 1
                live[r] = False
                log(f"hymba oracle: near-tie at token {i} of row {r}; "
                    "stop there")
        tk = lk[:, :v].argmax(-1)
        tr = lr[:, :v].argmax(-1)
        lk, ck = model.decode_step(params, tk[:, None], pos + i, ck)
        lr, cr = model.decode_step(params, tr[:, None], pos + i, cr)
    total = b * HYMBA_ORACLE_NEW
    assert compared >= total // 2, f"only {compared}/{total} compared"
    log(f"hymba oracle: {compared}/{total} greedy tokens equal from the "
        f"two paths' caches, {near_ties} near-tie stops, smallest top-2 "
        f"gap {min_gap:.3g} of the largest |logit|")
    del params, ck, cr
    torch.cuda.empty_cache()
    return dict(batch=b, prompt=s, capacity=cap, rel_err=errs,
                rel_median=medians, decode_step_ms=step_s * 1e3,
                compared=compared, total=total, near_tie_stops=near_ties,
                min_gap_rel=min_gap, seconds=time.monotonic() - t0)


def mla_ring_check(dev, seed: int):
    """deepseek-v2-236b at full width and ORACLE_LAYERS layers in float32
    (the MLA oracle's configuration, capacity factor MLA_ORACLE_FACTOR: no
    token dropped): ``Model.prefill`` of 2 prompts, then MLA_RING_NEW
    greedy ``decode_step``s through the latent ring (``mla_decode``:
    absorbed, bf16 operands, float32 sums), each token held against the
    argmax of ``Model.forward`` over prompt + generated tokens. The ring
    decode attends over the latent where Model.forward decompresses it,
    so the two round differently (ROADMAP §3), and a MoE router's choice
    near a tie can flip. A token may differ only (a) where Model.forward's
    top-2 logits lie within NEAR_TIE of the largest |logit| and the decode
    chose the runner-up, or (b) where the decode itself routed a generated
    position up to that token's to other experts than Model.forward does
    (its router logits are recorded during the decode) at a router
    near-tie: Model.forward's k-th and (k+1)-th router logits there within
    NEAR_TIE of the largest |router logit|; the prefill's routing of the
    prompt (both rows in one batch) counts as the decode's. Model.forward
    runs over the decode's own tokens, so every position has the same
    prefix on both sides and all 2 x MLA_RING_NEW tokens are compared: a
    mismatch does not end a row. The MLA path launches no kernel."""
    import repro_torch.models.transformer as tr
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.attention import MLACache

    t0 = time.monotonic()
    cfg = dataclasses.replace(
        get_config(MLA_ARCH), num_layers=ORACLE_LAYERS, dtype="float32",
        logits_fp32=True, capacity_factor=MLA_ORACLE_FACTOR)
    params = init_params(cfg, seed=seed, device=dev)
    model = tr.Model(cfg)
    b, s, v, k = 2, MLA_RING_PROMPT, cfg.vocab_size, cfg.moe_top_k
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, v, (b, s)), device=dev)
    # router logits of each MoE layer call: the prefill's (B * S, E), then
    # each decode step's (B, E)
    routers = []
    moe_forward = tr.moe_forward

    def recording_moe(c, pm, h, **kw):
        routers.append(h.reshape(-1, h.shape[-1]).float() @ pm["router"]["w"])
        return moe_forward(c, pm, h, **kw)

    reset_launch_counts()
    out = []
    tr.moe_forward = recording_moe
    try:
        logits, caches = model.prefill(params, toks,
                                       seq_capacity=s + MLA_RING_NEW)
        for i in range(MLA_RING_NEW):
            tok = logits[:, :v].argmax(-1)
            out.append(tok)
            logits, caches = model.decode_step(
                params, tok[:, None], torch.full((b,), s + i, device=dev),
                caches)
    finally:
        tr.moe_forward = moe_forward
    assert launch_counts() == dict(flash_prefill=0, paged_attention=0,
                                   ssd_scan=0), launch_counts()
    assert all(isinstance(c, MLACache) for c in caches)
    n_moe = sum(seg.n for seg in model.plan if seg.mlp_kind == "moe")
    assert len(routers) == n_moe * (1 + MLA_RING_NEW)
    gen = torch.stack(out, 1)
    compared = near_ties = flipped = 0
    min_gap = math.inf
    for r in range(b):
        full = torch.cat([toks[r], gen[r, :-1]])[None]
        lf, rf = oracle_forward(model, params, full)
        lf = lf[0, s - 1:, :v].float()
        for i in range(MLA_RING_NEW):
            tok = int(gen[r, i])
            top2 = torch.topk(lf[i], 2)
            gap = float(top2.values[0] - top2.values[1])
            top = float(lf[i].abs().max())
            min_gap = min(min_gap, gap / top)
            compared += 1
            if tok == int(top2.indices[0]):
                continue
            if tok == int(top2.indices[1]) and gap < NEAR_TIE * top:
                near_ties += 1
                log(f"MLA ring: near-tie at token {i} of row {r}")
                continue
            # the positions routed before token i: the prompt's by the
            # prefill, s .. s + i - 1 by decode steps 0 .. i - 1 (step j
            # feeds token j at position s + j)
            near = []
            for layer in range(n_moe):
                zd = torch.cat([routers[layer][r * s:(r + 1) * s]] + [
                    routers[(1 + j) * n_moe + layer][r:r + 1]
                    for j in range(i)])
                zf = rf[layer][:s + i]
                diff = (routed(zd, k) != routed(zf, k)).any(-1)
                for pos in diff.nonzero().flatten().tolist():
                    zs = torch.sort(zf[pos], descending=True).values
                    rgap = float(zs[k - 1] - zs[k]) / float(
                        zf[pos].abs().max())
                    if rgap < NEAR_TIE:
                        near.append((layer, pos, round(rgap, 6)))
            assert near, \
                f"MLA ring: token {i} of row {r}: decode {tok}, forward " \
                f"{int(top2.indices[0])}, top-2 gap {gap / top:.3g} of the " \
                f"largest |logit|, and no routing flip at a router near-tie"
            flipped += 1
            log(f"MLA ring: routing flip before token {i} of row {r}: the "
                f"decode routes (MoE layer, position, Model.forward's router "
                f"gap) {near} otherwise and chooses {tok} (Model.forward "
                f"{int(top2.indices[0])}, top-2 gap {gap / top:.3g})")
    total = b * MLA_RING_NEW
    assert compared == total
    log(f"MLA ring: {total - near_ties - flipped}/{total} float32 "
        f"tokens equal to Model.forward's, {near_ties} at a near-tie, "
        f"{flipped} after a routing flip at a router near-tie, "
        f"smallest top-2 gap {min_gap:.3g} of the largest |logit|")
    del params, caches
    torch.cuda.empty_cache()
    return dict(arch=cfg.arch_id, layers=cfg.num_layers, prompt=s,
                total=total, near_ties=near_ties, routing_flips=flipped,
                min_gap_rel=min_gap, seconds=time.monotonic() - t0)


# -- the encoder-decoder and media families: seamless-m4t and internvl2 ------

def media_inputs(cfg, dev, seed: int, b: int, s: int, enc_len: int = 0):
    """(tokens (b, s), media (b, M, D) normal x 0.02 in the model type
    from a seeded ``torch.Generator``, encoder tokens (b, enc_len) or
    None)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           device=dev)
    media = (torch.randn((b, cfg.num_media_tokens, cfg.d_model),
                         generator=gen, device=dev) * 0.02) \
        .to(cfg.torch_dtype)
    enc = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, enc_len)),
                          device=dev) if enc_len else None
    return toks, media, enc


def media_kw(media, enc):
    kw = dict(media=media)
    if enc is not None:
        kw["encoder_tokens"] = enc
    return kw


def ring_run(label: str, cfg, params, dev, toks, kw, new: int, want):
    """``Model.prefill`` of ``toks`` (with media / encoder tokens ``kw``)
    and ``new`` greedy ``decode_step``s, bf16 or float32. The launch counts
    are read around the prefill alone and must equal ``want``; the decode
    launches none. Every logit, and every cache leaf after the prefill and
    after the decode, must be finite. Returns (the greedy tokens (b, new +
    1): the prefill's and each step's, stats, the last caches)."""
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.transformer import Model
    model = Model(cfg)
    b, s = toks.shape
    cap = s + new
    # warm-up at the timed shapes: the first calls load kernels and pick
    # GEMM algorithms
    _, warm = model.prefill(params, toks, seq_capacity=cap, **kw)
    model.decode_step(params, toks[:, :1], toks[:, 0], warm)
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()  # read around this prefill alone
    t0 = time.monotonic()
    logits, caches = model.prefill(params, toks, seq_capacity=cap, **kw)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    launches = launch_counts()
    assert launches == want, f"{label}: prefill launches {launches}, " \
        f"want {want}"
    assert logits.shape == (b, pad_vocab(cfg.vocab_size))
    assert all(torch.isfinite(t.float()).all() for t in _leaves(caches)
               if t.is_floating_point())
    tok = logits[:, :cfg.vocab_size].argmax(-1)
    pos = torch.full((b,), s, device=dev)
    generated = [tok]
    finite = torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    t0 = time.monotonic()
    for i in range(new):
        logits, caches = model.decode_step(params, tok[:, None], pos + i,
                                           caches)
        finite &= torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t0
    assert launch_counts() == want, f"{label}: the ring decode launched"
    assert bool(finite), f"{label}: a logit was not finite"
    assert all(torch.isfinite(t.float()).all() for t in _leaves(caches)
               if t.is_floating_point())
    gen = torch.stack(generated, 1)
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()
    return gen, dict(batch=b, prompt=s, capacity=cap,
                     prefill_ms=prefill_s * 1e3,
                     prefill_tokens_per_s=b * s / prefill_s,
                     decode_steps=new, decode_ms=decode_s * 1e3,
                     decode_tokens_per_s=b * new / decode_s,
                     launches=launches), caches


def ring_oracle(label: str, cfg, params, prompts, kw, generated):
    """Each row's greedy tokens from ``Model.prefill`` + ``decode_step``
    (the kernel prefill, the plain decode) against the argmax of
    ``Model.forward`` (plain attention) over prompt + generated tokens,
    teacher-forced with the same media / encoder tokens, by the oracle
    phase's rule: a mismatch is allowed only where the forward's top-2
    logits are closer than NEAR_TIE of its largest |logit| and the ring
    chose the runner-up; comparing that row stops there."""
    from repro_torch.models.transformer import Model
    b, plen = prompts.shape
    full = torch.cat([prompts, generated[:, :-1]], 1)
    logits, _ = Model(cfg).forward(params, full, **kw)
    lg = logits[:, plen - 1:, :cfg.vocab_size].float()
    del logits
    compared = near_ties = 0
    min_gap = math.inf
    for r in range(b):
        for i in range(generated.shape[1]):
            top2 = torch.topk(lg[r, i], 2)
            tok, want = int(generated[r, i]), int(top2.indices[0])
            gap = float(top2.values[0] - top2.values[1])
            top = float(lg[r, i].abs().max())
            min_gap = min(min_gap, gap / top)
            compared += 1
            if tok == want:
                continue
            assert tok == int(top2.indices[1]) and gap < NEAR_TIE * top, \
                f"{label}: row {r} token {i}: ring {tok}, forward {want}, " \
                f"top-2 gap {gap} >= {NEAR_TIE * top}"
            near_ties += 1
            log(f"{label}: near-tie at token {i} of row {r}; stop there")
            break
    total = generated.numel()
    assert compared >= total // 2, f"only {compared}/{total} compared"
    log(f"{label}: {compared}/{total} float32 greedy tokens of the ring "
        f"equal Model.forward's argmax, {near_ties} near-tie stops, "
        f"smallest top-2 gap {min_gap:.3g} of the largest |logit|")
    return dict(compared=compared, total=total, near_tie_stops=near_ties,
                min_gap_rel=min_gap)


def seamless_phase(dev, seed: int):
    """Full-width seamless-m4t-medium (12 encoder and 12 decoder layers,
    d 1024, 16 heads, vocab 256206; random weights from a seed, bf16):
    MEDIA_BATCH requests of ENC_LEN encoder positions, the first 512 audio
    frame embeddings, and a SEAMLESS_PROMPT-token decoder prompt, through
    ``Model.prefill`` (``flash_prefill`` once per sequence in each encoder
    layer and twice in each decoder layer: self and cross; no other
    kernel) and SEAMLESS_NEW greedy tokens (no kernel in the decode). Then
    the float32 oracle at full width on the same inputs."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config

    cfg = get_config(SEAMLESS_ARCH)  # full width and depth, no cut
    t_phase = t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"seamless phase: {cfg.arch_id} {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d{cfg.d_model} {cfg.num_heads} "
        f"heads, {n_params / 1e9:.3f} B params {cfg.dtype} on the card in "
        f"{time.monotonic() - t0:.1f}s")
    b = MEDIA_BATCH
    toks, media, enc = media_inputs(cfg, dev, seed, b, SEAMLESS_PROMPT,
                                    ENC_LEN)
    kw = media_kw(media, enc)
    want = dict(flash_prefill=(cfg.encoder_layers + 2 * cfg.num_layers) * b,
                paged_attention=0, ssd_scan=0)
    gen, run, _ = ring_run("seamless phase", cfg, params, dev, toks, kw,
                        SEAMLESS_NEW, want)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"seamless phase: prefill of {b} x ({ENC_LEN} encoder positions, "
        f"{cfg.num_media_tokens} of them audio frames, + {SEAMLESS_PROMPT} "
        f"decoder tokens) in {run['prefill_ms']:.1f} ms; launches "
        f"{run['launches']} = ({cfg.encoder_layers} + 2 x {cfg.num_layers})"
        f" x {b}; {run['decode_steps']} greedy decode steps in "
        f"{run['decode_ms']:.1f} ms ({run['decode_tokens_per_s']:.1f} "
        f"tokens/s); max_memory_allocated {peak_gib:.2f} GiB")
    del params
    torch.cuda.empty_cache()

    # the float32 oracle, whole: the kernel prefill and the ring decode
    # against Model.forward, on the same inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.monotonic()
    f32 = dataclasses.replace(cfg, dtype="float32", logits_fp32=True)
    params = init_params(f32, seed=seed, device=dev)
    kw = media_kw(media.float(), enc)
    gen32, _, _ = ring_run("seamless oracle", f32, params, dev, toks, kw,
                        SEAMLESS_ORACLE_NEW, want)
    oracle = ring_oracle("seamless oracle", f32, params, toks, kw, gen32)
    oracle["seconds"] = time.monotonic() - t1
    del params
    torch.cuda.empty_cache()
    return dict(**phase_end("seamless phase", t_phase), params=n_params,
                encoder_positions=ENC_LEN, media=cfg.num_media_tokens,
                measure_peak_gib=peak_gib, oracle=oracle, **run)


def internvl_phase(dev, seed: int):
    """Full-width internvl2-26b (48 layers, d 6144, 48 heads over 8 KV
    heads (G 6), Dh 128, vocab 92553; random weights from a seed, bf16, ~
    38.6 GB): ``Model.prefill`` of MEDIA_BATCH prompts of INTERNVL_PROMPT
    positions, the first 256 patch embeddings (``flash_prefill`` once per
    layer and sequence), INTERNVL_NEW greedy ``decode_step``s; then the
    same weights serve SHORT_PROMPTS text-only on the paged engine through
    LLMService (``paged_attention`` at G 6 on a model's path). Then the
    float32 oracles at ORACLE_LAYERS: the ring with media against
    ``Model.forward``, and the engine (``oracle_model``)."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config

    cfg = get_config(INTERNVL_ARCH)  # full width and depth, no cut
    t_phase = t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"internvl2 phase: {cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, Dh "
        f"{cfg.head_dim}, {n_params / 1e9:.3f} B params {cfg.dtype} on the "
        f"card in {time.monotonic() - t0:.1f}s")
    b = MEDIA_BATCH
    toks, media, _ = media_inputs(cfg, dev, seed, b, INTERNVL_PROMPT)
    want = dict(flash_prefill=cfg.num_layers * b, paged_attention=0,
                ssd_scan=0)
    _, run, _ = ring_run("internvl2 phase", cfg, params, dev, toks,
                      media_kw(media, None), INTERNVL_NEW, want)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"internvl2 phase: prefill of {b} x {INTERNVL_PROMPT} positions "
        f"({cfg.num_media_tokens} of them patches) in "
        f"{run['prefill_ms']:.1f} ms ({run['prefill_tokens_per_s']:.0f} "
        f"tokens/s); launches {run['launches']}; {run['decode_steps']} "
        f"greedy decode steps in {run['decode_ms']:.1f} ms "
        f"({run['decode_tokens_per_s']:.1f} tokens/s); "
        f"max_memory_allocated {peak_gib:.2f} GiB")
    del toks, media
    serve = serve_model("internvl2 serve phase", cfg, dev, seed,
                        short_requests(cfg.vocab_size, seed), SHORT_ENGINE,
                        params=params)
    del params
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.monotonic()
    f32 = dataclasses.replace(cfg, dtype="float32", logits_fp32=True,
                              num_layers=ORACLE_LAYERS)
    params = init_params(f32, seed=seed + 1, device=dev)
    toks, media, _ = media_inputs(f32, dev, seed + 1, 2,
                                  INTERNVL_ORACLE_PROMPT)
    kw = media_kw(media, None)
    gen32, _, _ = ring_run("internvl2 oracle", f32, params, dev, toks, kw,
                        INTERNVL_ORACLE_NEW,
                        dict(flash_prefill=ORACLE_LAYERS * 2,
                             paged_attention=0, ssd_scan=0))
    ring = ring_oracle("internvl2 oracle", f32, params, toks, kw, gen32)
    ring["seconds"] = time.monotonic() - t1
    del params, toks, media, kw
    torch.cuda.empty_cache()
    engine = oracle_model("internvl2 engine oracle", dataclasses.replace(
        cfg, num_layers=ORACLE_LAYERS), dev, seed + 2)
    return dict(**phase_end("internvl2 phase", t_phase), params=n_params,
                media=cfg.num_media_tokens, measure_peak_gib=peak_gib,
                serve=serve, oracle=dict(ring=ring, engine=engine), **run)


# -- training: Model.loss, AdamW, the corpus, checkpoints, the launcher -------

TRAIN_STEPS = 10
TRAIN_LOW_LR = 3e-4  # a second full-width run beside the launcher's 1e-3
TRAIN_FAMILIES = ("h2o-danube-1.8b", "llama4-scout-17b-a16e",
                  "deepseek-v2-236b", "mamba2-1.3b", "hymba-1.5b",
                  SEAMLESS_ARCH, INTERNVL_ARCH)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ENC = 2, 64, 40
# a CUDA train step against the CPU one from the same float32 weights, as
# tests/test_torch_train_grads.py holds the loss (2e-5) and
# tests/test_torch_training.py a float32 step (grad_norm 1e-3; parameters
# within 2 lr (1 + wd |p|) everywhere, beyond 0.1 lr on at most 1%)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_FAR_FRAC = 2e-5, 1e-3, 0.01
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def train_batch(cfg, seed: int):
    """Tokens and labels (TRAIN_BATCH, TRAIN_SEQ), the first labels of row
    0 masked; media normal x 0.02 and encoder tokens where the config
    takes them: numpy from a seed, as the CPU tests make them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    labels = toks.copy()
    labels[0, :5] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.num_media_tokens:
        batch["media"] = (rng.standard_normal(
            (TRAIN_BATCH, cfg.num_media_tokens, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    if cfg.is_encdec:
        batch["encoder_tokens"] = rng.integers(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_ENC)).astype(np.int32)
    return batch


def train_step_pair(arch: str, dev, seed: int) -> dict:
    """One ``make_train_step`` of ``arch`` at smoke width in float32 on the
    card and one on the CPU, from the same weights (drawn on the CPU and
    copied over: the two generators differ) and the same batch. Loss,
    grad_norm, lr and every updated parameter compared; no kernel may
    launch."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer
    from repro_torch.training.train_loop import batch_to, make_train_step
    from repro_torch.training.tree import leaves, tree_map

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              logits_fp32=True)
    cpu = init_params(cfg, seed=seed, device="cpu")
    gpu = tree_map(lambda t: t.to(dev, copy=True), cpu)  # steps in place
    batch = train_batch(cfg, seed)
    ocfg = optimizer.OptConfig(**TRAIN_OPT)
    step = make_train_step(Model(cfg), ocfg)
    reset_launch_counts()
    gpu, _, gm = step(gpu, optimizer.init(gpu), batch_to(batch, dev))
    torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"train phase: {arch}'s train step launched "
                             f"kernels {launches}")
    cpu, _, cm = step(cpu, optimizer.init(cpu), batch_to(batch, "cpu"))
    got = {k: float(v) for k, v in gm.items()}
    want = {k: float(v) for k, v in cm.items()}
    for k, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm",
                                                TRAIN_GNORM_RTOL),
                    ("lr", 1e-6)):
        if not math.isfinite(got[k]) or \
                abs(got[k] - want[k]) > rtol * abs(want[k]):
            raise AssertionError(f"train phase: {arch} {k} {got[k]!r} on "
                                 f"the card, {want[k]!r} on the CPU")
    lr, far, total, worst = want["lr"], 0, 0, 0.0
    for g, c in zip(leaves(gpu), leaves(cpu)):
        d = (g.cpu() - c).abs()
        bound = 2 * lr * (1 + ocfg.weight_decay * c.abs()) * (1 + 2e-4) \
            + 1e-7
        worst = max(worst, float((d / bound).max()))
        far += int((d > 0.1 * lr).sum())
        total += d.numel()
    if worst > 1 or far > TRAIN_FAR_FRAC * total:
        raise AssertionError(f"train phase: {arch}'s parameters after a "
                             f"step: worst {worst:.3f} of the bound, "
                             f"{far} of {total} beyond 0.1 lr")
    return dict(loss=got["loss"], loss_cpu=want["loss"],
                grad_norm=got["grad_norm"], grad_norm_cpu=want["grad_norm"],
                lr=got["lr"], params=total, beyond_tenth_lr=far,
                worst_of_bound=worst, launches=launches)


def checkpoint_round_trip(dev, seed: int) -> dict:
    """A smoke-width {"params", "opt"} after one train step on the card,
    saved and restored in a temporary directory under build/ that is
    removed after: every leaf equal bit for bit, on its device."""
    import tempfile

    from repro_torch.bridge import init_params
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model
    from repro_torch.training import checkpoint, optimizer
    from repro_torch.training.train_loop import batch_to, make_train_step
    from repro_torch.training.tree import leaves

    cfg = smoke_config("h2o-danube-1.8b")
    params = init_params(cfg, seed=seed, device=dev)
    step = make_train_step(Model(cfg), optimizer.OptConfig(**TRAIN_OPT))
    params, state, _ = step(params, optimizer.init(params),
                            batch_to(train_batch(cfg, seed), dev))
    tree = {"params": params, "opt": state}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        checkpoint.save(d, 1, tree)
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*"))
        if checkpoint.latest_step(d) != 1:
            raise AssertionError("train phase: checkpoint step not found")
        back = checkpoint.restore(d, 1, tree)
    n = 0
    for got, want in zip(leaves(back), leaves(tree)):
        if got.dtype != want.dtype or got.device != want.device or \
                got.shape != want.shape:
            raise AssertionError(f"train phase: restored leaf {n} is "
                                 f"{got.dtype} {tuple(got.shape)} on "
                                 f"{got.device}")
        same = torch.equal(got.view(torch.int16), want.view(torch.int16)) \
            if got.dtype == torch.bfloat16 else torch.equal(got, want)
        if not same:
            raise AssertionError(f"train phase: restored leaf {n} differs")
        n += 1
    return dict(leaves=n, bytes=nbytes)


def train_phase(dev, seed: int) -> dict:
    """Training on the port: full-width h2o-danube-1.8b (24 layers, d 2560,
    1.75 B parameters, bf16, random weights from seed 0) through the train
    launcher at its defaults (8 x 256 tokens a step, each layer recomputed
    in the backward) for TRAIN_STEPS steps: finite losses that fall;
    then one train step per plan family at smoke width in float32 on the
    card against the CPU; then a checkpoint round trip. No kernel may
    launch anywhere in the phase: training runs plain attention and
    ``ssd_chunked`` (the kernels have no backward)."""
    from repro_torch.launch import train as train_launcher

    def plain(flags):  # the launcher's loop without a mesh
        return train_launcher.run(train_launcher.build_parser().parse_args(
            flags), dev=dev)

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    reset_launch_counts()
    full = plain(["--steps", str(TRAIN_STEPS)])
    launches = launch_counts()
    losses = full["losses"]
    log("train phase: " + ", ".join(
        f"step {i} loss {x:.4f}" for i, x in enumerate(losses)))
    if any(launches.values()):
        raise AssertionError(f"train phase: the launcher launched kernels "
                             f"{launches}")
    if not all(math.isfinite(x) for x in losses + full["grad_norms"]) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train phase: losses {losses}")
    log(f"train phase: {full['arch']} whole, {TRAIN_STEPS} steps of "
        f"{full['tokens_per_step']} tokens, step "
        f"{full['step_median_s'] * 1e3:.1f} ms (median of steps 2-"
        f"{TRAIN_STEPS - 1}), "
        f"{full['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
        f"{full['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    gc.collect()
    torch.cuda.empty_cache()
    # the same run at a lower peak learning rate: whether the launcher's
    # 1e-3 (the reference's default, chosen at smoke width) is what makes
    # a fresh full-width model's loss jump in the first steps
    low = plain(["--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LOW_LR)])
    if not all(math.isfinite(x) for x in low["losses"]) or \
            any(launch_counts().values()):
        raise AssertionError(f"train phase: lr {TRAIN_LOW_LR} losses "
                             f"{low['losses']}, launches {launch_counts()}")
    log(f"train phase: lr {TRAIN_LOW_LR}: " + ", ".join(
        f"step {i} loss {x:.4f}" for i, x in enumerate(low["losses"])))
    gc.collect()
    torch.cuda.empty_cache()
    families = {}
    for i, arch in enumerate(TRAIN_FAMILIES):
        families[arch] = r = train_step_pair(arch, dev, seed + i)
        log(f"train phase: {arch} smoke float32 step, loss {r['loss']:.6f} "
            f"(CPU {r['loss_cpu']:.6f}), grad_norm {r['grad_norm']:.6f} "
            f"(CPU {r['grad_norm_cpu']:.6f}), parameters worst "
            f"{r['worst_of_bound']:.3f} of the bound, "
            f"{r['beyond_tenth_lr']} of {r['params']} beyond 0.1 lr")
    ckpt = checkpoint_round_trip(dev, seed)
    log(f"train phase: checkpoint round trip of {ckpt['leaves']} leaves "
        f"({ckpt['bytes']} bytes) bit for bit")
    return dict(**phase_end("train phase", t_phase), full=full,
                low_lr=low, families=families, checkpoint=ckpt)


# -- the mesh: sharding, DistAttention, the dry-run ---------------------------

MESH_LOSS_RTOL = 1e-4  # step 0 against the plain run (one rank: no sum
# is split, so only DTensor's own op choices differ)
DIST_SHAPE = dict(b=4, s=32768, h=32, hkv=8, dh=128)
DIST_TOL = 1e-4  # bf16 q, K, V; float32 partials against the float32
# oracle on the same values: they differ only in the order of the sums
DRYRUN = (("h2o-danube-1.8b", "train_4k"),
          ("llama4-scout-17b-a16e", "train_4k"),
          ("h2o-danube-1.8b", "decode_32k"))
DRYRUN_CAP = 2  # count 2 and 4 layers a segment, extrapolate, as the
# reference does


def mesh_phase(dev, seed: int, plain: dict) -> dict:
    """The train launcher SPMD on a one-rank NCCL mesh against the train
    phase's plain run ``plain``; ``dist_attention`` on that mesh at a long
    decode; the dry-run's three records. No kernel may launch. On success
    the one-rank NCCL group stays: ``examples_phase`` must run next, and it
    destroys the group."""
    import torch.distributed as dist
    from repro_torch.core.distkv.dist_attention import (dist_attention,
                                                        dist_attention_ref)
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    run = train_launcher.main(["--steps", str(TRAIN_STEPS)])
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"mesh phase: the launcher launched kernels "
                             f"{launches}")
    losses, want = run["losses"], plain["losses"]
    log("mesh phase: " + ", ".join(
        f"step {i} loss {x:.4f} (plain {y:.4f})"
        for i, (x, y) in enumerate(zip(losses, want))))
    if not all(math.isfinite(x) for x in losses + run["grad_norms"]):
        raise AssertionError(f"mesh phase: losses {losses}")
    for k in ("losses", "grad_norms"):
        got, ref = run[k][0], plain[k][0]
        if abs(got - ref) > MESH_LOSS_RTOL * abs(ref):
            raise AssertionError(f"mesh phase: step 0 {k} {got!r} on the "
                                 f"mesh, {ref!r} without")
    dispatch = run["step_median_s"] - plain["step_median_s"]
    log(f"mesh phase: {run['arch']} whole on mesh {run['mesh']}, step "
        f"{run['step_median_s'] * 1e3:.1f} ms (plain "
        f"{plain['step_median_s'] * 1e3:.1f} ms: DTensor dispatch "
        f"{dispatch * 1e3:.1f} ms a step), {run['tokens_per_s']:.0f} "
        f"tokens/s, max_memory_allocated {run['peak_gib']:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    # DistAttention on the one-rank mesh, a long decode
    init_distributed(dev)
    try:
        mesh = make_host_mesh(1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        sh = DIST_SHAPE
        q = torch.randn(sh["b"], sh["h"], sh["dh"], generator=gen,
                        device=dev).to(torch.bfloat16)
        k = torch.randn(sh["b"], sh["s"], sh["hkv"], sh["dh"], generator=gen,
                        device=dev).to(torch.bfloat16)
        v = torch.randn(sh["b"], sh["s"], sh["hkv"], sh["dh"], generator=gen,
                        device=dev).to(torch.bfloat16)
        lens = torch.tensor([sh["s"], 17, sh["s"] // 2 + 3, sh["s"] - 1],
                            dtype=torch.int32, device=dev)
        want_o = dist_attention_ref(q, k, v, lens)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got_o = dist_attention(mesh, q, k, v, lens).to_local()
        torch.cuda.synchronize()
        da_ms = (time.monotonic() - t0) * 1e3
        err = float((got_o - want_o).abs().max())
        if not math.isfinite(err) or err > DIST_TOL:
            raise AssertionError(f"mesh phase: dist_attention max error "
                                 f"{err} > {DIST_TOL}")
        kv_gb = 2 * k.numel() * k.element_size() / 1e9
        log(f"mesh phase: dist_attention B {sh['b']} S {sh['s']} H "
            f"{sh['h']}/{sh['hkv']} Dh {sh['dh']} bf16 ({kv_gb:.2f} GB of "
            f"K/V) on the one-rank mesh: max error {err:.2e} against "
            f"dist_attention_ref, {da_ms:.1f} ms (one call, host clock)")
    except BaseException:
        dist.destroy_process_group()
        raise
    del q, k, v, want_o, got_o
    gc.collect()
    torch.cuda.empty_cache()
    if any(launch_counts().values()):
        raise AssertionError(f"mesh phase: kernels launched "
                             f"{launch_counts()}")

    # the dry-run: one child process a record, on the CPU, each rank 0 of
    # a fake group of 256 ranks, all three at once
    out_dir = Path(__file__).resolve().parent / "build" / "torch_dryrun"
    src = str(Path(__file__).resolve().parent / "src")
    t0 = time.monotonic()
    children = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--cap", str(DRYRUN_CAP), "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES=""))
        for arch, shape in DRYRUN]
    for child in children:
        stdout, stderr = child.communicate(timeout=600)
        if child.returncode != 0:
            raise AssertionError(f"mesh phase: the dry-run failed\n"
                                 f"{stdout[-2000:]}{stderr[-3000:]}")
    dry_s = time.monotonic() - t0
    records = {}
    for arch, shape in DRYRUN:
        rec = json.loads((out_dir / f"{arch}_{shape}_16x16.json")
                         .read_text())
        roof = rec.get("roofline") or {}
        need = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collective_breakdown",
                "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck")
        if rec.get("status") != "ok" or any(k not in roof for k in need) \
                or not roof["flops_per_device"] > 0:
            raise AssertionError(f"mesh phase: dry-run record {arch} "
                                 f"{shape} incomplete: {rec}")
        records[f"{arch} {shape}"] = rec
        coll = {k: v for k, v in roof["collective_breakdown"].items() if v}
        log(f"mesh phase: dry-run {arch} {shape} on 16x16 (H100 data-sheet "
            f"terms, counted in {rec['count_s']:.1f} s at "
            f"{rec['layers_counted']} layers): per rank "
            f"{roof['flops_per_device']:.4g} FLOPs, "
            f"{roof['bytes_per_device']:.4g} bytes, collectives "
            f"{roof['collective_bytes_per_device']:.4g} bytes {coll}; "
            f"t_compute {roof['t_compute_s']:.4g} s, t_memory "
            f"{roof['t_memory_s']:.4g} s, t_collective "
            f"{roof['t_collective_s']:.4g} s -> {roof['bottleneck']}; "
            f"useful_flop_frac {rec['useful_flop_frac']:.3f}; "
            f"{rec['hbm_per_device_gib']:.2f} GiB a rank "
            f"(fits 80 GB: {rec['fits_80gb']})")
    log(f"mesh phase: dry-run children {dry_s:.1f} s")
    return dict(**phase_end("mesh phase", t_phase), train=run,
                dispatch_s=dispatch, dist_attention=dict(
                    max_err=err, ms=da_ms, **DIST_SHAPE),
                dryrun=records, dryrun_s=dry_s)


# -- the examples: examples/torch_*.py on the card ----------------------------

EXAMPLES = ("torch_chain_nsga2", "torch_distributed_kv_cluster",
            "torch_quickstart", "torch_serve_continuous_batching",
            "torch_serve_shared_prefix")
# the examples that serve on the paged engine: both attention kernels must
# launch in each
ENGINE_EXAMPLES = ("torch_quickstart", "torch_serve_continuous_batching",
                   "torch_serve_shared_prefix")
EXAMPLE_DIST_TOL = 1e-5  # float32 DistAttention against its oracle


def examples_phase(dev) -> dict:
    """The five examples' ``main(device="cuda")`` in this process, each at
    the reference's sizes and traffic with its own assertions: wall seconds
    and each kernel's launches, counted from 0 around each. The three that
    serve must launch ``paged_attention`` and ``flash_prefill``; the
    DistAttention demo runs on the mesh phase's one-rank NCCL group (kept
    by ``init_distributed``), within EXAMPLE_DIST_TOL of its oracle. The
    group is destroyed at the end."""
    import importlib.util

    import torch.distributed as dist

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    root = Path(__file__).resolve().parent / "examples"
    runs = {}
    try:
        if not dist.is_initialized():
            raise AssertionError("examples phase: the mesh phase's process "
                                 "group is gone")
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                name, root / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            log(f"examples phase: {name}")
            reset_launch_counts()
            t0 = time.monotonic()
            out = module.main(device="cuda")
            torch.cuda.synchronize()
            runs[name] = dict(seconds=time.monotonic() - t0,
                              launches=launch_counts())
            if name == "torch_distributed_kv_cluster":
                err = out["dist_attention_err"]
                if not math.isfinite(err) or err > EXAMPLE_DIST_TOL:
                    raise AssertionError(f"examples phase: DistAttention "
                                         f"max error {err} > "
                                         f"{EXAMPLE_DIST_TOL}")
                runs[name]["dist_attention_err"] = err
            if name == "torch_serve_shared_prefix":
                runs[name]["prefix_cache_stats"] = out["stats"]
            del module, out
            gc.collect()
    finally:
        dist.destroy_process_group()
    for name in ENGINE_EXAMPLES:
        n = runs[name]["launches"]
        if not (n["paged_attention"] > 0 and n["flash_prefill"] > 0):
            raise AssertionError(f"examples phase: {name} launched {n}")
    return dict(phase_end("examples phase", t_phase), runs=runs)


def attention_row(label: str, dev, gen, b: int, s: int, skv: int, widths,
                  *, causal=True, window=None):
    """``prefill_attention`` as ``Model.prefill`` dispatches it (one launch
    per sequence): ``b`` x ``s`` queries over ``skv`` keys at ``widths``
    (H, Hkv, Dh), bf16, against its plain version, and timed beside it and
    SDPA on the same inputs (an explicit mask with a window, else
    ``is_causal``). Three input sets, cycled, so that no call finds its
    inputs in the 50 MB L2. Returns the row's detail dict."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   prefill_attention)
    h, hkv, dh = widths
    dtype = torch.bfloat16
    esz = torch.finfo(dtype).bits // 8
    kw = dict(causal=causal, window=window)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sets = [(rand(b, s, h, dh), rand(b, skv, hkv, dh), rand(b, skv, hkv, dh))
            for _ in range(3)]
    before = flash_prefill.launches
    q, k, v = sets[0]
    got = prefill_attention(q, k, v, **kw)
    want = ref.prefill_attention(q, k, v, **kw)
    if causal:
        torch.testing.assert_close(got.float(), want.float(), **TOL_ENGINE)
    else:
        rel_close(got, want, *NC_TOL[dtype], label)
    qpos, kpos = torch.arange(s, device=dev), torch.arange(skv, device=dev)
    mask = torch.ones((s, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    sdpa = dict(attn_mask=mask) if window is not None \
        else dict(is_causal=causal)
    lib = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
           for q, k, v in sets]
    ms, device_ms, host_us = cuda_ms(
        lambda i: prefill_attention(*sets[i % 3], **kw), 9)
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.prefill_attention(*sets[i % 3], **kw), 6, warmup=1)
    library_ms, library_device_ms, _ = cuda_ms(
        lambda i: F.scaled_dot_product_attention(*lib[i % 3],
                                                 enable_gqa=True, **sdpa), 9)
    flash_prefill.launches = before  # timing launches are not the path's
    pairs = int(mask.sum())  # of one sequence
    nbytes = 2 * b * s * h * dh * esz + 2 * b * skv * hkv * dh * esz
    flops = 4 * b * h * dh * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = dict(shape=[b, s, skv, h, hkv, dh], causal=causal, window=window,
               launches_per_call=b,
               max_abs_err=(got.float() - want.float()).abs().max().item(),
               ms=ms, device_ms=device_ms, host_us=host_us,
               plain_ms=plain_ms, plain_device_ms=plain_device_ms,
               library_ms=library_ms, library_device_ms=library_device_ms,
               valid_pairs=b * pairs, bytes=nbytes, flops=flops,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"flash_prefill at {label} {row['shape']} (B, S, Skv, H, Hkv, Dh), "
        f"causal {causal}, window {window}: back to back {ms:.4f} ms, "
        f"device {fmt_ms(device_ms)}, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms (device {fmt_ms(library_device_ms)}); bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    del sets, lib, q, k, v, got, want
    torch.cuda.empty_cache()
    return row


def contiguous_row(dev, gen, b: int, s: int, widths, window, dtype):
    """The contiguous entry (``flash_prefill``, the TPU kernel's function:
    one launch over the batch; bf16 runs the wgmma body, float32 the
    CUDA-core body) at ``b`` x ``s`` causal tokens with ``window``, in
    ``dtype``: against its plain version, then timed beside it and SDPA on
    the same inputs (an explicit mask with a window, else ``is_causal``),
    three input sets cycled. Returns the row's detail dict."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    h, hkv, dh = widths
    esz = torch.finfo(dtype).bits // 8
    kw = dict(causal=True, window=window)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sets = [(rand(b, s, h, dh), rand(b, s, hkv, dh), rand(b, s, hkv, dh))
            for _ in range(3)]
    before = flash_prefill.launches
    got = flash_prefill(*sets[0], **kw)
    want = ref.flash_prefill(*sets[0], **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    del got, want
    pos = torch.arange(s, device=dev)
    mask = pos[None] <= pos[:, None]
    if window is not None:
        mask &= pos[None] > pos[:, None] - window
    sdpa = dict(attn_mask=mask) if window is not None \
        else dict(is_causal=True)
    lib = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
           for q, k, v in sets]
    ms, device_ms, host_us = cuda_ms(
        lambda i: flash_prefill(*sets[i % 3], **kw), 9)
    flash_prefill.launches = before  # timing launches are not the path's
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.flash_prefill(*sets[i % 3], **kw), 6, warmup=1)
    library_ms, library_device_ms, _ = cuda_ms(
        lambda i: F.scaled_dot_product_attention(*lib[i % 3],
                                                 enable_gqa=True, **sdpa), 9)
    pairs = int(mask.sum())  # of one sequence
    nbytes = 2 * b * s * h * dh * esz + 2 * b * s * hkv * dh * esz
    flops = 4 * b * h * dh * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = dict(shape=[b, s, s, h, hkv, dh], dtype=str(dtype)[6:],
               window=window, launches_per_call=1, max_abs_err=err, ms=ms,
               device_ms=device_ms, host_us=host_us, plain_ms=plain_ms,
               plain_device_ms=plain_device_ms, library_ms=library_ms,
               library_device_ms=library_device_ms, valid_pairs=b * pairs,
               bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"flash_prefill contiguous entry {row['dtype']} at hymba's prefill "
        f"shape {row['shape']} (B, S, Skv, H, Hkv, Dh), window {window}: "
        f"back to back {ms:.4f} ms, device {fmt_ms(device_ms)}, plain "
        f"{plain_ms:.4f} ms (device {fmt_ms(plain_device_ms)}), SDPA "
        f"{library_ms:.4f} ms (device {fmt_ms(library_device_ms)}); bound "
        f"{bound_ms:.4f} ms ({bound_by}); max_abs_err {err:.3g}")
    del sets, lib
    torch.cuda.empty_cache()
    return row


def prefill_shape_timing(dev, seed: int):
    """``attention_row`` at this slice's shapes: seamless's encoder
    (MEDIA_BATCH x ENC_LEN, non-causal, 16 heads, Dh 64), its
    cross-attention (MEDIA_BATCH x SEAMLESS_PROMPT queries over ENC_LEN
    keys) and internvl2's prefill (MEDIA_BATCH x INTERNVL_PROMPT, causal,
    G 6, Dh 128). Returns one detail dict per shape."""
    from repro_torch.configs import get_config
    sm, iv = get_config(SEAMLESS_ARCH), get_config(INTERNVL_ARCH)
    shapes = {
        "seamless_encoder": (ENC_LEN, ENC_LEN, sm, False),
        "seamless_cross": (SEAMLESS_PROMPT, ENC_LEN, sm, False),
        "internvl2": (INTERNVL_PROMPT, INTERNVL_PROMPT, iv, True)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {name: attention_row(
        name, dev, gen, MEDIA_BATCH, s, skv,
        (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim), causal=causal)
        for name, (s, skv, cfg, causal) in shapes.items()}


def hymba_timing(dev, seed: int):
    """The two kernels of hymba's prefill at its shapes, bf16: the prefill
    attention (``attention_row``: HYMBA_BATCH x HYMBA_PROMPT tokens, G 5,
    Dh 64, with the window and without; and ``contiguous_row``: the
    contiguous entry there, bf16 and float32), and
    ``ssd_scan`` at (HYMBA_BATCH x HYMBA_PROMPT, 64 heads of 50, state 16,
    chunk 256), three input sets cycled. Returns one detail dict per
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    cfg = get_config(HYMBA_ARCH)
    b, s = HYMBA_BATCH, HYMBA_PROMPT
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    widths = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    attention = {
        "window" if window else "global": attention_row(
            "hymba's prefill shape", dev, gen, b, s, s, widths,
            window=window)
        for window in (cfg.sliding_window, None)}
    attention["contiguous"] = {
        str(dt)[6:]: {"window" if window else "global": contiguous_row(
            dev, gen, b, s, widths, window, dt)
            for window in (cfg.sliding_window, None)}
        for dt in (torch.bfloat16, torch.float32)}

    shape = (b, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
             cfg.ssm_state, cfg.ssm_chunk)
    sets = [ssd_inputs(gen, dev, dtype, *shape[:6]) for _ in range(3)]
    y, _ = ssd_scan(*sets[0], chunk=shape[6])
    yr, _ = ref.ssd_scan(*sets[0], chunk=shape[6])
    err = (y - yr).abs().max().item()
    assert err <= SSD_TOL * yr.abs().max().item()
    before = ssd_scan.launches
    ms, device_ms, host_us = cuda_ms(
        lambda i: ssd_scan(*sets[i % 3], chunk=shape[6]), 9)
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.ssd_scan(*sets[i % 3], chunk=shape[6]), 6, warmup=1)
    ssd_scan.launches = before
    nbytes, flops = ssd_bytes_flops(*shape, dtype)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    del sets, y, yr
    torch.cuda.empty_cache()
    ssd = dict(shape=list(shape[:6]), chunk=shape[6], max_abs_err=err,
               ms=ms, device_ms=device_ms, host_us=host_us,
               plain_ms=plain_ms, plain_device_ms=plain_device_ms,
               library_ms=None, bytes=nbytes, flops=flops,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"ssd_scan at hymba's prefill shape {ssd['shape']}: back to back "
        f"{ssd['ms']:.4f} ms, device {fmt_ms(ssd['device_ms'])}, plain "
        f"{ssd['plain_ms']:.4f} ms; bound {ssd['bound_ms']:.4f} ms "
        f"({ssd['bound_by']})")
    return attention, ssd


# -- timing at the serve phase's shapes -----------------------------------------

def timing_phase(dev, seed: int, launches: int,
                 arch: str = "h2o-danube-1.8b", max_layers=None):
    """paged_attention at the serve phase's decode shapes: 8 slots, each
    context at its request's prompt + half the new tokens, bf16 pools of the
    engine's geometry for all of ``arch``'s layers (at most
    ``max_layers``), at its widths, cycled so that every call reads its
    layer's K/V from device memory as a decode step does."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    cfg = get_config(arch)
    L, dtype, window = cfg.num_layers, torch.bfloat16, cfg.sliding_window
    L = min(L, max_layers or L)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens = [p + SERVE_NEW // 2 for p in SERVE_PROMPTS]
    q, kp, vp, bt, ctx = paged_inputs(gen, dev, dtype, lens, layers=L,
                                      widths=(h, hkv, dh))
    b, smax = len(lens), bt.shape[1] * PS

    out = paged_attention(q, kp[0], vp[0], bt, ctx, page_size=PS,
                          window=window)
    want = ref.paged_attention(q, kp[0], vp[0], bt, ctx, page_size=PS,
                               window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), want.float(), **TOL_BF16_OUT)
    err = (out.float() - want.float()).abs().max().item()

    # the library yardstick: SDPA over K/V gathered per layer beforehand
    # (the gather is not timed), GQA heads shared, a key mask per row
    idx = bt.long()
    kg = [kp[i][idx].reshape(b, smax, hkv, dh).transpose(1, 2)
          for i in range(L)]
    vg = [vp[i][idx].reshape(b, smax, hkv, dh).transpose(1, 2)
          for i in range(L)]
    pos = torch.arange(smax, device=dev)
    valid = pos[None] < ctx[:, None]
    if window is not None:
        valid &= pos[None] > ctx[:, None] - 1 - window
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
    valid_tokens = sum(min(x, window or x) for x in lens)
    n_pages = sum(-(-x // PS) for x in lens)
    nbytes = valid_tokens * hkv * dh * 2 * esz + 2 * b * h * dh * esz \
        + 4 * (n_pages + b)
    flops = 4 * h * dh * valid_tokens
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:103",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms), \
        dict(arch=arch, g=h // hkv, heads=h, kv_heads=hkv, head_dim=dh,
             layers_cycled=L, batch=b, context_lens=lens, bytes=nbytes,
             flops=flops, dtype="bfloat16", window=window,
             device_ms=device_ms,
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


def flash_timing(dev, seed: int, launches: int,
                 arch: str = "h2o-danube-1.8b", max_layers=None,
                 chunk_shapes=ENGINE_CHUNKS):
    """The engine form of flash_prefill at a serve-phase chunk: the second
    512-token chunk of the 1024-token prompt (positions 512..1023 over 1024
    keys), bf16 pools of the serve engine's geometry for all of ``arch``'s
    layers (at most ``max_layers``), at its widths, cycled so that every
    call reads its layer's K/V from device memory. Then the kernel and
    SDPA at each of ``chunk_shapes``."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   prefill_attention_paged)
    cfg = get_config(arch)
    L, dtype, window = cfg.num_layers, torch.bfloat16, cfg.sliding_window
    L = min(L, max_layers or L)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s, q_offset = 512, 512
    ctx = q_offset + s
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (L, SERVE_ENGINE["num_pages"] + 1, PS, hkv, dh)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    n = ctx // PS
    pages = torch.randperm(shape[1] - 1, generator=gen, device=dev)[:n] \
        .to(torch.int32)
    q = torch.randn((1, s, h, dh), generator=gen, device=dev).to(dtype)

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
    kg = [kp[i][idx].reshape(1, ctx, hkv, dh).transpose(1, 2)
          for i in range(L)]
    vg = [vp[i][idx].reshape(1, ctx, hkv, dh).transpose(1, 2)
          for i in range(L)]
    qpos = q_offset + torch.arange(s, device=dev)
    kpos = torch.arange(ctx, device=dev)
    mask = kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
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
    nbytes = 2 * s * h * dh * esz + 2 * ctx * hkv * dh * esz + 4 * n
    flops = 4 * h * dh * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)

    # the kernel alone at each of the kernel phase's engine chunk shapes,
    # beside SDPA on the same chunk (the mix a serve run launches)
    chunks = []
    all_pages = torch.randperm(shape[1] - 1, generator=gen, device=dev) \
        .to(torch.int32)
    for cs, co in chunk_shapes:
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
        ck = [kp[i][cidx].reshape(1, cn * PS, hkv, dh)[:, :cctx]
              .transpose(1, 2) for i in range(L)]
        cv = [vp[i][cidx].reshape(1, cn * PS, hkv, dh)[:, :cctx]
              .transpose(1, 2) for i in range(L)]
        cq4 = cq.transpose(1, 2)
        clib, clib_dev, _ = cuda_ms(lambda i: F.scaled_dot_product_attention(
            cq4, ck[i % L], cv[i % L], attn_mask=cmask, enable_gqa=True),
            iters)
        cpairs = int(cmask.sum())
        cb, _ = bound(2 * cs * h * dh * esz + 2 * cctx * hkv * dh * esz,
                      4 * h * dh * cpairs, dtype)
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
        dict(arch=arch, g=h // hkv, heads=h, kv_heads=hkv, head_dim=dh,
             layers_cycled=L, chunk=s, q_offset=q_offset, keys=ctx,
             valid_pairs=pairs, bytes=nbytes, flops=flops,
             dtype="bfloat16", window=window,
             engine_chunks=chunks, device_ms=device_ms,
             plain_device_ms=plain_device_ms,
             library_device_ms=library_device_ms, host_us=host_us,
             library_host_us=library_host_us)


def ssd_bytes_flops(b, l, h, p, g, n, chunk, dtype):
    """What one ssd_scan call must move and compute. Bytes: x, dt, A, B, C
    read once, y and the state written once; operations: per (sequence,
    head, chunk) the masked scores C_i.B_j and their product with xdt over
    the j <= i pairs, C S^T and the state update."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = b * l * h * p * esz + b * l * h * 4 + h * 4 \
        + 2 * b * l * g * n * esz + b * l * h * p * 4 + b * h * p * n * 4
    pairs = chunk * (chunk + 1) // 2
    flops = b * h * (l // chunk) * (2 * pairs * (n + p) + 4 * chunk * n * p)
    return nbytes, flops


def ssd_timing(dev, seed: int, launches: int):
    """ssd_scan at mamba2-1.3b's prefill shapes (4 x 1024 tokens, 64 heads
    of 64, state 128, one group, chunk 256), bf16 x / B / C; three input
    sets, cycled, so that no call finds its inputs in the 50 MB L2. Then the
    kernel alone at one 4096-token prompt (``SSD_LONG``: 16 chunks chained).
    No single PyTorch call computes this function: library_ms is null."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, l, h, p, g, n, chunk = SSD_TIMING
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
    plain_ms, plain_device_ms, _ = cuda_ms(
        lambda i: ref.ssd_scan(*sets[i % 3], chunk=chunk), 6, warmup=1)
    nbytes, flops = ssd_bytes_flops(b, l, h, p, g, n, chunk, dtype)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    del sets

    lb, ll, lh, lp, lg, ln, lchunk = SSD_LONG
    long_sets = [ssd_inputs(gen, dev, dtype, lb, ll, lh, lp, lg, ln)
                 for _ in range(3)]
    long_ms, long_device_ms, _ = cuda_ms(
        lambda i: ssd_scan(*long_sets[i % 3], chunk=lchunk), 9)
    ssd_scan.launches = before  # timing launches are not the path's
    long_bound_ms, _ = bound(*ssd_bytes_flops(*SSD_LONG, dtype), dtype)
    del long_sets
    torch.cuda.empty_cache()
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:68",
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), \
        dict(shape=[b, l, h, p, g, n], chunk=chunk, bytes=nbytes,
             flops=flops, dtype="bfloat16", device_ms=device_ms,
             plain_device_ms=plain_device_ms, host_us=host_us,
             long_prompt=dict(shape=list(SSD_LONG[:6]), chunk=lchunk,
                              ms=long_ms, device_ms=long_device_ms,
                              bound_ms=long_bound_ms))


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def log_timings(card: str, timed) -> None:
    """One line per kernel: back to back (the kernels line's times), then
    the card's time alone and the host's per call."""
    for k, shapes in timed:
        lp = shapes.get("long_prompt")
        if lp is not None:
            log(f"ssd_scan long prompt on {card}: {lp['shape']} chunk "
                f"{lp['chunk']}: back to back kernel {lp['ms']:.4f} ms; "
                f"device kernel {fmt_ms(lp['device_ms'])}; bound "
                f"{lp['bound_ms']:.4f} ms")
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
    at its chunks, and the engine form's chunk at the widths of each
    GQA_TIMING config that SRC's tree knows), for the ``repro_torch`` under
    ``SRC``, e.g. an unpacked earlier commit's ``src``, so that two trees'
    host and device cost per call can be compared on one card, the trees
    run in turns."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import _build
    for name in KERNELS[:2]:
        _build.build(name)
    dev = torch.device("cuda", 0)
    card = card_line()
    paged, paged_shapes = timing_phase(dev, seed=2, launches=0)
    flash, flash_shapes = flash_timing(dev, seed=5, launches=0)
    gqa = {arch: flash_timing(dev, seed=5, launches=0, arch=arch,
                              max_layers=TIMING_LAYERS, chunk_shapes=())
           for arch in GQA_TIMING if arch in ARCH_IDS}
    log(f"host cost of {src} on {card}")
    log_timings(card, [(paged, paged_shapes), (flash, flash_shapes)])
    log("host_cost " + json.dumps(dict(
        src=str(src), card=card,
        paged_attention=dict(ms=paged["ms"], library_ms=paged["library_ms"],
                             **paged_shapes),
        flash_prefill=dict(ms=flash["ms"], library_ms=flash["library_ms"],
                           **flash_shapes),
        flash_prefill_at={arch: dict(ms=k["ms"], **shapes)
                          for arch, (k, shapes) in gqa.items()})))
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

    cases = kernel_phase(dev) + partials_phase(dev) + flash_phase(dev) \
        + gqa_group_phase(dev) + non_causal_phase(dev) + ssd_phase(dev)
    serve = serve_phase(dev, seed=0)
    oracle = oracle_phase(dev, seed=1)
    slice1 = slice1_phase(dev, seed=8)
    mamba = mamba_phase(dev, seed=3)
    hymba = hymba_phase(dev, seed=12)
    seamless = seamless_phase(dev, seed=13)
    internvl = internvl_phase(dev, seed=14)
    moe = moe_phases(dev, seed=9)
    dense = dense_phases(dev, seed=10)
    mla = mla_phases(dev, seed=11)
    train = train_phase(dev, seed=15)
    mesh = mesh_phase(dev, seed=16, plain=train["full"])
    examples = examples_phase(dev)
    example_launches = {k: sum(r["launches"][k] for r in
                               examples["runs"].values()) for k in KERNELS}
    cluster = dense["cluster"]
    host_tiers = [slice1["host_tier"], dense["host_tier"]]
    sim = dense["sim"]
    paged, paged_shapes = timing_phase(
        dev, seed=2, launches=serve["launches"] + cluster["launches"]
        + sum(h["launches"] for h in host_tiers) + sim["launches"]
        + internvl["serve"]["launches"]
        + example_launches["paged_attention"])
    flash, flash_shapes = flash_timing(
        dev, seed=5,
        launches=serve["prefill_launches"] + cluster["prefill_launches"]
        + sum(h["prefill_launches"] for h in host_tiers)
        + sim["prefill_launches"] + hymba["launches"]["flash_prefill"]
        + seamless["launches"]["flash_prefill"]
        + internvl["launches"]["flash_prefill"]
        + internvl["serve"]["prefill_launches"]
        + example_launches["flash_prefill"])
    ssd, ssd_shapes = ssd_timing(
        dev, seed=6,
        launches=mamba["launches"] + hymba["launches"]["ssd_scan"]
        + example_launches["ssd_scan"])
    hymba_attention, hymba_ssd = hymba_timing(dev, seed=7)
    # each kernel's entry also carries its time at hymba's prefill shape
    flash["at_hymba"] = dict(
        launches_per_prefill=hymba["launches"]["flash_prefill"],
        **hymba_attention)
    ssd["at_hymba"] = dict(launches_per_prefill=hymba["launches"]["ssd_scan"],
                           **hymba_ssd)
    # and at the encoder-decoder and media families' prefill shapes
    for name, t in prefill_shape_timing(dev, seed=8).items():
        flash[f"at_{name}"] = t
    served = dict(dense["serve"], **{MOE_ARCH: moe["serve"],
                                     MLA_ARCH: mla["serve"],
                                     INTERNVL_ARCH: internvl["serve"]})
    gqa_timed = {}
    for arch in GQA_TIMING:
        run = served[arch]
        gqa_timed[arch] = [
            timing_phase(dev, seed=2, launches=run["launches"], arch=arch,
                         max_layers=TIMING_LAYERS),
            flash_timing(dev, seed=5, launches=run["prefill_launches"],
                         arch=arch, max_layers=TIMING_LAYERS,
                         chunk_shapes=())]

    card = card_line()
    for label, run in [("serve phase", serve), *(
            (f"{arch} serve phase", run) for arch, run in served.items())]:
        log(f"{label} on {card}: {run['arch']} {run['layers']}L, "
            f"{run['tokens_per_s']:.1f} tokens/s ({run['tokens']} tokens in "
            f"{run['wall_s']:.2f}s), mean TTFT "
            f"{run['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
            f"{run['ttft_max_s'] * 1e3:.1f} ms, {run['decode_steps']} decode "
            f"steps, {run['prefill_chunks']} prefill chunks, launches "
            f"paged_attention {run['launches']}, flash_prefill "
            f"{run['prefill_launches']}, pool {run['schema']}, "
            f"max_memory_allocated {run['peak_gib']:.2f} GiB")
    for label, st in cluster["modes"].items():
        log(f"cluster phase, {label} on {card}: {cluster['arch']} "
            f"{cluster['layers']}L x 2 instances, {st['tokens_per_s']:.1f} "
            f"tokens/s ({st['tokens']} tokens in {st['wall_s']:.2f}s), mean "
            f"TTFT {st['ttft_mean_s'] * 1e3:.1f} ms, max TTFT "
            f"{st['ttft_max_s'] * 1e3:.1f} ms, first token back mean "
            f"{st['first_token_mean_s'] * 1e3:.1f} ms, max "
            f"{st['first_token_max_s'] * 1e3:.1f} ms, {st['decode_steps']} "
            f"decode steps ({st['leased_decode_steps']} with leases, "
            f"{st['remote_partials']} remote partials), "
            f"{st['prefill_chunks']} chunks ({st['leased_chunks']} leased), "
            f"launches paged_attention {st['launches']} "
            f"({st['partial_launches']} with partials), flash_prefill "
            f"{st['prefill_launches']}, max_memory_allocated "
            f"{st['peak_gib']:.2f} GiB")
    log(f"cluster phase: {cluster['seconds']:.1f} s for the four modes; "
        f"float32 gate {cluster['gate']['seconds']:.1f} s")
    for label, st in dense["host_tier"]["modes"].items():
        rates = st["movers"] or {}
        log(f"OPT host tier, {label} on {card}: {st['tokens_per_s']:.1f} "
            f"tokens/s, mean TTFT {st['ttft_mean_s'] * 1e3:.1f} ms, max "
            f"{st['ttft_max_s'] * 1e3:.1f} ms, {st['preemptions']} "
            f"preemptions, {st['swapped_out']} swap-outs, "
            f"{st['swapped_in']} swap-ins, {st['issues']} issues, "
            f"{st['cancels']} cancels, max_memory_allocated "
            f"{st['peak_gib']:.2f} GiB" + "".join(
                f", {way} {r['gb_per_s']:.1f} GB/s" for way, r in
                rates.items() if r["ms"]))
    log(f"host tier phase (danube float32): "
        f"{slice1['host_tier']['seconds']:.1f} s")
    fit, lane = sim["fit"], sim["swap_lane"]["both"]
    log(f"sim phase on {card}: {sim['seconds']:.1f} s (studies "
        f"{sim['studies']['seconds']:.1f} s on the host); mixed router engine "
        f"child {sim['router']['engine_tokens_per_s']:.1f} tokens/s, TTFT "
        f"mean {sim['router']['ttft_mean_s'] * 1e3:.1f} ms, "
        f"max_memory_allocated {sim['router']['peak_gib']:.2f} GiB; "
        f"CostModel of full-width paper-opt-13b: t_fixed "
        f"{fit['t_fixed'] * 1e3:.3f} ms, c_token {fit['c_token'] * 1e6:.3f} "
        f"us, c_ctx {fit['c_ctx'] * 1e9:.3f} ns (R^2 {fit['r2']:.4f}, "
        f"{fit['iterations']} iterations); swap lane "
        f"{fmt_gbps(lane['pcie_gbps'])} Gb/s, t_swap_fixed "
        + (f"{lane['t_swap_fixed'] * 1e6:.1f} us" if lane["t_swap_fixed"]
           is not None else "not separable"))
    log(f"mamba2 phase on {card}: prefill {mamba['prefill_ms']:.1f} ms "
        f"for {MAMBA_BATCH} x {MAMBA_PROMPT} tokens, decode "
        f"{mamba['decode_tokens_per_s']:.1f} tokens/s")
    log(f"hymba phase on {card}: prefill {hymba['prefill_ms']:.1f} ms "
        f"for {HYMBA_BATCH} x {HYMBA_PROMPT} tokens "
        f"({hymba['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{hymba['decode_tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{hymba['measure_peak_gib']:.2f} GiB")
    log(f"seamless phase on {card}: prefill {seamless['prefill_ms']:.1f} ms "
        f"for {MEDIA_BATCH} x ({ENC_LEN} encoder + {SEAMLESS_PROMPT} "
        f"decoder positions), decode {seamless['decode_tokens_per_s']:.1f} "
        f"tokens/s, max_memory_allocated "
        f"{seamless['measure_peak_gib']:.2f} GiB; {seamless['seconds']:.1f} "
        f"s")
    log(f"internvl2 phase on {card}: prefill {internvl['prefill_ms']:.1f} ms "
        f"for {MEDIA_BATCH} x {INTERNVL_PROMPT} positions "
        f"({internvl['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{internvl['decode_tokens_per_s']:.1f} tokens/s, "
        f"max_memory_allocated {internvl['measure_peak_gib']:.2f} GiB; "
        f"{internvl['seconds']:.1f} s")
    full = train["full"]
    log(f"train phase on {card}: {full['arch']} whole, step "
        f"{full['step_median_s'] * 1e3:.1f} ms, {full['tokens_per_s']:.0f} "
        f"tokens/s, max_memory_allocated {full['peak_gib']:.2f} GiB, loss "
        f"{full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}; "
        f"{len(train['families'])} smoke families on the card equal to the "
        f"CPU; {train['seconds']:.1f} s")
    run = mesh["train"]
    log(f"mesh phase on {card}: {run['arch']} whole on a one-rank mesh, "
        f"step {run['step_median_s'] * 1e3:.1f} ms (DTensor dispatch "
        f"{mesh['dispatch_s'] * 1e3:.1f} ms a step over the plain run), "
        f"{run['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
        f"{run['peak_gib']:.2f} GiB; dist_attention max error "
        f"{mesh['dist_attention']['max_err']:.2e}; dry-run "
        f"{mesh['dryrun_s']:.1f} s; {mesh['seconds']:.1f} s")
    pc = slice1["prefix_cache"]["stats"]
    log(f"slice-1 phase on {card}: prefix-cache engine hit_tokens "
        f"{pc['hit_tokens']}, lookup_tokens {pc['lookup_tokens']}, hit_rate "
        f"{pc['hit_rate']!r}, cached_pages {pc['cached_pages']}, "
        f"kv_utilization {pc['kv_utilization']!r} after the run")
    log(f"examples phase on {card}: {examples['seconds']:.1f} s; " + "; ".join(
        f"{name} {run['seconds']:.2f} s, paged_attention "
        f"{run['launches']['paged_attention']}, flash_prefill "
        f"{run['launches']['flash_prefill']}, ssd_scan "
        f"{run['launches']['ssd_scan']}"
        for name, run in examples["runs"].items()))
    log_timings(card, [(paged, paged_shapes), (flash, flash_shapes),
                       (ssd, ssd_shapes)])
    for arch, timed in gqa_timed.items():
        log_timings(f"{card} at {arch}'s widths (G {timed[0][1]['g']})",
                    timed)
    log("detail " + json.dumps(dict(
        card=card, serve=serve, oracle=oracle, slice1=slice1, mamba=mamba,
        hymba=hymba, seamless=seamless, internvl2=internvl, moe=moe,
        dense=dense, mla=mla, train=train, mesh=mesh, examples=examples,
        kernel_cases=cases,
        timing=dict(paged_attention=paged_shapes,
                    flash_prefill=flash_shapes, ssd_scan=ssd_shapes,
                    gqa={arch: dict(paged_attention=dict(t[0][0], **t[0][1]),
                                    flash_prefill=dict(t[1][0], **t[1][1]))
                         for arch, t in gqa_timed.items()}))))
    log(card)
    log(json.dumps({"kernels": [paged, flash, ssd]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
