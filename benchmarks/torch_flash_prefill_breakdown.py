"""Where the contiguous ``flash_prefill``'s bf16 body spends its time on the
GPU: copies of ``src/repro_torch/csrc/flash_prefill.cu`` with one part of
``flash_prefill_wgmma_kernel`` cut out each, built side by side and timed
at hymba-1.5b's prefill shape.

    python3 benchmarks/torch_flash_prefill_breakdown.py

Needs one CUDA card and ``nvcc``. The copies go under ``build/breakdown/``
(git-ignored). Each cut keeps the rest of the kernel as it is; its results
are wrong and are not checked, only timed:

* ``no_exp``: the exponentials of the softmax become their argument (the
  multiply-add stays);
* ``no_softmax``: the softmax of every tile after the first is skipped
  (masks, maxima, exponentials, sums);
* ``no_kv_loads``: the producer signals each K/V stage without loading it
  (the handshakes stay);
* ``no_products``: no ``wgmma`` is issued (the fences, commits and waits
  stay);
* ``loop_only``: no K/V loads, no softmax, no products: what the loop's
  handshakes, turns and bookkeeping cost by themselves;
* ``items_only``: every item has no key tile: Q loads and the output's
  stores alone.

Prints the card's name and power limit and, for each copy, the device ms
of one call (``chip_smoke.cuda_ms``: calls queued behind a device-side
sleep, the median of five bursts) with the window and without, then one
JSON line with the same numbers. Cutting a part removes its time only
where nothing else waits in its place, so the differences bound each
part's share from below.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "breakdown"

NO_SOFTMAX = [("        softmax(t, alpha);\n",
               "        alpha[0] = alpha[1] = 1.f;\n")]
NO_KV_LOADS = [("""            tma::mbar_arrive_expect(&full[st], 2 * NR * kKvRegion);
            for (int r = 0; r < NR; ++r) {
              tma::load_4d(kt + r * kKvRegion, &a.kmap, 64 * r, it.kvh, kb,
                           it.b, &full[st]);
              tma::load_4d(vt + r * kKvRegion, &a.vmap, 64 * r, it.kvh, kb,
                           it.b, &full[st]);
            }""", "            tma::mbar_arrive(&full[st]);")]
NO_PRODUCTS = [
    ("      for (int ks = 0; ks < KS; ++ks)\n        wg::wg_ss_n128(",
     "      for (int ks = 0; ks < 0; ++ks)\n        wg::wg_ss_n128("),
    ("      for (int kk = 0; kk < kWgKeys / 16; ++kk) {\n"
     "        const uint64_t dv",
     "      for (int kk = 0; kk < 0; ++kk) {\n        const uint64_t dv")]
CUTS = {
    "base": [],
    "no_exp": [("const float p = ex2(fmaf(s[4 * jj + 2 * h + e], c2, "
                "-m_new[h]));",
                "const float p = fmaf(s[4 * jj + 2 * h + e], c2, "
                "-m_new[h]);")],
    "no_softmax": NO_SOFTMAX,
    "no_kv_loads": NO_KV_LOADS,
    "no_products": NO_PRODUCTS,
    "loop_only": NO_SOFTMAX + NO_KV_LOADS + NO_PRODUCTS,
    "items_only": [("    it.nt = k_hi > it.k_lo ? (k_hi - it.k_lo + kWgKeys - "
                    "1) / kWgKeys : 0;", "    it.nt = 0;")],
}


def build(name: str) -> Path:
    """The copy of flash_prefill.cu with cut ``name``, built. Raises if an
    anchor of the cut is missing (the kernel changed: update the cut)."""
    text = (CSRC / "flash_prefill.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"cut {name}: anchor not found once: "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    src = OUT / f"flash_prefill_{name}.cu"
    src.write_text(text)
    lib = OUT / f"flash_prefill_{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for cut {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_prefill_breakdown: no CUDA device",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    with concurrent.futures.ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(build, CUTS)))
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cfg = get_config(cs.HYMBA_ARCH)
    b, s = cs.HYMBA_BATCH, cs.HYMBA_PROMPT
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((b, s, h, dh), (b, s, hkv, dh),
                                (b, s, hkv, dh)))
            for _ in range(3)]
    out = torch.empty_like(sets[0][0])
    stream = torch.cuda.current_stream().cuda_stream
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_float
    rows = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).flash_prefill_contiguous
        fn.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, f32, i32, p]
        fn.restype = i32
        rows[name] = {}
        for window in (cfg.sliding_window, None):
            def call(i, window=window):
                q, k, v = sets[i % 3]
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, s, h, hkv, dh, s, 1, window or 0,
                         k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                         v.stride(1), v.stride(2), 1.0 / dh ** 0.5, 1,
                         stream)
                if err:
                    raise RuntimeError(f"cut {name}: launch error {err}")
            _, device_ms, _ = cs.cuda_ms(call, 20)
            rows[name]["window" if window else "global"] = device_ms
        print(f"{name:12s} window {cs.fmt_ms(rows[name]['window'])}, "
              f"global {cs.fmt_ms(rows[name]['global'])}", flush=True)
    print(json.dumps(dict(card=card, shape=[b, s, s, h, hkv, dh],
                          window=cfg.sliding_window, device_ms=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
