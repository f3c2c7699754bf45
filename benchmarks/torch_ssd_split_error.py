"""How many bf16 parts the bf16 ssd_scan kernel's float32 operands need.

    PYTHONPATH=src python3 benchmarks/torch_ssd_split_error.py

Runs on the CPU (seconds). The CUDA kernel (``csrc/ssd_scan.cu``) multiplies
on bf16 tensor cores; three of its products have a float32 operand (the
decay-weighted scores times x, the incoming state S_in times C, the weighted
x^T times B for the chunk's state), which it splits into bf16 parts, one
product per part. This script repeats that arithmetic in float32 with the
float32 operands rounded to k bf16 parts (each part the rounding of what the
earlier ones left) and compares the result with the plain version
``kernels.ref.ssd_scan`` on the inputs of ``chip_smoke.py`` / the card tests
(normal x, B, C in bf16; dt softplus of a normal; A = -exp(normal / 2)). It
prints, for the parts of (scores, state, x^T), the worst elementwise error
as a share of the card tests' tolerance (2e-4 + 2e-4 |ref|) and the largest
error relative to max |y| (the chip_smoke.py measure, held at 2e-4).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

SHAPES = [(1, 512, 4, 64, 1, 128, 256), (1, 1024, 4, 64, 1, 128, 64)]
PARTS = [(1, 1, 1), (2, 2, 2), (3, 2, 3), (3, 3, 3)]


def split(v, k):
    """v as the sum of k bf16-rounded parts (as float32)."""
    parts, rest = [], v
    for _ in range(k):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def emulate(x, dt, A, B, C, chunk, k_scores, k_state, k_xt):
    """The kernel's chunked scan with its operand splits, in float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2:]
    x, B, C = x.float(), B.float(), C.float()
    y = torch.zeros(b, l, h, p)
    final = torch.zeros(b, h, p, n)
    for bb in range(b):
        for hh in range(h):
            gg = hh // (h // g)
            st = torch.zeros(p, n)
            for c in range(l // chunk):
                sl = slice(c * chunk, (c + 1) * chunk)
                d = dt[bb, sl, hh]
                cum = torch.cumsum(d * A[hh], 0)
                cc, bc, xc = C[bb, sl, gg], B[bb, sl, gg], x[bb, sl, hh]
                w = torch.exp(cum[:, None] - cum[None, :]).tril() * d[None]
                yy = sum(part @ xc for part in split((cc @ bc.T) * w,
                                                     k_scores))
                if c:
                    yy = yy + sum(cc @ part.T for part in split(st, k_state)) \
                        * torch.exp(cum)[:, None]
                wl = torch.exp(cum[-1] - cum) * d
                st = st * torch.exp(cum[-1]) + sum(
                    part @ bc for part in split((xc * wl[:, None]).T, k_xt))
                y[bb, sl, hh] = yy
            final[bb, hh] = st
    return y, final


def main() -> int:
    for b, l, h, p, g, n, chunk in SHAPES:
        rng = np.random.default_rng(l + p)
        t = [torch.from_numpy(a.astype(np.float32)) for a in (
            rng.standard_normal((b, l, h, p)),
            np.log1p(np.exp(rng.standard_normal((b, l, h)))),
            -np.exp(rng.standard_normal(h) * 0.5),
            rng.standard_normal((b, l, g, n)),
            rng.standard_normal((b, l, g, n)))]
        x, dt, A, B, C = t
        x, B, C = (v.to(torch.bfloat16) for v in (x, B, C))
        yr, sr = ref.ssd_scan(x, dt, A, B, C, chunk=chunk)
        for parts in PARTS:
            y, s = emulate(x, dt, A, B, C, chunk, *parts)
            worst = max(((y - yr).abs() / (2e-4 + 2e-4 * yr.abs())).max(),
                        ((s - sr).abs() / (2e-4 + 2e-4 * sr.abs())).max())
            rel = max((y - yr).abs().max() / yr.abs().max(),
                      (s - sr).abs().max() / sr.abs().max())
            print(f"shape {[b, l, h, p, g, n]} chunk {chunk}: parts "
                  f"(scores, state, x^T) {parts}: worst elementwise error "
                  f"{float(worst):.3f} of the tolerance, {float(rel):.3g} "
                  f"of the largest magnitude")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
