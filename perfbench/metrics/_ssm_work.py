"""The Mamba-2 layer's work, for its rooflines: plain numbers in, plain
numbers out, as the rest of the yardstick (``_yardstick.py``).

:func:`ssd_scan_work` is the chunked SSD scan's useful operations and the
bytes it has to move: for each (sequence, head) and each chunk of ``c``
tokens (the last one may be shorter), the intra-chunk scores C_i . B_j and
their product with x over the pairs j <= i (2 (N + P) a pair), the chunk's
own state x^T B (2 c P N) and the readout C S (2 c P N); bytes: x, dt, A,
B and C read once, y (float32) and the final state (float32) written once,
and the initial state read where the scan carries one. At mamba2-1.3b's
prefill (4 x 1024 tokens, H 64, P 64, N 128, one group, chunk 256, bf16)
that is 112,197,888 B and 21.5 GFLOP (``csrc/ssd_scan.cu``'s header).

:func:`ssm_update_bytes` is a decode step's in one SSM layer: each
stepping row's float32 state read and written once, and its conv window
((W - 1) x conv channels, in the model type) read and written once.
"""

from __future__ import annotations

from typing import Tuple


def ssd_scan_work(batch: int, length: int, heads: int, head_dim: int,
                  state: int, groups: int, chunk: int, carried: bool,
                  elem: int) -> Tuple[float, float]:
    """(operations, bytes) of one scan call; ``elem`` the bytes of an
    element of x, B and C."""
    ops = 0.0
    for c0 in range(0, length, chunk):
        c = min(chunk, length - c0)
        pairs = c * (c + 1) // 2
        ops += 2.0 * pairs * (state + head_dim) + 4.0 * c * head_dim * state
    ops *= batch * heads
    tokens = batch * length
    nbytes = (tokens * heads * head_dim * elem  # x
              + tokens * heads * 4 + heads * 4  # dt, A
              + 2 * tokens * groups * state * elem  # B, C
              + tokens * heads * head_dim * 4  # y
              + batch * heads * head_dim * state * 4 * (2 if carried else 1))
    return ops, float(nbytes)


def ssm_update_bytes(rows: int, heads: int, head_dim: int, state: int,
                     conv_width: int, conv_channels: int,
                     elem: int) -> float:
    """Bytes a decode step's SSM layer has to move for ``rows`` stepping
    rows: state and conv window, each read and written once."""
    per_row = 2 * heads * head_dim * state * 4 \
        + 2 * (conv_width - 1) * conv_channels * elem
    return float(rows * per_row)
