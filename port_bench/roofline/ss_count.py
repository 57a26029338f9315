"""Roofline arithmetic of the ``ss_count`` kernel
(``babble_tpu_torch/csrc/ss_count.cu``, behind ``ops/ss.py
ss_counts_acc``), from the shapes of each call.

A call adds ``cnt[a, b] = |{k : A[g, a, k] >= B[g, b, k]}|`` over ``g``
stacked blocks to an int32 tally: ``g * A * B * w`` element compares and
as many counts.  The work is counted as the algorithm needs it, whatever
implements it:

- **Operations.** Two per element pair (a compare and a count), on the
  integer lanes, ``32 / element-bits`` elements a lane operation (four
  int8, two int16, one int32 to a 32-bit lane).  The pipe: each SM's
  integer ALU pipe (64 lanes a clock) with the FMA pipe's integer path
  (64 more), 128 lanes a clock, which is also the issue limit of the
  SM's four schedulers of 32 lanes (NVIDIA, CUDA C++ Programming Guide,
  arithmetic throughput for compute capability 9.0).  Peak: 128 lanes x
  the card's SMs (132 on the H100 SXM) x the maximum SM clock that
  ``nvidia-smi`` reports (1,980 MHz at the 700 W limit).
- **Bytes.** Each input byte read once and each output byte written
  once: both row sets, and the tally read and written, at 3.35 TB/s.
- **Least time.** The larger of the two bounds, summed over the calls.

A formulation on the tensor cores (a one-hot product) would do other
work; a change that brings one restates this count in a ``benchmark``
change.
"""

from __future__ import annotations

from typing import Iterable, Tuple

LANES_PER_SM = 128
HBM_BYTES_S = 3.35e12


def call_shape(rows_a, rows_b, acc) -> Tuple[int, int, int, int, int]:
    """``(g, A, B, w, element bytes)`` of one ``ss_counts_acc`` call."""
    g = rows_a.shape[0] if rows_a.dim() == 3 else 1
    return (g, int(rows_a.shape[-2]), int(rows_b.shape[-2]),
            int(rows_a.shape[-1]), int(rows_a.element_size()))


def bounds(call, sm_count: int, clock_hz: float) -> Tuple[float, float]:
    """(operations seconds, bytes seconds) of one call."""
    g, a, b, w, elem = call
    lane_ops = 2 * g * a * b * w * elem / 4
    t_ops = lane_ops / (LANES_PER_SM * sm_count * clock_hz)
    t_bytes = (elem * g * (a + b) * w + 8 * a * b) / HBM_BYTES_S
    return t_ops, t_bytes


def least_seconds(calls: Iterable[tuple], device: dict) -> Tuple[float, str]:
    """Summed least time of ``calls`` on ``device`` (``sm_count``,
    ``sm_clock_max_hz``), and which bound dominates the sum."""
    ops = byt = total = 0.0
    for call in calls:
        t_ops, t_bytes = bounds(call, device["sm_count"],
                                device["sm_clock_max_hz"])
        ops += t_ops
        byt += t_bytes
        total += max(t_ops, t_bytes)
    return total, "operations" if ops >= byt else "bytes"
