"""Roofline arithmetic of the ``fork_ss`` kernel
(``babble_tpu_torch/csrc/fork_ss.cu``, behind ``ops/forks.py
ss_counts``), from the shapes of each call.

A call counts, for ``g`` groups of ``X`` viewer rows and ``W`` witness
rows over ``B = n * k`` branch columns, the creators through which a
viewer strongly sees a witness: ``X * W * B`` element compares and
``X * W * n`` counts (one a creator's OR-ed result; the detection mask
is folded into the viewer).  Counted as the algorithm needs them,
whatever implements them:

- **Operations.** The compares and counts on the integer lanes, two
  16-bit elements a lane operation: a chain index inside the window
  needs no more (the program narrows to 16 bits wherever the window
  fits, and the count cannot be lower for a wider type).  Peak as in
  ``ss_count.py``: 128 lanes a clock an SM x the SMs x the maximum SM
  clock.
- **Bytes.** The 16-bit viewer and witness rows read once and the int32
  counts written once, at 3.35 TB/s.
- **Least time.** The larger of the two bounds, summed over the calls.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .ss_count import HBM_BYTES_S, LANES_PER_SM


def call_shape(la_x, det_x, helper_w, k, window=None) -> Tuple[int, ...]:
    """``(g, X, W, B, k)`` of one ``ss_counts`` call."""
    g = la_x.shape[0] if la_x.dim() == 3 else 1
    return (g, int(la_x.shape[-2]), int(helper_w.shape[-2]),
            int(la_x.shape[-1]), int(k))


def bounds(call, sm_count: int, clock_hz: float) -> Tuple[float, float]:
    """(operations seconds, bytes seconds) of one call."""
    g, x, w, b, k = call
    lane_ops = g * x * w * (b + b // k) / 2
    t_ops = lane_ops / (LANES_PER_SM * sm_count * clock_hz)
    t_bytes = (2 * g * (x + w) * b + 4 * g * x * w) / HBM_BYTES_S
    return t_ops, t_bytes


def least_seconds(calls: Iterable[tuple], device: dict) -> Tuple[float, str]:
    """Summed least time of ``calls`` on ``device``, and the bound that
    dominates the sum."""
    ops = byt = total = 0.0
    for call in calls:
        t_ops, t_bytes = bounds(call, device["sm_count"],
                                device["sm_clock_max_hz"])
        ops += t_ops
        byt += t_bytes
        total += max(t_ops, t_bytes)
    return total, "operations" if ops >= byt else "bytes"
