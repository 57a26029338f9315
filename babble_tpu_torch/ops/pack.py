"""Bit-packing primitives: boolean participant-axis tensors stored 8:1
as uint8 lanes, tallied by popcount.

Layout contract (the same as the JAX package's ``ops/pack.py``): lanes
are LITTLE-endian — bit ``j`` of lane ``l`` is participant ``8*l + j`` —
matching ``np.packbits(..., bitorder="little")``.  Padding lanes
(participants past ``n``) pack to zero bits, neutral under ``&`` and
popcount.

torch has no uint8 popcount on every backend, so ``popcount_sum`` reads
a 256-entry lookup table.  The table and the lane weights are copied to
each device once per process: a copy from host memory per call would
wait for the device's queue to drain, each time.
"""

from __future__ import annotations

import functools

import torch

LANE = 8
U8 = torch.uint8
I32 = torch.int32

_WEIGHTS = tuple(1 << j for j in range(LANE))
_POPCOUNT = tuple(bin(v).count("1") for v in range(256))


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(lane weights i32[8], popcount table i32[256]) on ``device``."""
    return (torch.tensor(_WEIGHTS, dtype=I32, device=device),
            torch.tensor(_POPCOUNT, dtype=I32, device=device))


def lane_count(n: int) -> int:
    """uint8 lanes covering ``n`` participant bits: ``ceil(n/8)``."""
    return -(-n // LANE)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool[..., n] -> uint8[..., ceil(n/8)], little-endian lanes."""
    n = x.shape[-1]
    pad = lane_count(n) * LANE - n
    if pad:
        x = torch.cat(
            [x, torch.zeros(x.shape[:-1] + (pad,), dtype=torch.bool,
                            device=x.device)], dim=-1
        )
    r = x.reshape(x.shape[:-1] + (lane_count(n), LANE))
    w = _device_tables(x.device)[0]
    # accumulate in i32 (exact: lane totals < 256), narrow once
    return (r.to(I32) * w).sum(-1, dtype=I32).to(U8)


def popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """uint8[..., L] -> int[...]: total set bits over the lane axis
    (summed at the default integer width, as the JAX package's sum is
    under x64)."""
    return _device_tables(x.device)[1][x.long()].sum(-1)


def count_bits(x: torch.Tensor) -> torch.Tensor:
    """bool[..., n] -> int[...]: the packed twin of ``x.sum(-1)``."""
    return popcount_sum(pack_bits(x))
