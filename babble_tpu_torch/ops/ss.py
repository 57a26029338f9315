"""Strongly-see count primitive (compare form).

``cnt[a, b] = |{k : la_rows[a, k] >= fd_rows[b, k]}|`` is the count under
every consensus predicate (reference StronglySee, hashgraph.go:201-207).
The port's twin of the JAX package's ``ops/ss.py ss_counts_compare``:
a compare-reduce chunked over rows of ``a`` so the [Ac, B, K]
intermediate stays bounded.  The one-hot matmul form of the JAX package
is a TPU cost choice that its dispatch never takes off the TPU, so it is
not ported.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def ss_counts_compare(la_rows: torch.Tensor, fd_rows: torch.Tensor,
                      a_chunk: int = 512) -> torch.Tensor:
    """cnt[a, b] = sum_k [la_rows[a, k] >= fd_rows[b, k]] (exact for
    arbitrary absolute seq values)."""
    A = la_rows.shape[0]
    if A <= a_chunk:
        return (la_rows[:, None, :] >= fd_rows[None, :, :]).sum(
            -1, dtype=I32
        )
    return torch.cat([
        (la_rows[a0:a0 + a_chunk, None, :] >= fd_rows[None, :, :]).sum(
            -1, dtype=I32
        )
        for a0 in range(0, A, a_chunk)
    ])
