"""Strongly-see count primitives (the port's twin of the JAX package's
``ops/ss.py``).

``cnt[a, b] = |{k : la_rows[a, k] >= fd_rows[b, k]}|`` is the count under
every consensus predicate (reference StronglySee, hashgraph.go:201-207).
Two exact formulations:

- ``compare``: a compare-reduce chunked over rows of ``a`` so the
  [Ac, B, K] intermediate stays bounded.
- ``onehot``: the threshold count as a matmul over one-hot seq
  positions, P[a, (k,s)] = [la[a,k] >= s], Q[b, (k,s)] = [fd[b,k] == s]:
  cnt = P @ Q^T.  In JAX an int8 matmul for the TPU's MXU; here an f32
  matmul, exact because the operands are 0/1 and the counts stay below
  2^24 (with TF32 off on the card).

The dispatch (``ss_counts``) takes the one-hot form only where the JAX
package would: on a TPU, at wide n and shallow chains.  ``use_onehot``
therefore returns False here, as JAX's does on every other backend, so
the card runs the compare form, the one JAX itself takes off the TPU;
the one-hot form is kept for parity with the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

I32 = torch.int32
F32 = torch.float32


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


def ss_counts_onehot(
    la_rows: torch.Tensor,
    fd_rows: torch.Tensor,
    s_hi: int,
    off: Optional[torch.Tensor] = None,
    k_chunk_elems: int = 1 << 15,
) -> torch.Tensor:
    """cnt[a, b] = sum_k [la_rows[a, k] >= fd_rows[b, k]] as a one-hot
    matmul.  Exact iff every finite fd value (minus ``off``) lies in
    [0, s_hi]: la above the band satisfies every threshold (clamped to
    s_hi) and fd above it, which can only be INF, goes to a dead bucket
    s_hi + 1 outside the one-hot range.  The chain axis runs in chunks
    of ``kc`` columns (a divisor of the minimally padded K, as in JAX)."""
    A, K = la_rows.shape
    B = fd_rows.shape[0]
    S1 = s_hi + 1
    if off is not None:
        inf = torch.iinfo(fd_rows.dtype).max
        la_rows = torch.where(la_rows < 0, -1, la_rows - off[None, :])
        fd_rows = torch.where(fd_rows >= inf, inf, fd_rows - off[None, :])
    la_rows = torch.clamp(la_rows, -1, s_hi)
    fd_rows = torch.clamp(fd_rows, 0, s_hi + 1)

    kc_target = max(128, k_chunk_elems // S1)
    parts = max(1, -(-K // kc_target))
    kc = -(-K // parts)
    Kp = parts * kc
    if Kp != K:
        la_rows = torch.cat([la_rows, torch.full(
            (A, Kp - K), -1, dtype=la_rows.dtype, device=la_rows.device)], 1)
        fd_rows = torch.cat([fd_rows, torch.full(
            (B, Kp - K), s_hi + 1, dtype=fd_rows.dtype,
            device=fd_rows.device)], 1)
    s_idx = torch.arange(S1, dtype=I32, device=la_rows.device)
    # exact 0/1 products: keep the f32 matmul out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    acc = torch.zeros((A, B), dtype=F32, device=la_rows.device)
    for k0 in range(0, Kp, kc):
        la_c = la_rows[:, k0:k0 + kc]
        fd_c = fd_rows[:, k0:k0 + kc]
        P = (la_c[:, :, None] >= s_idx).to(F32).reshape(A, kc * S1)
        Q = (fd_c[:, :, None] == s_idx).to(F32).reshape(B, kc * S1)
        acc = acc + P @ Q.T
    return acc.to(I32)


def use_onehot(n: int, s_cap: int) -> bool:
    """The JAX package's static choice of the one-hot form: only on a
    TPU backend (n >= 4096 and s_cap <= 256 there).  This package never
    runs on a TPU, so the answer is always False, as JAX's is on a GPU
    or a CPU."""
    return False


def ss_counts(la_rows: torch.Tensor, fd_rows: torch.Tensor, s_cap: int,
              batch_window: bool) -> torch.Tensor:
    """Dispatching wrapper: exact strongly-see counts.  ``batch_window``
    asserts the batch-path invariant (window offsets all zero) that the
    one-hot form needs; pass False on rolled-window states."""
    if batch_window and use_onehot(la_rows.shape[1], s_cap):
        return ss_counts_onehot(la_rows, fd_rows, s_cap)
    return ss_counts_compare(la_rows, fd_rows)
