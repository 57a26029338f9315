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
  2^24 (under any matmul precision: 0 and 1 are exact in TF32 too).

The dispatch (``ss_counts``) takes the one-hot form only where the JAX
package would: on a TPU, at wide n and shallow chains.  ``use_onehot``
therefore returns False here, as JAX's does on every other backend, so
the card runs the compare form, the one JAX itself takes off the TPU;
the one-hot form is kept for parity with the JAX package.

``ss_counts_acc`` is the wide engine's per-block partial
(``ops/wide.py _ss_partial``): ``acc += compare count``, in place.  On
CUDA tensors it launches the hand-written ``csrc/ss_count.cu``; on CPU
tensors it runs ``ss_counts_compare``, its plain twin.  The kernel
compares int8 and int16 rows four or two to a 32-bit word, so the
wrapper first hands it rows padded to 16 bytes (``padded_rows``).
"""

from __future__ import annotations

import ctypes
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
    # exact under any matmul precision: 0/1 products (exact in TF32
    # and bf16), each column k adds at most 1, so a count stays <= K
    # < 2^24 in the f32 accumulator
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


#: coordinate types ``csrc/ss_count.cu`` is instantiated for
SS_COUNT_DTYPES = (torch.int8, torch.int16, torch.int32)


def ss_counts_acc(rows_a: torch.Tensor, rows_b: torch.Tensor,
                  acc: torch.Tensor) -> torch.Tensor:
    """``acc[a, b] += sum_k [rows_a[a, k] >= rows_b[b, k]]`` in place, and
    returns ``acc`` (the JAX package donates ``acc`` to ``_ss_partial``
    and rebinds the result; here the same tensor is updated).

    ``rows_a`` is ``[A, w]`` and ``rows_b`` ``[B, w]`` in one coordinate
    type (int8, int16 or int32, compared signed), or both stacked
    ``[C, A, w]`` / ``[C, B, w]``, whose counts are summed over the C
    blocks.  Rows may be strided; columns must be contiguous.  ``acc``
    is int32 ``[A, B]``, contiguous.  On CUDA tensors this launches
    ``csrc/ss_count.cu`` on the current stream, counted in
    ``ss_counts_acc.launches``, or raises; on CPU tensors it adds
    ``ss_counts_compare``, the plain twin."""
    _check_acc_args(rows_a, rows_b, acc)
    if rows_a.device.type == "cpu":
        if rows_a.dim() == 2:
            acc += ss_counts_compare(rows_a, rows_b)
        else:
            for c in range(rows_a.shape[0]):
                acc += ss_counts_compare(rows_a[c], rows_b[c])
        return acc
    return _launch_ss_count(rows_a, rows_b, acc)


ss_counts_acc.launches = 0


def _check_acc_args(rows_a, rows_b, acc):
    if rows_a.dim() != rows_b.dim() or rows_a.dim() not in (2, 3):
        raise ValueError("ss_counts_acc: rows_a and rows_b must both be "
                         "[rows, w] or both [C, rows, w]")
    if rows_a.dim() == 3 and rows_a.shape[0] != rows_b.shape[0]:
        raise ValueError(f"ss_counts_acc: block counts {rows_a.shape[0]} "
                         f"and {rows_b.shape[0]} differ")
    if rows_a.shape[-1] != rows_b.shape[-1]:
        raise ValueError(f"ss_counts_acc: widths {rows_a.shape[-1]} and "
                         f"{rows_b.shape[-1]} differ")
    if rows_a.dtype != rows_b.dtype or rows_a.dtype not in SS_COUNT_DTYPES:
        raise ValueError(f"ss_counts_acc: rows must share one type of "
                         f"{SS_COUNT_DTYPES}, got {rows_a.dtype} and "
                         f"{rows_b.dtype}")
    want = (rows_a.shape[-2], rows_b.shape[-2])
    if acc.dtype != I32 or tuple(acc.shape) != want:
        raise ValueError(f"ss_counts_acc: acc must be int32 {list(want)}, "
                         f"got {acc.dtype} {list(acc.shape)}")
    if rows_b.device != rows_a.device or acc.device != rows_a.device:
        raise ValueError("ss_counts_acc: tensors on different devices")


def _ss_count_lib() -> ctypes.CDLL:
    """The built ``csrc/ss_count.cu``, its C function declared."""
    from .. import cuda_build

    lib = cuda_build.load("ss_count")
    lib.ss_count_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    lib.ss_count_launch.restype = ctypes.c_int
    return lib


#: the packed kernel's row alignment
PACK_BYTES = 16


def padded_rows(rows: torch.Tensor, side: str) -> torch.Tensor:
    """``rows`` ``[G, R, w]`` (int8 or int16) as the packed kernel reads
    them: every row's columns padded to a multiple of ``PACK_BYTES``,
    every row starting on a ``PACK_BYTES`` boundary.  Pad columns hold
    the type's minimum on the A side (``side="a"``) and its maximum on
    the B side (``"b"``): a pad column meets only pad columns, and min >=
    max is false, so the pads count nothing whatever the real values
    are.  A new contiguous tensor."""
    per16 = PACK_BYTES // rows.element_size()
    g, r, w = rows.shape
    wp = -(-w // per16) * per16
    info = torch.iinfo(rows.dtype)
    out = torch.empty((g, r, wp), dtype=rows.dtype, device=rows.device)
    out[..., :w] = rows
    out[..., w:] = info.min if side == "a" else info.max
    return out


def _launch_ss_count(rows_a, rows_b, acc):
    dev = rows_a.device
    if dev.type != "cuda":
        raise ValueError(f"ss_count: the kernel needs CUDA tensors, got {dev}")
    if rows_a.stride(-1) != 1 or rows_b.stride(-1) != 1:
        raise ValueError("ss_count: row columns must be contiguous")
    if not acc.is_contiguous():
        raise ValueError("ss_count: acc must be contiguous")
    a3 = rows_a if rows_a.dim() == 3 else rows_a[None]
    b3 = rows_b if rows_b.dim() == 3 else rows_b[None]
    g, na, w = a3.shape
    nb = b3.shape[1]
    if acc.numel() == 0 or w == 0 or g == 0:
        return acc
    if a3.element_size() < 4:
        a3, b3 = padded_rows(a3, "a"), padded_rows(b3, "b")
        w = a3.shape[2]
    fn = _ss_count_lib().ss_count_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a3.data_ptr(), b3.data_ptr(), acc.data_ptr(), na, nb, w, g,
                a3.stride(1), b3.stride(1), a3.stride(0), b3.stride(0),
                a3.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"ss_count: kernel launch failed, cudaError_t {rc}")
    ss_counts_acc.launches += 1
    return acc
