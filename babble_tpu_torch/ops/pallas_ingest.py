"""One-pass last-ancestor fill ("the walk"): a hand-written CUDA kernel
and its plain torch twin.

Slot order is topological, so one sequential walk over the slots
computes the whole last-ancestor table:

    la[x] = max(la[sp(x)], la[op(x)]) ; la[x, creator(x)] = seq(x)

The JAX package runs this as a Pallas TPU kernel (``ops/pallas_ingest.py
_walk_kernel``) with the table packed into VMEM; here it is
``csrc/la_walk.cu`` (one thread per participant column, table in global
memory / L2 — see the note at the top of the source).  Both return the
unpacked i32 ``[E+1, N]`` table with -1 on rows at or past ``n_events``:
what the JAX package's ``la_walk`` followed by ``unpack_la`` computes.

``la_walk`` takes the plain twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

I32 = torch.int32
_HALF = 64
_VMEM_BUDGET = 13 * 1024 * 1024


def walk_supported(n: int, e_cap: int, s_cap: int) -> bool:
    """The JAX package's gate for walk mode, copied unchanged so the port
    picks walk mode exactly where the JAX package does."""
    table = (e_cap + 2) // 2 * 128 * 2            # packed int16 bytes
    index = 4 * (e_cap + 1) * 4                   # sp/op/creator/seq i32
    return n <= _HALF and s_cap < 32767 and table + index < _VMEM_BUDGET


def _check_args(sp, op, creator, seq, n_events, e_cap, n):
    e1 = e_cap + 1
    if not 1 <= n <= _HALF:
        raise ValueError(f"la_walk: n={n} outside [1, {_HALF}]")
    dev = sp.device
    for name, t in (("sp", sp), ("op", op), ("creator", creator),
                    ("seq", seq)):
        if t.dtype != I32 or tuple(t.shape) != (e1,):
            raise ValueError(
                f"la_walk: {name} must be int32 [{e1}], got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"la_walk: {name} must be contiguous")
        if t.device != dev:
            raise ValueError(
                f"la_walk: {name} on {t.device}, sp on {dev}"
            )
    if not isinstance(n_events, torch.Tensor) or n_events.dtype != I32 \
            or n_events.dim() != 0 or n_events.device != dev:
        raise ValueError(
            "la_walk: n_events must be a 0-d int32 tensor on the device "
            "of the index arrays"
        )


def la_walk(sp: torch.Tensor, op: torch.Tensor, creator: torch.Tensor,
            seq: torch.Tensor, n_events: torch.Tensor, e_cap: int,
            n: int) -> torch.Tensor:
    """Fill la for the whole (topologically slot-ordered) DAG.

    Takes the state's ``[E+1]`` int32 index arrays and its 0-d int32
    ``n_events``; returns a new i32 ``[E+1, N]`` table.  On CUDA tensors
    this launches ``csrc/la_walk.cu`` on the current stream (and counts
    the launch in ``la_walk.launches``); on CPU tensors it runs
    ``la_walk_plain``."""
    _check_args(sp, op, creator, seq, n_events, e_cap, n)
    dev = sp.device
    if dev.type == "cpu":
        return la_walk_plain(sp, op, creator, seq, n_events, e_cap, n)
    if dev.type != "cuda":
        raise ValueError(f"la_walk: unsupported device {dev}")

    from .. import cuda_build

    lib = cuda_build.load("la_walk")
    fn = lib.la_walk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    la = torch.empty((e_cap + 1, n), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(sp.data_ptr(), op.data_ptr(), creator.data_ptr(),
            seq.data_ptr(), n_events.data_ptr(), e_cap + 1, n,
            la.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"la_walk: kernel launch failed, cudaError_t {rc}")
    la_walk.launches += 1
    return la


la_walk.launches = 0


def la_walk_plain(sp: torch.Tensor, op: torch.Tensor, creator: torch.Tensor,
                  seq: torch.Tensor, n_events, e_cap: int,
                  n: int) -> torch.Tensor:
    """The same recurrence in plain torch: a Python loop over the slots
    with one row max and one own-column set each, on the device of the
    inputs.  A parent outside ``[0, E+1)`` is missing (-1); the own
    column gets ``max(seq, 0) & 0xFFFF``, the value the TPU kernel packs."""
    e1 = e_cap + 1
    dev = sp.device
    ne = min(max(int(n_events), 0), e1)
    la = torch.full((e1, n), -1, dtype=I32, device=dev)
    missing = torch.full((n,), -1, dtype=I32, device=dev)
    sp_l, op_l = sp[:ne].tolist(), op[:ne].tolist()
    cr_l, sq_l = creator[:ne].tolist(), seq[:ne].tolist()
    for x in range(ne):
        s, o, c = sp_l[x], op_l[x], cr_l[x]
        row = torch.maximum(la[s] if 0 <= s < e1 else missing,
                            la[o] if 0 <= o < e1 else missing)
        if 0 <= c < n:
            row[c] = max(sq_l[x], 0) & 0xFFFF
        la[x] = row
    return la
