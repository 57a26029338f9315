"""One-pass last-ancestor fill ("the walk"): a hand-written CUDA kernel
and its plain torch twin.

Slot order is topological, so one sequential walk over the slots
computes the whole last-ancestor table:

    la[x] = max(la[sp(x)], la[op(x)]) ; la[x, own(x)] = int16(seq(x))

The JAX package runs this as a Pallas TPU kernel (``ops/pallas_ingest.py
_walk_kernel``) with the table packed into VMEM as int16; here it is
``csrc/la_walk.cu`` (one block per participant column, the column held
in shared memory as int16, one warp resolving the slots in rounds — see
the note at the top of the source).  Both return the unpacked i32
``[E+1, N]`` table with -1 on rows at or past ``n_events``: what the JAX
package's ``la_walk`` followed by ``unpack_la`` computes, including its
int16 values (a seq of 32,768 or more wraps) and its own-column lane
(``(creator << 16 | seq) >> 16``, which is ``creator`` below 65,536).

``la_walk`` takes the plain twin only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

A column range ``[c0, c0 + w)`` of the ``n`` columns (a rank's shard in
``parallel/sharded.py``) fills only those columns: the columns are
independent, so the kernel launches one block per column of the range
and tests a slot's own lane against the block's global column; the
result is ``[E+1, w]``, column ``c`` holding global column ``c0 + c``.
The defaults (``0`` and ``n``) give the whole table.
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


def kernel_supports(n: int, e_cap: int) -> bool:
    """Whether the wrapper launches ``csrc/la_walk.cu`` at this size:
    exactly the sizes walk mode admits (one block per column, each
    column fits the block's shared memory up to the gate's edge,
    e_cap 94,661)."""
    return n >= 1 and e_cap >= 0 and walk_supported(n, e_cap, 0)


def own_lane_and_value(creator: torch.Tensor, seq: torch.Tensor):
    """The column each slot overwrites and the value it writes, as the TPU
    kernel computes them: ``meta = creator << 16 | max(seq, 0)`` in int32,
    lane ``meta >> 16``, value ``meta & 0xFFFF`` stored as int16."""
    meta = ((creator.long() & 0xFFFF) << 16) | seq.long().clamp(min=0)
    meta = meta - ((meta & 0x80000000) << 1)      # wrap to signed int32
    return meta >> 16, ((meta & 0xFFFF) ^ 0x8000) - 0x8000


def _check_args(sp, op, creator, seq, n_events, e_cap, n, c0=0, w=None):
    e1 = e_cap + 1
    if not 1 <= n <= _HALF:
        raise ValueError(f"la_walk: n={n} outside [1, {_HALF}]")
    w = n if w is None else w
    if not (0 <= c0 and 1 <= w and c0 + w <= n):
        raise ValueError(f"la_walk: columns [{c0}, {c0 + w}) outside "
                         f"[0, {n})")
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
            n: int, c0: int = 0, w: int = None) -> torch.Tensor:
    """Fill la for the whole (topologically slot-ordered) DAG, columns
    ``[c0, c0 + w)`` of ``n`` (all by default).

    Takes the state's ``[E+1]`` int32 index arrays and its 0-d int32
    ``n_events``; returns a new i32 ``[E+1, w]`` table.  On CUDA tensors
    this launches ``csrc/la_walk.cu`` on the current stream (and counts
    the launch in ``la_walk.launches``); on CPU tensors it runs
    ``la_walk_plain``."""
    w = n if w is None else w
    _check_args(sp, op, creator, seq, n_events, e_cap, n, c0, w)
    if sp.device.type == "cpu":
        return la_walk_plain(sp, op, creator, seq, n_events, e_cap, n, c0, w)
    return _launch(sp, op, creator, seq, n_events, e_cap, n, None, c0, w)


la_walk.launches = 0


def la_walk_phases(sp: torch.Tensor, op: torch.Tensor, creator: torch.Tensor,
                   seq: torch.Tensor, n_events: torch.Tensor, e_cap: int,
                   n: int):
    """``la_walk`` on CUDA tensors with the kernel's own clock read out:
    returns the table and an int64 ``[n, 4]`` tensor on the host holding,
    per block, its start, the end of its walk and the end of its epilogue
    (globaltimer ns), and the rounds of its walking warp."""
    _check_args(sp, op, creator, seq, n_events, e_cap, n)
    prof = torch.zeros((n, 4), dtype=torch.int64, device=sp.device)
    la = _launch(sp, op, creator, seq, n_events, e_cap, n, prof)
    return la, prof.cpu()


def _kernel_lib() -> ctypes.CDLL:
    """The built ``csrc/la_walk.cu``, its C functions declared."""
    from .. import cuda_build

    lib = cuda_build.load("la_walk")
    lib.la_walk_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.la_walk_launch.restype = ctypes.c_int
    lib.la_walk_dynamic_smem.argtypes = [ctypes.c_int]
    lib.la_walk_dynamic_smem.restype = ctypes.c_int
    lib.la_walk_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.la_walk_attributes.restype = ctypes.c_int
    return lib


def kernel_attributes(e_cap: int) -> dict:
    """What the CUDA runtime reports for the compiled kernel (registers
    and local spill bytes per thread, static shared bytes, largest
    block) and the dynamic shared bytes a block takes at ``e_cap``."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 4)()
    rc = lib.la_walk_attributes(out)
    if rc != 0:
        raise RuntimeError(f"la_walk_attributes: cudaError_t {rc}")
    return dict(registers=out[0], static_smem=out[1], local_bytes=out[2],
                max_threads=out[3],
                dynamic_smem=lib.la_walk_dynamic_smem(e_cap + 1))


def _launch(sp, op, creator, seq, n_events, e_cap, n, prof, c0=0, w=None):
    dev = sp.device
    w = n if w is None else w
    if dev.type != "cuda":
        raise ValueError(f"la_walk: the kernel needs CUDA tensors, got {dev}")
    if not kernel_supports(n, e_cap):
        raise ValueError(
            f"la_walk: the kernel runs at the sizes walk mode admits "
            f"(n <= {_HALF}, e_cap up to the walk gate's edge); got "
            f"e_cap={e_cap}, n={n}"
        )
    fn = _kernel_lib().la_walk_launch
    e1 = e_cap + 1
    pitch = -(-e1 // 8) * 8
    la = torch.empty((e1, w), dtype=I32, device=dev)
    cols = torch.empty((w, pitch), dtype=torch.int16, device=dev)  # scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(sp.data_ptr(), op.data_ptr(), creator.data_ptr(),
                seq.data_ptr(), n_events.data_ptr(), e1, c0, w,
                la.data_ptr(), cols.data_ptr(), pitch,
                None if prof is None else prof.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"la_walk: kernel launch failed, cudaError_t {rc}")
    la_walk.launches += 1
    return la


def la_walk_plain(sp: torch.Tensor, op: torch.Tensor, creator: torch.Tensor,
                  seq: torch.Tensor, n_events, e_cap: int,
                  n: int, c0: int = 0, w: int = None) -> torch.Tensor:
    """The same recurrence in plain torch: a Python loop over the slots
    with one row max and one own-column set each, on the device of the
    inputs, over columns ``[c0, c0 + w)`` (all by default).  A parent
    outside ``[0, E+1)``, or not yet written, is missing (-1); the own
    column and its value are the TPU kernel's (``own_lane_and_value``)."""
    e1 = e_cap + 1
    w = n if w is None else w
    dev = sp.device
    ne = min(max(int(n_events), 0), e1)
    la = torch.full((e1, w), -1, dtype=I32, device=dev)
    missing = torch.full((w,), -1, dtype=I32, device=dev)
    lane, value = own_lane_and_value(creator[:ne], seq[:ne])
    sp_l, op_l = sp[:ne].tolist(), op[:ne].tolist()
    lane_l, value_l = (lane - c0).tolist(), value.tolist()
    for x in range(ne):
        s, o, c = sp_l[x], op_l[x], lane_l[x]
        row = torch.maximum(la[s] if 0 <= s < e1 else missing,
                            la[o] if 0 <= o < e1 else missing)
        if 0 <= c < w:
            row[c] = value_l[x]
        la[x] = row
    return la
