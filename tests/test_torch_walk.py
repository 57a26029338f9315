"""The port's last-ancestor walk against the JAX package's Pallas kernel
(run in interpret mode, followed by ``unpack_la``) on seqs that do not
fit int16, on the CPU.

The TPU kernel packs ``meta = creator << 16 | max(seq, 0)`` in int32 and
stores ``int16(meta & 0xFFFF)`` in lane ``meta >> 16``: a seq of 32,768
or more reads back negative, and one of 65,536 or more spills into the
lane.  The walk step never meets such seqs (``walk_supported`` requires
``s_cap < 32767``), but ``la_walk`` must still give the reference's
table on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from babble_tpu.ops.pallas_ingest import la_walk as jax_la_walk
from babble_tpu.ops.pallas_ingest import unpack_la
from babble_tpu.ops.pallas_ingest import walk_supported as jax_walk_supported

from babble_tpu_torch.ops.pallas_ingest import (
    kernel_supports, la_walk, la_walk_plain, own_lane_and_value,
    walk_supported,
)
from babble_tpu_torch.sim.arrays import random_walk_arrays


def _repro():
    """Six events, creators 0 and 1 alternating, sp = x-2, op = x-1;
    creator 0's seqs are 40000, 40002, 40004."""
    e_cap, k = 16, 6
    x = np.arange(k)

    def pad(a, fill):
        out = np.full(e_cap + 1, fill, np.int32)
        out[:k] = a
        return out

    return dict(sp=pad(x - 2, -1), op=pad(x - 1, -1),
                creator=pad([0, 1, 0, 1, 0, 1], 4),
                seq=pad([40000, 1, 40002, 3, 40004, 5], -1)), 4, e_cap, k


def _synthetic(n, e, seq_base):
    return random_walk_arrays(n, e, seed=n + e, seq_base=seq_base), n, e, e


CASES = {
    "repro": _repro,
    "int16-wrap": lambda: _synthetic(4, 600, [32767, 40000, 0, 65535]),
    "lane-spill": lambda: _synthetic(8, 1000, [32700, 65500, 0, 40000,
                                               70000, 131000, 5, 65536]),
    "int32-top": lambda: _synthetic(3, 500, 2**31 - 400),
}


def _jax_la(a, n, e_cap, k):
    packed = jax_la_walk(e_cap, n, *(jnp.asarray(a[f]) for f in
                                     ("sp", "op", "creator", "seq")),
                         k, True)
    return np.asarray(unpack_la(e_cap, n, packed, k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_la_walk_matches_pallas_on_wrapped_seqs(case):
    a, n, e_cap, k = CASES[case]()
    want = _jax_la(a, n, e_cap, k)
    t = {f: torch.from_numpy(a[f]) for f in ("sp", "op", "creator", "seq")}
    ne = torch.tensor(k, dtype=torch.int32)
    args = (t["sp"], t["op"], t["creator"], t["seq"], ne, e_cap, n)
    np.testing.assert_array_equal(la_walk_plain(*args).numpy(), want)
    before = la_walk.launches
    np.testing.assert_array_equal(la_walk(*args).numpy(), want)
    assert la_walk.launches == before
    if case == "repro":
        # int16(40000) = -25536, which loses to a missing parent's -1
        assert want[0, 0] == -25536 and want[1, 0] == -1
        assert want[2, 0] == -25534 and want[3, 0] == -1


@pytest.mark.parametrize("case", sorted(CASES))
def test_own_lane_and_value_match_the_tpu_packing(case):
    a, n, e_cap, k = CASES[case]()
    meta = ((jnp.asarray(a["creator"]).astype(jnp.int32) << 16)
            | jnp.maximum(jnp.asarray(a["seq"]), 0).astype(jnp.int32))
    lane, value = own_lane_and_value(torch.from_numpy(a["creator"]),
                                     torch.from_numpy(a["seq"]))
    np.testing.assert_array_equal(lane.numpy(), np.asarray(meta >> 16))
    np.testing.assert_array_equal(
        value.numpy(), np.asarray((meta & 0xFFFF).astype(jnp.int16)))


def test_kernel_covers_the_walk_gate():
    """The wrapper launches the kernel at exactly the sizes walk mode
    admits (the card test holds it at the edge)."""
    edge = 94661
    for n in (1, 8, 64):
        assert walk_supported(n, edge, 1107) and jax_walk_supported(n, edge, 1107)
        assert not walk_supported(n, edge + 1, 1107)
        assert not jax_walk_supported(n, edge + 1, 1107)
        assert kernel_supports(n, edge)
        assert not kernel_supports(n, edge + 1)
    assert not kernel_supports(65, 1024)
    assert not kernel_supports(0, 1024)


def test_random_walk_arrays_shapes():
    a = random_walk_arrays(5, 300, seed=2, seq_base=[0, 10, 20, 30, 40],
                           n_events=250)
    assert all(v.dtype == np.int32 and v.shape == (301,) for v in a.values())
    x = np.arange(250)
    assert np.all(a["sp"][:250] < x) and np.all(a["op"][:250] < x)
    assert np.all(a["creator"][250:] == 5) and np.all(a["seq"][250:] == -1)
    for c in range(5):
        mine = np.flatnonzero(a["creator"][:250] == c)
        np.testing.assert_array_equal(a["seq"][mine],
                                      10 * c + np.arange(len(mine)))
        np.testing.assert_array_equal(a["sp"][mine][1:], mine[:-1])
