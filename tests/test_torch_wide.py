"""The port's column-blocked wide pipeline (``ops/wide.py``) and its
blocked strongly-see count (``ops/ss.py ss_counts_acc``, the plain twin
of ``csrc/ss_count.cu``) against the JAX package's ``ops/wide.py``, on
the CPU.

The JAX package's ``tests/test_wide.py`` and the wide case of
``tests/test_coord16.py`` run here against JAX's own wide pipeline, with
forced blocking at C = 2, 3 and 8 (ragged last blocks included) and at
int8, int16 and int32 coordinates: every consensus tensor (la and fd
too, where assembled) is compared exactly.

The JAX package is imported inside the tests, so that the gpu-marked
kernel test can be collected on the card's machine, which has no JAX:

    python -m pytest tests/test_torch_wide.py -m gpu --noconftest

``python -m tests.test_torch_wide`` (with ``JAX_PLATFORMS=cpu``) prints
``WIDE_EXPECT`` for ``chip_smoke.py`` phase 12(b): the JAX package's
``run_wide_pipeline`` at BASELINE config 3 (1024 x 100k, r_cap 16,
int32) and its ``stream_consensus`` over ``chip_smoke.WIDE_STREAM``.
"""

import json

import numpy as np
import pytest
import torch

from babble_tpu_torch import batch_from_arrays, random_gossip_arrays
from babble_tpu_torch.ops import ss as pss
from babble_tpu_torch.ops import wide as W
from babble_tpu_torch.ops.state import DagConfig

CPU = "cpu"
FIELDS = ("la", "fd", "round", "witness", "rr", "cts", "wslot", "famous",
          "lcr", "max_round", "n_events", "ce", "cnt", "seq", "creator")


def _jax():
    import babble_tpu.ops.state as jstate
    import babble_tpu.ops.wide as jwide
    import babble_tpu.sim.arrays as jarrays

    return jstate, jwide, jarrays


def _both(n, e, seed, C=None, assemble=True, **cfg_kw):
    """The JAX package's and the port's run_wide_pipeline on
    random_gossip_arrays(n, e, seed)."""
    jstate, jwide, jarrays = _jax()
    jd = jarrays.random_gossip_arrays(n, e, seed=seed)
    kw = dict(n=n, e_cap=e, s_cap=jd.max_chain + 2, **cfg_kw)
    jt, pt, js, ps = {}, {}, {}, {}
    ref = jwide.run_wide_pipeline(jstate.DagConfig(**kw),
                                  jarrays.batch_from_arrays(jd), n_blocks=C,
                                  timings=jt, stats=js, assemble=assemble)
    pd = random_gossip_arrays(n, e, seed=seed)
    got = W.run_wide_pipeline(DagConfig(**kw),
                              batch_from_arrays(pd, device=CPU), n_blocks=C,
                              timings=pt, stats=ps, assemble=assemble)
    assert set(pt) == set(jt) == {"coords", "rounds", "fame", "order"}
    assert ps == js
    return ref, got


def _eq(ref, got, label, fields=FIELDS):
    for f in fields:
        a = getattr(ref, f)
        b = getattr(got, f)
        if a is None or b is None:
            assert a is None and b is None, (label, f)
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (label, f)
        assert (a == b).all(), (f"{label}: {f} differs on "
                                f"{int((a != b).sum())} entries")


@pytest.mark.parametrize("n,e,r_cap,seed",
                         [(8, 200, 32, 1), (16, 500, 32, 2),
                          (48, 3000, 64, 4)])
def test_wide_pipeline_equals_jax(n, e, r_cap, seed):
    """tests/test_wide.py's shapes, one block: every consensus tensor,
    the phase timings' keys and the stats equal JAX's."""
    ref, got = _both(n, e, seed, r_cap=r_cap)
    _eq(ref, got, f"wide n={n}")
    assert int((got.rr[:e] >= 0).sum()) > 0


@pytest.mark.parametrize("C,narrow", [
    (2, {}), (3, {}), (8, {}),
    (3, dict(coord16=True)), (8, dict(coord16=True)),
    (2, dict(coord8=True)), (8, dict(coord8=True)),
])
def test_wide_pipeline_forced_blocks_equal_jax(C, narrow):
    """Forced column blocking, the last block ragged (22 columns in 2, 3
    or 8 blocks), at int32, int16 and int8 coordinates: the blocked
    partial counts, the clamped block-column gathers (hazard (a)) and
    the blocked median equal JAX's."""
    ref, got = _both(22, 900, 17, C=C, r_cap=32, **narrow)
    _eq(ref, got, f"C={C} {narrow}")
    assert int(got.lcr) >= 0


def test_wide_pipeline_coord8_unassembled():
    """tests/test_wide.py's coord8 case: ``assemble=False`` leaves la/fd
    None, as in JAX, and the consensus fields equal JAX's."""
    ref, got = _both(16, 700, 19, C=2, assemble=False, r_cap=32,
                     coord8=True)
    assert got.la is None and got.fd is None
    _eq(ref, got, "coord8 unassembled")
    assert int(got.lcr) >= 0


def test_coord16_wide_equals_jax_and_int32():
    """tests/test_coord16.py's wide case: int16 coordinates through the
    wide pipeline give JAX's tensors, and int32's consensus fields."""
    ref, got = _both(24, 1200, 22, r_cap=32, coord16=True)
    _eq(ref, got, "coord16")
    _, wide32 = _both(24, 1200, 22, r_cap=32)
    for f in ("round", "witness", "rr", "cts", "famous", "lcr"):
        assert torch.equal(getattr(got, f), getattr(wide32, f)), f
    assert torch.equal(got.la.to(torch.int32), wide32.la)


def test_block_rules_equal_jax():
    """wide_wins, block_count and the block width follow JAX's rules (1
    GiB blocks), so the forced-blocking shapes and BASELINE config 5's
    6 blocks of 1,667 columns are the same."""
    jstate, jwide, _ = _jax()
    for kw in (dict(n=1024, e_cap=100_000, s_cap=131, r_cap=16),
               dict(n=10_000, e_cap=100_000, s_cap=32, r_cap=8),
               dict(n=10_000, e_cap=620_000, s_cap=110, r_cap=16,
                    coord8=True),
               dict(n=10_000, e_cap=620_000, s_cap=110, r_cap=16,
                    coord16=True),
               dict(n=22, e_cap=900, s_cap=40, r_cap=32)):
        jc, pc = jstate.DagConfig(**kw), DagConfig(**kw)
        assert W.wide_wins(pc) == jwide.wide_wins(jc), kw
        assert W.block_count(pc) == jwide.block_count(jc), kw
        C = W.block_count(pc)
        assert W._block_width(pc, C) == jwide._block_width(jc, C)
        assert W._use_onehot_partial(pc) is False
    cfg5 = DagConfig(n=10_000, e_cap=620_000, s_cap=110, r_cap=16,
                     coord8=True)
    assert (W.block_count(cfg5), W._block_width(cfg5, 6)) == (6, 1667)


def test_ss_counts_acc_plain_twin():
    """On CPU tensors ``ss_counts_acc`` adds ``ss_counts_compare`` into
    ``acc`` in place (signed compares, -1 and fd_inf included), over one
    block or a stacked [C, rows, w] pair; bad arguments raise."""
    gen = np.random.default_rng(5)
    for dt, inf in ((torch.int8, 127), (torch.int16, 32767),
                    (torch.int32, 2**31 - 1)):
        a = torch.from_numpy(gen.integers(-1, 40, (3, 37, 29))).to(dt)
        b = torch.from_numpy(gen.integers(-1, 45, (3, 41, 29))).to(dt)
        b[b >= 40] = inf
        acc = torch.from_numpy(gen.integers(0, 9, (37, 41))).to(torch.int32)
        want = acc.clone()
        for c in range(3):
            want += pss.ss_counts_compare(a[c], b[c])
        out = pss.ss_counts_acc(a, b, acc)
        assert out is acc and torch.equal(acc, want)
        one = torch.zeros((37, 41), dtype=torch.int32)
        pss.ss_counts_acc(a[1], b[1], one)
        assert torch.equal(one, pss.ss_counts_compare(a[1], b[1]))
    z = torch.zeros((4, 5), dtype=torch.int32)
    r8 = torch.zeros((4, 3), dtype=torch.int8)
    s8 = torch.zeros((5, 3), dtype=torch.int8)
    for args in ((r8, s8.to(torch.int16), z), (r8, s8, z.to(torch.int64)),
                 (r8, s8, z[:3]), (r8, s8[:, :2], z),
                 (r8.to(torch.int64), s8.to(torch.int64), z),
                 (r8[None], s8, z)):
        with pytest.raises(ValueError):
            pss.ss_counts_acc(*args)
    assert pss.ss_counts_acc.launches == 0


@pytest.mark.gpu
def test_ss_count_kernel_equals_its_twin_on_the_card():
    """``csrc/ss_count.cu`` against ``ss_counts_compare`` on the card,
    exactly, at every coordinate type with ragged rows and columns and
    the -1 / fd_inf sentinels present, one block and stacked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(7)
    for dt, inf in ((torch.int8, 127), (torch.int16, 32767),
                    (torch.int32, 2**31 - 1)):
        for g, A, B, w in ((1, 65, 63, 1), (1, 130, 257, 1667),
                           (3, 1000, 77, 333), (2, 64, 64, 64)):
            a = torch.randint(-1, 110, (g, A, w), generator=gen).to(dt)
            b = torch.randint(-1, 120, (g, B, w), generator=gen).to(dt)
            b[b >= 110] = inf
            acc0 = torch.randint(0, 5, (A, B), generator=gen,
                                 dtype=torch.int32)
            want = acc0.clone()
            for c in range(g):
                want += pss.ss_counts_compare(a[c], b[c])
            before = pss.ss_counts_acc.launches
            got = pss.ss_counts_acc(a.cuda(), b.cuda(), acc0.cuda())
            torch.cuda.synchronize()
            assert pss.ss_counts_acc.launches == before + 1
            assert torch.equal(got.cpu(), want), (dt, g, A, B, w)
    with pytest.raises(ValueError):
        pss.ss_counts_acc(a.cuda()[..., ::2], b.cuda()[..., ::2],
                          torch.zeros((A, B), dtype=torch.int32,
                                      device="cuda"))


# ----------------------------------------------------------------------
# chip_smoke.py phase 12(b)'s reference


def test_chip_smokes_wide_summaries_on_small_runs():
    """chip_smoke.py phase 12(b) holds the card to ``WIDE_EXPECT``, this
    file's ``main`` over BASELINE config 3 and ``WIDE_STREAM``: the same
    summaries of a JAX and a port run, here at small shapes."""
    import chip_smoke
    from babble_tpu.ops.stream import stream_consensus as jstream

    from babble_tpu_torch.ops.stream import stream_consensus

    ref, got = _both(24, 900, 5, C=3, r_cap=32, assemble=False)
    assert chip_smoke.pipeline_summary(ref) == \
        chip_smoke.pipeline_summary(got)
    jstate, _, jarrays = _jax()
    kw = dict(n=24, e_cap=1400, s_cap=110, r_cap=16, coord8=True)
    run = dict(batch_events=350, n_blocks=3, seq_window=16, compact_min=64)
    js = jstream(jstate.DagConfig(**kw),
                 jarrays.random_gossip_arrays(24, 2800, seed=13), **run)
    ps = stream_consensus(DagConfig(**kw),
                          random_gossip_arrays(24, 2800, seed=13),
                          device=CPU, **run)
    assert ps.evicted > 0
    assert chip_smoke.stream_summary(js) == chip_smoke.stream_summary(ps)
    assert chip_smoke.WIDE_FULL == dict(n=1024, e=100_000, seed=7,
                                        r_cap=16)


def main() -> None:
    import chip_smoke
    from babble_tpu.ops.stream import stream_consensus as jstream

    jstate, jwide, jarrays = _jax()
    f = chip_smoke.WIDE_FULL
    dag = jarrays.random_gossip_arrays(f["n"], f["e"], seed=f["seed"])
    cfg = jstate.DagConfig(n=f["n"], e_cap=f["e"], s_cap=dag.max_chain + 3,
                           r_cap=f["r_cap"])
    out = jwide.run_wide_pipeline(cfg, jarrays.batch_from_arrays(dag),
                                  assemble=False)
    full = chip_smoke.pipeline_summary(out)
    del out, dag
    s = chip_smoke.WIDE_STREAM
    dag = jarrays.random_gossip_arrays(s["n"], s["e"], seed=s["seed"])
    stream = jstream(jstate.DagConfig(**s["cfg"]), dag, **s["run"])
    print("WIDE_EXPECT = " + json.dumps(
        {"full": full, "stream": chip_smoke.stream_summary(stream)}))


if __name__ == "__main__":
    main()
