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


@pytest.mark.parametrize("dt", [torch.int8, torch.int16])
def test_padded_rows_leave_the_count_unchanged(dt):
    """The packed kernel's layout (``padded_rows``): rows padded to 16
    bytes with the type's minimum on the A side and its maximum on the B
    side count nothing, at widths 1, 3, 527 and 1,667, with the type's
    minimum and maximum present among the real values on both sides,
    over gathered rows and a strided view."""
    info = torch.iinfo(dt)
    gen = np.random.default_rng(12)
    for w in (1, 3, 527, 1667):
        vals = gen.integers(info.min, info.max + 1, (2, 19, w + 5))
        vals[:, :3, :2] = info.min
        vals[:, 3:6, :2] = info.max
        vals[:, 6:9, -2:] = info.max
        vals[:, 9:12, -2:] = info.min
        full = torch.from_numpy(vals).to(dt)
        a = full[:, :, 5:]                                    # strided view
        b = full[:, torch.tensor([18, 3, 3, 0, 11, 7, 9]), :w]  # gathered
        pa, pb = pss.padded_rows(a, "a"), pss.padded_rows(b, "b")
        per16 = 16 // a.element_size()
        assert pa.shape[2] == pb.shape[2] == -(-w // per16) * per16
        assert pa.shape[:2] == a.shape[:2] and pb.shape[:2] == b.shape[:2]
        assert torch.equal(pa[..., :w], a) and torch.equal(pb[..., :w], b)
        assert (pa[..., w:] == info.min).all()
        assert (pb[..., w:] == info.max).all()
        for c in range(2):
            assert torch.equal(pss.ss_counts_compare(pa[c], pb[c]),
                               pss.ss_counts_compare(a[c], b[c])), (w, c)


@pytest.mark.gpu
def test_ss_count_kernel_equals_its_twin_on_the_card():
    """``csrc/ss_count.cu`` against ``ss_counts_compare`` on the card,
    exactly, from a non-zero starting tally, at every coordinate type:
    ragged rows and columns with the -1 / fd_inf sentinels; widths that
    are not a multiple of 4 or of 16 bytes (1, 3, 13, 22, 37, 333, 527,
    1,667); rows and columns under one 128 x 128 tile and not a multiple
    of it; stacked G = 2, 3, 4; the type's minimum and maximum on both
    sides (la = max against fd = min and the reverse); gathered rows
    with a row stride off a 4-byte boundary and strided views.  Every
    call is one counted launch, and columns that are not contiguous
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    gen = torch.Generator().manual_seed(7)
    dev = torch.device("cuda")
    for dt in (torch.int8, torch.int16, torch.int32):
        for name, a, b, acc0 in chip_smoke.ss_count_cases(dt, gen):
            want = acc0.clone()
            a3 = a if a.dim() == 3 else a[None]
            b3 = b if b.dim() == 3 else b[None]
            for c in range(a3.shape[0]):
                want += pss.ss_counts_compare(a3[c], b3[c])
            ca, cb = chip_smoke.card_view(a, dev), chip_smoke.card_view(b, dev)
            assert ca.stride() == a.stride()
            before = pss.ss_counts_acc.launches
            got = pss.ss_counts_acc(ca, cb, acc0.cuda())
            torch.cuda.synchronize()
            assert pss.ss_counts_acc.launches == before + 1
            assert torch.equal(got.cpu(), want), (dt, name)
    A, B = a.shape[-2], b.shape[-2]
    with pytest.raises(ValueError):
        pss.ss_counts_acc(a.cuda()[..., ::2], b.cuda()[..., ::2],
                          torch.zeros((A, B), dtype=torch.int32,
                                      device="cuda"))


@pytest.mark.parametrize("dt", [torch.int8, torch.int16, torch.int32])
def test_ss_count_cases_hold_on_the_cpu_twin(dt):
    """chip_smoke.py's ``ss_count_cases`` (the card test's and phase
    12(a)'s cases): each names its shape, keeps the strides it was built
    with (gathered rows with a row stride off 4 bytes, strided views),
    and on the CPU ``ss_counts_acc`` adds exactly ``sum_g
    ss_counts_compare`` to its starting tally; for int8 and int16 the
    packed kernel's padded rows count the same."""
    import chip_smoke

    gen = torch.Generator().manual_seed(7)
    cases = chip_smoke.ss_count_cases(dt, gen)
    assert len(cases) == 13
    strides = {name: (a.stride(), b.stride()) for name, a, b, _ in cases}
    assert strides["gathered rows 190x170x527"] == ((527, 1), (527, 1))
    assert strides["strided views 300x150x530"] == ((531, 1), (1062, 1))
    for name, a, b, acc0 in cases:
        a3 = a if a.dim() == 3 else a[None]
        b3 = b if b.dim() == 3 else b[None]
        want = acc0.clone()
        for c in range(a3.shape[0]):
            want += pss.ss_counts_compare(a3[c], b3[c])
        assert torch.equal(pss.ss_counts_acc(a, b, acc0.clone()), want), name
        assert chip_smoke.card_view(a, torch.device(CPU)).stride() == \
            a.stride()
        if dt != torch.int32:
            pa, pb = pss.padded_rows(a3, "a"), pss.padded_rows(b3, "b")
            got = acc0.clone()
            for c in range(a3.shape[0]):
                got += pss.ss_counts_compare(pa[c], pb[c])
            assert torch.equal(got, want), name


def test_chip_smokes_ss_count_bound():
    """``chip_smoke.ss_count_bound`` counts one 32-bit word pair (4 int8,
    2 int16 or 1 int32 pairs) a lane operation of one pipe at 64 a clock
    an SM: 1.575 ms at the 10k run's 10,000 x 10,000 x 527 int16 shape,
    2.491 ms at bench's 1,667-wide int8 block, 3.151 ms for the run's
    shape in int32; the bytes bound only where the rows are few."""
    import chip_smoke

    def ms(*args):
        t, by = chip_smoke.ss_count_bound(*args)
        return round(t, 3), by

    assert ms(1, 10_000, 10_000, 527, 2) == (1.575, "operations")
    assert ms(1, 10_000, 10_000, 1667, 1) == (2.491, "operations")
    assert ms(1, 10_000, 10_000, 527, 4) == (3.151, "operations")
    assert ms(19, 10_000, 10_000, 527, 2) == (29.931, "operations")
    assert ms(1, 1, 1, 1 << 20, 1)[1] == "bytes"


_SASS = """
\t\tFunction : _Z6kernelv
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   IMAD.IADD R8, R4, 0x1, R5 ;
        /*0030*/                   IADD3 R9, R4, R6, -0x7fff8000 ;
        /*0040*/                   LOP3.LUT R10, R7, R6, R8, 0xe8, !PT ;
        /*0050*/                   IDP.4A.U8.U8 R11, R10, UR4, R11 ;
        /*0060*/              @P0 BRA 0x10 ;
        /*0070*/                   IMAD.MOV.U32 R3, RZ, RZ, R2 ;
        /*0080*/              @!P1 BRA 0x0 ;
        /*0090*/                   EXIT ;
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_chip_smokes_sass_reader_finds_the_inner_loop(monkeypatch, capsys):
    """``chip_smoke.sass_listing`` reads ``cuobjdump -sass``: opcodes
    without modifiers but IMAD's, predicates skipped, branch targets;
    ``kernel_sass`` reports the backward branch's body densest in IDP,
    per IDP."""
    import chip_smoke

    class Done:
        stdout = _SASS

    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: Done())
    from babble_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build, "nvcc", lambda: "/cuda/bin/nvcc")
    got = chip_smoke.sass_listing("lib.so", "kernel")
    assert list(got) == ["_Z6kernelv"]
    assert [op for _, op, _ in got["_Z6kernelv"]] == [
        "LDC", "LDS", "IMAD.IADD", "IADD3", "LOP3", "IDP", "BRA",
        "IMAD.MOV", "BRA", "EXIT"]
    assert got["_Z6kernelv"][6] == (0x60, "BRA", 0x10)
    chip_smoke.kernel_sass("lib.so", "kernel", "t")
    out = capsys.readouterr().out
    assert "10 instructions; compare loop 6: LOP3 1, IADD3 1, " \
        "IMAD.IADD 1, IDP 1, LDS 1, BRA 1; per IDP: 6.000 instructions, " \
        "ALU pipe 2.000, FMA pipe 2.000, LDS 1.000" in out


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
