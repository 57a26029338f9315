"""The fork pipeline's two level scans (``ops/forks.py level_scan``):
``csrc/fork_levels.cu`` on the card, its plain twin on the CPU.

On the CPU: the wrapper takes the plain twin for CPU tensors and
refuses what the kernel does not take; a numpy model of the kernel's
rule (a block walks the rows in order, pad lanes and missing parents do
nothing, fd skips an INF row) equals the plain loops after the
sentinel reset, on every ``chip_smoke.LEVEL_CASES`` case; a column
range scans as the whole table's columns; the pipeline's spans name
the plain form.  Marked ``gpu`` (each skips itself without a card):
the kernel equals the plain twin bit for bit on every case and at the
byzantine cell's shape, and ``fork_pipeline`` launches it twice a call
in fd mode "reverse".

    python -m pytest tests/test_torch_fork_levels.py -q
    python -m pytest tests/test_torch_fork_levels.py -m gpu --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu_torch.obs import spans
from babble_tpu_torch.ops import forks as F
from babble_tpu_torch.ops.state import INT32_MAX
from babble_tpu_torch.sim.arrays import random_byzantine_fork_arrays
from chip_smoke import BYZ_SMALL, LEVEL_CASES, level_case, level_results

CASES = [pytest.param(opts, id=name) for name, opts in LEVEL_CASES]


@pytest.fixture
def ring(monkeypatch):
    """A fresh process-wide stage ring for one test."""
    tr = spans.SpanTracer(capacity=spans.STAGE_CAPACITY, counters=True)
    monkeypatch.setattr(spans, "STAGES", tr)
    return tr


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernel_rule(cfg, b, seed, reverse):
    """What one block of the kernel does to its columns, in numpy: the
    rows in order (deepest first for fd), each slot's lanes against its
    parents; a pad lane or a missing parent does nothing and fd skips a
    row of INF cells; the sentinel row is then reset."""
    t = seed.numpy().copy()
    rows = t.shape[0]
    sched, sp, op = (x.numpy() for x in (b.sched, b.sp, b.op))
    order = range(len(sched) - 1, -1, -1) if reverse else range(len(sched))
    for r in order:
        for s in sched[r]:
            if not 0 <= s < rows:
                continue
            parents = [p for p in (sp[s], op[s]) if 0 <= p < rows]
            if not reverse:
                for p in parents:
                    t[s] = np.maximum(t[s], t[p])
            else:
                for p in parents:
                    t[p] = np.minimum(t[p], t[s])
    t[cfg.e_cap] = INT32_MAX if reverse else -1
    return torch.from_numpy(t)


@pytest.mark.parametrize("opts", CASES)
def test_level_scan_takes_the_plain_twin_on_the_cpu(opts):
    cfg, b, seeds = level_case(opts)
    for reverse in (False, True):
        got, want, launched = level_results(cfg, b, seeds[reverse], reverse)
        assert launched == 0
        assert torch.equal(got, want)


@pytest.mark.parametrize("opts", CASES)
def test_kernel_rule_equals_the_plain_loops(opts):
    """The kernel's design argument, checked without a card: skipping
    pads and missing parents, in row order, gives the plain loops'
    tables once the sentinel row is reset."""
    cfg, b, seeds = level_case(opts)
    for reverse in (False, True):
        _, want, _ = level_results(cfg, b, seeds[reverse], reverse)
        got = _kernel_rule(cfg, b, seeds[reverse], reverse)
        assert torch.equal(got, want), "fd" if reverse else "la"
        if b.sched.shape[0]:
            assert not torch.equal(want, seeds[reverse]), "nothing scanned"


def test_column_range_scans_as_the_whole_tables_columns():
    """No step crosses columns, so a rank's range [lo, hi) scans to the
    whole table's columns there (the sharded fork step's tables)."""
    opts = dict(kind="arrays")
    cfg, b, whole = level_case(opts)
    for lo, hi in ((6, 28), (0, 32), (32, 64), (62, 64)):
        _, part = level_case(dict(opts, lo=lo, hi=hi))[1:]
        for reverse in (False, True):
            full = level_results(cfg, b, whole[reverse], reverse)[1]
            got = level_results(cfg, b, part[reverse], reverse)[1]
            assert torch.equal(got, full[:, lo:hi]), (lo, hi, reverse)


BAD_TABLES = {
    "int64": lambda la: la.long(),
    "1-d": lambda la: la[:, 0].contiguous(),
    "non-contiguous": lambda la: la.T.contiguous().T,
    "strided columns": lambda la: la[:, ::2],
    "rows": lambda la: la[:-1].contiguous(),
    "columns past B": lambda la: torch.cat([la, la[:, :2]], 1),
}
BAD_BATCHES = {
    "sched int64": lambda b: b._replace(sched=b.sched.long()),
    "sched 1-d": lambda b: b._replace(sched=b.sched.reshape(-1)),
    "sp int64": lambda b: b._replace(sp=b.sp.long()),
    "op rows": lambda b: b._replace(op=b.op[:-1]),
}


@pytest.mark.parametrize("bad", list(BAD_TABLES))
def test_level_scan_refuses_a_table_the_kernel_does_not_take(bad):
    cfg, b, seeds = level_case(dict(kind="arrays"))
    with pytest.raises(ValueError, match="level_scan"):
        F.level_scan(BAD_TABLES[bad](seeds[False]), b, cfg, False)


@pytest.mark.parametrize("bad", list(BAD_BATCHES))
def test_level_scan_refuses_a_schedule_the_kernel_does_not_take(bad):
    cfg, b, seeds = level_case(dict(kind="arrays"))
    with pytest.raises(ValueError, match="level_scan"):
        F.level_scan(seeds[True], BAD_BATCHES[bad](b), cfg, True)


def test_pipeline_spans_name_the_plain_scans_on_the_cpu(ring):
    cfg, arrays = random_byzantine_fork_arrays(10, 700, seed=3,
                                               fork_rate=0.06, r_cap=16)
    before = F.level_scan.launches
    out = F.fork_pipeline(cfg, F.fork_batch_from_numpy(arrays, "cpu"))
    assert F.level_scan.launches == before
    by = {c["name"]: c["attrs"] for c in ring.trees()[1]["children"]}
    assert by["fork.la_scan"]["impl"] == "plain"
    assert by["fork.fd"]["impl"] == "plain"
    assert int(out.lcr) >= 0


# ----------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("opts", CASES)
def test_fork_levels_kernel_matches_plain(opts):
    _need_card()
    cfg, b, seeds = level_case(opts, "cuda")
    for reverse in (False, True):
        got, want, launched = level_results(cfg, b, seeds[reverse], reverse)
        torch.cuda.synchronize()
        assert launched == (1 if b.sched.shape[0] else 0)
        assert torch.equal(got, want), "fd" if reverse else "la"


@pytest.mark.gpu
def test_fork_levels_at_the_cell_shape():
    """The byzantine cell's shape (n 1,024, 100,000 events, from the
    benchmark's frozen generator): exact in both directions, one launch
    each, nothing allocated by the launch."""
    _need_card()
    import json
    import os

    from port_bench.gen import byzantine

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "port_bench", "configs",
                           "byzantine-1024.json")) as f:
        conf = json.load(f)
    sizes, arrays = byzantine.random_byzantine_fork_arrays(
        conf["n"], 100_000, seed=2_900_000_001, **conf["generator"])
    cfg = F.ForkConfig(**sizes)
    b = F.fork_batch_from_numpy(arrays, "cuda")
    for reverse in (False, True):
        seed = F._own_rows(cfg, b, INT32_MAX if reverse else -1)
        work = seed.clone()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        F.level_scan(work, b, cfg, reverse)
        assert torch.cuda.max_memory_allocated() == before
        got, want, launched = level_results(cfg, b, seed, reverse)
        torch.cuda.synchronize()
        assert launched == 1
        assert torch.equal(got, want), "fd" if reverse else "la"


@pytest.mark.gpu
@pytest.mark.parametrize("mode,launches", [("reverse", 2), ("chains", 1)])
def test_fork_pipeline_launches_fork_levels_once_a_scan(ring, monkeypatch,
                                                        mode, launches):
    """A ``fork_pipeline`` call on the card launches the kernel for la
    and, in fd mode "reverse" (the byzantine cell's), for fd: two
    launches, named by the spans; every output equals the CPU's plain
    run."""
    _need_card()
    monkeypatch.setattr(F, "fd_reverse_scan_wins",
                        lambda *a: mode == "reverse")
    small = {k: v for k, v in BYZ_SMALL.items() if k not in ("n", "e")}
    cfg, arrays = random_byzantine_fork_arrays(BYZ_SMALL["n"],
                                               BYZ_SMALL["e"], **small)
    b = F.fork_batch_from_numpy(arrays, "cuda")
    ref = F.fork_pipeline(cfg, F.fork_batch_from_numpy(arrays, "cpu"))
    for _ in range(2):
        before = F.level_scan.launches
        out = F.fork_pipeline(cfg, b)
        assert F.level_scan.launches == before + launches
        for name in F.ForkOut._fields:
            assert torch.equal(getattr(out, name).cpu(), getattr(ref, name))
    pipe = [t for t in ring.trees() if t["name"] == "fork.pipeline"][-1]
    by = {c["name"]: c["attrs"] for c in pipe["children"]}
    assert by["fork.la_scan"]["impl"] == "kernel"
    assert by["fork.fd"]["mode"] == mode
    assert by["fork.fd"]["impl"] == ("kernel" if mode == "reverse"
                                     else "plain")
