"""The port's native host code (``babble_tpu_torch/native/``) against the
JAX package's, on the CPU with g++.

- the C++ sources are the JAX package's, byte for byte;
- the loader builds each library into a hash-named file, raises when the
  compiler is missing or refuses, and survives two processes building
  one library at once;
- the C++ generator equals its pure-Python twin and the JAX package's
  generator (native and Python), and the C++ schedule the numpy one;
- the port's C++ baseline equals the JAX package's in every array;
- the port's batch step, in modes ``"full"``, ``"fast"`` and ``"walk"``,
  equals the baseline (``tests/test_arrays.py``'s shapes), with the
  diagonal fame's strongly-see counts chunked as config 3's width needs
  them.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from babble_tpu import native as jnative
from babble_tpu.sim import arrays as jarrays

import chip_smoke
from babble_tpu_torch import (
    DagConfig, batch_from_arrays, consensus_step, init_state, native,
)
from babble_tpu_torch.ops import fame
from babble_tpu_torch.ops.pallas_ingest import walk_supported
from babble_tpu_torch.sim import arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
FIELDS = chip_smoke.ARRAY_FIELDS
BASELINE_SHAPES = [(4, 200, 0), (8, 500, 3), (16, 1500, 9)]


def _eq_dags(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f"{what} {f}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    assert (a.n, a.max_chain, a.n_levels) == (b.n, b.max_chain, b.n_levels)


@pytest.mark.parametrize("name", ["graph_builder", "baseline_consensus"])
def test_sources_are_the_jax_packages_bytes(name):
    with open(native.source_path(name), "rb") as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(jnative.__file__),
                           f"{name}.cpp"), "rb") as f:
        assert ours == f.read()


def test_build_into_a_directory_and_into_build(tmp_path, monkeypatch):
    """Each library builds into a file named by its source's hash, is
    reused once built, and loads; by default into
    ``babble_tpu_torch/_build/``."""
    import ctypes
    import hashlib

    default = native.BUILD_DIR
    assert default == os.path.join(REPO, "babble_tpu_torch", "_build")
    names = ("graph_builder", "baseline_consensus")
    with monkeypatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", str(tmp_path))
        for name in names:
            path = native.build(name)
            with open(native.source_path(name), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:12]
            assert path == str(tmp_path / f"lib{name}-{digest}.so")
            mtime = os.stat(path).st_mtime_ns
            assert native.build(name) == path
            assert os.stat(path).st_mtime_ns == mtime
            ctypes.CDLL(path)
        assert sorted(os.listdir(tmp_path)) == sorted(
            os.path.basename(native.library_path(n)) for n in names)
    native.load()
    native.load_baseline()
    assert native.available()
    for name in names:
        assert os.path.dirname(native.library_path(name)) == default
        assert os.path.exists(native.library_path(name))


def test_a_missing_or_refusing_compiler_raises(tmp_path, monkeypatch):
    """No silent None: the JAX loader returns None when the build fails,
    the port's raises with the compiler's own words."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-gxx"))
    with pytest.raises(RuntimeError, match="no-gxx"):
        native.load()
    with pytest.raises(RuntimeError, match="no-gxx"):
        arrays.random_gossip_arrays(4, 20, seed=1)
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.load_baseline()
    assert os.listdir(tmp_path / "b") == []        # no half-written file
    # the twin needs no compiler
    assert arrays.random_gossip_arrays(4, 20, seed=1,
                                       force_python=True).n_events == 20


_RACE = r"""
import os, sys, time
from babble_tpu_torch import native
from babble_tpu_torch.sim.arrays import random_gossip_arrays
native.BUILD_DIR = sys.argv[1]
open(os.path.join(sys.argv[2], "ready" + sys.argv[3]), "w").close()
while not os.path.exists(os.path.join(sys.argv[2], "go")):
    time.sleep(0.01)
print(native.baseline_consensus(random_gossip_arrays(8, 500, seed=3))[0])
"""


def test_two_processes_build_one_library_at_once(tmp_path):
    """Two processes reach an empty build directory together: each
    builds both libraries into a temporary file and renames it into
    place, and each loads a whole library."""
    build, sync = tmp_path / "build", tmp_path / "sync"
    sync.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, str(build), str(sync), str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        for i in range(2):
            for _ in range(1200):
                if (sync / f"ready{i}").exists() or procs[i].poll() is not None:
                    break
                time.sleep(0.05)
        (sync / "go").touch()
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "370"
    assert sorted(os.listdir(build)) == sorted(
        os.path.basename(native.library_path(n))
        for n in ("graph_builder", "baseline_consensus"))


@pytest.mark.parametrize("n,e,seed", [
    (64, 4096, 7), (1024, 6000, 7), (4, 200, 0), (16, 1500, 9), (8, 5, 2),
    (2, 300, 11),
])
def test_generators_and_schedules_equal(n, e, seed):
    """The C++ generator == its Python twin == the JAX package's
    generator, native and Python; the C++ schedule == the numpy one ==
    the JAX package's."""
    cpp = arrays.random_gossip_arrays(n, e, seed=seed)
    twin = arrays.random_gossip_arrays(n, e, seed=seed, force_python=True)
    _eq_dags(cpp, twin, "port C++ vs twin")
    for force in (False, True):
        _eq_dags(cpp, jarrays.random_gossip_arrays(
            n, e, seed=seed, force_python=force), f"JAX force={force}")
    sched = arrays.build_schedule(cpp.levels)
    assert sched.dtype == np.int32
    np.testing.assert_array_equal(
        sched, arrays.build_schedule_numpy(cpp.levels))
    np.testing.assert_array_equal(sched, jarrays.build_schedule(cpp.levels))
    wide = arrays.build_schedule(cpp.levels, cpp.n_levels + 3)
    np.testing.assert_array_equal(
        wide, arrays.build_schedule_numpy(cpp.levels, cpp.n_levels + 3))


def test_build_schedule_refuses_levels_outside_its_rows():
    lv = np.array([0, 1, 2, 1], np.int32)
    with pytest.raises(ValueError, match="levels outside"):
        arrays.build_schedule(lv, 2)
    with pytest.raises(ValueError, match="levels outside"):
        arrays.build_schedule(np.array([0, -1], np.int32))


@pytest.mark.parametrize("n,e,seed", BASELINE_SHAPES)
def test_baseline_equals_jax(n, e, seed):
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    ordered, got = native.baseline_consensus(dag)
    jordered, want = jnative.baseline_consensus(dag)
    assert ordered == jordered > 0
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _hold_step(n, e, seed, mode, r_cap=64):
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=dag.max_chain + 1, r_cap=r_cap)
    if mode == "walk":
        assert walk_supported(cfg.n, cfg.e_cap, cfg.s_cap)
    out = consensus_step(cfg, mode, init_state(cfg, device=CPU),
                         batch_from_arrays(dag, device=CPU))
    base = native.baseline_consensus(dag)
    assert chip_smoke.hold_to_baseline(f"{mode} {n}x{e}", out, base,
                                       e) == base[0]
    return out, base


@pytest.mark.parametrize("mode", ["full", "fast", "walk"])
@pytest.mark.parametrize("n,e,seed", BASELINE_SHAPES)
def test_step_equals_baseline(n, e, seed, mode):
    """The port's ``test_cpp_baseline_matches_tpu_engine``: rounds,
    witnesses, round received, consensus timestamps where received and
    witness fame through the wslot table; on the CPU ``"walk"`` runs
    la_walk's twin."""
    _, (ordered, _) = _hold_step(n, e, seed, mode)
    assert ordered > 0


def test_hold_to_baseline_names_the_first_field_that_differs():
    out, (ordered, base) = _hold_step(8, 500, 3, "fast")
    for field, slot in (("round", 7), ("rr", 9), ("cts", 0)):
        bad = {k: v.copy() for k, v in base.items()}
        if field == "cts":
            slot = int(np.flatnonzero(bad["rr"] >= 0)[0])
        bad[field][slot] += 1
        with pytest.raises(AssertionError, match=f": {field} differs"):
            chip_smoke.hold_to_baseline("x", out, (ordered, bad), 500)
    bad = {k: v.copy() for k, v in base.items()}
    bad["fame"][int(out.wslot[0, 0])] = 2 if bad["fame"][
        int(out.wslot[0, 0])] == 1 else 1
    with pytest.raises(AssertionError, match=": fame differs"):
        chip_smoke.hold_to_baseline("x", out, (ordered, bad), 500)
    with pytest.raises(AssertionError, match="ordered"):
        chip_smoke.hold_to_baseline("x", out, (ordered + 1, base), 500)


@pytest.mark.parametrize("budget", ["round by round", "three rounds"])
def test_diagonal_fame_in_chunks_equals_one_pass(budget, monkeypatch):
    """The diagonal fame's strongly-see counts in chunks of rounds, and
    round by round through ``ss_counts_compare`` (config 3's width: one
    round's [N, N, N] compare alone passes the budget), give the one
    pass's state."""
    n, e, seed = 8, 500, 3
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=dag.max_chain + 1, r_cap=64)
    from babble_tpu_torch.ops import ingest, state

    st = ingest.ingest_impl(cfg, init_state(cfg, device=CPU), "fast",
                            batch_from_arrays(dag, device=CPU))
    want = fame.decide_fame_impl(cfg, st)
    monkeypatch.setattr(fame, "SS_NEXT_CHUNK_ELEMS",
                        1 if budget == "round by round" else 3 * n ** 3)
    got = fame.decide_fame_impl(cfg, st)
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.equal(b), f
    assert (got.famous != state.FAME_UNDEFINED).any()


def test_diagonal_fame_at_config_3s_width_counts_round_by_round(monkeypatch):
    """At BASELINE config 3's width (1,024 creators) one round's [N, N,
    N] strongly-see compare alone passes the diagonal fame's budget, so
    the count runs round by round through ``ss_counts_compare``'s row
    chunks; in one pass it asked the CPU for 137 GB at r_cap 16 (the
    card has 80).  The step at that width is held to the baseline on
    the card (``chip_smoke.py`` phase 13(d))."""
    n, r_cap = 1024, 2
    assert fame.SS_NEXT_CHUNK_ELEMS // n ** 3 == 0
    calls = []
    orig = fame.ss_counts_compare

    def spy(a, b):
        calls.append(tuple(a.shape))
        return orig(a, b)

    monkeypatch.setattr(fame, "ss_counts_compare", spy)
    cfg = DagConfig(n=n, e_cap=64, s_cap=8, r_cap=r_cap)
    out = fame.decide_fame_impl(cfg, init_state(cfg, device=CPU))
    assert calls == [(n, n)] * r_cap
    assert out.famous.shape == (r_cap + 1, n)
