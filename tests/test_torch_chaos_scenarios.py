"""The port's chaos runner against the JAX package's, on the CPU.

Every scenario runs twice, once through JAX ``chaos.run_scenario`` and
once through the port's ``run_scenario(..., device="cpu")``, from the
same dict: the fingerprint (fault schedule, every node's committed and
consensus order), ``committed``, ``consensus``, ``epochs``,
``membership_logs`` and ``fault_counts`` must be equal, and both reports
must hold.  The minis are the JAX package's own scenarios
(``tests/test_chaos_scenarios.py``, ``tests/test_hostile_fleet.py``),
spread over this file, ``test_torch_chaos_recovery.py``,
``test_torch_chaos_eviction.py`` and ``test_torch_chaos_membership.py``
to keep each file's JAX compiles under a minute and a half; the full canned sweep at seeds 1 and 2 is the
``slow`` tier, and on the card ``chip_smoke.py`` phases 10 and 11(d)
hold it to ``CHAOS_EXPECT``.

``python -m tests.test_torch_chaos_scenarios [--jobs N]`` runs the JAX
package over phase 10's and phase 11(d)'s sweeps on the CPU and prints
``CHAOS_EXPECT``.
"""

import pytest

from chip_smoke import chaos_summary

from babble_tpu.chaos import Scenario as JScenario
from babble_tpu.chaos import canned_names as jcanned_names
from babble_tpu.chaos import load_scenario as jload_scenario
from babble_tpu.chaos import run_scenario as jrun_scenario

from babble_tpu_torch.chaos import Scenario, load_scenario, run_scenario

from tests.test_chaos_scenarios import (
    _MINI_DISKROT,
    _MINI_FLAKY,
    _MINI_FORK,
    _MINI_PARTITION,
)

#: the fields of a result both packages must give alike
PARITY_FIELDS = ("fault_schedule", "committed", "consensus", "epochs",
                 "membership_logs", "fault_counts")


def run_both(spec: dict, seed=None):
    """(JAX result, port result) of one scenario dict."""
    jax = jrun_scenario(JScenario.from_dict(spec), seed=seed)
    port = run_scenario(Scenario.from_dict(spec), seed=seed, device="cpu")
    return jax, port


def first_difference(jax, port) -> str:
    """The first field that differs, and for a per-node field the node
    and index, so that a divergence names where to look."""
    for name in PARITY_FIELDS:
        a, b = getattr(jax, name), getattr(port, name)
        if a == b:
            continue
        if isinstance(a, dict) and name in ("committed", "consensus"):
            for node in sorted(set(a) | set(b)):
                x, y = a.get(node, []), b.get(node, [])
                if x != y:
                    i = next((i for i, (u, v) in enumerate(zip(x, y))
                              if u != v), min(len(x), len(y)))
                    return (f"{name}: node {node} differs at index {i} "
                            f"(lengths {len(x)} and {len(y)})")
        return f"{name}: JAX {a!r} port {b!r}"[:2000]
    return ""


def assert_parity(jax, port) -> None:
    assert first_difference(jax, port) == ""
    assert port.fingerprint() == jax.fingerprint()
    assert jax.report.ok, jax.report.format()
    assert port.report.ok, port.report.format()


# ----------------------------------------------------------------------
# tier 1: the JAX package's minis under both packages


@pytest.mark.parametrize("spec", [_MINI_FLAKY, _MINI_PARTITION],
                         ids=lambda s: s["name"])
def test_mini_scenario_matches_jax(spec):
    jax, port = run_both(spec)
    assert_parity(jax, port)
    if spec is _MINI_PARTITION:
        assert port.fault_counts.get("partition", 0) > 0


def test_broken_fork_attack_fails_loudly_as_in_jax():
    """The JAX package's intentionally broken scenario runs the fused
    engine, so the port runs it: the fork attack's branches are refused
    at insert on both packages' nodes alike, and both checkers fail on
    fork_detected alone."""
    spec = {**_MINI_FORK, "name": "mini-fork-broken", "engine": "fused"}
    jax, port = run_both(spec)
    assert first_difference(jax, port) == ""
    assert port.fingerprint() == jax.fingerprint()
    assert port.fork_attack == jax.fork_attack
    assert port.fork_attack["rejected"]
    assert port.report.to_dict() == jax.report.to_dict()
    assert {v.invariant for v in port.report.violations} == {"fork_detected"}


def test_byzantine_scenario_gives_the_jax_fingerprint():
    """The JAX package's mini-fork (the byzantine engine, ROADMAP item 7,
    which the port refused before it had that engine): a forked creator
    planted at two honest nodes, detected by every honest node, with the
    JAX package's fingerprint.  Renamed from
    ``test_byzantine_scenarios_raise_naming_item_7``, the refusal test
    this one replaced in place, whose name said the opposite."""
    jax, port = run_both(_MINI_FORK)
    assert_parity(jax, port)
    assert port.fork_attack == jax.fork_attack
    assert port.fork_attack["injected"] and port.fault_counts["fork_attack"]
    assert "fork_detected" in port.report.to_dict()["checked"]


def test_the_runner_takes_the_card_by_default():
    """No device: the nodes' engines are built on cuda, which this CPU
    machine does not have, so the run fails instead of falling back."""
    import inspect

    import torch

    from babble_tpu_torch.chaos import ScenarioRunner, run_live

    for fn in (run_scenario, ScenarioRunner.__init__, run_live):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the failing half needs a machine without a CUDA card")
    spec = {**_MINI_FLAKY, "steps": 6, "txs": 1, "settle_rounds": 1}
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        run_scenario(Scenario.from_dict(spec))


def test_flaky_link_seed_1_is_chip_smokes_expectation():
    """chip_smoke.py cannot import the JAX package (the card's machine
    has none): its CHAOS_EXPECT entry for flaky-link at seed 1 must be
    what JAX computes, and its sweep must be this file's."""
    import chip_smoke

    assert chip_smoke.CHAOS_SWEEP == sweep()
    assert chip_smoke.CHAOS_BYZANTINE == byzantine_sweep()
    assert set(chip_smoke.CHAOS_EXPECT) == set(
        sweep() + ["mini-disk-rot"] + byzantine_sweep())
    assert chip_smoke.CHAOS_MINI_DISKROT == _MINI_DISKROT
    r = jrun_scenario(jload_scenario("flaky-link"), seed=1)
    assert chip_smoke.CHAOS_EXPECT["flaky-link"][1] == chaos_summary(r)


# ----------------------------------------------------------------------
# the slow tier: every fused canned scenario at seeds 1 and 2


def sweep() -> list:
    """The canned scenarios of phase 10: all that run the fused engine."""
    return [name for name in jcanned_names()
            if jload_scenario(name).engine == "fused"]


def byzantine_sweep() -> list:
    """The canned scenarios of phase 11(d): the byzantine engine's
    (fork-attack)."""
    return [name for name in jcanned_names()
            if jload_scenario(name).engine == "byzantine"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sweep() + byzantine_sweep())
def test_canned_scenario_matches_jax(name, seed):
    import jax as jax_module

    jax = jrun_scenario(jload_scenario(name), seed=seed)
    # the XLA CPU compiler aborts after some hundreds of programs in one
    # process (tests/conftest.py); each scenario compiles its own shapes
    jax_module.clear_caches()
    port = run_scenario(load_scenario(name), seed=seed, device="cpu")
    assert_parity(jax, port)


# ----------------------------------------------------------------------
# the reference for chip_smoke.py phase 10


def _reference_run(job):
    import logging

    logging.disable(logging.WARNING)
    name, seed = job
    if name == "mini-disk-rot":
        sc = JScenario.from_dict({**_MINI_DISKROT, "seed": seed})
    else:
        sc = jload_scenario(name)
    return name, seed, chaos_summary(jrun_scenario(sc, seed=seed))


def chip_reference(jobs: int = 1):
    """The JAX package over phase 10's sweep (``CHAOS_EXPECT``)."""
    import multiprocessing
    import pprint

    work = [(name, seed)
            for name in sweep() + ["mini-disk-rot"] + byzantine_sweep()
            for seed in (1, 2)]
    expect: dict = {}
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        for name, seed, got in pool.imap_unordered(_reference_run, work):
            print(name, seed, got["fingerprint"], got["ok"], flush=True)
            expect.setdefault(name, {})[seed] = got
    expect = {name: dict(sorted(expect[name].items()))
              for name in sorted(expect)}
    print("CHAOS_EXPECT = " + pprint.pformat(expect, width=76,
                                             sort_dicts=False))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=1)
    chip_reference(ap.parse_args().jobs)
