"""The port's chaos runner against the JAX package's on the durable
restarts (see ``test_torch_chaos_scenarios.py``): a crash and a restart
from the write-ahead log, and a restart into a rotten checkpoint and a
torn WAL (seeded disk rot, recovered through
``load_checkpoint_tolerant``), under both packages; and a serve held up
past ``Config.test_config``'s 0.2 s RPC timeout, which moves the JAX
runner's result and not the port's.
"""

from chip_smoke import CHAOS_MINI_DISKROT

from babble_tpu.chaos import Scenario as JScenario
from babble_tpu.chaos import run_scenario as jrun_scenario
from babble_tpu.node.node import Node as JNode
from babble_tpu_torch.chaos import Scenario, run_scenario
from babble_tpu_torch.node import Node

from tests.test_chaos_scenarios import _MINI_CRASH, _MINI_DISKROT
from tests.test_disk_rot_draws import PINNED_DISKROT_FINGERPRINTS
from tests.test_torch_chaos_card import hold_up_serves
from tests.test_torch_chaos_scenarios import assert_parity, run_both


def test_mini_crash_matches_jax():
    jax, port = run_both(_MINI_CRASH)
    assert_parity(jax, port)
    assert port.restarted == jax.restarted == {2}
    assert not any(port.fork_detected.values())


def test_mini_disk_rot_matches_jax():
    jax, port = run_both(_MINI_DISKROT)
    assert_parity(jax, port)
    assert port.fault_counts.get("checkpoint_corrupt", 0) == 1
    assert port.fault_counts.get("wal_truncate", 0) == 1


def test_a_held_up_serve_leaves_the_port_runners_result(monkeypatch):
    hold_up_serves(monkeypatch, Node)
    r = run_scenario(Scenario.from_dict({**CHAOS_MINI_DISKROT, "seed": 2}),
                     device="cpu")
    assert r.report.ok, r.report.format()
    assert r.fingerprint() == PINNED_DISKROT_FINGERPRINTS[2]


def test_a_held_up_serve_moves_the_jax_runners_result(monkeypatch):
    """The reference's fault (ROADMAP Queue 3): its runner's nodes keep
    test_config's 0.2 s RPC timeout, so a serve that the host holds up
    fails the exchange and the run's fingerprint moves."""
    hold_up_serves(monkeypatch, JNode)
    r = jrun_scenario(JScenario.from_dict({**CHAOS_MINI_DISKROT, "seed": 2}))
    assert r.fingerprint() != PINNED_DISKROT_FINGERPRINTS[2]
