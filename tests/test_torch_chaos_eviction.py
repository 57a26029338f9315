"""The port's chaos runner against the JAX package's on the scenarios
that evict and restore (see ``test_torch_chaos_scenarios.py``): the
dead-creator mini (per-creator eviction past a silent peer, then its
return through verified fast-forward) under both packages, and the
mini-disk-rot pins of the JAX package's structure-relative disk draws.
"""

import pytest

from chip_smoke import CHAOS_EXPECT, CHAOS_MINI_DISKROT

from babble_tpu_torch.chaos import Scenario, run_scenario

from tests.test_chaos_scenarios import _MINI_DEAD_CREATOR
from tests.test_disk_rot_draws import PINNED_DISKROT_FINGERPRINTS
from tests.test_torch_chaos_scenarios import assert_parity, run_both


def test_mini_dead_creator_matches_jax():
    jax, port = run_both(_MINI_DEAD_CREATOR)
    assert_parity(jax, port)
    assert port.eviction_horizons == jax.eviction_horizons
    assert port.eviction_horizons.get(3, -1) >= 0
    assert port.outage_live_window_max == jax.outage_live_window_max
    assert port.fast_forwards == jax.fast_forwards
    assert port.fast_forwards[3] == 1


def test_pinned_diskrot_fingerprints_are_the_jax_pins():
    """chip_smoke.py holds mini-disk-rot on the card to the JAX pins."""
    assert {s: CHAOS_EXPECT["mini-disk-rot"][s]["fingerprint"]
            for s in (1, 2)} == PINNED_DISKROT_FINGERPRINTS


@pytest.mark.parametrize("seed", [1, 2])
def test_mini_disk_rot_gives_the_pinned_fingerprints(seed):
    """The port's checkpoint meta bytes and its codec's re-pack must land
    every disk-rot draw where msgpack does."""
    r = run_scenario(Scenario.from_dict({**CHAOS_MINI_DISKROT, "seed": seed}),
                     device="cpu")
    assert r.report.ok, r.report.format()
    assert r.fault_counts.get("checkpoint_corrupt", 0) == 1
    assert r.fault_counts.get("wal_truncate", 0) == 1
    assert r.fingerprint() == PINNED_DISKROT_FINGERPRINTS[seed]
