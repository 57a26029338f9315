"""The port's chaos runner against the JAX package's on the membership
and adversarial-time minis (see ``test_torch_chaos_scenarios.py``): a
join under load, a leave, bounded clock drift and lying timestamps (each
with its drift-free twin run), and WAN-shaped links.
"""

import pytest

from tests.test_chaos_scenarios import _MINI_JOIN, _MINI_LEAVE, _MINI_SKEW
from tests.test_hostile_fleet import _MINI_LIE, _MINI_WAN
from tests.test_torch_chaos_scenarios import assert_parity, run_both


@pytest.mark.parametrize("spec,kind", [(_MINI_JOIN, "join"),
                                       (_MINI_LEAVE, "leave")],
                         ids=["mini-join", "mini-leave"])
def test_mini_membership_matches_jax(spec, kind):
    jax, port = run_both(spec)
    assert_parity(jax, port)
    assert set(port.epochs.values()) == {1}
    assert all(len(v) == 1 and v[0][1] == kind
               for v in port.membership_logs.values())
    assert port.joined == jax.joined


@pytest.mark.parametrize("spec,kind", [(_MINI_SKEW, "clock_skew"),
                                       (_MINI_LIE, "lying_ts")],
                         ids=["mini-skew", "mini-lie"])
def test_mini_adversarial_time_matches_jax(spec, kind):
    jax, port = run_both(spec)
    assert_parity(jax, port)
    assert port.noskew_committed == jax.noskew_committed
    assert port.noskew_keys == jax.noskew_keys
    assert port.fault_counts.get(kind, 0) > 0


def test_mini_wan_matches_jax():
    jax, port = run_both(_MINI_WAN)
    assert_parity(jax, port)
    assert port.fault_counts.get("bw_delay", 0) > 0
    assert port.fault_counts.get("ge_drop", 0) > 0
