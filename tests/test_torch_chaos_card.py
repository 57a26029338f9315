"""The port's chaos runner on the card, with serves held up.

A node's serve of a sync can take longer than ``Config.test_config``'s
0.2 s RPC timeout on a loaded host or on a first call on the card; the
runner's nodes wait ``chaos.scenario.RPC_TIMEOUT_S`` instead, so the
run's result does not move.  Marked ``gpu``: the test skips itself
without a card.  On a machine with one, run

    python -m pytest tests/test_torch_chaos_card.py -m gpu --noconftest
"""

import asyncio

import pytest
import torch

from chip_smoke import CHAOS_EXPECT, CHAOS_MINI_DISKROT

from babble_tpu_torch.chaos import Scenario, run_scenario
from babble_tpu_torch.node import Node


def hold_up_serves(monkeypatch, node_cls, count=3, seconds=0.3):
    """Hold the first ``count`` sync serves back by ``seconds`` of real
    time, as a loaded host's serve thread or a first call on the card
    does: past test_config's 0.2 s, within the port runner's wait."""
    serve = node_cls._process_sync_request
    left = [count]

    async def held_up(self, req):
        if left[0] > 0:
            left[0] -= 1
            await asyncio.sleep(seconds)
        return await serve(self, req)

    monkeypatch.setattr(node_cls, "_process_sync_request", held_up)


@pytest.mark.gpu
def test_a_held_up_serve_leaves_the_result_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hold_up_serves(monkeypatch, Node)
    r = run_scenario(Scenario.from_dict({**CHAOS_MINI_DISKROT, "seed": 2}))
    assert r.report.ok, r.report.format()
    assert r.fingerprint() == CHAOS_EXPECT["mini-disk-rot"][2]["fingerprint"]
