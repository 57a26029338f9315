"""Fast-forward across the packages over loopback TCP, on the CPU.

A node that was down (its port closed) while the rest of its fleet moved
past their rolling windows comes back on its address: its syncs get
``too_late`` and it adopts a snapshot from a node of the other package
over TCP (proof and attestation quorum verified), then keeps committing.
Both ways: a port node from JAX responders, and a JAX node from port
responders (``tests/test_torch_node.py``'s in-memory pattern).  Failed
exchanges are sorted as in ``tests/test_torch_tcp_fleet.py``; every
wait is bounded.
"""

import asyncio

import pytest

from .test_torch_tcp_fleet import NEW_TCP, _fleet, _shutdown, _until


@pytest.mark.parametrize("majority,straggler", [("jax", "torch"),
                                                ("torch", "jax")])
def test_fast_forward_across_packages_over_tcp(majority, straggler):
    """Node 3 stays down (its port closed) while the others move past
    their rolling windows; started, its syncs get too_late and it adopts
    a snapshot from a node of the other package over TCP, proof and
    attestation quorum verified, then keeps committing."""

    async def go():
        kinds = [majority] * 3 + [straggler]
        nodes, proxies, failures, peers = await _fleet(
            kinds, seed=32, cache_size=64, seq_window=8,
            consensus_interval=0.05)
        last = nodes[3]
        addr = last.transport.local_addr()
        try:
            for nd in nodes:
                nd.init()
            await last.transport.close()
            for nd in nodes[:3]:
                nd.run_task()
            await _until(lambda: all(nd.core.hg.dag.slot_base > 8
                                     for nd in nodes[:3]), 240, 0.2)
            # the node comes back on its address with a new transport
            last.transport = await NEW_TCP[straggler](addr)
            last.run_task()
            await _until(lambda: last.core.hg.dag.slot_base > 0, 240, 0.2)
            base = last.core.hg.consensus_events_count()
            await _until(lambda: last.core.hg.consensus_events_count()
                         > base + 10, 240, 0.2)
            # both committed windows (2 x cache_size entries each) at
            # one instant: the fleet keeps committing while its nodes
            # shut down one by one, so windows read afterwards can hold
            # stretches of the order too far apart to overlap
            got = last.core.hg.consensus_events()
            ref = nodes[0].core.hg.consensus_events()
        finally:
            await _shutdown(nodes, failures)
        assert int(last._m_ff_total.value) > int(last._m_ff_rejects.value)
        shared = set(got) & set(ref)
        assert len(shared) > 10
        assert [x for x in got if x in shared] == \
            [x for x in ref if x in shared]
        assert failures.records == []
        # the majority's pulls found node 3's port closed
        assert failures.exchanges.get("gossip unreachable", 0) > 0

    asyncio.run(asyncio.wait_for(go(), 300))
