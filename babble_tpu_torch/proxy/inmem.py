"""In-memory AppProxy (reference proxy/app/inmem_app_proxy.go:21-58): the
port's copy of the JAX package's ``proxy/inmem.py``."""

from __future__ import annotations

import asyncio
from typing import List


class InmemAppProxy:
    """Test/embedding fake: records committed transactions, feeds submitted
    ones straight into the node's submit queue."""

    def __init__(self):
        self.submit_queue: "asyncio.Queue[bytes]" = asyncio.Queue()
        self.committed: List[bytes] = []
        self.fast_forwards: List[int] = []

    async def submit_tx(self, tx: bytes) -> None:
        await self.submit_queue.put(bytes(tx))

    def submit_tx_nowait(self, tx: bytes) -> None:
        self.submit_queue.put_nowait(bytes(tx))

    async def commit_tx(self, tx: bytes) -> None:
        self.committed.append(bytes(tx))

    async def commit_batch(self, txs) -> None:
        """Batched delivery (ingress plane): same committed order as N
        commit_tx calls, one await."""
        self.committed.extend(bytes(tx) for tx in txs)

    def committed_transactions(self) -> List[bytes]:
        return list(self.committed)

    async def on_fast_forward(self, lcr) -> None:
        """Fast-forward gap notification (node catch-up): commits between
        the last delivery and round `lcr` were skipped; a state-machine
        app would restore its own snapshot here."""
        self.fast_forwards.append(lcr)
