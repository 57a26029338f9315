"""App-side socket BabbleProxy (reference proxy/babble/socket_babble_proxy.go):
the port's copy of the JAX package's ``proxy/socket_babble.py``.

Mirror image of SocketAppProxy: a server exposing ``State.CommitTx``
(node → app commit queue) and a client calling ``Babble.SubmitTx``.
Also serves ``State.CommitTxBatch`` (ingress plane): one RPC per commit
batch instead of one per transaction — at fleet commit rates the
per-call JSON round trip IS the app-side bottleneck.  Apps speaking
only the reference protocol keep working: the node's proxy falls back
to per-tx ``State.CommitTx`` when the batch verb is unknown.
"""

from __future__ import annotations

import asyncio

from .jsonrpc import JsonRpcClient, JsonRpcServer, b64d, b64e


class SocketBabbleProxy:
    def __init__(self, node_addr: str, bind_addr: str, timeout: float = 5.0):
        """node_addr: the node's SubmitTx server; bind_addr: where we
        listen for the node's CommitTx calls."""
        self.commit_queue: "asyncio.Queue[bytes]" = asyncio.Queue()
        self.server = JsonRpcServer(bind_addr)
        self.server.register("State.CommitTx", self._commit_tx)
        self.server.register("State.CommitTxBatch", self._commit_tx_batch)
        self.client = JsonRpcClient(node_addr, timeout)

    async def start(self) -> None:
        await self.server.start()

    @property
    def bind_addr(self) -> str:
        return self.server.bind_addr

    async def _commit_tx(self, tx_b64: str):
        await self.commit_queue.put(b64d(tx_b64))
        return True

    async def _commit_tx_batch(self, txs_b64: list):
        for tx_b64 in txs_b64:
            await self.commit_queue.put(b64d(tx_b64))
        return True

    async def submit_tx(self, tx: bytes) -> None:
        ack = await self.client.call("Babble.SubmitTx", b64e(tx))
        if ack is not True:
            raise RuntimeError(f"node failed to ack submitted tx: {ack!r}")

    async def close(self) -> None:
        await self.server.close()
        await self.client.close()
