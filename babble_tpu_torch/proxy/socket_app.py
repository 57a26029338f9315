"""Babble-side socket AppProxy (reference proxy/app/socket_app_proxy.go):
the port's copy of the JAX package's ``proxy/socket_app.py``.

Runs a JSON-RPC server exposing ``Babble.SubmitTx`` (app → node submit
queue) and a client calling ``State.CommitTx`` on the app for every
consensus transaction, requiring an ack.

The submit queue is an :class:`~.admission.AdmissionQueue`: bounded per
client and in total, drained round-robin so one bombarding client
cannot starve the rest, and shedding load with the structured
``overloaded`` JSON-RPC error (clients must back off ``retry_after_ms``)
instead of queueing into unbounded latency.  The client identity is the
submitting connection's peer address, passed through by the JSON-RPC
server.

A commit whose ack is late is awaited, not sent again.  The node retries
a delivery that raised; a retry of the call still in flight waits for
that call's ack on its connection, and only a call whose connection
failed (or that the app answered with an error) is sent again.  The JAX
package's proxy sends it again, so an app slower than the wait holds the
batch twice (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import asyncio

from .admission import AdmissionQueue, OverloadedError
from .jsonrpc import JsonRpcClient, JsonRpcServer, b64d, b64e


class SocketAppProxy:
    def __init__(self, client_addr: str, bind_addr: str, timeout: float = 5.0,
                 submit_per_client: int = 1024, submit_total: int = 8192,
                 registry=None, submit_adaptive: bool = False):
        """client_addr: the app's State server; bind_addr: where we listen
        for the app's SubmitTx calls.  ``submit_adaptive`` derives the
        admission caps from the observed commit drain rate (EWMA)
        instead of the static numbers — the millions-of-submitters
        posture, where hand-tuned caps are always wrong somewhere."""
        self.submit_queue = AdmissionQueue(
            per_client=submit_per_client, total=submit_total,
            registry=registry, adaptive=submit_adaptive,
        )
        self.server = JsonRpcServer(bind_addr)
        self.server.register("Babble.SubmitTx", self._submit_tx,
                             with_client=True)
        self.server.register("Babble.SubmitTxBatch", self._submit_tx_batch,
                             with_client=True)
        self.client = JsonRpcClient(client_addr, timeout)
        #: (payload, task, wait) of the last commit call sent: the
        #: node's retry passes the same payload object again
        self._inflight = None

    def instrument(self, registry) -> None:
        """Land the admission series on the owning node's /metrics page
        (the same late-binding seam the transports use)."""
        self.submit_queue.instrument(registry)

    def bind_observability(self, lineage, flight) -> None:
        """Bind the owning node's lineage/flight recorders so the front
        door records each tx's submit/admit/shed verdict."""
        self.submit_queue.bind_observability(lineage, flight)

    async def start(self) -> None:
        await self.server.start()

    @property
    def bind_addr(self) -> str:
        return self.server.bind_addr

    async def _submit_tx(self, tx_b64: str, client: str):
        # raises admission.OverloadedError on a full queue — the JSON-RPC
        # server serializes it as the structured `overloaded` error
        self.submit_queue.submit_nowait(client, b64d(tx_b64))
        return True

    async def _submit_tx_batch(self, txs_b64: list, client: str):
        """Batched submit: one RPC round trip admits many txs (the
        per-call round trip bounds a single client's rate otherwise).
        Admission stays per-tx: a cap mid-batch sheds the REST, and the
        structured error's ``admitted`` count tells the client exactly
        what to resubmit after the backoff."""
        admitted = 0
        try:
            for tx_b64 in txs_b64:
                self.submit_queue.submit_nowait(client, b64d(tx_b64))
                admitted += 1
        except OverloadedError as e:
            e.admitted = admitted
            raise
        return True

    async def _commit(self, method: str, payload, param, nbytes: int):
        """Send one commit call, or wait again for the ack of the one
        in flight when ``payload`` is the same object (the node's
        retry).  Raises ``TimeoutError`` while the ack is late."""
        inflight = self._inflight
        if inflight is None or inflight[0] is not payload:
            task = asyncio.ensure_future(
                self.client.call(method, param, bounded=False))
            inflight = self._inflight = (payload, task,
                                         self.client.budget(nbytes))
        _, task, wait = inflight
        try:
            return await asyncio.wait_for(asyncio.shield(task), wait)
        except asyncio.TimeoutError:
            if task.done():
                raise           # the call itself failed with a timeout
            raise asyncio.TimeoutError(
                f"{method} ack not in after {wait:.1f} s; still awaited "
                f"on its connection, not sent again") from None
        finally:
            # single-caller contract: the node's commit loop calls
            # commit_tx/commit_batch one at a time and awaits each
            # (node/node.py's sequential commit loop), so no other task
            # runs _commit between the write above and this one
            if task.done() and self._inflight is inflight:
                self._inflight = None  # babble-lint: disable=await-state-race

    async def commit_tx(self, tx: bytes) -> None:
        wire = b64e(tx)
        ack = await self._commit("State.CommitTx", tx, wire, len(wire))
        if ack is not True:
            raise RuntimeError(f"app failed to ack committed tx: {ack!r}")

    async def commit_batch(self, txs) -> None:
        """One RPC for a whole commit batch (State.CommitTxBatch).  An
        app speaking only the reference per-tx protocol answers
        ``unknown method`` (a RuntimeError here) — the node's commit
        loop catches that once and falls back to commit_tx for good."""
        wire = [b64e(tx) for tx in txs]
        ack = await self._commit("State.CommitTxBatch", txs, wire,
                                 sum(len(w) + 4 for w in wire))
        if ack is not True:
            raise RuntimeError(f"app failed to ack committed batch: {ack!r}")

    async def close(self) -> None:
        if self._inflight is not None:
            self._inflight[1].cancel()
            self._inflight = None
        await self.server.close()
        await self.client.close()
