"""Dummy demo app (reference proxy/dummy.go:28-100), the port's copy of the
JAX package's ``proxy/dummy.py``: a chat client that appends every
committed transaction to messages.txt, as the JAX package writes it."""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

from .socket_babble import SocketBabbleProxy


class State:
    """The demo app state machine (reference proxy/dummy.go:28-56)."""

    def __init__(self, log_path: str = "messages.txt"):
        self.log_path = log_path
        self.messages: List[str] = []

    def commit_tx(self, tx: bytes) -> None:
        msg = tx.decode(errors="replace")
        self.messages.append(msg)
        self.write_message(msg)

    def commit_batch(self, txs) -> None:
        """Batched commit (ingress plane): one append + one write for
        the whole burst — at fleet commit rates the per-message
        open/write/close syscall churn was measurable load."""
        msgs = [tx.decode(errors="replace") for tx in txs]
        self.messages.extend(msgs)
        with open(self.log_path, "a") as f:
            f.write("".join(m + "\n" for m in msgs))

    def write_message(self, msg: str) -> None:
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def get_messages(self) -> List[str]:
        return list(self.messages)


class DummySocketClient:
    """Wires a State to a SocketBabbleProxy (reference proxy/dummy.go:58-100)."""

    def __init__(self, node_addr: str, bind_addr: str,
                 log_path: str = "messages.txt"):
        self.state = State(log_path)
        self.proxy = SocketBabbleProxy(node_addr, bind_addr)
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        await self.proxy.start()
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            tx = await self.proxy.commit_queue.get()
            # greedy drain: one wakeup commits the whole delivered burst
            txs = [tx]
            while True:
                try:
                    txs.append(self.proxy.commit_queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            self.state.commit_batch(txs)

    async def submit_tx(self, tx: bytes) -> None:
        await self.proxy.submit_tx(tx)

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self.proxy.close()
