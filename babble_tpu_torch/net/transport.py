"""Transport interface (reference net/transport.go:21-70).

A transport delivers inbound RPCs on an asyncio queue (``consumer``) and
performs outbound request/response syncs.  The RPC object carries a future
the handler resolves with its response — the async mirror of the
reference's ``RPCResponse`` channel.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Optional, Union

from .commands import SyncRequest, SyncResponse


@dataclass
class RPC:
    command: SyncRequest
    _future: "asyncio.Future[SyncResponse]" = field(
        default_factory=lambda: asyncio.get_event_loop().create_future()
    )

    def respond(self, resp: Optional[SyncResponse], error: Optional[str] = None):
        if self._future.done():
            return
        if error is not None:
            self._future.set_exception(TransportError(error))
        else:
            self._future.set_result(resp)

    async def response(self) -> SyncResponse:
        return await self._future


class TransportError(Exception):
    pass


class Transport:
    """Abstract transport.  Implementation: InmemTransport (the TCP
    transport is not ported yet)."""

    @property
    def consumer(self) -> "asyncio.Queue[RPC]":
        raise NotImplementedError

    def local_addr(self) -> str:
        raise NotImplementedError

    async def sync(
        self, target: str, req: SyncRequest, timeout: Optional[float] = None
    ) -> SyncResponse:
        """Send a sync request to target and await its response."""
        raise NotImplementedError

    async def request(self, target, req, timeout: Optional[float] = None):
        """Generic verb-tagged RPC; defaults to the sync plumbing (in-
        process transports pass request objects through unchanged)."""
        return await self.sync(target, req, timeout)

    async def close(self) -> None:
        raise NotImplementedError
