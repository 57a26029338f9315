"""In-process loopback transport (reference net/inmem_transport.go:49-152).

An ``InmemNetwork`` is the registry connecting transports by address;
``connect``/``disconnect`` provide the fault-injection seam the reference
exposes (Disconnect/DisconnectAll) — used by partition tests.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Dict, Optional

from .commands import SyncRequest, SyncResponse
from .transport import RPC, Transport, TransportError

_counter = itertools.count()


class InmemNetwork:
    """Registry of in-memory transports, keyed by address."""

    def __init__(self):
        self.transports: Dict[str, "InmemTransport"] = {}
        self.links: Dict[tuple, bool] = {}  # (src, dst) -> connected

    def transport(self, addr: Optional[str] = None) -> "InmemTransport":
        if addr is None:
            addr = f"inmem://{next(_counter)}"
        t = InmemTransport(addr, self)
        self.transports[addr] = t
        return t

    def connected(self, src: str, dst: str) -> bool:
        return self.links.get((src, dst), True)

    def disconnect(self, src: str, dst: str) -> None:
        self.links[(src, dst)] = False

    def disconnect_all(self, addr: str) -> None:
        for other in self.transports:
            self.links[(addr, other)] = False
            self.links[(other, addr)] = False

    def connect(self, src: str, dst: str) -> None:
        self.links[(src, dst)] = True


class InmemTransport(Transport):
    def __init__(self, addr: str, network: InmemNetwork):
        self._addr = addr
        self._network = network
        self._consumer: "asyncio.Queue[RPC]" = asyncio.Queue()
        self._closed = False

    @property
    def consumer(self) -> "asyncio.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._addr

    async def sync(
        self, target: str, req: SyncRequest, timeout: Optional[float] = 10.0
    ) -> SyncResponse:
        if self._closed:
            raise TransportError("transport closed")
        if not self._network.connected(self._addr, target):
            raise TransportError(f"not connected to {target}")
        peer = self._network.transports.get(target)
        if peer is None or peer._closed:
            raise TransportError(f"unknown peer {target}")
        rpc = RPC(command=req)
        await peer._consumer.put(rpc)
        return await asyncio.wait_for(rpc.response(), timeout)

    async def close(self) -> None:
        self._closed = True
        self._network.transports.pop(self._addr, None)
