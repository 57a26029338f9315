"""A mixed in-memory network: JAX-package nodes and port nodes in one fleet.

The in-memory transports of both packages hand command objects straight
to the peer's queue, and each ``Node._process_rpc`` dispatches with
``isinstance`` on its own package's command classes.  So a mixed fleet
needs a bridge: every call here is packed with the SENDER's
``net/commands.py`` and unpacked with the RECEIVER's, and the response
goes back the same way.  The fleet then proves the wire as well as the
consensus: each decoded object is packed again on the receiving side and
must give the very same bytes (``BridgeNetwork.mismatches`` lists any
that do not).

Errors cross too: an error response raised as the receiver's
``TransportError`` reaches the sender as the sender's, with the same
text (the ``too_late`` prefix is what triggers a fast-forward).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from babble_tpu.net import commands as jcommands
from babble_tpu.net import transport as jtransport
from babble_tpu_torch.net import commands as pcommands
from babble_tpu_torch.net import transport as ptransport

PACKAGES = {
    "jax": (jcommands, jtransport),
    "torch": (pcommands, ptransport),
}


class BridgeNetwork:
    """Registry of bridge transports keyed by address, each tagged with
    the package ("jax" or "torch") of the node that owns it."""

    def __init__(self):
        self.transports: Dict[str, "BridgeTransport"] = {}
        self.links: Dict[tuple, bool] = {}
        #: (rtype, direction, sender package) of every call whose bytes
        #: changed when the receiver packed its decoded object again
        self.mismatches: List[tuple] = []
        #: calls carried, by (sender package, receiver package)
        self.calls: Dict[tuple, int] = {}

    def transport(self, addr: str, package: str) -> "BridgeTransport":
        t = BridgeTransport(addr, package, self)
        self.transports[addr] = t
        return t

    def connected(self, src: str, dst: str) -> bool:
        return self.links.get((src, dst), True)

    def disconnect_all(self, addr: str) -> None:
        for other in self.transports:
            self.links[(addr, other)] = False
            self.links[(other, addr)] = False

    def connect_all(self, addr: str) -> None:
        for other in self.transports:
            self.links[(addr, other)] = True
            self.links[(other, addr)] = True

    def _cross(self, obj, dst_commands, rtype: int, response: bool,
               src_package: str):
        data = obj.pack()
        cls = dst_commands.REQUEST_TYPES[rtype]
        if response:
            cls = cls.RESPONSE_CLS
        out = cls.unpack(data)
        if out.pack() != data:
            self.mismatches.append((rtype, "response" if response
                                    else "request", src_package))
        return out


class BridgeTransport:
    """One node's end of the bridge.  It has the surface both packages'
    ``Node`` use: ``consumer``, ``local_addr``, ``sync``, ``request``
    and ``close``."""

    def __init__(self, addr: str, package: str, network: BridgeNetwork):
        self._addr = addr
        self.package = package
        self._commands, self._transport = PACKAGES[package]
        self._network = network
        self._consumer: asyncio.Queue = asyncio.Queue()
        self._closed = False

    @property
    def consumer(self) -> asyncio.Queue:
        return self._consumer

    def local_addr(self) -> str:
        return self._addr

    async def sync(self, target: str, req, timeout: Optional[float] = 10.0):
        err = self._transport.TransportError
        if self._closed:
            raise err("transport closed")
        if not self._network.connected(self._addr, target):
            raise err(f"not connected to {target}")
        peer = self._network.transports.get(target)
        if peer is None or peer._closed:
            raise err(f"unknown peer {target}")
        net = self._network
        key = (self.package, peer.package)
        net.calls[key] = net.calls.get(key, 0) + 1
        rtype = req.RTYPE
        theirs = net._cross(req, peer._commands, rtype, False, self.package)
        rpc = peer._transport.RPC(command=theirs)
        await peer._consumer.put(rpc)
        try:
            resp = await asyncio.wait_for(rpc.response(), timeout)
        except peer._transport.TransportError as e:
            raise err(str(e)) from None
        return net._cross(resp, self._commands, rtype, True, peer.package)

    async def request(self, target: str, req,
                      timeout: Optional[float] = None):
        return await self.sync(target, req, timeout)

    async def close(self) -> None:
        self._closed = True
        self._network.transports.pop(self._addr, None)
