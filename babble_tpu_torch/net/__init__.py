"""Communication backend: peers, the RPC verbs, and the transports
(the port's copy of the JAX package's ``net``).

Mirror of the reference's ``net/`` package (net/transport.go, net/peer.go,
net/commands.go): the sync, push, fast-forward and state-proof verbs
(``commands``, whose ``pack``/``unpack`` give the JAX package's bytes), a
``Transport`` interface with TCP and in-memory loopback implementations
(the TCP frames are the JAX package's byte for byte, transcoded off the
loop above 64 KB by ``codec``), and peer bookkeeping with canonical id
assignment by public-key sort.

The wire format is msgpack (``codec.py``), not Go gob — only the
information content matches the reference.
"""

from .commands import PushRequest, PushResponse, SyncRequest, SyncResponse
from .peers import Peer, JSONPeers, StaticPeers, canonical_ids, exclude_peer
from .transport import RPC, Transport, TransportError
from .inmem_transport import InmemTransport, InmemNetwork
from .tcp_transport import TCPTransport, new_tcp_transport

__all__ = [
    "PushRequest",
    "PushResponse",
    "SyncRequest",
    "SyncResponse",
    "Peer",
    "JSONPeers",
    "StaticPeers",
    "canonical_ids",
    "exclude_peer",
    "RPC",
    "Transport",
    "TransportError",
    "InmemTransport",
    "InmemNetwork",
    "TCPTransport",
    "new_tcp_transport",
]
