"""App integration: the two mirror-image proxy interfaces
(reference proxy/proxy.go:18-26), the port's copy of the JAX package's
``proxy``.

- AppProxy  — held by the node: exposes the app's submitted transactions
  (``submit_queue``) and delivers consensus-ordered transactions to the
  app (``commit_tx``).
- BabbleProxy — held by the app: submits transactions to the node
  (``submit_tx``) and receives committed ones (``commit_queue``).

Implementations: in-memory pair for tests/embedding, and a JSON-RPC-over-
TCP socket pair matching the reference's net/rpc/jsonrpc protocol shape,
whose bytes are the JAX package's in both directions.
"""

from .admission import AdmissionQueue, OverloadedError
from .inmem import InmemAppProxy
from .socket_app import SocketAppProxy
from .socket_babble import SocketBabbleProxy

__all__ = [
    "AdmissionQueue",
    "InmemAppProxy",
    "OverloadedError",
    "SocketAppProxy",
    "SocketBabbleProxy",
]
