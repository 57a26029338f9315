"""App proxies: the seam between a node and its application.  The port
has the in-memory proxy; the socket and JSON-RPC proxies and admission
control are not ported yet (ROADMAP.md Queue 1, item 5d)."""

from .inmem import InmemAppProxy

__all__ = ["InmemAppProxy"]
