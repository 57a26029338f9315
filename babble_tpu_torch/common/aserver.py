"""Shared asyncio TCP-server lifecycle.

Every listening component (net.TCPTransport, proxy.JsonRpcServer,
service.Service) needs the same four things: bind with port-0 resolution,
track live inbound connections, serve a per-connection handler, and shut
down without deadlocking.  ``asyncio.Server.wait_closed`` (3.12+) waits for
per-connection handlers to finish, and our handlers loop until the peer
hangs up — so close must also close the inbound sockets to EOF the
handlers' pending reads.  That subtlety lives here, once.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional

Handler = Callable[
    [asyncio.StreamReader, asyncio.StreamWriter], Awaitable[None]
]


class AsyncTcpServer:
    """A listening TCP socket + connection registry with safe shutdown.

    ``handler`` is awaited once per inbound connection; connection close
    and registry bookkeeping are managed here.
    """

    def __init__(self, bind_addr: str, handler: Handler):
        self.bind_addr = bind_addr
        self._handler = handler
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    async def start(self) -> None:
        host, port = self.bind_addr.rsplit(":", 1)
        host = host or "127.0.0.1"
        self._server = await asyncio.start_server(
            self._serve_conn, host, int(port)
        )
        actual = self._server.sockets[0].getsockname()[1]
        self.bind_addr = f"{host}:{actual}"

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conns.add(writer)
        try:
            await self._handler(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        # Close inbound sockets so handlers blocked on reads see EOF and
        # exit; otherwise wait_closed() (3.12+) deadlocks on them.
        for w in list(self._conns):
            w.close()
        await self._server.wait_closed()
        self._server = None
