"""Minimal JSON-RPC 1.0 over TCP (the port's copy of the JAX package's
``proxy/jsonrpc.py``, whose bytes it writes and reads), matching the shape
of Go's net/rpc jsonrpc codec used by the reference
(proxy/app/socket_app_proxy_client.go,
proxy/babble/socket_babble_proxy_server.go):

request:  {"method": "Service.Method", "params": [arg], "id": N}
response: {"id": N, "result": ..., "error": null}

Binary payloads ([]byte in Go) travel as base64 strings.  Objects are
streamed back-to-back on the socket (no framing), so decoding uses an
incremental raw JSON decoder.
"""

from __future__ import annotations

import asyncio
import base64
import json
import itertools
import re
from typing import Any, Callable, Dict, Optional

from ..common.aserver import AsyncTcpServer

_decoder = json.JSONDecoder()

MAX_OBJECT_BYTES = 16 << 20  # close the stream rather than buffer forever


def b64e(data: bytes) -> str:
    return base64.b64encode(data).decode()


def b64d(s: str) -> bytes:
    return base64.b64decode(s)


#: the next bracket or string quote
_SPECIAL = re.compile(r'[{}\[\]"]')
#: the rest of a string after its opening quote: group 1 is the closing
#: quote, or a lone backslash or nothing where the text ends first
_STRING_REST = re.compile(r'[^"\\]*(?:\\.[^"\\]*)*("|\\?\Z)')


class JsonStreamError(Exception):
    """The peer sent bytes that can never become a valid JSON object."""


class JsonStream:
    """Incremental JSON-object reader over an asyncio StreamReader.

    An object or array is decoded once its brackets close, found by a
    scan that resumes where the last read ended; the JAX package's
    reader decodes the whole buffer after every read instead, and takes
    the error a read that ends inside a string (or a literal) gives for
    an invalid prefix, so it refuses every object longer than one read
    whose cut falls there.  Bytes that can never become a value (an
    invalid closed object, a stray bracket) are refused as in JAX."""

    def __init__(self, reader: asyncio.StreamReader):
        self.reader = reader
        self.buf = ""
        #: (resume offset, bracket depth, inside a string) of the scan of
        #: the object at the head of ``buf``
        self._scan = (0, 0, False)

    def _still_open(self, text: str) -> bool:
        """Whether ``text`` (the buffer's head, whitespace stripped)
        starts an object or array whose brackets have not closed yet."""
        if text[0] not in "{[":
            return False
        pos, depth, in_string = self._scan
        while True:
            if in_string:
                m = _STRING_REST.match(text, pos)
                if m.group(1) != '"':
                    # resume at a trailing backslash: its escape is
                    # completed by the next read
                    self._scan = (m.end() - len(m.group(1)), depth, True)
                    return True
                pos, in_string = m.end(), False
            m = _SPECIAL.search(text, pos)
            if m is None:
                self._scan = (len(text), depth, False)
                return True
            pos, c = m.end(), m.group()
            if c == '"':
                in_string = True
            elif c in "{[":
                depth += 1
            else:
                depth -= 1
                if depth <= 0:
                    return False

    async def next_obj(self) -> Optional[dict]:
        while True:
            stripped = self.buf.lstrip()
            if stripped:
                if not self._still_open(stripped):
                    try:
                        obj, end = _decoder.raw_decode(stripped)
                        self.buf = stripped[end:]
                        self._scan = (0, 0, False)
                        return obj
                    except json.JSONDecodeError as e:
                        # An error before the end of the buffer means the
                        # prefix itself is invalid — more bytes can never
                        # fix it.
                        if e.pos < len(stripped):
                            raise JsonStreamError(
                                f"invalid JSON at byte {e.pos}"
                            ) from e
                if len(self.buf) > MAX_OBJECT_BYTES:
                    raise JsonStreamError("JSON object exceeds size limit")
            chunk = await self.reader.read(65536)
            if not chunk:
                return None
            # single-consumer contract: one JsonStream per connection,
            # drained by exactly one handler coroutine (socket_app/
            # jsonrpc _handle loops never call next_obj concurrently)
            self.buf += chunk.decode(errors="replace")  # babble-lint: disable=await-state-race


class JsonRpcServer:
    """Serves registered methods over TCP.

    Methods registered with ``with_client=True`` receive the calling
    connection's peer identity (``"ip:port"``) as a second argument —
    the admission controller's per-client fairness key.  An exception
    exposing ``to_error()`` (e.g. admission.OverloadedError) is
    serialized as a STRUCTURED error object instead of a bare string,
    so clients can key off ``error["code"]`` (the documented
    ``overloaded`` contract) rather than parse prose."""

    def __init__(self, bind_addr: str):
        self.methods: Dict[str, Callable] = {}
        self._with_client: set = set()
        self._server = AsyncTcpServer(bind_addr, self._handle)

    @property
    def bind_addr(self) -> str:
        return self._server.bind_addr

    def register(self, name: str, fn: Callable,
                 with_client: bool = False) -> None:
        """fn: async (param) -> result, or async (param, client) ->
        result when registered with ``with_client=True``."""
        self.methods[name] = fn
        if with_client:
            self._with_client.add(name)

    async def start(self) -> None:
        await self._server.start()

    async def _handle(self, reader, writer) -> None:
        stream = JsonStream(reader)
        peer = writer.get_extra_info("peername")
        client = (f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple)
                  else str(peer))
        try:
            while True:
                obj = await stream.next_obj()
                if obj is None:
                    return
                rid = obj.get("id")
                name = obj.get("method", "")
                method = self.methods.get(name)
                if method is None:
                    resp = {"id": rid, "result": None,
                            "error": f"unknown method {obj.get('method')}"}
                else:
                    try:
                        params = obj.get("params") or [None]
                        if name in self._with_client:
                            result = await method(params[0], client)
                        else:
                            result = await method(params[0])
                        resp = {"id": rid, "result": result, "error": None}
                    except Exception as e:
                        to_error = getattr(e, "to_error", None)
                        err = (to_error() if callable(to_error)
                               else str(e))
                        resp = {"id": rid, "result": None, "error": err}
                writer.write(json.dumps(resp).encode())
                await writer.drain()
        except JsonStreamError:
            return  # unrecoverable stream; drop the connection

    async def close(self) -> None:
        await self._server.close()


class JsonRpcClient:
    """Single-connection client with sequential request ids; reconnects on
    demand (the reference dials per call, socket_app_proxy_client.go:38-47).
    Calls are serialized by a lock: the stream carries strictly one
    request/response pair at a time, so responses can't be mis-attributed.

    The wait for a response scales with the request (``budget``):
    ``timeout``, or one second a MiB of request when that is longer, as
    the TCP transport budgets a frame in flight (a commit batch of
    17,500 transactions is 1.6 MB of JSON, which an app needs time to
    read).  The JAX package's client waits ``timeout`` for any request
    (ROADMAP.md Queue 3).  A call with ``bounded=False`` waits as long
    as its connection lives: its caller bounds its own wait, as
    ``SocketAppProxy`` does to await a late commit ack instead of
    sending the batch again."""

    def __init__(self, target: str, timeout: float = 5.0):
        self.target = target
        self.timeout = timeout
        self._ids = itertools.count(1)
        self._conn = None
        self._lock = asyncio.Lock()

    def budget(self, nbytes: int) -> float:
        """Seconds to wait for the answer to a request of ``nbytes``."""
        return max(self.timeout, nbytes / (1024 * 1024))

    async def _connect(self):
        if self._conn is not None and not self._conn[1].is_closing():
            return self._conn
        host, port = self.target.rsplit(":", 1)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), self.timeout
        )
        self._conn = (reader, writer, JsonStream(reader))
        return self._conn

    def _drop(self) -> None:
        if self._conn is not None:
            self._conn[1].close()
            self._conn = None

    async def call(self, method: str, param: Any,
                   bounded: bool = True) -> Any:
        async with self._lock:
            reader, writer, stream = await self._connect()
            req = {"method": method, "params": [param], "id": next(self._ids)}
            body = json.dumps(req).encode()
            try:
                writer.write(body)
                await writer.drain()
                read = stream.next_obj()
                resp = await (asyncio.wait_for(read, self.budget(len(body)))
                              if bounded else read)
            except BaseException:
                # a call that failed, ran out of time or was cancelled
                # leaves its connection, so its late answer is not read
                # as the next call's
                self._drop()
                raise
            if resp is None:
                self._drop()
                raise ConnectionError("connection closed mid-call")
            err = resp.get("error")
            if err:
                if isinstance(err, dict) and err.get("code") == "overloaded":
                    # the admission controller's structured shed: raise
                    # the typed error so clients back off instead of
                    # pattern-matching strings
                    from .admission import OverloadedError

                    raise OverloadedError.from_error(err)
                raise RuntimeError(err)
            return resp.get("result")

    async def close(self) -> None:
        self._drop()
