"""Admission control: the ingress plane's front door (the port's copy of
the JAX package's ``proxy/admission.py``).

The submit path used to be an unbounded ``asyncio.Queue``: any client
could grow it without limit (memory), and a single bombarding client
could fill it faster than the node drains, starving every other
client's transactions (FIFO is fair only among equals).  The
:class:`AdmissionQueue` replaces it with:

- **bounded queues** — one FIFO per client, capped at ``per_client``,
  plus a ``total`` cap across clients;
- **load shedding** — a submit over either cap is rejected immediately
  with a structured :class:`OverloadedError` (JSON-RPC clients see
  ``{"code": "overloaded", "scope": ..., "retry_after_ms": ...}``)
  instead of queueing into unbounded latency;
- **round-robin fairness** — the node drains one transaction per
  client per turn, so a client bombarding at 100× the rate of the rest
  gets at most an equal share of minted-event payload slots and cannot
  starve anyone.

The surface mirrors the ``asyncio.Queue`` subset the node's select
loop uses (``get`` / ``get_nowait`` / ``qsize`` / ``empty``), so
``Node.run`` drains it unchanged.  ``put``/``put_nowait`` exist for
queue-compat callers (tests, dummy harnesses) and submit under a
shared anonymous client id — real ingress goes through
``submit_nowait(client, tx)`` with the connection's peer identity.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, Optional

#: client id used by queue-compat ``put``/``put_nowait`` callers
ANON_CLIENT = "<anon>"

#: adaptive-cap EWMA window (seconds) and smoothing factor: the drain
#: rate is sampled per window and folded with DRAIN_ALPHA weight on the
#: newest sample — a few windows to converge, stable under bursts
DRAIN_WINDOW_S = 0.5
DRAIN_ALPHA = 0.3


class OverloadedError(Exception):
    """Structured load-shed rejection.  ``scope`` says which cap was
    hit (``client``: your own backlog; ``total``: the node's); clients
    must back off ``retry_after_ms`` before resubmitting."""

    def __init__(self, scope: str, depth: int, cap: int,
                 retry_after_ms: int = 100, admitted: int = 0):
        self.scope = scope
        self.depth = depth
        self.cap = cap
        self.retry_after_ms = retry_after_ms
        #: batched submits: how many txs of the batch WERE admitted
        #: before the cap tripped — the client resubmits only the rest
        self.admitted = admitted
        super().__init__(
            f"overloaded: {scope} submit queue at {depth}/{cap}"
        )

    def to_error(self) -> dict:
        """The JSON-RPC structured error body (jsonrpc.py serializes
        this verbatim; clients key off ``code``)."""
        return {
            "code": "overloaded",
            "scope": self.scope,
            "depth": self.depth,
            "cap": self.cap,
            "retry_after_ms": self.retry_after_ms,
            "admitted": self.admitted,
        }

    @classmethod
    def from_error(cls, err: dict) -> "OverloadedError":
        return cls(
            scope=str(err.get("scope", "total")),
            depth=int(err.get("depth", 0)),
            cap=int(err.get("cap", 0)),
            retry_after_ms=int(err.get("retry_after_ms", 100)),
            admitted=int(err.get("admitted", 0)),
        )


class AdmissionQueue:
    """Bounded, per-client-fair submit queue (see module docstring)."""

    def __init__(self, per_client: int = 1024, total: int = 8192,
                 registry=None, adaptive: bool = False,
                 horizon_s: float = 2.0, min_total: int = 64,
                 max_total: Optional[int] = None):
        """``adaptive=True`` derives the caps
        from the OBSERVED commit drain rate instead of static config:
        the queue admits at most ``horizon_s`` seconds of drain (EWMA
        over DRAIN_WINDOW_S samples), clamped to [min_total,
        max_total].  A node that drains 10k tx/s offers a deep queue; a
        node wedged behind consensus backpressure shrinks toward
        min_total and sheds — which is the point: queued work the node
        cannot drain is just latency the client pays.  The static
        ``per_client``/``total`` remain the COLD-START caps until the
        first drain window completes, and per-client fairness becomes a
        dynamic equal share of the effective total."""
        if per_client <= 0 or total <= 0:
            raise ValueError("admission caps must be positive")
        if adaptive and (horizon_s <= 0 or min_total <= 0):
            raise ValueError("adaptive admission bounds must be positive")
        self.per_client = per_client
        self.total = total
        self.adaptive = adaptive
        self.horizon_s = horizon_s
        self.min_total = min_total
        self.max_total = max_total if max_total is not None else total
        #: EWMA of the drain rate (tx/s); None until one window closes
        self._drain_ewma: Optional[float] = None
        self._win_start = time.monotonic()
        self._win_drained = 0
        #: client -> FIFO; OrderedDict preserves round-robin rotation
        #: order (move_to_end after each drain turn)
        self._queues: "OrderedDict[str, Deque[bytes]]" = OrderedDict()
        self._size = 0
        self._data = asyncio.Event()
        self._m_shed = None
        self._m_admitted = None
        #: attribution plane: the owning node's lineage and
        #: flight recorders, bound late like the registry — the front
        #: door records each tx's submit/admit/shed verdict and shed
        #: EPISODES land on the flight ring (rate-limited)
        self._lineage = None
        self._flight = None
        if registry is not None:
            self.instrument(registry)

    def bind_observability(self, lineage, flight) -> None:
        self._lineage = lineage
        self._flight = flight

    def instrument(self, registry) -> None:
        self._m_shed = registry.counter(
            "babble_ingress_shed_total",
            "submitted transactions rejected by admission control, by "
            "which cap tripped",
            labelnames=("scope",))
        for scope in ("client", "total"):
            self._m_shed.labels(scope)
        self._m_admitted = registry.counter(
            "babble_ingress_admitted_total",
            "submitted transactions accepted into the admission queue")
        registry.gauge(
            "babble_ingress_queue_depth",
            "transactions waiting in the admission queue across all "
            "clients",
        ).set_function(lambda: self._size)
        registry.gauge(
            "babble_ingress_clients",
            "clients with a non-empty admission queue",
        ).set_function(lambda: len(self._queues))
        registry.gauge(
            "babble_ingress_total_cap",
            "total admission cap in force (drain-rate-derived when "
            "adaptive, else the static config)",
        ).set_function(self.effective_total)
        registry.gauge(
            "babble_ingress_drain_rate",
            "EWMA of the observed drain rate (tx/s; 0 until the first "
            "adaptive window closes)",
        ).set_function(lambda: self._drain_ewma or 0.0)

    # ------------------------------------------------------------------
    # adaptive caps (drain-rate EWMA)

    def _note_drain(self, n: int = 1) -> None:
        """Fold drained txs into the rate EWMA.  Called by get_nowait
        (the drain side IS the observation point) and with n=0 by
        submit_nowait, so a FULLY wedged drain still closes windows and
        decays the rate toward zero — without that, a node that stopped
        draining would keep admitting at its last healthy cap."""
        if not self.adaptive:
            return
        self._win_drained += n
        now = time.monotonic()
        dt = now - self._win_start
        if dt >= DRAIN_WINDOW_S:
            if self._win_drained == 0 and self._size == 0:
                # IDLE window: nothing was queued, so nothing could
                # drain — a zero sample here is not evidence of a
                # wedged drain, and folding it would collapse the cap
                # to min_total on the first burst after any quiet
                # stretch.  Re-arm the window without sampling.
                self._win_start = now
                return
            rate = self._win_drained / dt
            self._drain_ewma = (
                rate if self._drain_ewma is None
                else DRAIN_ALPHA * rate
                + (1 - DRAIN_ALPHA) * self._drain_ewma
            )
            self._win_start = now
            self._win_drained = 0

    def effective_total(self) -> int:
        """The total cap in force: ``horizon_s`` seconds of observed
        drain when adaptive (clamped), else the static cap."""
        if not self.adaptive or self._drain_ewma is None:
            return self.total
        derived = int(self._drain_ewma * self.horizon_s)
        return max(self.min_total, min(derived, self.max_total))

    def effective_per_client(self) -> int:
        """Per-client cap: an equal share of the effective total across
        clients with backlog (floor 8 so a fresh client always gets a
        foot in the door), else the static cap."""
        if not self.adaptive or self._drain_ewma is None:
            return self.per_client
        share = self.effective_total() // max(1, len(self._queues))
        return max(8, share)

    # ------------------------------------------------------------------
    # ingress side

    def submit_nowait(self, client: str, tx: bytes) -> None:
        """Admit one transaction for ``client`` or shed it with a
        structured OverloadedError."""
        self._note_drain(0)   # close stale windows: no drain = decay
        if self._lineage is not None:
            self._lineage.note_tx(tx, "submit", client=client)
        total = self.effective_total()
        if self._size >= total:
            self._note_shed(tx, "total", self._size, total)
            raise OverloadedError("total", self._size, total)
        per_client = self.effective_per_client()
        q = self._queues.get(client)
        if q is not None and len(q) >= per_client:
            self._note_shed(tx, "client", len(q), per_client)
            raise OverloadedError("client", len(q), per_client)
        if q is None:
            q = deque()
            self._queues[client] = q
        q.append(tx)
        self._size += 1
        if self._m_admitted is not None:
            self._m_admitted.inc()
        if self._lineage is not None:
            self._lineage.note_tx(tx, "admit")
        self._data.set()

    def _note_shed(self, tx: bytes, scope: str, depth: int,
                   cap: int) -> None:
        if self._m_shed is not None:
            self._m_shed.labels(scope).inc()
        if self._lineage is not None:
            self._lineage.note_tx(tx, "shed", scope=scope)
        if self._flight is not None:
            # a shed EPISODE is one flight record, not one per tx — a
            # bombard burst must not evict the interesting transitions
            self._flight.note_limited("admission_shed", scope=scope,
                                      depth=depth, cap=cap)

    # queue-compat writers (tests / in-process harnesses)

    def put_nowait(self, tx: bytes) -> None:
        self.submit_nowait(ANON_CLIENT, tx)

    async def put(self, tx: bytes) -> None:
        self.put_nowait(tx)

    # ------------------------------------------------------------------
    # drain side (the node's select loop)

    def get_nowait(self) -> bytes:
        """Pop one transaction, round-robin across clients: the head
        client yields ONE tx and rotates to the tail, so every client
        with backlog advances at the same rate regardless of depth."""
        while self._queues:
            client, q = next(iter(self._queues.items()))
            if not q:
                # emptied by a previous turn: drop the bookkeeping row
                del self._queues[client]
                continue
            tx = q.popleft()
            self._size -= 1
            self._note_drain()
            if q:
                self._queues.move_to_end(client)
            else:
                del self._queues[client]
            if self._size == 0:
                self._data.clear()
            return tx
        self._data.clear()
        raise asyncio.QueueEmpty

    async def get(self) -> bytes:
        while True:
            try:
                return self.get_nowait()
            except asyncio.QueueEmpty:
                await self._data.wait()

    def qsize(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0
