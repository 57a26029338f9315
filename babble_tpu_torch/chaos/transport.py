"""FaultyTransport: the chaos plane's wire tap around any Transport.

Wraps a concrete transport (InmemTransport in scenario clusters,
TCPTransport in live fleets — anything implementing the Transport
surface) and applies a :class:`~babble_tpu_torch.chaos.injector.FaultInjector`
's decisions to every sync:

- **outbound** (``sync``): partition check, drop (TransportError),
  delay (awaited sleep), duplicate (a shadow copy of the request is
  fired at the peer and its response discarded — each caller still
  receives the response to *its own* request, because every attempt
  carries its own RPC future), reorder (extra delay on this message
  relative to the ones behind it);
- **inbound** (consumer pump, only started when the plan needs it):
  partition enforcement on the receive side, and the ``stale_replay``
  byzantine mode — this node answers a sampled fraction of inbound
  syncs with a cached stale response instead of fresh state.

Injected faults are counted on ``babble_chaos_faults_total{kind=...}``;
the node's constructor calls ``instrument(registry)`` (the same seam
TCPTransport uses), so the series lands on that node's /metrics and
dashboards can tell injected faults from organic ones.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Dict, Optional

from ..net.commands import (
    FastForwardResponse,
    PushRequest,
    SyncRequest,
    SyncResponse,
)
from ..net.transport import RPC, Transport, TransportError
from ..obs import Registry
from .injector import FAULT_KINDS, FaultInjector


class FaultyTransport(Transport):
    def __init__(
        self,
        inner: Transport,
        injector: FaultInjector,
        node_id: int,
        addr_index: Dict[str, int],
        registry: Optional[Registry] = None,
        forge_key=None,
    ):
        self.inner = inner
        self.injector = injector
        self.node_id = node_id
        self.addr_index = dict(addr_index)
        #: participant key of the forge_snapshot byzantine actor — the
        #: doctored snapshot must carry a self-consistent re-signed
        #: proof, or the forgery dies at the joiner's cheapest check
        #: instead of exercising the attestation quorum (chaos/forge.py)
        self._forge_key = forge_key
        self._closed = False
        self._consumer: "asyncio.Queue[RPC]" = asyncio.Queue()
        self._pump: Optional[asyncio.Task] = None
        self._bg: set = set()
        #: recent responses this node served — the stale_replay actor's
        #: ammunition (bounded: replaying arbitrarily ancient state is
        #: indistinguishable from unknown-peer noise)
        self._stale_cache: "deque[SyncResponse]" = deque(maxlen=8)
        self._bind_metrics(registry if registry is not None else Registry())

    # ------------------------------------------------------------------
    # metrics

    def _bind_metrics(self, registry: Registry) -> None:
        self._m_faults = registry.counter(
            "babble_chaos_faults_total",
            "faults injected by the chaos plane, by kind",
            labelnames=("kind",),
        )
        for kind in FAULT_KINDS:
            self._m_faults.labels(kind)   # series visible from boot

    def instrument(self, registry: Registry) -> None:
        """Re-home the chaos counters on the node's registry and pass
        the seam through to the wrapped transport (TCPTransport's
        bytes/pool series must keep landing on /metrics too)."""
        self._bind_metrics(registry)
        inner_instrument = getattr(self.inner, "instrument", None)
        if inner_instrument is not None:
            inner_instrument(registry)

    def _count(self, kind: str) -> None:
        self._m_faults.labels(kind).inc()

    # ------------------------------------------------------------------
    # Transport surface

    def local_addr(self) -> str:
        return self.inner.local_addr()

    @property
    def consumer(self) -> "asyncio.Queue[RPC]":
        if not self._needs_pump():
            return self.inner.consumer
        if self._pump is None:
            self._pump = asyncio.get_running_loop().create_task(
                self._pump_loop()
            )
        return self._consumer

    def _needs_pump(self) -> bool:
        return bool(self.injector.plan.partitions) or (
            self.injector.is_stale_replayer(self.node_id)
        ) or self.injector.is_snapshot_forger(self.node_id)

    async def sync(self, target, req, timeout=None):
        if self._closed:
            raise TransportError("transport closed")
        await self._outbound_gate(target, req, timeout)
        return await self.inner.sync(target, req, timeout)

    async def _outbound_gate(self, target, req, timeout) -> None:
        """One per-link fault decision for an outbound gossip-class
        message (sync AND push — the pipelined path's speculative
        shipments take the same drop/delay/duplicate/reorder draws from
        the same per-link RNG stream, so wrapping the multiplexed
        transport changes nothing about the stream contract: the k-th
        attempt on a link draws the k-th fault, whatever the verb)."""
        dst = self.addr_index.get(target)
        if dst is None or dst == self.node_id:
            return
        inj = self.injector
        src = self.node_id
        if inj.link_blocked(src, dst):
            inj.record("partition", src, dst)
            self._count("partition")
            raise TransportError(f"chaos: partitioned from {target}")
        act = inj.outbound(src, dst)
        if act.drop:
            self._count("ge_drop" if act.ge else "drop")
            raise TransportError(f"chaos: dropped sync to {target}")
        # WAN bandwidth model (token bucket + size-proportional
        # serialization): sized from the command's cheap host-side
        # estimate — the same seam the off-loop codec uses — so the
        # model never encodes anything just to measure it
        bw_s = inj.bw_delay_s(src, dst, req.approx_size())
        if bw_s > 0:
            inj.record("bw_delay", src, dst,
                       ms=round(bw_s * 1e3, 3))
            self._count("bw_delay")
            await asyncio.sleep(bw_s)
        if act.delay_s > 0:
            self._count("delay")
            await asyncio.sleep(act.delay_s)
        if act.duplicate:
            self._count("duplicate")
            t = asyncio.ensure_future(
                self._shadow_send(target, req, timeout)
            )
            self._bg.add(t)
            t.add_done_callback(self._bg.discard)
        if act.reorder_s > 0:
            self._count("reorder")
            await asyncio.sleep(act.reorder_s)

    async def _shadow_send(self, target, req, timeout) -> None:
        """The duplicate copy: delivered for real, response discarded.
        Its fate must never surface to the caller — the original
        attempt's future is the only one anyone awaits."""
        try:
            await self.inner.sync(target, req, timeout)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    async def request(self, target, req, timeout=None):
        """Verb-tagged RPCs.  Pushes are gossip-class: they take the
        full per-link fault gate exactly like syncs (same RNG stream).
        Fast-forward fetches honor partitions — a snapshot must not
        cross a split brain — but skip the link-noise faults: one
        logical catch-up is modeled as one decision, on the sync path
        that triggered it."""
        if self._closed:
            raise TransportError("transport closed")
        if isinstance(req, (SyncRequest, PushRequest)):
            await self._outbound_gate(target, req, timeout)
            return await self.inner.request(target, req, timeout)
        dst = self.addr_index.get(target)
        if dst is not None and dst != self.node_id \
                and self.injector.link_blocked(self.node_id, dst):
            self.injector.record("partition", self.node_id, dst)
            self._count("partition")
            raise TransportError(f"chaos: partitioned from {target}")
        return await self.inner.request(target, req, timeout)

    async def close(self) -> None:
        self._closed = True
        for t in [self._pump] + list(self._bg):
            if t is not None:
                t.cancel()
        self._pump = None
        self._bg.clear()
        await self.inner.close()

    # ------------------------------------------------------------------
    # inbound pump

    async def _pump_loop(self) -> None:
        inner_consumer = self.inner.consumer
        while not self._closed:
            rpc = await inner_consumer.get()
            req = rpc.command
            src = None
            if isinstance(req, SyncRequest) or hasattr(req, "from_addr"):
                src = self.addr_index.get(getattr(req, "from_addr", ""))
            if src is not None and src != self.node_id \
                    and self.injector.link_blocked(src, self.node_id):
                self.injector.record("partition", src, self.node_id)
                self._count("partition")
                rpc.respond(None, error="chaos: partitioned")
                continue
            if (isinstance(req, SyncRequest) and self._stale_cache
                    and self.injector.stale_replay(self.node_id)):
                pick = self.injector.stale_pick(
                    self.node_id, len(self._stale_cache)
                )
                self.injector.record(
                    "stale_replay", self.node_id,
                    src if src is not None else -1,
                )
                self._count("stale_replay")
                rpc.respond(self._stale_cache[pick])
                continue
            fwd = RPC(command=req)
            self._consumer.put_nowait(fwd)
            t = asyncio.ensure_future(self._snoop(rpc, fwd, src))
            self._bg.add(t)
            t.add_done_callback(self._bg.discard)

    async def _snoop(self, orig: RPC, fwd: RPC, src=None) -> None:
        """Relay the node's answer back to the caller's RPC, caching
        sync responses for the stale-replay actor.  Error strings pass
        through verbatim — the ``too_late:`` marker the fast-forward
        path keys off must survive the relay."""
        try:
            resp = await fwd.response()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            orig.respond(None, error=str(e))
            return
        if isinstance(resp, SyncResponse):
            self._stale_cache.append(resp)
        if (isinstance(resp, FastForwardResponse)
                and self._forge_key is not None
                and self.injector.snapshot_forge(self.node_id)):
            from .forge import forge_snapshot_response

            # executor hop: the forgery re-packs a multi-MB snapshot
            # (codec-on-loop discipline); awaited before respond, so
            # the runner's sequential determinism is untouched
            forged = await asyncio.get_running_loop().run_in_executor(
                None, forge_snapshot_response, resp, self._forge_key
            )
            if forged is not resp:
                self.injector.record(
                    "forged_snapshot", self.node_id,
                    src if src is not None else -1,
                )
                self._count("forged_snapshot")
                resp = forged
        orig.respond(resp)
