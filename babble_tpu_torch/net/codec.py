"""Off-loop wire codec (the ingress plane's stage (c)): the port's copy
of the JAX package's ``net/codec.py``, with the same size gate and the
same one codec thread.

msgpack encode/decode of gossip frames used to run inline on the event
loop (tcp_transport ``req.pack()`` / ``RESPONSE_CLS.unpack()``).  For
the small frames of an idle fleet that is free, but a loaded sync or
push response carries hundreds of events — encoding it on the loop
stalls every other RPC, heartbeat and submit for the duration, which is
precisely the failure mode the ``asyncio-blocking-call`` lint polices
for sockets and the loop-lag probe measures at runtime.  The companion
``codec-on-loop`` lint rule (analysis/codecloop.py) now polices codecs
the same way: any call chain inside an ``async def`` that reaches
``msgpack.packb``/``unpackb`` must route through this module (or carry
a justified suppression).

Policy: frames under :data:`CODEC_OFFLOAD_BYTES` are transcoded inline
— a thread-pool hop costs more than a sub-64KB msgpack pass — larger
ones go to the dedicated single-thread codec executor.  The size test
is ``approx_size()`` on the command object (encode side; a cheap
``len()``-only estimate, never an encode) or ``len(payload)`` (decode
side).  One codec thread, not a pool: frames from one connection must
not be re-ordered against each other mid-transcode, and a single
thread keeps the worst case at "one big frame in flight" instead of N
concurrent multi-MB allocations.

In the port the gate moves the transcode off the loop but not off the
interpreter lock: ``codec.py`` is msgpack in pure Python, so a large
frame on the codec thread still holds the lock for most of its decode
(about 55 us an event each way), and a fast-forward frame may be up to
256 MB.  The policy is kept as it is; what one large frame costs is
measured by ``chip_smoke.py`` phase 9.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

#: inline-vs-executor threshold: below this the executor hop dominates
CODEC_OFFLOAD_BYTES = 64 * 1024

_codec_executor: Optional[ThreadPoolExecutor] = None


def codec_executor() -> ThreadPoolExecutor:
    """The shared codec thread, created on first use (import must stay
    cheap — processes that never touch a TCP socket import this
    module)."""
    global _codec_executor
    if _codec_executor is None:
        _codec_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="babble-codec"
        )
    return _codec_executor


async def encode_frame(
    msg, observe: Optional[Callable[[float], None]] = None
) -> bytes:
    """``msg.pack()``, off the event loop when the frame is big.

    ``observe`` (histogram callback) receives the wall time of the
    whole stage — executor queueing included, because that queueing IS
    the stage latency a loaded node pays."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    if msg.approx_size() < CODEC_OFFLOAD_BYTES:
        # small-frame fast path: an executor hop (wakeup + GIL handoff)
        # costs more than encoding a sub-64KB frame inline; the size
        # gate above is what keeps big frames off the loop
        body = msg.pack()  # babble-lint: disable=codec-on-loop
    else:
        body = await loop.run_in_executor(codec_executor(), msg.pack)
    if observe is not None:
        observe(loop.time() - t0)
    return body


async def decode_frame(
    cls, payload: bytes, observe: Optional[Callable[[float], None]] = None
):
    """``cls.unpack(payload)``, off the event loop when the frame is
    big (the decode side knows the exact size: ``len(payload)``)."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    if len(payload) < CODEC_OFFLOAD_BYTES:
        # same fast-path rationale as encode_frame: the gate is the size
        obj = cls.unpack(payload)  # babble-lint: disable=codec-on-loop
    else:
        obj = await loop.run_in_executor(
            codec_executor(), cls.unpack, payload
        )
    if observe is not None:
        observe(loop.time() - t0)
    return obj
