"""Metrics registry: Counter / Gauge / Histogram with Prometheus-text
exposition.

Why hand-rolled instead of prometheus_client: the container contract is
"no new dependencies", the registry must import in minimal environments
(the port runs on torch, numpy and the standard library alone), and the
surface this runtime needs is small — monotone counters, gauges (with
optional callback sampling so queue depths are read at scrape time
instead of maintained at every mutation site), and fixed-bucket
histograms for latency/size distributions.

Concurrency model: the gossip runtime is an asyncio loop *plus* worker
threads driving the device pipeline (node/node.py run_in_executor), so
every update path takes a per-child ``threading.Lock``.  Updates are a
few instructions under the lock; exposition snapshots values without
blocking writers for longer than one child at a time.

Histograms carry a ``last`` sample beside the Prometheus sum/count:
``/Stats`` renders its legacy ``*_ms`` keys (the reference's stat map
schema) from the most recent observation, so one instrument serves both
the byte-compatible stats endpoint and the scrapable distribution.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: fixed log-scale latency buckets (seconds), 100 µs .. 60 s in a
#: 1-2.5-5 progression: one shared shape for every duration histogram so
#: cross-metric quantile comparisons line up bucket-for-bucket
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: log-scale size buckets (events / bytes), powers of four
SIZE_BUCKETS: Tuple[float, ...] = (
    1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
    262144.0, 1048576.0, 4194304.0, 16777216.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral floats print as ints."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotone counter."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def sample_lines(self, name: str, labelstr: str) -> List[str]:
        return [f"{name}{labelstr} {_fmt(self._value)}"]

    def to_dict(self) -> dict:
        return {"value": self._value}


class Gauge:
    """Point-in-time value: set/inc/dec, or a callback sampled at
    scrape time (``set_function``) so queue depths and pool sizes need
    no bookkeeping at every mutation site."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                # a dead callback must not take /metrics down with it
                return float("nan")
        return self._value

    def sample_lines(self, name: str, labelstr: str) -> List[str]:
        return [f"{name}{labelstr} {_fmt(self.value)}"]

    def to_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` exposition) plus the
    most recent raw observation (``last``) for /Stats compatibility."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"buckets must be non-empty and increasing: {b}")
        if b[-1] == math.inf:
            b = b[:-1]   # +Inf is implicit
        self._lock = threading.Lock()
        self.buckets = b
        self._counts = [0] * (len(b) + 1)   # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._last: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._last = v

    class _Timer:
        def __init__(self, hist: "Histogram"):
            self._hist = hist

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._hist.observe(time.perf_counter() - self._t0)
            return False

    def time(self) -> "Histogram._Timer":
        return Histogram._Timer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def last(self) -> Optional[float]:
        return self._last

    def sample_lines(self, name: str, labelstr: str) -> List[str]:
        # merge the le label with any family labels
        base = labelstr[1:-1] if labelstr else ""
        sep = "," if base else ""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out = []
        cum = 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            out.append(
                f'{name}_bucket{{{base}{sep}le="{_fmt(bound)}"}} {cum}'
            )
        out.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {total}')
        out.append(f"{name}_sum{labelstr} {_fmt(s)}")
        out.append(f"{name}_count{labelstr} {total}")
        return out

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": self._sum,
                   "last": self._last}
        cum, buckets = 0, []
        for bound, c in zip(self.buckets, counts):
            cum += c
            buckets.append([bound, cum])
        buckets.append(["+Inf", out["count"]])
        out["buckets"] = buckets
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric, optionally labelled.  Unlabelled families
    delegate the child surface (``inc``/``set``/``observe``/...)
    directly, so ``registry.counter(...).inc()`` reads naturally."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...],
                 factory: Callable[[], object]):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._factory = factory
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._children[()] = factory()

    def labels(self, *values) -> object:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._factory()
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # -- unlabelled delegation ----------------------------------------

    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; call .labels() first")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._solo().set_function(fn)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def time(self):
        return self._solo().time()

    def to_dict(self) -> dict:
        return self._solo().to_dict()

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum

    @property
    def last(self) -> Optional[float]:
        return self._solo().last


class Registry:
    """Metric namespace + exposition root.  One per node process-role
    (each Node owns its own so multi-node tests don't cross streams);
    registration is idempotent — asking for an existing name with the
    same kind/labels returns the same family, so independently-wired
    components can share instruments safely."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._register("counter", name, help, labelnames, Counter)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._register("gauge", name, help, labelnames, Gauge)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  ) -> MetricFamily:
        # normalize like Histogram.__init__ (floats, implicit +Inf) so
        # the mismatch check below compares like with like
        b = tuple(float(x) for x in buckets)
        if b and b[-1] == math.inf:
            b = b[:-1]
        return self._register("histogram", name, help, labelnames,
                              lambda: Histogram(b), buckets=b)

    def _register(self, kind, name, help, labelnames, factory,
                  buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        names = tuple(labelnames)
        for ln in names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != names:
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{fam.kind}{fam.labelnames}, not {kind}{names}"
                    )
                if buckets is not None and fam.buckets != buckets:
                    # sharing an instrument is safe only if both sides
                    # mean the same distribution — a silently ignored
                    # bucket layout would collapse one of them into +Inf
                    raise ValueError(
                        f"histogram {name} already registered with "
                        f"buckets {fam.buckets}, not {buckets}"
                    )
                return fam
            fam = MetricFamily(kind, name, help, names, factory)
            fam.buckets = buckets
            self._families[name] = fam
            return fam

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def _labelstr(self, fam: MetricFamily, key: Tuple[str, ...]) -> str:
        if not fam.labelnames:
            return ""
        pairs = ",".join(
            f'{ln}="{_escape_label(v)}"'
            for ln, v in zip(fam.labelnames, key)
        )
        return "{" + pairs + "}"

    def exposition(self) -> str:
        """Prometheus text format, version 0.0.4."""
        lines: List[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                lines.extend(
                    child.sample_lines(fam.name, self._labelstr(fam, key))
                )
        return "\n".join(lines) + "\n"

    def series_count(self) -> int:
        """Number of sample lines (series) exposition would emit."""
        return sum(
            1 for line in self.exposition().splitlines()
            if line and not line.startswith("#")
        )

    def snapshot(self) -> dict:
        """JSON-able dump of every family — the form bench artifacts
        embed so a degraded round carries its own evidence."""
        out = {}
        for fam in self.families():
            series = []
            for key, child in fam.children():
                series.append({
                    "labels": dict(zip(fam.labelnames, key)),
                    **child.to_dict(),
                })
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out
