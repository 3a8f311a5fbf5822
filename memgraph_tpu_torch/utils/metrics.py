"""A process-wide registry of counters, gauges and summaries.

The port's stand-in for memgraph_tpu/observability/metrics.py's
``global_metrics``, kept to what the serving plane reads: the kernel
server's health reply ships its counters to clients (another process),
and the kernel routes count their routed and fallen-back calls here.
``Histogram`` (the reference's fixed exponential buckets, with
exemplars) and ``promname`` serve observability/stats.py's per-query
latencies and expositions.
"""

from __future__ import annotations

import bisect
import re
import threading
import time

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: the reference's buckets: 0.1 ms doubling 24 times
DEFAULT_BUCKETS = tuple(0.0001 * (2 ** i) for i in range(24))


def promname(name: str) -> str:
    """Prometheus metric-name sanitization: every invalid character maps
    to '_' and a leading digit gets a '_' prefix."""
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


class Histogram:
    """Fixed-bucket histogram with cumulative exposition and exemplars
    (the reference's).  Not thread-safe on its own: its owner serializes
    access."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "exemplars")

    def __init__(self, bounds=DEFAULT_BUCKETS) -> None:
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        #: bucket index -> (value, trace_id, unix_ts) of the latest
        #: traced observation landing in that bucket
        self.exemplars: dict[int, tuple[float, str, float]] = {}

    def observe(self, value: float, trace_id: str | None = None) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        self.bucket_counts[idx] += 1
        self.count += 1
        self.sum += value
        if trace_id:
            self.exemplars[idx] = (value, trace_id, time.time())

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the bucket the rank falls in
        (PromQL's histogram_quantile)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] * 2
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1] * 2

    def cumulative(self):
        """[(le_bound_or_None, cumulative_count)], exposition order."""
        total = 0
        out = []
        for i, c in enumerate(self.bucket_counts):
            total += c
            bound = self.bounds[i] if i < len(self.bounds) else None
            out.append((bound, total))
        return out


class Metrics:
    """Thread-safe named values: ``increment`` (counters), ``set_gauge``
    and ``observe`` (a summary: its count and sum)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._summaries: dict[str, list] = {}

    def increment(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            s = self._summaries.setdefault(name, [0, 0.0])
            s[0] += 1
            s[1] += float(value)

    def value(self, name: str) -> float:
        """A counter's or a gauge's value (0.0 when never set)."""
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0.0))

    def snapshot(self) -> list:
        """[(name, kind, value)]: each counter and gauge, and each
        summary as ``<name>.count`` and ``<name>.sum``."""
        with self._lock:
            out = [(k, "counter", v) for k, v in self._counters.items()]
            out += [(k, "gauge", v) for k, v in self._gauges.items()]
            for k, (n, total) in self._summaries.items():
                out += [(f"{k}.count", "summary", float(n)),
                        (f"{k}.sum", "summary", total)]
        return out


global_metrics = Metrics()
