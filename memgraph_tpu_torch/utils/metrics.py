"""A process-wide registry of counters, gauges and summaries.

The port's stand-in for memgraph_tpu/observability/metrics.py's
``global_metrics``, kept to what the serving plane reads: the kernel
server's health reply ships its counters to clients (another process),
and the kernel routes count their routed and fallen-back calls here.
"""

from __future__ import annotations

import threading


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
