"""Per-query and process-wide memory accounting.

Python analog of the reference's allocation tracking
(memgraph/src/utils/memory_tracker.cpp and
src/memory/query_memory_control.cpp): the reference hooks the allocator
per thread; here the Volcano operators account their MATERIALIZED state
(aggregation groups, sort buffers, DISTINCT sets, eager barriers,
collected lists, result accumulation) — the places where query memory
actually grows without bound — against a per-query limit, and every
query's usage also counts against an optional process-wide limit.

`QUERY MEMORY LIMIT 100 MB` (grammar: Cypher.g4:134-136) attaches a
per-query limit; the `--memory-limit` flag sets the global one.

Copy of memgraph_tpu/utils/memory_tracker.py for the port (its imports the port's own).
"""

from __future__ import annotations

import sys
import threading

from ..exceptions import MemgraphTpuError


class MemoryLimitException(MemgraphTpuError):
    pass


def approx_size(value, _depth: int = 2) -> int:
    """Cheap recursive size estimate (caps recursion; containers sample
    the first 16 elements and extrapolate)."""
    try:
        size = sys.getsizeof(value)
    except TypeError:  # pragma: no cover - exotic objects
        return 64
    if _depth <= 0:
        return size
    if isinstance(value, (list, tuple, set, frozenset)):
        n = len(value)
        if n:
            sample = list(value)[:16]
            per = sum(approx_size(v, _depth - 1) for v in sample)
            size += per * n // len(sample)
        return size
    if isinstance(value, dict):
        n = len(value)
        if n:
            items = list(value.items())[:16]
            per = sum(approx_size(k, _depth - 1) + approx_size(v, _depth - 1)
                      for k, v in items)
            size += per * n // len(items)
        return size
    return size


class GlobalMemoryTracker:
    """Sum of all live query trackers vs an optional process limit."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.limit: int | None = None
        self.current = 0
        self.peak = 0

    def add(self, nbytes: int) -> None:
        with self._lock:
            if (self.limit is not None
                    and self.current + nbytes > self.limit):
                # never record the breaching chunk: callers treat a raise
                # as "nothing was added" (QueryMemoryTracker symmetry)
                raise MemoryLimitException(
                    f"global memory limit exceeded: tracked "
                    f"{self.current + nbytes} bytes > limit {self.limit} "
                    "(raise --memory-limit or add QUERY MEMORY LIMIT to "
                    "the offending queries)")
            self.current += nbytes
            if self.current > self.peak:
                self.peak = self.current

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.current -= nbytes
            if self.current < 0:
                self.current = 0


GLOBAL = GlobalMemoryTracker()


class QueryMemoryTracker:
    """One per query execution; released wholesale when the query ends."""

    __slots__ = ("limit", "current", "peak", "_global")

    def __init__(self, limit: int | None = None,
                 global_tracker: GlobalMemoryTracker = None) -> None:
        self.limit = limit
        self.current = 0
        self.peak = 0
        self._global = GLOBAL if global_tracker is None else global_tracker

    def add(self, nbytes: int) -> None:
        # order matters for symmetry with release_all(): self.current must
        # only ever count bytes that were also added to the global tracker,
        # so a raise here (per-query or global limit) records nothing
        if self.limit is not None and self.current + nbytes > self.limit:
            raise MemoryLimitException(
                f"query memory limit exceeded: tracked "
                f"{self.current + nbytes} bytes > limit {self.limit} "
                "(QUERY MEMORY LIMIT)")
        self._global.add(nbytes)
        self.current += nbytes
        if self.current > self.peak:
            self.peak = self.current

    def add_value(self, value) -> None:
        self.add(approx_size(value))

    def release_all(self) -> None:
        self._global.release(self.current)
        self.current = 0
