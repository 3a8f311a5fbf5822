"""PROFILE instrumentation: per-operator pulls, rows, time, memory, and
device attribution.

Counterpart of the reference's ScopedProfile/ProfilingStats
(memgraph/src/query/plan/profile.cpp, scoped_profile.hpp): every
operator cursor is wrapped with counters + a timer; results render as
the profile tree (OPERATOR, ACTUAL HITS, ROWS, RELATIVE TIME, ABSOLUTE
TIME, PEAK MEM).

PROFILE v2:

* ``attach_profiling`` no longer ``copy.deepcopy``-s the plan. Each
  operator NODE is shallow-copied (expressions, symbols and every other
  referenced object stay shared) and its child links are rewired to
  profiled wrappers — so profiling a plan-cache-hit query costs O(plan
  nodes) pointer work instead of a deep clone of the whole tree, and
  the CACHED plan object is never mutated (the regression test proves a
  PROFILE run neither poisons the cache nor changes results).

* the collector tracks, per operator: ``hits`` (cursor pulls, including
  the exhausting one), ``rows`` (frames produced), inclusive ``time``,
  and ``peak_mem`` — a sampled ``approx_size`` estimate of the largest
  frame the operator emitted (first frames + every 16th, so wide rows
  are caught without paying a size walk per frame).

* ``profile_rows`` appends DEVICE ATTRIBUTION rows when the query's
  stage accumulator (observability/stats.py) saw device work: kernel
  dispatch, transfer, compile and iterate seconds — so ``PROFILE`` on
  an analytics-routed query shows where the HBM-seconds went even when
  the kernel ran in the resident server process.

Copy of memgraph_tpu/query/plan/profile.py for the port (its imports the port's own).
"""

from __future__ import annotations

import copy
import time

from .operators import LogicalOperator

#: every attribute that may hold a child operator (kept in sync with
#: profile_rows' walk and the planner's tree shapes)
CHILD_ATTRS = ("input", "subplan", "match_plan", "create_plan",
               "update_plan", "left", "right")

#: frame-size sampling cadence: the first _MEM_SAMPLE_HEAD frames are
#: always measured, then every _MEM_SAMPLE_EVERY-th
_MEM_SAMPLE_HEAD = 4
_MEM_SAMPLE_EVERY = 16


class ProfileCollector:
    def __init__(self) -> None:
        self.stats: dict[int, dict] = {}

    def entry(self, op_id: int, name: str) -> dict:
        if op_id not in self.stats:
            self.stats[op_id] = {"name": name, "hits": 0, "rows": 0,
                                 "time": 0.0, "peak_mem": 0}
        return self.stats[op_id]


class ProfiledOp(LogicalOperator):
    """Cursor wrapper around ONE (shallow-copied) operator node."""

    def __init__(self, inner: LogicalOperator, collector: ProfileCollector):
        self.inner = inner
        self.collector = collector

    def __getattr__(self, name):
        # operators occasionally read child attributes (symbols, flags);
        # delegate so a wrapped child is indistinguishable from the
        # bare operator for everything except cursor()
        if name in ("inner", "collector"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def name(self) -> str:
        return self.inner.name()

    def children(self):
        return [c for c in (getattr(self.inner, attr, None)
                            for attr in CHILD_ATTRS)
                if isinstance(c, LogicalOperator)]

    def cursor(self, ctx):
        from ...utils.memory_tracker import approx_size
        entry = self.collector.entry(id(self), self.inner.name())
        it = self.inner.cursor(ctx)
        rows = 0
        while True:
            t0 = time.perf_counter()
            try:
                frame = next(it)
            except StopIteration:
                entry["time"] += time.perf_counter() - t0
                entry["hits"] += 1
                return
            entry["time"] += time.perf_counter() - t0
            entry["hits"] += 1
            entry["rows"] += 1
            if rows < _MEM_SAMPLE_HEAD or rows % _MEM_SAMPLE_EVERY == 0:
                size = approx_size(frame)
                if size > entry["peak_mem"]:
                    entry["peak_mem"] = size
            rows += 1
            yield frame


def attach_profiling(plan: LogicalOperator):
    """Wrap every operator for profiling WITHOUT cloning the plan deeply.

    Returns (wrapped_plan, collector). Each node is ``copy.copy``-ed (a
    shallow, O(fields) pointer copy — expressions and symbols stay
    shared with the cached plan) and its child attributes are rewired
    to wrapped children; the original tree is never touched, so a
    cached plan can be profiled concurrently with unprofiled runs.

    Self-time accounting: the wrapper measures inclusive time;
    rendering subtracts children's inclusive time to show self time.
    """
    collector = ProfileCollector()

    def wrap(op):
        if not isinstance(op, LogicalOperator):
            return op
        clone = copy.copy(op)
        for attr in CHILD_ATTRS:
            child = getattr(clone, attr, None)
            if isinstance(child, LogicalOperator):
                setattr(clone, attr, wrap(child))
        return ProfiledOp(clone, collector)

    return wrap(plan), collector


#: render order — tests key on [0]=operator and [1]=hits
PROFILE_COLUMNS = ["OPERATOR", "ACTUAL HITS", "ROWS", "RELATIVE TIME",
                   "ABSOLUTE TIME", "PEAK MEM (BYTES)"]


def profile_rows(plan, collector: ProfileCollector, total_time: float,
                 stages: dict | None = None):
    """Render the profile tree (plus device attribution) as rows."""
    def walk(op, depth):
        if isinstance(op, ProfiledOp):
            stats = collector.stats.get(
                id(op), {"name": op.inner.name(), "hits": 0, "rows": 0,
                         "time": 0.0, "peak_mem": 0})
            children = op.children()
        else:
            stats = {"name": op.name(), "hits": 0, "rows": 0,
                     "time": 0.0, "peak_mem": 0}
            children = [c for c in (getattr(op, attr, None)
                                    for attr in CHILD_ATTRS)
                        if isinstance(c, LogicalOperator)]
        child_time = sum(collector.stats.get(id(c), {}).get("time", 0.0)
                         for c in children)
        self_time = max(stats["time"] - child_time, 0.0)
        rel = (self_time / total_time * 100.0) if total_time > 0 else 0.0
        indent = "| " * depth
        yield [f"{indent}* {stats['name']}", stats["hits"], stats["rows"],
               f"{rel:.6f} %", f"{self_time * 1000:.6f} ms",
               stats["peak_mem"]]
        for child in children:
            yield from walk(child, depth + 1)

    yield from walk(plan, 0)

    # device attribution: where the query's HBM-seconds went, from the
    # stage accumulator (kernel replies merge their server-side splits
    # into it, so a kernel-server-routed dispatch attributes here too)
    for stage in sorted(stages or {}):
        slot = stages[stage]
        seconds = float(slot.get("seconds", 0.0))
        rel = (seconds / total_time * 100.0) if total_time > 0 else 0.0
        yield [f">> device: {stage}", int(slot.get("count", 0)), 0,
               f"{rel:.6f} %", f"{seconds * 1000:.6f} ms", 0]
