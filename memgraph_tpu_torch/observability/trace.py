"""Spans: low-overhead, always-compiled-in request tracing.

Port of memgraph_tpu/observability/trace.py.  One request yields ONE
connected trace across the process boundaries the port has: the kernel
server's request protocol (a ``trace`` carrier in the request header,
the daemon's spans shipped home in the reply's ``spans``), and the
device extents the ops open inside it (``device.chunk``,
``device.transfer``).

Design rules (the reference's):

* **Disarmed costs ~nothing.** Tracing is armed only by
  ``MEMGRAPH_TPU_TRACE=1`` (or ``enable()``).  Every public entry point
  starts with one attribute read; disarmed, ``span()`` returns a shared
  no-op context manager and ``inject()`` / ``activate()`` /
  ``begin_trace()`` return ``None`` / no-ops.

* **Spans open only through this module's context-manager API**:
  ``span()`` for synchronous extents, ``record_span()`` for records
  made after the fact, ``begin_trace()`` for a long-lived root finished
  by its owner.  Every name is one of :data:`SPAN_NAMES`.

* **Head-based sampling, slow and errored traces always kept.**  The
  keep / drop verdict is taken once, at the root, from a hash of the
  trace id against ``MEMGRAPH_TPU_TRACE_SAMPLE``, and travels in the
  carrier.  A trace whose root ran ``MEMGRAPH_TPU_TRACE_SLOW_MS`` or
  more, or that holds an errored span, is kept whatever the verdict.

* **Cross-process spans ship home.**  A kernel-server dispatch records
  its spans under the propagated trace id; ``take_trace()`` pops them
  into the reply and the caller ``adopt_spans()``-s them.

CUDA launches are asynchronous: a span's extent is the host's, and it
covers the device work it launched only where the op already reads a
value back inside it (the segment fixpoints read their error a step,
the PPR batch its lanes' errors).  Nothing here synchronizes the card.

Exports: ``traces_json()``, ``to_jsonl()`` and ``chrome_trace()``
(Chrome trace-event JSON for Perfetto / chrome://tracing).
``MEMGRAPH_TPU_TRACE_XLA=1`` also opens every span as a
``torch.profiler.record_function`` range, so spans appear in a
``torch.profiler`` trace (and as NVTX ranges under ``emit_nvtx``); the
switch keeps the reference's name.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from ..utils.locks import fork_safe

log = logging.getLogger(__name__)

ENV_ARM = "MEMGRAPH_TPU_TRACE"
ENV_SAMPLE = "MEMGRAPH_TPU_TRACE_SAMPLE"
ENV_SLOW_MS = "MEMGRAPH_TPU_TRACE_SLOW_MS"
ENV_RING = "MEMGRAPH_TPU_TRACE_RING"
ENV_XLA = "MEMGRAPH_TPU_TRACE_XLA"

#: Every span name code may open (the reference's registry, kept whole so
#: that a carrier from the reference's processes names nothing unknown).
SPAN_NAMES = (
    "bolt.run",            # one Bolt RUN..PULL* exchange (session root)
    "query",               # interpreter root: prepare -> summary
    "query.parse",         # text -> AST (cache-aware)
    "query.plan",          # AST -> operator tree (cache-aware)
    "query.execute",       # stream drain: first pull -> exhaustion
    "query.commit",        # autocommit finalization (interpreter side)
    "mvcc.begin",          # storage transaction begin
    "mvcc.commit",         # storage engine commit (durability + repl)
    "kernel.request",      # client->kernel-server round trip
    "kernel.dispatch",     # server-side supervised dispatch
    "device.transfer",     # partition-centric blocking + device_put
    "device.chunk",        # one compiled chunk of device iterations
    "mp.execute",          # parent->mp-worker round trip
    "mp.worker",           # worker-side prepare+pull
    "shard.request",       # router->shard-owner round trip (r18)
    "shard.worker",        # shard-worker-side statement execution
    "repl.ship",           # one WAL frame ship + ack, per replica
    "repl.apply",          # replica-side system-txn application
    "raft.rpc",            # outbound raft RPC (request + response)
    "raft.handle",         # inbound raft RPC application
)

_SPAN_NAME_SET = frozenset(SPAN_NAMES)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def _sample_decision(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling verdict from the trace id: every
    process that sees the id would agree even without the carrier."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / 0xFFFFFFFF < rate


class TraceContext:
    """The propagated identity: (trace_id, span_id, sampled)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def carrier(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}


class _NoopSpan:
    """Shared disarmed-path context manager: one allocation per process."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _NullActivation:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_ACTIVATION = _NullActivation()


def _clean_attrs(attrs: dict) -> dict:
    """Attrs must survive JSON serialization across process boundaries."""
    out = {}
    for k, v in attrs.items():
        if v is None or isinstance(v, (str, int, float, bool)):
            out[k] = v
        else:
            out[k] = str(v)
    return out


class _LiveSpan:
    """An open span; created only while armed, via span()."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "_t0_wall", "_t0_perf", "attrs", "status", "error",
                 "_prev_ctx", "_xla")

    def __init__(self, tracer: "Tracer", name: str, ctx_parent, attrs):
        self._tracer = tracer
        self.name = name
        if ctx_parent is not None:
            self.trace_id = ctx_parent.trace_id
            self.parent_id = ctx_parent.span_id
            sampled = ctx_parent.sampled
        else:
            self.trace_id = _new_id(16)
            self.parent_id = None
            sampled = _sample_decision(self.trace_id, tracer.sample_rate)
        self.span_id = _new_id()
        self.attrs = _clean_attrs(attrs) if attrs else {}
        self.status = "ok"
        self.error = None
        self._prev_ctx = None
        self._xla = None
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()
        # children opened inside this extent hang off this span
        self._prev_ctx = tracer._swap_current(
            TraceContext(self.trace_id, self.span_id, sampled))
        if tracer.xla_bridge:
            self._xla = tracer._enter_xla(name)

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(_clean_attrs(attrs))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.status = "error"
            self.error = f"{exc_type.__name__}: {exc}"
        t = self._tracer
        if self._xla is not None:
            t._exit_xla(self._xla)
        dur = time.perf_counter() - self._t0_perf
        t._swap_current(self._prev_ctx)
        t._record(self.trace_id, {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "ts": self._t0_wall, "dur_s": dur, "status": self.status,
            "error": self.error, "attrs": self.attrs,
            "pid": os.getpid(), "tid": threading.get_ident()})
        return False


class _Activation:
    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer: "Tracer", ctx: TraceContext) -> None:
        self._tracer = tracer
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = self._tracer._swap_current(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        self._tracer._swap_current(self._prev)
        return False


class _Adoption(_Activation):
    """Activation of a REMOTE parent context; with retain=True the trace
    is finalized locally on scope exit (for one-way hops whose spans
    cannot ship back — raft/replication appliers)."""

    __slots__ = ("_retain",)

    def __init__(self, tracer, ctx, retain: bool) -> None:
        super().__init__(tracer, ctx)
        self._retain = retain

    def __exit__(self, exc_type, exc, tb):
        super().__exit__(exc_type, exc, tb)
        if self._retain:
            self._tracer._finalize(self._ctx.trace_id, self._ctx.sampled,
                                   root_dur_s=None)
        return False


class TraceHandle:
    """The one sanctioned long-lived root span (a query's lifetime spans
    multiple protocol messages, so its root cannot be a ``with`` block).
    Mint with begin_trace(); the owner calls finish() exactly once."""

    __slots__ = ("_tracer", "name", "ctx", "parent_id", "t0_wall",
                 "t0_perf", "_done", "_owns_finalize")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 parent_id: str | None, owns_finalize: bool) -> None:
        self._tracer = tracer
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.t0_wall = time.time()
        self.t0_perf = time.perf_counter()
        self._done = False
        # finalization ownership: only the OUTERMOST local handle (a
        # true root, or the process-edge adopter of an external
        # client's carrier) moves the trace to the retained ring — an
        # inner handle (the interpreter's "query" under a Bolt session,
        # or inside an mp/kernel worker whose spans ship home via
        # take_trace) must leave the buffer alone
        self._owns_finalize = owns_finalize

    @property
    def trace_id(self) -> str:
        return self.ctx.trace_id

    def finish(self, status: str = "ok", error: str | None = None,
               force_keep: bool = False, **attrs) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self.t0_perf
        t = self._tracer
        t._record(self.ctx.trace_id, {
            "trace_id": self.ctx.trace_id, "span_id": self.ctx.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "ts": self.t0_wall, "dur_s": dur, "status": status,
            "error": error, "attrs": _clean_attrs(attrs),
            "pid": os.getpid(), "tid": threading.get_ident()})
        if self._owns_finalize:
            t._finalize(self.ctx.trace_id, self.ctx.sampled,
                        root_dur_s=dur, force=force_keep)
        elif force_keep:
            # not the retention owner (e.g. the interpreter under a Bolt
            # session root): sticky-mark the trace so the owner keeps it
            t.force_keep(self.ctx.trace_id)


class Tracer:
    """Process-wide tracer: current-context registry + span buffers."""

    #: open (unfinalized) traces the buffer tolerates before evicting
    #: the oldest — orphans (a deadline-exceeded dispatch whose spans
    #: were never taken) must not leak unboundedly
    MAX_ACTIVE = 512

    def __init__(self) -> None:
        self._armed = _env_flag(ENV_ARM)
        self.sample_rate = _env_float(ENV_SAMPLE, 1.0)
        self.slow_ms = _env_float(ENV_SLOW_MS, 250.0)
        self.ring_cap = int(_env_float(ENV_RING, 256))
        self.xla_bridge = _env_flag(ENV_XLA)
        self._tls = threading.local()
        self._lock = threading.Lock()
        #: trace_id -> {"spans": [dict], "error": bool}
        self._active: dict[str, dict] = {}
        #: finalized, retained traces (each a list of span dicts)
        self._finished: list[list[dict]] = []
        self._counts = {"started": 0, "kept": 0, "dropped": 0}

    # --- arming ------------------------------------------------------------

    def enable(self, sample: float | None = None,
               slow_ms: float | None = None) -> None:
        if sample is not None:
            self.sample_rate = sample
        if slow_ms is not None:
            self.slow_ms = slow_ms
        self._armed = True

    def disable(self) -> None:
        self._armed = False

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._finished.clear()
            self._counts = {"started": 0, "kept": 0, "dropped": 0}

    # --- current context ----------------------------------------------------

    def _swap_current(self, ctx):
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        return prev

    def current(self) -> TraceContext | None:
        if not self._armed:
            return None
        return getattr(self._tls, "ctx", None)

    # --- span recording -----------------------------------------------------

    def _record(self, trace_id: str, span: dict) -> None:
        with self._lock:
            entry = self._active.get(trace_id)
            if entry is None:
                entry = {"spans": [], "error": False}
                self._active[trace_id] = entry
                self._counts["started"] += 1
                while len(self._active) > self.MAX_ACTIVE:
                    victim = next(iter(self._active))
                    del self._active[victim]
                    self._counts["dropped"] += 1
            entry["spans"].append(span)
            if span.get("status") == "error":
                entry["error"] = True

    def force_keep(self, trace_id: str) -> None:
        """Sticky keep-mark on a still-open trace (slow-query linkage)."""
        with self._lock:
            entry = self._active.get(trace_id)
            if entry is not None:
                entry["force"] = True

    def _finalize(self, trace_id: str, sampled: bool,
                  root_dur_s: float | None, force: bool = False) -> None:
        with self._lock:
            entry = self._active.pop(trace_id, None)
            if entry is None:
                return
            slow = root_dur_s is not None and \
                root_dur_s * 1000.0 >= self.slow_ms
            if not (force or entry.get("force") or sampled or slow
                    or entry["error"]):
                self._counts["dropped"] += 1
                return
            self._finished.append(entry["spans"])
            self._counts["kept"] += 1
            while len(self._finished) > self.ring_cap:
                self._finished.pop(0)

    def take_trace(self, trace_id: str) -> list[dict]:
        """Pop the spans accumulated for an ADOPTED trace, for shipping
        back to the process that owns the root."""
        with self._lock:
            entry = self._active.pop(trace_id, None)
        return entry["spans"] if entry else []

    def adopt_spans(self, spans) -> None:
        """Merge spans a remote process shipped back into their (still
        open) local trace."""
        if not self._armed or not spans:
            return
        for span in spans:
            tid = span.get("trace_id")
            if tid:
                self._record(tid, dict(span))

    # --- snapshots / exporters ---------------------------------------------

    def finished_traces(self) -> list[list[dict]]:
        with self._lock:
            return [list(spans) for spans in self._finished]

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    # --- profiler-range bridge (MEMGRAPH_TPU_TRACE_XLA) ----------------------

    def _enter_xla(self, name: str):
        try:
            import torch
            ann = torch.profiler.record_function(f"mgtrace:{name}")
            ann.__enter__()
            return ann
        except Exception as e:  # noqa: BLE001 — profiling never breaks serving
            log.debug("profiler range bridge unavailable: %s", e)
            return None

    def _exit_xla(self, ann) -> None:
        if ann is None:
            return
        try:
            ann.__exit__(None, None, None)
        except Exception as e:  # noqa: BLE001 — profiling never breaks serving
            log.debug("profiler range exit failed: %s", e)


TRACER = fork_safe(Tracer())


# --------------------------------------------------------------------------
# module-level API (what product code calls)
# --------------------------------------------------------------------------


def armed() -> bool:
    return TRACER._armed


def enable(sample: float | None = None, slow_ms: float | None = None) -> None:
    TRACER.enable(sample=sample, slow_ms=slow_ms)


def disable() -> None:
    TRACER.disable()


def span(name: str, **attrs):
    """Open a child span of the current context (context manager).

    Disarmed: returns the shared no-op (one attribute read + one call).
    The span object is truthy only when armed, so hot paths can guard
    attr computation with ``if sp:``.
    """
    t = TRACER
    if not t._armed:
        return _NOOP
    return _LiveSpan(t, name, t.current(), attrs)


def record_span(name: str, start_wall: float, duration_s: float,
                span_id: str | None = None, status: str = "ok",
                **attrs) -> None:
    """Atomically record a completed span under the current context —
    for extents whose start and end straddle protocol messages (e.g.
    query.execute across PULL batches). No begin/end imbalance is
    possible: one call, one span."""
    t = TRACER
    if not t._armed:
        return
    ctx = t.current()
    if ctx is None:
        return
    t._record(ctx.trace_id, {
        "trace_id": ctx.trace_id, "span_id": span_id or _new_id(),
        "parent_id": ctx.span_id, "name": name, "ts": start_wall,
        "dur_s": duration_s, "status": status, "error": None,
        "attrs": _clean_attrs(attrs), "pid": os.getpid(),
        "tid": threading.get_ident()})


def begin_trace(name: str, carrier: dict | None = None):
    """Mint the root of a locally-owned trace. Returns a TraceHandle (or
    None when disarmed); the owner must call ``handle.finish()`` exactly
    once. If a remote ``carrier`` (or an ambient local context) exists,
    the new root joins that trace as a child."""
    t = TRACER
    if not t._armed:
        return None
    parent = None
    edge = False
    if carrier and carrier.get("trace_id"):
        # a process-edge adoption (e.g. a Bolt client's carrier): this
        # handle is the local retention owner
        parent = TraceContext(str(carrier["trace_id"]),
                              str(carrier.get("span_id") or ""),
                              bool(carrier.get("sampled", True)))
        edge = True
    if parent is None:
        parent = t.current()
    if parent is not None:
        trace_id, sampled = parent.trace_id, parent.sampled
        parent_id = parent.span_id or None
    else:
        trace_id = _new_id(16)
        sampled = _sample_decision(trace_id, t.sample_rate)
        parent_id = None
    ctx = TraceContext(trace_id, _new_id(), sampled)
    return TraceHandle(t, name, ctx, parent_id,
                       owns_finalize=edge or parent_id is None)


def activate(ctx):
    """Make ``ctx`` (a TraceContext, e.g. ``handle.ctx``) current for
    the extent — the cross-thread continuation primitive. None → no-op."""
    if ctx is None or not TRACER._armed:
        return _NULL_ACTIVATION
    return _Activation(TRACER, ctx)


def adopt(carrier: dict | None, retain: bool = False):
    """Activate a REMOTE parent context from a wire carrier. Spans
    opened inside join the remote trace. retain=True finalizes the
    trace locally on exit (one-way hops); retain=False leaves the spans
    for take_trace() to ship back."""
    t = TRACER
    if not t._armed or not carrier or not carrier.get("trace_id"):
        return _NULL_ACTIVATION
    ctx = TraceContext(str(carrier["trace_id"]),
                       str(carrier.get("span_id") or ""),
                       bool(carrier.get("sampled", True)))
    return _Adoption(t, ctx, retain)


def inject() -> dict | None:
    """The wire carrier for the current context, or None."""
    ctx = TRACER.current()
    return ctx.carrier() if ctx is not None else None


def current_trace_id() -> str | None:
    ctx = TRACER.current()
    return ctx.trace_id if ctx is not None else None


def take_trace(trace_id: str) -> list[dict]:
    return TRACER.take_trace(trace_id)


def adopt_spans(spans) -> None:
    TRACER.adopt_spans(spans)


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------


def traces_json(trace_id: str | None = None) -> list[list[dict]]:
    """Retained traces (newest last), optionally filtered by id."""
    traces = TRACER.finished_traces()
    if trace_id:
        traces = [t for t in traces
                  if t and t[0].get("trace_id") == trace_id]
    return traces


def to_jsonl(traces=None) -> str:
    """One span per line — grep/jq-friendly archival form."""
    traces = TRACER.finished_traces() if traces is None else traces
    lines = []
    for spans in traces:
        for s in spans:
            lines.append(json.dumps(s, sort_keys=True, default=str))
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(traces=None) -> dict:
    """Chrome trace-event JSON (load in Perfetto / chrome://tracing).

    Complete ("X") events in microseconds; pid/tid preserved so a
    cross-process trace renders as lanes per process."""
    traces = TRACER.finished_traces() if traces is None else traces
    events = []
    for spans in traces:
        for s in spans:
            args = {"trace_id": s.get("trace_id"),
                    "span_id": s.get("span_id"),
                    "parent_id": s.get("parent_id"),
                    "status": s.get("status")}
            args.update(s.get("attrs") or {})
            if s.get("error"):
                args["error"] = s["error"]
            events.append({
                "name": s.get("name", "?"), "cat": "mgtrace", "ph": "X",
                "ts": float(s.get("ts", 0.0)) * 1e6,
                "dur": max(float(s.get("dur_s", 0.0)) * 1e6, 0.001),
                "pid": s.get("pid", 0), "tid": s.get("tid", 0),
                "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_jsonl(path: str) -> int:
    """Dump every retained span to a JSONL file; returns span count."""
    text = to_jsonl()
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return sum(1 for line in text.splitlines() if line)
