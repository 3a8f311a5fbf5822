"""Per-query accounting, device-stage extents and the saturation plane.

Port of memgraph_tpu/observability/stats.py:

* **Query fingerprints**: a query text normalized to a literal-stripped,
  parameter-normalized shape (``fingerprint_text``); per-fingerprint
  statistics (count, errors, latency histogram, rows, plan-cache hits,
  trace ids) in a bounded space-saving top-K registry
  (:class:`QueryStatsRegistry`: counts are exact while distinct shapes
  are at most K, and over by at most the evicted minimum after).

* **Device-stage attribution**: a thread-local :class:`StageAccumulator`
  collects where device seconds went (``kernel_dispatch`` /
  ``device_transfer`` / ``device_compile`` / ``device_iterate`` and the
  read lane's ``lane_*``).  The ops record into whichever accumulator
  is active; a kernel-server dispatch collects on its worker thread and
  ships the result home in the reply header (``stages``), which the
  client merges into its own active accumulator.  With no accumulator
  active every hook is one thread-local read.  A stage's seconds are
  host extents: they cover the card's work only where the op already
  reads a value back inside them (no synchronize is added for them).

* **Saturation plane**: :class:`SaturationPlane` folds the gauges the
  serving plane exports into one readiness verdict ``{"ready", "reasons",
  "checks"}``; error-class signals (sheds) trip on movement since the
  previous evaluation.

* **Exposition helpers**: ``label_exposition`` / ``federate_expositions``
  merge several instances' Prometheus payloads with an ``instance``
  label a sample, and ``counters_exposition`` renders a daemon's health
  counters as one.

The reference guards its registries with its race sanitizer's tracked
locks and shared-field annotations; the port has no sanitizer, so they
are plain ``threading.Lock``s and plain attributes.
``MEMGRAPH_TPU_STATS=0`` disables fingerprint collection.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque

from ..utils.metrics import Histogram, global_metrics, promname

ENV_DISABLE = "MEMGRAPH_TPU_STATS"          # "0" disables collection
ENV_TOPK = "MEMGRAPH_TPU_STATS_TOPK"        # top-K capacity (default 128)
ENV_MAX_LAG = "MEMGRAPH_TPU_HEALTH_MAX_REPL_LAG"        # txns (default 1000)
ENV_MAX_BACKLOG = "MEMGRAPH_TPU_HEALTH_MAX_FSYNC_BACKLOG"  # bytes (64 MiB)
ENV_MAX_PPR_QUEUE = "MEMGRAPH_TPU_HEALTH_MAX_PPR_QUEUE"  # pending (192)
ENV_MAX_SHARD_QUEUE = "MEMGRAPH_TPU_HEALTH_MAX_SHARD_QUEUE"  # depth (16)
ENV_MAX_STREAM_LAG = "MEMGRAPH_TPU_HEALTH_MAX_STREAM_LAG"  # units (100000)

#: every device stage the accumulator may carry.  The ``lane_*`` stages
#: are the read lane's split (ops/pipeline.py): program build / host
#: staging and upload / device execution.
STAGE_NAMES = ("kernel_dispatch", "device_transfer", "device_compile",
               "device_iterate", "lane_compile", "lane_dispatch",
               "lane_iterate")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# --------------------------------------------------------------------------
# query fingerprinting
# --------------------------------------------------------------------------

_STRING_LIT = re.compile(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"")
_PARAM = re.compile(r"\$\w+")
_NUMBER = re.compile(r"\b\d+(?:\.\d+)?(?:[eE][+-]?\d+)?\b")
_WS = re.compile(r"\s+")


def fingerprint_text(text: str) -> str:
    """Literal-stripped, parameter-normalized query shape.

    Two queries differing only in literal values or parameter names map
    to the same fingerprint; label/property/identifier case is kept
    (labels are case-sensitive, so folding would merge distinct shapes).
    The fingerprint never contains literal values — it is safe to log
    and expose (same contract as the slow-query log's redaction).
    """
    s = _STRING_LIT.sub("?", text)
    s = _PARAM.sub("$?", s)
    s = _NUMBER.sub("?", s)
    s = _WS.sub(" ", s).strip()
    # PROFILE/EXPLAIN wrap a shape, they are not one: a profiled run
    # increments the SAME fingerprint as the plain query (the
    # interpreter strips the keyword for plan-cache keying identically)
    head, _, rest = s.partition(" ")
    if head.upper() in ("PROFILE", "EXPLAIN") and rest:
        return rest
    return s


class _Entry:
    """One fingerprint's accumulated statistics."""

    __slots__ = ("fingerprint", "count", "errors", "overcount",
                 "plan_cache_hits", "rows_total", "latency", "trace_ids",
                 "first_seen", "last_seen")

    def __init__(self, fingerprint: str, overcount: int = 0) -> None:
        self.fingerprint = fingerprint
        self.count = overcount          # space-saving: inherited minimum
        self.overcount = overcount      # error bound on `count`
        self.errors = 0
        self.plan_cache_hits = 0
        self.rows_total = 0
        self.latency = Histogram()
        #: most recent trace ids observed while tracing was armed — the
        #: link from a hot fingerprint to retained traces in /traces
        self.trace_ids: deque = deque(maxlen=8)
        self.first_seen = time.time()
        self.last_seen = self.first_seen


class QueryStatsRegistry:
    """Bounded per-fingerprint statistics (space-saving top-K).

    All mutation happens under one leaf lock; `record()` is the per-
    query hot path and does one dict lookup + one histogram observe.
    """

    def __init__(self, capacity: int | None = None) -> None:
        self.capacity = capacity if capacity is not None \
            else max(8, _env_int(ENV_TOPK, 128))
        self._enabled = os.environ.get(ENV_DISABLE, "") != "0"
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        #: query text -> fingerprint memo (the plan-cache analog: repeat
        #: query texts never re-run the normalization regexes)
        self._fp_cache: dict[str, str] = {}

    # --- arming -------------------------------------------------------------

    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._fp_cache.clear()

    # --- recording ----------------------------------------------------------

    def fingerprint(self, text: str) -> str:
        """Memoized fingerprint of a query text (bounded memo)."""
        with self._lock:
            hit = self._fp_cache.get(text)
        if hit is not None:
            return hit
        fp = fingerprint_text(text)
        with self._lock:
            if len(self._fp_cache) < 1024:
                self._fp_cache[text] = fp
        return fp

    def record(self, fingerprint: str, latency_s: float, rows: int = 0,
               error: bool = False, plan_cache_hit: bool = False,
               trace_id: str | None = None) -> None:
        if not self._enabled:
            return
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                if len(self._entries) >= self.capacity:
                    # space-saving eviction: replace the minimum-count
                    # entry; the newcomer inherits its count as both the
                    # starting value and the documented overcount bound
                    victim = min(self._entries.values(),
                                 key=lambda e: e.count)
                    del self._entries[victim.fingerprint]
                    entry = _Entry(fingerprint, overcount=victim.count)
                    global_metrics.increment("mgstat.evictions_total")
                else:
                    entry = _Entry(fingerprint)
                self._entries[fingerprint] = entry
            entry.count += 1
            entry.last_seen = time.time()
            if error:
                entry.errors += 1
            if plan_cache_hit:
                entry.plan_cache_hits += 1
            entry.rows_total += int(rows)
            entry.latency.observe(latency_s, trace_id)
            if trace_id:
                entry.trace_ids.append(trace_id)

    def record_text(self, text: str, latency_s: float, rows: int = 0,
                    error: bool = False, plan_cache_hit: bool = False,
                    trace_id: str | None = None) -> None:
        """Fingerprint + record in one call (mp-executor hot path)."""
        if not self._enabled:
            return
        self.record(self.fingerprint(text), latency_s, rows=rows,
                    error=error, plan_cache_hit=plan_cache_hit,
                    trace_id=trace_id)

    # --- snapshots ----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Entries as dicts, hottest first."""
        with self._lock:
            entries = list(self._entries.values())
            out = []
            for e in sorted(entries, key=lambda e: -e.count):
                out.append({
                    "fingerprint": e.fingerprint,
                    "count": e.count,
                    "overcount_bound": e.overcount,
                    "errors": e.errors,
                    "plan_cache_hits": e.plan_cache_hits,
                    "rows_total": e.rows_total,
                    "latency_p50_ms": round(e.latency.quantile(0.5) * 1e3,
                                            3),
                    "latency_p99_ms": round(e.latency.quantile(0.99) * 1e3,
                                            3),
                    "trace_ids": list(e.trace_ids),
                    "first_seen": e.first_seen,
                    "last_seen": e.last_seen,
                })
            return out

    def rows(self) -> list[list]:
        """SHOW QUERY STATS rows (columns in QUERY_STATS_COLUMNS order)."""
        return [[s["fingerprint"], s["count"], s["errors"],
                 s["latency_p50_ms"], s["latency_p99_ms"],
                 s["rows_total"], s["plan_cache_hits"],
                 list(s["trace_ids"])]
                for s in self.snapshot()]


QUERY_STATS_COLUMNS = ["fingerprint", "count", "errors", "latency_p50_ms",
                       "latency_p99_ms", "rows_total", "plan_cache_hits",
                       "trace_ids"]

global_query_stats = QueryStatsRegistry()


# --------------------------------------------------------------------------
# device-stage attribution
# --------------------------------------------------------------------------

_stage_tls = threading.local()


class StageAccumulator:
    """Where the device seconds of one extent went, by stage.

    Single-thread by construction (thread-local activation); the kernel
    server ships a snapshot across the socket and the client merges it
    into its own active accumulator.
    """

    __slots__ = ("stages",)

    def __init__(self) -> None:
        self.stages: dict[str, dict] = {}

    def add(self, stage: str, seconds: float, count: int = 1) -> None:
        slot = self.stages.get(stage)
        if slot is None:
            slot = self.stages[stage] = {"seconds": 0.0, "count": 0}
        slot["seconds"] += float(seconds)
        slot["count"] += int(count)

    def merge(self, stages: dict | None) -> None:
        for name, slot in (stages or {}).items():
            self.add(name, slot.get("seconds", 0.0),
                     slot.get("count", 0) or 1)

    def snapshot(self) -> dict:
        return {name: dict(slot) for name, slot in self.stages.items()}


class _StageScope:
    __slots__ = ("_acc", "_prev")

    def __init__(self, acc: StageAccumulator) -> None:
        self._acc = acc
        self._prev = None

    def __enter__(self) -> StageAccumulator:
        self._prev = getattr(_stage_tls, "acc", None)
        _stage_tls.acc = self._acc
        return self._acc

    def __exit__(self, exc_type, exc, tb):
        _stage_tls.acc = self._prev
        return False


def collecting_stages(acc: StageAccumulator | None = None) -> _StageScope:
    """Activate a stage accumulator for the extent (context manager)."""
    return _StageScope(acc if acc is not None else StageAccumulator())


def stages_active() -> bool:
    """True when a stage accumulator is collecting on this thread (a
    PROFILE-d / accounted extent). Result caches use this to demote a
    verbatim hit to a warm seed: a profiled CALL exists to measure the
    device path, so serving stored bytes — attributing nothing — would
    defeat the run's purpose."""
    return getattr(_stage_tls, "acc", None) is not None


def record_stage(stage: str, seconds: float, count: int = 1) -> None:
    """Attribute device seconds to the ACTIVE accumulator, if any.

    Disarmed (no profiled/accounted extent running on this thread) this
    is one thread-local read — safe to call from every hot path.
    """
    acc = getattr(_stage_tls, "acc", None)
    if acc is not None:
        acc.add(stage, seconds, count)


def merge_stages(stages: dict | None) -> None:
    """Merge a remote snapshot (kernel-server reply) into the active
    accumulator, if any."""
    if not stages:
        return
    acc = getattr(_stage_tls, "acc", None)
    if acc is not None:
        acc.merge(stages)


def current_stages() -> StageAccumulator | None:
    return getattr(_stage_tls, "acc", None)


# --------------------------------------------------------------------------
# saturation / readiness plane
# --------------------------------------------------------------------------

#: counters whose MOVEMENT between evaluations marks saturation (the
#: USE "errors" axis); gauges are compared against thresholds directly
_RATE_SIGNALS = (
    # (snapshot key prefix/name, reason id)
    ("kernel_server.dispatch.shed_total", "kernel_server_shed"),
    ("kernel_server.admission_rejected_total", "kernel_server_shed"),
    ("kernel_server.daemon.dispatch.shed_total", "kernel_server_shed"),
    ("kernel_server.daemon.admission_rejected_total", "kernel_server_shed"),
)


class SaturationPlane:
    """Folds resource gauges + error counters into one readiness verdict.

    Stateful ON PURPOSE: error-class signals (sheds) are judged by
    movement since the previous evaluation — a single shed ages out of
    the verdict once the pressure stops, exactly like a rate() alarm.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_counters: dict[str, float] = {}
        self._primed = False
        self.max_replica_lag = float(_env_int(ENV_MAX_LAG, 1000))
        self.max_fsync_backlog = float(_env_int(ENV_MAX_BACKLOG, 64 << 20))
        # trip BEFORE the serving plane's own hard shed threshold
        # (MEMGRAPH_TPU_PPR_MAX_QUEUE, default 256): load balancers see
        # the 503 while the queue is still servable
        self.max_ppr_queue = float(_env_int(ENV_MAX_PPR_QUEUE, 192))
        # per-shard dispatch is serial (shard-per-process): a deep
        # queue on ONE shard means a hot key / skewed hash range, and
        # admission control should shed before latency collapses
        self.max_shard_queue = float(_env_int(ENV_MAX_SHARD_QUEUE, 16))
        # streaming ingestion: source backlog (bytes behind the file
        # tail / records behind the broker) — /health must flip before
        # the consumer falls unboundedly behind the producers
        self.max_stream_lag = float(_env_int(ENV_MAX_STREAM_LAG, 100_000))

    def evaluate(self, ictx=None) -> dict:
        """One readiness verdict from the current metrics snapshot.

        Machine-readable: every reason carries {check, reason, value,
        threshold} so admission control can branch without parsing
        prose. ``ready`` is the conjunction of every check.
        """
        snap = {name: value for name, _kind, value
                in global_metrics.snapshot()}
        reasons: list[dict] = []
        checks: dict[str, str] = {}

        def trip(check: str, reason: str, value, threshold) -> None:
            checks[check] = "saturated"
            reasons.append({"check": check, "reason": reason,
                            "value": value, "threshold": threshold})

        def ok(check: str) -> None:
            checks.setdefault(check, "ok")

        # bolt session pool (gauges exported by BoltServer)
        live = snap.get("bolt.sessions_live")
        cap = snap.get("bolt.sessions_max") or 0
        if cap and live is not None and live >= cap:
            trip("bolt_sessions", "session pool exhausted", live, cap)
        else:
            ok("bolt_sessions")

        # mp executor in-flight vs worker count
        inflight = snap.get("mp_executor.in_flight")
        workers = snap.get("mp_executor.workers") or 0
        if workers and inflight is not None and inflight >= workers:
            trip("mp_executor", "all read workers busy", inflight, workers)
        else:
            ok("mp_executor")

        # kernel server: wedged daemon is an immediate not-ready
        if snap.get("kernel_server.daemon.wedged"):
            trip("kernel_server", "daemon wedged (overdue dispatch)",
                 1, 0)
        else:
            ok("kernel_server")

        # kernel server: sheds since the previous evaluation. The FIRST
        # evaluation only baselines — history predating the plane must
        # not read as fresh pressure.
        with self._lock:
            shed_now = 0.0
            for key, _reason in _RATE_SIGNALS:
                shed_now += float(snap.get(key) or 0.0)
            shed_prev = shed_now if not self._primed \
                else self._last_counters.get("shed", 0.0)
            self._last_counters["shed"] = shed_now
            self._primed = True
        if shed_now > shed_prev:
            trip("kernel_server_admission",
                 "requests shed since last evaluation (HBM pressure)",
                 shed_now - shed_prev, 0)
        else:
            ok("kernel_server_admission")

        # PPR serving plane: coalescing queue depth (local gauge, or the
        # daemon's own mirrored through the supervisor's health loop)
        depth = max(float(snap.get("ppr.queue_depth") or 0.0),
                    float(snap.get(
                        "kernel_server.daemon.ppr.queue_depth") or 0.0))
        if depth > self.max_ppr_queue:
            trip("ppr_queue", "PPR coalescing queue depth over budget",
                 depth, self.max_ppr_queue)
        else:
            ok("ppr_queue")

        # PPR batch-window occupancy: every window is leaving FULL and
        # requests still queue behind — the batcher is the bottleneck
        occ = max(float(snap.get("ppr.window_occupancy") or 0.0),
                  float(snap.get(
                      "kernel_server.daemon.ppr.window_occupancy")
                      or 0.0))
        if occ >= 1.0 and depth > 0:
            trip("ppr_window",
                 "PPR batch windows saturated with queue backlog",
                 occ, 1.0)
        else:
            ok("ppr_window")

        # sharded OLTP plane: per-shard queue depth (one gauge per
        # shard; serial per-shard dispatch makes depth the direct
        # saturation signal for a hot hash range)
        worst_shard = None
        for name, value in snap.items():
            if name.startswith("shard.queue_depth."):
                if worst_shard is None or value > worst_shard[1]:
                    worst_shard = (name, value)
        if worst_shard is not None and \
                worst_shard[1] > self.max_shard_queue:
            trip("shard_queue",
                 f"shard {worst_shard[0].rsplit('.', 1)[1]} queue "
                 "depth over budget", worst_shard[1],
                 self.max_shard_queue)
        else:
            ok("shard_queue")

        # replication lag (one gauge per replica)
        worst = None
        for name, value in snap.items():
            if name.startswith("replication.replica_lag."):
                if worst is None or value > worst[1]:
                    worst = (name, value)
        if worst is not None and worst[1] > self.max_replica_lag:
            trip("replication_lag",
                 f"replica {worst[0].rsplit('.', 1)[1]} lag over budget",
                 worst[1], self.max_replica_lag)
        else:
            ok("replication_lag")

        # WAL fsync backlog (batched-fsync deployments)
        backlog = snap.get("wal.fsync_backlog_bytes")
        if backlog is not None and backlog > self.max_fsync_backlog:
            trip("wal_fsync_backlog", "unfsynced WAL bytes over budget",
                 backlog, self.max_fsync_backlog)
        else:
            ok("wal_fsync_backlog")

        # streaming ingestion lag (one gauge per stream): the consumer
        # is falling behind its source faster than batches commit —
        # flip /health before the backlog grows without bound
        worst_stream = None
        for name, value in snap.items():
            if name.startswith("stream.lag."):
                if worst_stream is None or value > worst_stream[1]:
                    worst_stream = (name, value)
        if worst_stream is not None and \
                worst_stream[1] > self.max_stream_lag:
            trip("stream_lag",
                 f"stream {worst_stream[0].rsplit('.', 1)[1]} source "
                 "backlog over budget", worst_stream[1],
                 self.max_stream_lag)
        else:
            ok("stream_lag")

        ready = not reasons
        global_metrics.set_gauge("health.ready", 1.0 if ready else 0.0)
        if not ready:
            global_metrics.increment("health.not_ready_total")
        return {"ready": ready, "reasons": reasons, "checks": checks}

    def ingest_pressure(self) -> str | None:
        """Downstream-pressure probe for stream consumers: the check name
        that says polling MORE data would amplify overload, or None.

        Deliberately stateless (gauge thresholds only, no rate priming):
        the consumer loop calls this far more often than /health calls
        evaluate(), and must not perturb the shed-movement windows.
        """
        snap = {name: value for name, _kind, value
                in global_metrics.snapshot()}
        for name, value in snap.items():
            if name.startswith("replication.replica_lag.") and \
                    value > self.max_replica_lag:
                return "replication_lag"
        backlog = snap.get("wal.fsync_backlog_bytes")
        if backlog is not None and backlog > self.max_fsync_backlog:
            return "wal_fsync_backlog"
        if snap.get("kernel_server.daemon.wedged"):
            # the resident analytics plane (mgdelta warm refresh) is not
            # keeping up — pausing ingest is the graceful degradation
            return "kernel_server"
        return None


global_saturation = SaturationPlane()


# --------------------------------------------------------------------------
# exposition federation
# --------------------------------------------------------------------------

_SAMPLE_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?( .*)$")


def label_exposition(text: str, instance: str) -> list[tuple]:
    """Parse one prometheus_text() payload into
    [(metric, type|None, labeled_sample_line)] with an ``instance``
    label injected into every sample (exemplar suffixes preserved)."""
    out: list[tuple] = []
    types: dict[str, str] = {}
    inst = instance.replace("\\", "\\\\").replace('"', '\\"')
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_LINE.match(line)
        if m is None:
            continue
        name, labels, rest = m.group(1), m.group(2), m.group(3)
        if labels:
            merged = '{instance="%s",%s' % (inst, labels[1:])
        else:
            merged = '{instance="%s"}' % inst
        family = name
        for suffix in ("_bucket", "_count", "_sum"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                family = name[:-len(suffix)]
                break
        out.append((name, types.get(family), f"{name}{merged}{rest}"))
    return out


def federate_expositions(parts: dict[str, str]) -> str:
    """Merge several instances' expositions into ONE labeled payload.

    ``parts`` maps instance label -> prometheus_text() output. Every
    sample gains an ``instance`` label; one ``# TYPE`` line is emitted
    per metric family (first declaration wins)."""
    by_metric: dict[str, list[str]] = {}
    types: dict[str, str] = {}
    for instance in sorted(parts):
        for name, mtype, line in label_exposition(parts[instance],
                                                  instance):
            if mtype and name not in types:
                types[name] = mtype
            by_metric.setdefault(name, []).append(line)
    lines: list[str] = []
    emitted_types: set[str] = set()
    for name in sorted(by_metric):
        mtype = types.get(name)
        if mtype and name not in emitted_types:
            lines.append(f"# TYPE {name} {mtype}")
            emitted_types.add(name)
        lines.extend(by_metric[name])
    return "\n".join(lines) + ("\n" if lines else "")


def counters_exposition(counters: dict, extra_gauges: dict | None = None
                        ) -> str:
    """Render a flat counter dict (a kernel daemon's health-reply
    ``counters``) as a minimal exposition, so the daemon can appear as
    its own instance in the federated view."""
    lines = []
    merged = dict(counters or {})
    merged.update(extra_gauges or {})
    for name in sorted(merged):
        metric = promname(name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {float(merged[name])}")
    return "\n".join(lines) + ("\n" if lines else "")
