"""Multiprocess read-query executor: a path past the GIL for OLTP reads.

The Bolt worker pool gives concurrency, not CPU parallelism — pure-
Python operator execution serializes on the GIL, so aggregate
multi-client read throughput plateaus at ~1x (README).
This executor forks N worker processes, each inheriting a copy-on-write
snapshot of the storage; read-only queries fan out round-robin over
pipes and execute with N independent GILs.

Semantics: every worker serves the database AS OF the last fork().
`refresh()` re-forks after commits — the same snapshot-staleness
contract as the analytics GraphCache (ops/csr.py), applied to host
reads. Writes and transactional reads stay on the in-process path.

Caveats (documented, enforced):
  - queries that reach device state are refused in workers (fork
    after CUDA init is unsafe); this pool is for host-path OLTP.
  - one core boxes show ~1x: the component buys architecture; the
    speedup needs real cores.

Reference analog: the reference is a multithreaded C++ server with no
GIL to escape; this component restores multi-core reads for the Python
host layer.

Copy of memgraph_tpu/server/mp_executor.py for the port.  What differs
is the device rule, which the reference states and does not enforce (its
workers run a ``CALL pagerank.get()``):

- A worker decides from the plan, before anything runs, whether a Cypher
  read reaches the device: a plan that holds a compiled read lane
  (``_has_lane``, query/plan/lane.py) or calls a procedure (every
  procedure the port registers takes a device snapshot, and a loaded
  module's is opaque) is refused with ``DeviceWorkRefused``, shipped home
  through ``raise_wire_error``.  The caller runs such a query on its
  in-process interpreter.  The decision reads only the plan, so it is
  the same on the CPU and on the card.
- A worker never calls ``torch`` or ``torch.cuda``: a process forked
  after CUDA is initialised fails at its first CUDA call.  A worker
  freezes what it inherited (``gc.freeze``) as it starts, so its
  collector never finalises a tensor of the parent's.
- ``execute(..., username=)`` runs a request as that user (the reference
  runs every request anonymously, so a database with users refuses all
  of them).
- ``fork_s`` holds the seconds of the last (re-)fork of all workers.
"""

from __future__ import annotations

import gc
import itertools
import os
import pickle
import struct
import threading
import time

from ..exceptions import DeviceWorkRefused
from ..observability import trace as mgtrace

__all__ = ["MPReadExecutor", "device_reason"]


def _walk(op):
    """Every operator of a plan, the row-path fallbacks included."""
    from dataclasses import fields
    from ..query.plan import operators as Op
    stack, seen = [op], set()
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        yield cur
        if not hasattr(cur, "__dataclass_fields__"):
            continue
        for f in fields(cur):
            v = getattr(cur, f.name, None)
            items = v if isinstance(v, (list, tuple)) else (v,)
            stack.extend(x for x in items
                         if isinstance(x, Op.LogicalOperator))


def device_reason(ictx, text: str, query) -> str | None:
    """Why the Cypher ``query`` (parsed from ``text``) reaches the device,
    from its plan alone, or None when it stays on the host: a compiled
    read lane, or a procedure call."""
    from ..query.plan import operators as Op
    strip = text.strip()
    if query.explain or query.profile:
        strip = strip.split(None, 1)[1] if " " in strip else strip
    plan, _columns, _hit = ictx.cached_plan(strip, query)
    if getattr(plan, "_has_lane", False):
        return "its plan runs the compiled read lane on the device"
    for op in _walk(plan):
        if isinstance(op, Op.CallProcedureOp):
            return (f"it calls procedure {op.proc_name}, which takes a "
                    "device snapshot")
    return None


def _send(fd, obj) -> None:
    data = pickle.dumps(obj)
    os.write(fd, struct.pack("<I", len(data)) + data)


def _recv(fd):
    hdr = b""
    while len(hdr) < 4:
        chunk = os.read(fd, 4 - len(hdr))
        if not chunk:
            raise EOFError
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return pickle.loads(buf)


class MPReadExecutor:
    def __init__(self, ictx, n_workers: int = 4) -> None:
        from ..utils.metrics import global_metrics
        self._ictx = ictx
        self._n = max(1, n_workers)
        self._workers: list = []       # (pid, req_fd, resp_fd)
        self._locks: list = []
        self._rr = itertools.count()
        # saturation plane: in-flight vs worker count = queue depth
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        global_metrics.set_gauge("mp_executor.workers", float(self._n))
        global_metrics.set_gauge("mp_executor.in_flight", 0.0)
        self._fork()

    # -- lifecycle ----------------------------------------------------------

    def _fork(self) -> None:
        self.close()
        self._workers = []
        self._locks = []
        t0 = time.perf_counter()
        for _ in range(self._n):
            self._workers.append(self._spawn_one())
            self._locks.append(threading.Lock())
        self.fork_s = time.perf_counter() - t0

    def _spawn_one(self) -> tuple:
        req_r, req_w = os.pipe()
        resp_r, resp_w = os.pipe()
        pid = os.fork()
        if pid == 0:                      # ---- child ----
            # the child's collector must never finalise an inherited
            # object (a CUDA tensor's storage among them): every object
            # the fork copied goes to the permanent generation
            gc.freeze()
            os.close(req_w)
            os.close(resp_r)
            try:
                self._worker_loop(req_r, resp_w)
            finally:
                os._exit(0)
        os.close(req_r)
        os.close(resp_w)
        return (pid, req_w, resp_r)

    def _respawn(self, i: int, dead) -> None:
        """Replace a crashed worker (caller holds ``self._locks[i]``):
        reap the corpse, fork a fresh worker off the CURRENT parent
        snapshot, and count the respawn so dashboards see churn."""
        from ..utils.metrics import global_metrics
        pid, req_fd, resp_fd = dead
        for fd in (req_fd, resp_fd):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            pass
        self._workers[i] = self._spawn_one()
        global_metrics.increment("mp_executor.worker_respawn_total")

    def _worker_loop(self, req_fd: int, resp_fd: int) -> None:
        from ..query import Interpreter
        from ..query.frontend import ast as A
        interp = Interpreter(self._ictx)
        refusal = ("QueryException",
                   "only read-only Cypher queries may run on the "
                   "multiprocess read executor (writes against the forked "
                   "snapshot would be silently lost)")
        device_refusal = DeviceWorkRefused.__name__
        while True:
            try:
                msg = _recv(req_fd)
            except (EOFError, OSError, struct.error, ValueError,
                    pickle.UnpicklingError):
                # torn/garbage frame on the request pipe: the parent
                # side is gone or corrupt — exit so the parent's
                # respawn path replaces this worker cleanly
                return
            if msg is None:
                return
            query, params, carrier, username = msg
            # each request runs as its caller's user: the privileges are
            # checked against the forked auth store
            interp.username = username
            try:
                # enforce the read-only contract BEFORE prepare: non-Cypher
                # statements (auth/DDL/admin) can mutate state at prepare
                # time, and a misrouted write would vanish into this
                # worker's copy-on-write snapshot
                node = interp.ctx.cached_parse(query)
                if not isinstance(node, A.CypherQuery):
                    _send(resp_fd, ("err", *refusal))
                    continue
                # a forked worker never touches the card: decided from
                # the plan, before anything runs
                reason = device_reason(interp.ctx, query, node)
                if reason is not None:
                    _send(resp_fd, ("err", device_refusal,
                                    "a forked read worker does not run "
                                    f"device work: {reason}; run the "
                                    "query in process"))
                    continue
                # the job envelope is the trace carrier across the fork
                # boundary: this worker's spans (incl. the interpreter's
                # own query trace) join the parent's trace, then ship
                # home on the response envelope
                with mgtrace.adopt(carrier):
                    with mgtrace.span("mp.worker"):
                        prepared = interp.prepare(query, params)
                        if prepared.is_write:
                            interp.abort()
                            _send(resp_fd, ("err", *refusal))
                            continue
                        rows, _more, _summary = interp.pull(-1)
                spans = mgtrace.take_trace(carrier["trace_id"]) \
                    if carrier else []
                _send(resp_fd, ("ok", prepared.columns, rows, spans))
            except Exception as e:  # noqa: BLE001 — ship the error back
                try:
                    _send(resp_fd, ("err", type(e).__name__, str(e)))
                except (OSError, ValueError, struct.error):
                    return      # response pipe gone: die, get respawned

    def refresh(self) -> None:
        """Re-fork so workers see the current committed state."""
        self._fork()

    def close(self) -> None:
        for pid, req_fd, resp_fd in self._workers:
            try:
                _send(req_fd, None)
            except OSError:
                pass
            for fd in (req_fd, resp_fd):
                try:
                    os.close(fd)
                except OSError:
                    pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        self._workers = []
        self._locks = []

    # -- execution ----------------------------------------------------------

    def execute(self, query: str, params: dict | None = None, *,
                username: str | None = None):
        """Round-robin a read-only query to a worker, run as ``username``
        (anonymous when None); returns (columns, rows). Worker-side
        errors are rehydrated into the typed taxonomy (SyntaxException
        stays SyntaxException across the fork boundary)."""
        from ..utils.metrics import global_metrics
        from ..observability.stats import global_query_stats
        if not self._workers:
            raise RuntimeError("executor is closed")
        i = next(self._rr) % len(self._workers)
        with self._inflight_lock:
            self._inflight += 1
            global_metrics.set_gauge("mp_executor.in_flight",
                                     float(self._inflight))
        t0 = time.perf_counter()
        try:
            with mgtrace.span("mp.execute", worker=i):
                with self._locks[i]:
                    # unpack INSIDE the lock: _respawn replaces the
                    # tuple under this same lock, and a pre-lock copy
                    # could name fds already closed AND reused by the
                    # replacement's pipes (framing corruption)
                    pid, req_fd, resp_fd = self._workers[i]
                    try:
                        _send(req_fd,
                              (query, params or {}, mgtrace.inject(),
                               username))
                        out = _recv(resp_fd)
                    except (OSError, EOFError, struct.error,
                            ValueError, pickle.UnpicklingError) as e:
                        # dead worker: a wedged queue was the old
                        # failure mode — instead, respawn in place and
                        # fail THIS job with a typed retryable error
                        # (ConnectionError in the MRO: RetryPolicy's
                        # default retry_on catches it)
                        from ..exceptions import WorkerCrashedError
                        self._respawn(i, (pid, req_fd, resp_fd))
                        global_metrics.increment(
                            "mp_executor.errors_total")
                        global_query_stats.record_text(
                            query, time.perf_counter() - t0, rows=0,
                            error=True,
                            trace_id=mgtrace.current_trace_id())
                        raise WorkerCrashedError(
                            f"mp_executor worker {i} (pid {pid}) died "
                            "mid-request; respawned — retry") from e
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                global_metrics.set_gauge("mp_executor.in_flight",
                                         float(self._inflight))
        if out[0] == "err":
            # worker-side stats die with the forked snapshot; the parent
            # registry is the authoritative fingerprint table, so the
            # routed query accounts HERE — errors included
            global_metrics.increment("mp_executor.errors_total")
            global_query_stats.record_text(
                query, time.perf_counter() - t0, rows=0, error=True,
                trace_id=mgtrace.current_trace_id())
            from ..exceptions import raise_wire_error
            raise_wire_error(out[1], out[2])
        if len(out) > 3:
            mgtrace.adopt_spans(out[3])
        global_query_stats.record_text(
            query, time.perf_counter() - t0, rows=len(out[2]),
            trace_id=mgtrace.current_trace_id())
        return out[1], out[2]
