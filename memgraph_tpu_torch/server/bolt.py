"""Bolt protocol server (asyncio).

Counterpart of the reference's Bolt stack
(memgraph/src/communication/bolt/ — session state machine at
bolt/v1/session.hpp:55, message handlers at bolt/v1/states/executing.hpp):
handshake (versions 4.3/4.4/5.x), chunked message framing, HELLO/LOGON
auth, RUN/PULL/DISCARD with qid-less streaming, BEGIN/COMMIT/ROLLBACK,
RESET/GOODBYE, value conversion between the engine's Python values and
PackStream structures (the glue/communication.cpp analog).

Copy of memgraph_tpu/server/bolt.py for the port (its imports the port's
own).  What differs:

- Interpreter work runs on the session's worker pool, and each call runs
  with the interpreter context's device as the thread's current CUDA
  device (``_on_device``): a worker launches its kernels on the card its
  database was built on, whatever device the thread last used.  On the
  CPU nothing is set.
- ``bolt.prepare_latency_sec`` is observed without a trace exemplar: the
  port's metrics registry keeps counts and sums (the exemplars come with
  the port's observability slice).
- A numpy or torch scalar that reaches ``value_to_bolt`` raises
  ``PackStreamError``, as in the reference: the port's procedures yield
  Python values.
- ROUTE answers the single-instance table; a coordinator's comes with
  the port's replication slice.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct

from ..exceptions import MemgraphTpuError
from ..observability import trace as mgtrace
from ..query.interpreter import Interpreter, InterpreterContext
from ..query.values import Path
from ..storage.storage import EdgeAccessor, VertexAccessor
from ..utils.point import Point
from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                              ZonedDateTime)
from . import packstream as ps

log = logging.getLogger(__name__)

BOLT_MAGIC = b"\x60\x60\xB0\x17"
# value_to_bolt emits version-appropriate structures: v5 (element ids, UTC
# datetimes) for 5.x sessions, legacy 3-field/5-field structures for 4.x
SUPPORTED_VERSIONS = [(5, 2), (5, 1), (5, 0), (4, 4), (4, 3)]
LEGACY_DATETIME = 0x46  # 4.x offset datetime ('F')
LEGACY_DATETIME_ZONE_ID = 0x66  # 4.x zoned datetime ('f')

# message signatures
M_HELLO = 0x01
M_LOGON = 0x6A
M_LOGOFF = 0x6B
M_GOODBYE = 0x02
M_RESET = 0x0F
M_RUN = 0x10
M_BEGIN = 0x11
M_COMMIT = 0x12
M_ROLLBACK = 0x13
M_DISCARD = 0x2F
M_PULL = 0x3F
M_ROUTE = 0x66
M_SUCCESS = 0x70
M_RECORD = 0x71
M_IGNORED = 0x7E
M_FAILURE = 0x7F


def value_to_bolt(v, storage, view, version=(5, 2)):
    """Engine value → PackStream value (glue/communication.cpp analog).
    Structure field sets follow the negotiated protocol version."""
    v5 = version >= (5, 0)
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, (list, tuple)):
        return [value_to_bolt(x, storage, view, version) for x in v]
    if isinstance(v, dict):
        return {k: value_to_bolt(x, storage, view, version)
                for k, x in v.items()}
    if isinstance(v, VertexAccessor):
        labels = [storage.label_mapper.id_to_name(l) for l in v.labels(view)]
        props = {storage.property_mapper.id_to_name(k):
                 value_to_bolt(val, storage, view, version)
                 for k, val in v.properties(view).items()}
        fields = [v.gid, labels, props]
        if v5:
            fields.append(str(v.gid))  # element_id
        return ps.Structure(ps.S_NODE, fields)
    if isinstance(v, EdgeAccessor):
        props = {storage.property_mapper.id_to_name(k):
                 value_to_bolt(val, storage, view, version)
                 for k, val in v.properties(view).items()}
        fields = [v.gid, v.from_vertex().gid, v.to_vertex().gid,
                  storage.edge_type_mapper.id_to_name(v.edge_type), props]
        if v5:
            fields += [str(v.gid), str(v.from_vertex().gid),
                       str(v.to_vertex().gid)]
        return ps.Structure(ps.S_RELATIONSHIP, fields)
    if isinstance(v, Path):
        nodes = [value_to_bolt(n, storage, view, version)
                 for n in v.vertices()]
        edges = v.edges()
        rels = []
        for e in edges:
            props = {storage.property_mapper.id_to_name(k):
                     value_to_bolt(val, storage, view, version)
                     for k, val in e.properties(view).items()}
            fields = [e.gid,
                      storage.edge_type_mapper.id_to_name(e.edge_type),
                      props]
            if v5:
                fields.append(str(e.gid))
            rels.append(ps.Structure(ps.S_UNBOUND_RELATIONSHIP, fields))
        # index sequence: alternating rel index (1-based) and node index
        seq = []
        node_ids = [n.gid for n in v.vertices()]
        for i, e in enumerate(edges):
            rel_idx = i + 1
            if e.from_vertex().gid == node_ids[i]:
                seq.append(rel_idx)
            else:
                seq.append(-rel_idx)
            seq.append(i + 1)
        return ps.Structure(ps.S_PATH, [nodes, rels, seq])
    if isinstance(v, Date):
        return ps.Structure(ps.S_DATE, [v.d.toordinal() - 719163])  # epoch day
    if isinstance(v, LocalTime):
        return ps.Structure(ps.S_LOCAL_TIME, [v._micros() * 1000])
    if isinstance(v, LocalDateTime):
        micros = v.timestamp_micros()
        return ps.Structure(ps.S_LOCAL_DATETIME,
                            [micros // 1_000_000,
                             (micros % 1_000_000) * 1000])
    if isinstance(v, ZonedDateTime):
        micros = v.timestamp_micros()
        offset = int(v.dt.utcoffset().total_seconds()) if v.dt.utcoffset() \
            else 0
        if not v5:
            # legacy 4.x: wall-clock seconds (local) + offset, tag 'F'
            local = micros + offset * 1_000_000
            return ps.Structure(LEGACY_DATETIME,
                                [local // 1_000_000,
                                 (local % 1_000_000) * 1000, offset])
        return ps.Structure(ps.S_DATETIME,
                            [micros // 1_000_000,
                             (micros % 1_000_000) * 1000, offset])
    if isinstance(v, Duration):
        days, rem = divmod(v.micros, 86_400_000_000)
        seconds, micros = divmod(rem, 1_000_000)
        return ps.Structure(ps.S_DURATION,
                            [0, days, seconds, micros * 1000])
    if isinstance(v, Point):
        if v.crs.dims == 2:
            return ps.Structure(ps.S_POINT_2D, [v.crs.value, v.x, v.y])
        return ps.Structure(ps.S_POINT_3D, [v.crs.value, v.x, v.y, v.z])
    from ..storage.enums import EnumValue
    if isinstance(v, EnumValue):
        return str(v)  # "Name::Value" (reference sends enums as strings)
    raise ps.PackStreamError(f"cannot convert {type(v)!r} to bolt")


def bolt_to_value(v):
    """PackStream input (parameters) → engine value."""
    if isinstance(v, list):
        return [bolt_to_value(x) for x in v]
    if isinstance(v, dict):
        return {k: bolt_to_value(x) for k, x in v.items()}
    if isinstance(v, ps.Structure):
        import datetime as dt
        if v.tag == ps.S_DATE:
            return Date(dt.date.fromordinal(v.fields[0] + 719163))
        if v.tag == ps.S_LOCAL_TIME:
            from ..utils.temporal import _micros_to_time
            return LocalTime(_micros_to_time(v.fields[0] // 1000))
        if v.tag == ps.S_LOCAL_DATETIME:
            sec, nanos = v.fields
            return LocalDateTime(dt.datetime(1970, 1, 1)
                                 + dt.timedelta(seconds=sec,
                                                microseconds=nanos // 1000))
        if v.tag == ps.S_DURATION:
            months, days, seconds, nanos = v.fields
            return Duration.from_parts(days=months * 30 + days,
                                       seconds=seconds,
                                       microseconds=nanos // 1000)
        if v.tag == ps.S_DATETIME:
            sec, nanos, offset = v.fields
            tz = dt.timezone(dt.timedelta(seconds=offset))
            return ZonedDateTime(dt.datetime.fromtimestamp(
                sec + nanos / 1e9, tz))
        if v.tag == ps.S_DATETIME_ZONE_ID:
            sec, nanos, zone = v.fields
            base = dt.datetime.fromtimestamp(sec + nanos / 1e9,
                                             dt.timezone.utc)
            try:
                from zoneinfo import ZoneInfo
                base = base.astimezone(ZoneInfo(zone))
            except (ImportError, KeyError, ValueError, OSError):
                pass  # unknown/unavailable tz db: keep UTC instant
            return ZonedDateTime(base)
        if v.tag == LEGACY_DATETIME:
            # 4.x: local wall-clock seconds + offset
            sec, nanos, offset = v.fields
            tz = dt.timezone(dt.timedelta(seconds=offset))
            utc_micros = sec * 1_000_000 + nanos // 1000 \
                - offset * 1_000_000
            return ZonedDateTime(dt.datetime.fromtimestamp(
                utc_micros / 1e6, tz))
        if v.tag == ps.S_TIME:
            nanos, offset = v.fields
            from ..utils.temporal import _micros_to_time
            # offset-carrying time flattens to LocalTime (engine has no
            # zoned-time type; matches reference behavior for TIME values)
            return LocalTime(_micros_to_time(nanos // 1000))
        if v.tag in (ps.S_POINT_2D, ps.S_POINT_3D):
            from ..utils.point import CrsType
            crs = CrsType(v.fields[0])
            z = v.fields[3] if v.tag == ps.S_POINT_3D else None
            return Point(v.fields[1], v.fields[2], z, crs)
        raise ps.PackStreamError(
            f"unsupported parameter structure 0x{v.tag:02X}")
    return v


def _on_device(ictx, fn, *args):
    """fn(*args) with the context's card as the thread's current CUDA
    device; on the CPU, or for a context without a device, fn(*args)."""
    device = getattr(ictx, "device", None)
    if device is None or device.type != "cuda":
        return fn(*args)
    import torch
    with torch.cuda.device(device):
        return fn(*args)


class BoltSession:
    """One connection: handshake → auth → message loop.

    The reference's SessionHL analog (glue/SessionHL.hpp): bridges the wire
    protocol to an Interpreter.
    """

    def __init__(self, reader, writer, interpreter_context, auth=None,
                 executor=None):
        self.reader = reader
        self.writer = writer
        self.ictx = interpreter_context
        self.auth = auth
        self.interpreter = Interpreter(interpreter_context)
        self.version: tuple[int, int] = (0, 0)
        self.authenticated = False
        self.failed = False  # FAILURE → ignore until RESET
        self._prepared = None
        import uuid as _uuid
        self.session_id = str(_uuid.uuid4())
        # mgtrace: the session-level root of the current RUN..PULL*
        # exchange (None unless tracing is armed)
        self._bolt_trace = None
        # interpreter work (parse/plan/execute/pull) runs on this pool so
        # one session's long query never blocks the event loop — the
        # reference runs sessions on a work-stealing priority pool
        # (utils/priority_thread_pool.hpp); numpy/torch sections release
        # the GIL, so columnar scans and device kernels overlap for real.
        # Protocol reads/writes stay on the loop (transports are not
        # thread-safe); per-session ordering is preserved because the
        # message loop awaits each dispatch before reading the next.
        self._executor = executor

    def _register_session(self) -> bool:
        """SHOW ACTIVE USERS INFO registry (reference: GetActiveUsersInfo,
        interpreter.cpp SystemInfoQuery ACTIVE_USERS). Also the
        enforcement point for the user profile `sessions` limit
        (reference: user_profiles.cpp kSessions) — False = refused."""
        import datetime
        sessions = getattr(self.ictx, "active_sessions", None)
        if sessions is None:
            sessions = self.ictx.active_sessions = {}
        username = self.interpreter.username or ""
        profiles = getattr(self.ictx, "user_profiles", None)
        if profiles is not None and username:
            cap = profiles.limit_for_user(username, "sessions")
            if cap is not None:
                live = sum(1 for sid, (u, _t) in sessions.items()
                           if u == username and sid != self.session_id)
                if live >= cap:
                    return False
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat()
        sessions[self.session_id] = (username, ts)
        return True

    def _register_or_refuse(self) -> bool:
        """Register, or send the session-limit refusal; False = refused
        (the failure is already on the wire, caller just returns)."""
        if self._register_session():
            return True
        self.authenticated = False
        self.send_failure(
            "Memgraph.ClientError.Security.Unauthenticated",
            "session limit exceeded for this user's profile")
        return False

    def _unregister_session(self) -> None:
        getattr(self.ictx, "active_sessions", {}).pop(self.session_id, None)

    async def _offload(self, fn, *args):
        ictx = self.interpreter.ctx       # honors USE DATABASE
        if self._executor is None:
            return _on_device(ictx, fn, *args)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, _on_device, ictx,
                                          fn, *args)

    # --- wire framing -------------------------------------------------------

    async def _read_exact(self, n: int) -> bytes:
        return await self.reader.readexactly(n)

    async def read_message(self) -> bytes:
        chunks = []
        while True:
            header = await self._read_exact(2)
            size = struct.unpack(">H", header)[0]
            if size == 0:
                if chunks:
                    return b"".join(chunks)
                continue  # noop chunk (keep-alive)
            chunks.append(await self._read_exact(size))

    def write_message(self, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            chunk = data[pos:pos + 0xFFFF]
            self.writer.write(struct.pack(">H", len(chunk)) + chunk)
            pos += len(chunk)
        self.writer.write(b"\x00\x00")

    def send(self, signature: int, *fields) -> None:
        self.write_message(ps.pack(ps.Structure(signature, list(fields))))

    def send_success(self, metadata=None) -> None:
        self.send(M_SUCCESS, metadata or {})

    def send_failure(self, code: str, message: str) -> None:
        self.failed = True
        self._finish_bolt_trace("error")
        self.send(M_FAILURE, {"code": code, "message": message})

    # --- lifecycle ----------------------------------------------------------

    async def run(self) -> None:
        try:
            if not await self.handshake():
                return
            peer = self.writer.get_extra_info("peername")
            log.info("Accepted a connection from %s:%s",
                     *(peer[:2] if peer else ("?", "?")))
            while True:
                data = await self.read_message()
                msg = ps.unpack(data)
                if not isinstance(msg, ps.Structure):
                    raise MemgraphTpuError("malformed bolt message")
                if not await self.dispatch(msg):
                    break
                await self.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            log.exception("bolt session crashed")
        finally:
            self._finish_bolt_trace("abandoned")
            self._unregister_session()
            self.interpreter.abort()
            self.writer.close()

    async def drain(self):
        await self.writer.drain()

    async def handshake(self) -> bool:
        magic = await self._read_exact(4)
        if magic != BOLT_MAGIC:
            return False
        proposals = await self._read_exact(16)
        chosen = (0, 0)
        for i in range(4):
            major = proposals[i * 4 + 3]
            minor = proposals[i * 4 + 2]
            rng = proposals[i * 4 + 1]
            # a proposal (major, minor, range) offers minors
            # [minor - range, minor]; pick the highest we support
            for (maj, min_) in SUPPORTED_VERSIONS:
                if maj == major and minor >= min_ >= minor - rng:
                    chosen = (maj, min_)
                    break
            if chosen != (0, 0):
                break
        self.writer.write(bytes([0, 0, chosen[1], chosen[0]]))
        await self.drain()
        self.version = chosen
        return chosen != (0, 0)

    # --- dispatch -----------------------------------------------------------

    async def dispatch(self, msg: ps.Structure) -> bool:
        sig = msg.tag
        if sig == M_GOODBYE:
            return False
        if sig == M_RESET:
            self.failed = False
            self._finish_bolt_trace("abandoned")
            username = self.interpreter.username
            self.interpreter.abort()
            self.interpreter = Interpreter(self.ictx)
            self.interpreter.username = username  # RESET keeps the identity
            self._prepared = None
            self.send_success()
            return True
        if self.failed and sig not in (M_RESET, M_GOODBYE):
            self.send(M_IGNORED)
            return True
        if not self.authenticated and sig not in (M_HELLO, M_LOGON):
            self.send_failure(
                "Memgraph.ClientError.Security.Unauthenticated",
                "authentication required before other requests")
            return True
        try:
            if sig == M_HELLO:
                return self.on_hello(msg.fields[0] if msg.fields else {})
            if sig == M_LOGON:
                return self.on_logon(msg.fields[0] if msg.fields else {})
            if sig == M_LOGOFF:
                self.authenticated = False
                self._unregister_session()
                self.send_success()
                return True
            if sig == M_RUN:
                return await self.on_run(*msg.fields)
            if sig == M_PULL:
                return await self.on_pull(
                    msg.fields[0] if msg.fields else {})
            if sig == M_DISCARD:
                return await self.on_discard(
                    msg.fields[0] if msg.fields else {})
            if sig == M_BEGIN:
                await self._offload(self.interpreter.execute, "BEGIN")
                self.send_success()
                return True
            if sig == M_COMMIT:
                await self._offload(self.interpreter.execute, "COMMIT")
                self.send_success({"bookmark": "mg-bookmark"})
                return True
            if sig == M_ROLLBACK:
                await self._offload(self.interpreter.execute, "ROLLBACK")
                self.send_success()
                return True
            if sig == M_ROUTE:
                return self.on_route(msg.fields)
            self.send_failure("Memgraph.ClientError.Request.Invalid",
                              f"unsupported message 0x{sig:02X}")
            return True
        except MemgraphTpuError as e:
            self.send_failure(self._error_code(e), str(e))
            return True
        except Exception as e:  # pragma: no cover - defensive
            log.exception("error handling bolt message")
            self.send_failure("Memgraph.DatabaseError.Generic.Unknown",
                              str(e))
            return True

    @staticmethod
    def _error_code(e: MemgraphTpuError) -> str:
        from ..exceptions import (SemanticException, SyntaxException,
                                  TransactionException)
        if isinstance(e, SyntaxException):
            return "Memgraph.ClientError.Statement.SyntaxError"
        if isinstance(e, SemanticException):
            return "Memgraph.ClientError.Statement.SemanticError"
        if isinstance(e, TransactionException):
            return "Memgraph.ClientError.Transaction.Invalid"
        return "Memgraph.TransientError.General.Error"

    # --- handlers -----------------------------------------------------------

    def on_hello(self, extra: dict) -> bool:
        if self.version >= (5, 1):
            # auth arrives via LOGON; only an instance with no users defined
            # may proceed unauthenticated
            self.authenticated = (self.auth is None
                                  or not self.auth.users())
        else:
            principal = extra.get("principal", "")
            credentials = extra.get("credentials", "")
            scheme = (extra.get("scheme") or "basic").lower()
            if self.auth is not None and scheme not in ("basic", "none"):
                username = self.auth.authenticate_external(
                    scheme, principal, credentials)
                if username is None:
                    self.send_failure(
                        "Memgraph.ClientError.Security.Unauthenticated",
                        f"authentication failure (scheme {scheme!r})")
                    return True
                self.authenticated = True
                self.interpreter.username = username
            elif self.auth is not None and not self.auth.authenticate(
                    principal, credentials):
                self.send_failure(
                    "Memgraph.ClientError.Security.Unauthenticated",
                    "authentication failure")
                return True
            else:
                self.authenticated = True
                self.interpreter.username = principal
        if self.authenticated and not self._register_or_refuse():
            return True
        server_name = (getattr(self.ictx, "config", {}) or {}).get(
            "bolt_server_name") or "Neo4j/5.2.0 compatible (memgraph-tpu)"
        self.send_success({
            "server": server_name,
            "connection_id": "bolt-1",
        })
        return True

    def on_logon(self, auth_data: dict) -> bool:
        principal = auth_data.get("principal", "")
        credentials = auth_data.get("credentials", "")
        scheme = (auth_data.get("scheme") or "basic").lower()
        if self.auth is not None and scheme != "basic" \
                and scheme != "none":
            # SSO/external scheme: routed through the mapped auth module
            # (reference: --auth-module-mappings, auth/module.hpp)
            username = self.auth.authenticate_external(
                scheme, principal, credentials)
            if username is None:
                self.send_failure(
                    "Memgraph.ClientError.Security.Unauthenticated",
                    f"authentication failure (scheme {scheme!r})")
                return True
            self.authenticated = True
            self.interpreter.username = username
            if not self._register_or_refuse():
                return True
            self.send_success({})
            return True
        if self.auth is not None and not self.auth.authenticate(
                principal, credentials):
            self.send_failure(
                "Memgraph.ClientError.Security.Unauthenticated",
                "authentication failure")
            return True
        self.authenticated = True
        self.interpreter.username = principal  # RBAC enforcement identity
        if not self._register_or_refuse():
            return True
        self.send_success()
        return True

    def _traced_call(self, fn, *args):
        """Run fn on the worker thread under the session's trace context
        (thread-local, so the activation must happen ON that thread)."""
        handle = self._bolt_trace
        if handle is None:
            return fn(*args)
        with mgtrace.activate(handle.ctx):
            return fn(*args)

    def _finish_bolt_trace(self, status: str = "ok") -> None:
        if self._bolt_trace is not None:
            self._bolt_trace.finish(status=status)
            self._bolt_trace = None

    async def on_run(self, query: str, parameters: dict = None,
                     extra: dict = None) -> bool:
        parameters = {k: bolt_to_value(v)
                      for k, v in (parameters or {}).items()}
        if mgtrace.armed():
            # the Bolt extra-metadata field is the trace carrier across
            # the client boundary: drivers propagate {"trace":
            # {trace_id, span_id, sampled}} and the whole server-side
            # trace joins the caller's
            self._finish_bolt_trace("abandoned")
            carrier = None
            if isinstance(extra, dict):
                carrier = extra.get("trace") or \
                    (extra.get("tx_metadata") or {}).get("trace")
            self._bolt_trace = mgtrace.begin_trace(
                "bolt.run", carrier if isinstance(carrier, dict) else None)
        import time as _time
        t0 = _time.perf_counter()
        prepared = await self._offload(self._traced_call,
                                       self.interpreter.prepare, query,
                                       parameters)
        from ..utils.metrics import global_metrics
        global_metrics.observe(
            "bolt.prepare_latency_sec", _time.perf_counter() - t0)
        self._prepared = prepared
        meta = {"fields": prepared.columns, "t_first": 0, "qid": 0}
        if self._bolt_trace is not None:
            meta["trace_id"] = self._bolt_trace.trace_id
        self.send_success(meta)
        return True

    async def on_pull(self, extra: dict) -> bool:
        n = extra.get("n", -1)
        storage = self.interpreter.ctx.storage  # honors USE DATABASE
        from ..storage.common import View
        rows, has_more, summary = await self._offload(
            self.interpreter.pull, n)
        for row in rows:
            self.send(M_RECORD,
                      [value_to_bolt(v, storage, View.NEW, self.version)
                       for v in row])
        meta = {"has_more": has_more}
        if not has_more:
            meta["t_last"] = 0
            meta["type"] = self._prepared.summary_type if self._prepared \
                else "r"
            stats = summary.get("stats") if summary else None
            if stats and any(stats.values()):
                meta["stats"] = {k.replace("_", "-"): v
                                 for k, v in stats.items() if v}
            if self._bolt_trace is not None:
                meta["trace_id"] = self._bolt_trace.trace_id
                self._finish_bolt_trace("ok")
        self.send_success(meta)
        return True

    async def on_discard(self, extra: dict) -> bool:
        await self._offload(self.interpreter.pull, -1)
        self._finish_bolt_trace("ok")
        self.send_success({"has_more": False})
        return True

    def on_route(self, fields) -> bool:
        """The single-instance routing table: this server serves all
        roles.  (The coordinator's table, from live cluster state, comes
        with the port's replication slice.)"""
        addr = self.ictx.config.get("advertised_address", "localhost:7687")
        self.send_success({"rt": {
            "ttl": 300,
            "db": "memgraph",
            "servers": [
                {"addresses": [addr], "role": "WRITE"},
                {"addresses": [addr], "role": "READ"},
                {"addresses": [addr], "role": "ROUTE"},
            ],
        }})
        return True

    async def refuse_overloaded(self) -> None:
        """Session-cap refusal: finish the handshake so the client can
        parse a real Bolt FAILURE (instead of a dead socket), send it,
        and hang up. The client sees a transient, retryable error."""
        try:
            if not await self.handshake():
                return
            # consume the client's HELLO first: sending FAILURE and
            # closing immediately can RST the client's in-flight HELLO
            # before it ever reads our refusal
            await self.read_message()
            self.send_failure(
                "Memgraph.TransientError.General.ServerOverloaded",
                "server overloaded: max concurrent sessions reached, "
                "retry later")
            await self.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                OSError):
            pass   # the refused peer vanished first; nothing to clean up
        finally:
            self.writer.close()


class BoltServer:
    """Asyncio TCP server accepting Bolt sessions."""

    def __init__(self, interpreter_context: InterpreterContext,
                 host: str = "127.0.0.1", port: int = 7687, auth=None,
                 ssl_context=None, workers: int = None,
                 max_sessions: int | None = None):
        self.ictx = interpreter_context
        self.host = host
        self.port = port
        self.auth = auth
        self.ssl_context = ssl_context   # bolt+s (ref: communication/context.cpp)
        # accept-loop backpressure (reference: --bolt-num-workers bounded
        # session pool): beyond max_sessions concurrent sessions, new
        # connections get a proper Bolt FAILURE ("server overloaded")
        # instead of unbounded accept → fd/thread exhaustion under a
        # connection storm. 0/None = unlimited (single-user default).
        if max_sessions is None:
            max_sessions = int(os.environ.get(
                "MEMGRAPH_TPU_BOLT_MAX_SESSIONS", 0))
        self.max_sessions = max_sessions
        self._live_sessions = 0      # only touched on the event loop
        self._server = None
        if workers is None:
            workers = min(32, (os.cpu_count() or 4) * 4)
        from concurrent.futures import ThreadPoolExecutor
        # deep generator chains (one Python frame per plan operator) are
        # heap-allocated and FOR_ITER_GEN-inlined on CPython 3.12 — no
        # native stack growth — so only sys.recursionlimit (raised by the
        # Interpreter) matters, not thread stack size
        self._executor = (ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="bolt-worker")
            if workers > 0 else None)

    async def _handle(self, reader, writer):
        from ..utils.metrics import global_metrics
        session = BoltSession(reader, writer, self.ictx, self.auth,
                              executor=self._executor)
        if self.max_sessions and self._live_sessions >= self.max_sessions:
            global_metrics.increment("bolt.connections_rejected_total")
            log.warning("bolt: refusing connection, %d/%d sessions live",
                        self._live_sessions, self.max_sessions)
            await session.refuse_overloaded()
            return
        self._live_sessions += 1
        # USE-style pool gauges for the saturation plane (GET /health):
        # live vs cap makes pool exhaustion machine-readable
        global_metrics.set_gauge("bolt.sessions_live",
                                 float(self._live_sessions))
        global_metrics.set_gauge("bolt.sessions_max",
                                 float(self.max_sessions or 0))
        try:
            await session.run()
        finally:
            self._live_sessions -= 1
            global_metrics.set_gauge("bolt.sessions_live",
                                     float(self._live_sessions))

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, ssl=self.ssl_context)
        return self._server

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    def stop(self) -> None:
        """Release the worker pool (and the listener if still open).

        `asyncio.Server.close()` is not thread-safe: calling it from a
        foreign thread races the loop thread's own `_wakeup` (a client
        disconnect closing the last transport) and dies with
        `TypeError: 'NoneType' object is not iterable`. When the
        server's loop is still running, the close is marshalled onto it
        with `call_soon_threadsafe`; a close that loses the race to an
        already-completed shutdown is logged and ignored."""
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        srv = self._server
        if srv is None:
            return

        def _close():
            try:
                srv.close()
            except (RuntimeError, TypeError) as e:
                log.debug("bolt: listener already closing: %s", e)

        try:
            loop = srv.get_loop()
        except (RuntimeError, AttributeError):
            loop = None
        if loop is not None and loop.is_running() and not loop.is_closed():
            loop.call_soon_threadsafe(_close)
        else:
            _close()

    def run_in_thread(self):
        """Start the server on a background thread; returns (thread, loop).

        Raises the underlying error (e.g. port in use) if startup fails.
        """
        import threading
        loop = asyncio.new_event_loop()
        started = threading.Event()
        startup_error: list = []

        def runner():
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.start())
            except Exception as e:
                startup_error.append(e)
                started.set()
                return
            started.set()
            loop.run_forever()

        thread = threading.Thread(target=runner, daemon=True)
        thread.start()
        if not started.wait(timeout=10):
            raise TimeoutError("bolt server failed to start within 10s")
        if startup_error:
            raise startup_error[0]
        return thread, loop
