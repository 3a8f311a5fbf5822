"""MAIN-side replication: per-replica clients, modes, catch-up.

Counterpart of the reference's replication client/handler
(memgraph/src/replication_handler/replication_handler.cpp,
storage/v2/replication/): one connection per registered replica; commits
ship as WAL frames. Modes (replication_coordination_glue/mode.hpp:22):

  SYNC        — the committing thread waits for the replica's ack
  ASYNC       — frames queue onto a background worker
  STRICT_SYNC — like SYNC, and a failed ack marks the commit degraded
                (full 2PC vote-before-visibility is the HA follow-up)

Catch-up: on registration (or reconnect) the replica receives a full
snapshot transfer, then live frames — the reference's snapshot→WAL
catch-up ladder collapsed to its snapshot rung (recovery.hpp analog).

Copy of memgraph_tpu/replication/main_role.py for the port, over the
port's storage hooks (``pre_commit_hooks``, ``frame_consumers``,
``commit_abort_hooks``), its WAL frames and snapshots (each package's
MAIN feeds the other's replica) and its kvstore (``restore_state``).
What differs: the snapshot's ack is awaited for a time that grows with
its size (``snapshot_ack_timeout``; the reference waits the
connection's 30 s, which a 2M-edge snapshot's apply outlasts).  What it
adds: ``ReplicaClient.catchup_stats``, the last snapshot
catch-up's seconds by stage (``snapshot_s``: the MAIN's snapshot,
``ship_s``: from the send to the replica's ack, which holds the
transfer and the replica's apply) and its ``bytes``.
"""

from __future__ import annotations

import enum
import logging
import queue
import socket
import threading
import time
from collections import deque

from ..observability import trace as mgtrace
from ..utils.metrics import global_metrics
from ..utils import faultinject as FI
from ..utils.locks import tracked_lock
from ..utils.retry import RetryPolicy
from . import protocol as P

log = logging.getLogger(__name__)


class ReplicationMode(enum.Enum):
    SYNC = "sync"
    ASYNC = "async"
    STRICT_SYNC = "strict_sync"


class ReplicaStatus(enum.Enum):
    READY = "ready"
    REPLICATING = "replicating"
    RECOVERY = "recovery"
    INVALID = "invalid"


class FencedError(OSError):
    """A replica refused this MAIN's registration: its fencing epoch is
    newer — a successor MAIN was promoted. OSError subclass so generic
    network handlers treat it as a dead link, but carries the observed
    epoch so ReplicationState can fence itself on sight."""

    def __init__(self, observed_epoch: int):
        super().__init__(
            f"fenced: a main with epoch {observed_epoch} superseded us")
        self.observed_epoch = observed_epoch


class ReplicaClient:
    def __init__(self, name: str, address: str, mode: ReplicationMode,
                 storage, src_node: str = "main", epoch_fn=None):
        from ..exceptions import QueryException
        self.name = name
        self.address = address
        # logical node identities for the nemesis network model: every
        # message direction main→replica / replica→main consults the
        # (src, dst)-keyed link rules in utils/faultinject
        self.src_node = src_node
        # current fencing epoch, read at (re-)registration time — a
        # callable because reconnects may happen after a demote/promote
        # changed the owning state's epoch
        self.epoch_fn = epoch_fn or (lambda: 0)
        host, _, port = address.rpartition(":")
        if not host or not port.isdigit():
            raise QueryException(
                f"replica address must be 'host:port', got {address!r}")
        self._host, self._port = host, int(port)
        self.mode = mode
        self.storage = storage
        self.status = ReplicaStatus.INVALID
        # self-healing: ONE shared backoff policy for every RPC site and
        # the reconnect loop (replaces the old per-site except blocks);
        # exhausting it lets a STRICT_SYNC replica degrade instead of
        # wedging commits forever
        self.retry_policy = RetryPolicy(base_delay=0.1, max_delay=5.0,
                                        max_retries=5)
        # health bookkeeping is touched by the commit path, the heartbeat
        # thread, and per-replica reconnect workers concurrently; the
        # streak/backoff counters are read-modify-writes, so they share a
        # dedicated leaf lock (mgsan found lost increments here)
        from ..utils.locks import tracked_lock
        from ..utils.sanitize import shared_field
        self._health_lock = tracked_lock("ReplicaClient._health_lock")
        self.last_acked_ts = 0
        self.failures = 0              # consecutive failed RPCs
        self.degraded_from_strict = False
        self._reconnect_attempts = 0
        self._next_reconnect_at = 0.0
        shared_field(self, "last_acked_ts", "failures",
                     "_reconnect_attempts", "_next_reconnect_at")
        self._sock: socket.socket | None = None
        self._lock = tracked_lock("ReplicaClient._lock")
        self._queue: "queue.Queue[bytes]" = queue.Queue(maxsize=10_000)
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        # frames committed while catch-up is in flight buffer here; the
        # replica dedups by commit_ts, so replay overlap is harmless
        self._catchup_buffer: list[bytes] = []
        self._catchup_system: list[dict] = []
        self._system_queue: list[dict] = []
        self._syslock = tracked_lock("ReplicaClient._syslock")
        self._sys_draining = False
        self.catchup_used: str | None = None   # "wal_delta" | "snapshot"
        self.catchup_stats: dict = {}
        # serializes catch-up attempts: the registering thread and the
        # heartbeat reconnect may target the same client concurrently
        self._catchup_lock = tracked_lock("ReplicaClient._catchup_lock")

    # --- connection / catch-up ----------------------------------------------

    def connect_and_catch_up(self) -> None:
        with self._catchup_lock:
            if self.status is ReplicaStatus.READY:
                return            # another thread just finished catch-up
            try:
                self._connect_and_catch_up()
            except BaseException:
                # a half-done catch-up must not linger in RECOVERY: ship()
                # would buffer frames into _catchup_buffer forever
                self.status = ReplicaStatus.INVALID
                raise

    def _net_out(self) -> None:
        """Nemesis link check, main→replica direction: a partitioned
        link means the message never leaves this node."""
        if FI.net_fire(self.src_node, self.name) == "drop":
            raise FI.FaultInjected(
                f"link {self.src_node}->{self.name} partitioned")

    def _net_in(self) -> None:
        """Nemesis link check, replica→main direction, applied AFTER the
        peer processed the message: with an asymmetric partition the
        replica DID apply the frame but the ack is lost on the wire."""
        if FI.net_fire(self.name, self.src_node) == "drop":
            raise FI.FaultInjected(
                f"link {self.name}->{self.src_node} partitioned (ack lost)")

    def _connect_and_catch_up(self) -> None:
        self.status = ReplicaStatus.RECOVERY
        self._net_out()
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self.CONNECT_TIMEOUT_SEC)
        from ..utils.tls import wrap_cluster_client
        sock = wrap_cluster_client(sock, server_hostname=self._host)
        P.send_json(sock, P.MSG_REGISTER,
                    {"name": self.name, "epoch": self.epoch_fn(),
                     "src": self.src_node,
                     "main_commit_ts": self.storage.latest_commit_ts()})
        msg_type, payload = P.recv_frame(sock)
        if msg_type == P.MSG_FENCED:
            sock.close()
            raise FencedError(P.parse_json(payload).get("fencing_epoch", 0))
        if msg_type != P.MSG_REGISTER_OK:
            sock.close()
            raise ConnectionError("replica registration failed")
        try:
            self._net_in()
        except FI.FaultInjected:
            sock.close()
            raise
        info = P.parse_json(payload)
        self._sock = sock
        # catch-up ladder (reference recovery.hpp): WAL-delta rung first —
        # a briefly-behind replica receives only the missed commit frames;
        # snapshot rung when the ring no longer covers its position
        replica_ts = info.get("last_commit_ts", 0)
        if replica_ts < self.storage.latest_commit_ts():
            frames = None
            provider = getattr(self, "recent_frames_provider", None)
            if provider is not None:
                frames = provider(replica_ts)
            if frames is not None:
                self.catchup_used = "wal_delta"
                for frame in frames:
                    self._net_out()
                    P.send_frame(sock, P.MSG_WAL_FRAME, frame)
                    msg_type, payload = P.recv_frame(sock)
                    self._net_in()
                    if msg_type != P.MSG_ACK:
                        raise ConnectionError("wal-delta catch-up failed")
                    self._set_acked(
                        P.parse_json(payload)["last_commit_ts"])
            else:
                self.catchup_used = "snapshot"
                t0 = time.perf_counter()
                snapshot_bytes = self._snapshot_bytes()
                t1 = time.perf_counter()
                self._net_out()
                # the replica acks after it has loaded and applied the
                # snapshot: a deadline that grows with its size
                sock.settimeout(self.snapshot_ack_timeout(
                    len(snapshot_bytes)))
                P.send_frame(sock, P.MSG_SNAPSHOT, snapshot_bytes)
                msg_type, payload = P.recv_frame(sock)
                sock.settimeout(self.CONNECT_TIMEOUT_SEC)
                self.catchup_stats = {"snapshot_s": t1 - t0,
                                      "ship_s": time.perf_counter() - t1,
                                      "bytes": len(snapshot_bytes)}
                self._net_in()
                if msg_type != P.MSG_ACK:
                    raise ConnectionError("snapshot transfer failed")
                self._set_acked(
                    P.parse_json(payload)["last_commit_ts"])
        # system-state catch-up: full auth + database list (idempotent)
        state_provider = getattr(self, "system_state_provider", None)
        if state_provider is not None:
            full = state_provider()
            if full:
                with self._lock:
                    self._send_system_locked({"seq": 0, "kind": "full",
                                              "data": full})
        # drain anything committed while catch-up ran, then go live; the
        # status flip and the drain share the lock so no frame slips between
        with self._lock:
            buffered = self._catchup_buffer
            self._catchup_buffer = []
            for frame in buffered:
                self._send_frame_locked(frame)
            for txn in self._catchup_system:
                self._send_system_locked(txn)
            self._catchup_system = []
            self.status = ReplicaStatus.READY
        if self.mode is ReplicationMode.ASYNC:
            self._worker = threading.Thread(target=self._drain_loop,
                                            daemon=True)
            self._worker.start()

    #: the connection's socket timeout (the reference's 30 s)
    CONNECT_TIMEOUT_SEC = 30.0
    #: the replica's snapshot load and apply rate the ack deadline allows
    #: (the port's apply measured ~0.6 MB/s on a 23 MB, 2M-edge snapshot)
    SNAPSHOT_ACK_BYTES_PER_SEC = 50_000.0

    @classmethod
    def snapshot_ack_timeout(cls, n_bytes: int) -> float:
        """Seconds to wait for a snapshot's ack: the connection timeout
        plus the time its bytes take at ``SNAPSHOT_ACK_BYTES_PER_SEC``
        (the reference waits 30 s whatever the size, and a large
        snapshot's registration times out: ROADMAP Queue 3 item 22)."""
        return cls.CONNECT_TIMEOUT_SEC + n_bytes / cls.SNAPSHOT_ACK_BYTES_PER_SEC

    def _snapshot_bytes(self) -> bytes:
        import os
        import tempfile
        from ..storage.durability.snapshot import create_snapshot
        if self.storage.config.durability_dir:
            path = create_snapshot(self.storage)
            with open(path, "rb") as f:
                return f.read()
        # no durability dir: snapshot into a temp dir
        old = self.storage.config.durability_dir
        with tempfile.TemporaryDirectory() as tmp:
            self.storage.config.durability_dir = tmp
            try:
                path = create_snapshot(self.storage)
                with open(path, "rb") as f:
                    return f.read()
            finally:
                self.storage.config.durability_dir = old

    # --- unified failure / health bookkeeping -------------------------------

    def _mark_failed(self, op: str, exc: BaseException) -> None:
        """One handler for every RPC failure site: count it, mark the
        client INVALID (the heartbeat loop reconnects with backoff), and
        export health so operators see it without grepping logs."""
        from ..utils.sanitize import shared_write
        with self._health_lock:
            shared_write(self, "failures")
            self.failures += 1
            streak = self.failures
        self.status = ReplicaStatus.INVALID
        global_metrics.increment("replication.rpc_failures")
        global_metrics.set_gauge(
            f"replication.replica_health.{self.name}", 0.0)
        log.warning("replica %s %s failed (%d consecutive): %s",
                    self.name, op, streak, exc)

    def _note_ack(self, last_commit_ts: int) -> None:
        """Every successful ack resets the failure streak and refreshes
        the exported lag/health gauges."""
        from ..utils.sanitize import shared_write
        with self._health_lock:
            shared_write(self, "last_acked_ts")
            self.last_acked_ts = last_commit_ts
            self.failures = 0
            self._reconnect_attempts = 0
            self._next_reconnect_at = 0.0
        lag = max(0, self.storage.latest_commit_ts() - last_commit_ts)
        global_metrics.set_gauge(
            f"replication.replica_lag.{self.name}", float(lag))
        global_metrics.set_gauge(
            f"replication.replica_health.{self.name}", 1.0)

    def acked_ts(self) -> int:
        """last_acked_ts under the health lock (SHOW REPLICAS, tests)."""
        from ..utils.sanitize import shared_read
        with self._health_lock:
            shared_read(self, "last_acked_ts")
            return self.last_acked_ts

    def _set_acked(self, last_commit_ts: int) -> None:
        from ..utils.sanitize import shared_write
        with self._health_lock:
            shared_write(self, "last_acked_ts")
            self.last_acked_ts = last_commit_ts

    def reconnect_due(self, now: float) -> bool:
        from ..utils.sanitize import shared_read
        with self._health_lock:
            shared_read(self, "_next_reconnect_at")
            return now >= self._next_reconnect_at

    def note_reconnect_attempt(self, ok: bool) -> bool:
        """Record a reconnect outcome; returns True when this was the
        FIRST failure of the current outage (callers log that one at
        WARNING and the backed-off retries at DEBUG)."""
        from ..utils.sanitize import shared_write
        with self._health_lock:
            shared_write(self, "_reconnect_attempts")
            if ok:
                self._reconnect_attempts = 0
                self._next_reconnect_at = 0.0
                return False
            first = self._reconnect_attempts == 0
            delay = self.retry_policy.delay_for(
                min(self._reconnect_attempts,
                    self.retry_policy.max_retries))
            self._reconnect_attempts += 1
            self._next_reconnect_at = time.monotonic() + delay
            return first

    def retry_budget_exhausted(self) -> bool:
        """True once failures + backoff reconnect attempts blow past the
        policy budget — the trigger for STRICT_SYNC degradation."""
        from ..utils.sanitize import shared_read
        with self._health_lock:
            shared_read(self, "failures")
            return (self.failures + self._reconnect_attempts
                    > self.retry_policy.max_retries)

    # --- commit shipping ----------------------------------------------------

    def ship(self, frame: bytes) -> bool:
        """Ship one commit frame per the replica's mode. Returns success."""
        if self.status is ReplicaStatus.INVALID:
            return False
        with self._lock:
            if self.status is ReplicaStatus.RECOVERY:
                self._catchup_buffer.append(frame)
                return True
        if self.mode is ReplicationMode.ASYNC:
            try:
                self._queue.put_nowait(frame)
                return True
            except queue.Full:
                log.warning("replica %s queue full; marking invalid",
                            self.name)
                self.status = ReplicaStatus.INVALID
                return False
        return self._send_frame_sync(frame)

    def _send_frame_sync(self, frame: bytes) -> bool:
        with self._lock:
            return self._send_frame_locked(frame)

    def enqueue_system(self, txn: dict) -> None:
        """Queue a system txn in seq order (called under the state lock)."""
        with self._syslock:
            self._system_queue.append(txn)

    def drain_system(self) -> None:
        """Deliver queued system txns in order. Only one drainer runs at a
        time per client, so deliveries never interleave out of seq order."""
        with self._syslock:
            if self._sys_draining:
                return
            self._sys_draining = True
        try:
            while True:
                with self._syslock:
                    if not self._system_queue:
                        # clear the flag in the SAME critical section that
                        # observes the queue empty: a txn enqueued after an
                        # unlocked empty-check but before a finally-block
                        # clear would see _sys_draining=True and never be
                        # delivered (lost wakeup)
                        self._sys_draining = False
                        return
                    txn = self._system_queue.pop(0)
                self.send_system(txn)
        except BaseException:
            with self._syslock:
                self._sys_draining = False
            raise

    def send_system(self, txn: dict) -> bool:
        with self._lock:
            if self.status is ReplicaStatus.RECOVERY:
                # published mid-catch-up: the full dump may have been built
                # before this txn; buffer it to drain before going live
                self._catchup_system.append(txn)
                return True
            return self._send_system_locked(txn)

    def _send_system_locked(self, txn: dict) -> bool:
        try:
            carrier = mgtrace.inject()
            if carrier is not None:
                # system txns are JSON: the replication wire carries the
                # trace context so the replica-side apply span joins the
                # originating query's trace
                txn = {**txn, "trace": carrier}
            if FI.fire("repl.send") == "drop":
                raise FI.FaultInjected("injected drop of system txn")
            self._net_out()
            P.send_json(self._sock, P.MSG_SYSTEM, txn)
            msg_type, _ = P.recv_frame(self._sock)
            self._net_in()
            return msg_type == P.MSG_ACK
        except (ConnectionError, OSError) as e:
            self._mark_failed("system txn", e)
            return False

    def _send_frame_locked(self, frame: bytes) -> bool:
        t0 = time.perf_counter()
        try:
            # one span per (frame, replica): the replication-ack leg of
            # a committing query's trace
            with mgtrace.span("repl.ship") as sp:
                if sp:
                    sp.set(replica=self.name, bytes=len(frame))
                if FI.fire("repl.send") == "drop":
                    # the frame is lost before hitting the wire; the ack
                    # timeout/reconnect path must re-ship it via catch-up
                    raise FI.FaultInjected("injected drop of WAL frame")
                self._net_out()
                P.send_frame(self._sock, P.MSG_WAL_FRAME, frame)
                msg_type, payload = P.recv_frame(self._sock)
                self._net_in()
                if msg_type == P.MSG_ACK:
                    self._note_ack(
                        P.parse_json(payload)["last_commit_ts"])
                    global_metrics.observe(
                        "replication.ship_latency_sec",
                        time.perf_counter() - t0)
                    return True
            self._mark_failed("frame ship", ValueError(f"nack {msg_type}"))
            return False
        except (ConnectionError, OSError) as e:
            self._mark_failed("frame ship", e)
            return False

    # --- 2PC (STRICT_SYNC) --------------------------------------------------

    # 2PC vote RPCs run inside the storage engine lock — a hung replica
    # there stalls every new transaction, so they get a short dedicated
    # timeout instead of the 30s connection default (advisor finding).
    TWO_PC_RPC_TIMEOUT_SEC = 5.0

    def prepare(self, frame: bytes) -> bool:
        """Phase 1: ship the frame for a vote (held pending on the replica)."""
        if self.status is not ReplicaStatus.READY:
            return False
        with self._lock:
            try:
                if self._sock is None:
                    return False
                old = self._sock.gettimeout()
                self._sock.settimeout(self.TWO_PC_RPC_TIMEOUT_SEC)
                try:
                    if FI.fire("repl.send") == "drop":
                        raise FI.FaultInjected("injected drop of prepare")
                    self._net_out()
                    P.send_frame(self._sock, P.MSG_PREPARE, frame)
                    msg_type, payload = P.recv_frame(self._sock)
                    self._net_in()
                finally:
                    self._sock.settimeout(old)
                return msg_type == P.MSG_ACK
            except (ConnectionError, OSError) as e:
                self._mark_failed("prepare", e)
                return False

    def finalize(self, commit_ts: int, decision: str) -> bool:
        """Phase 2: commit/abort the pending frame."""
        with self._lock:
            try:
                if self._sock is None:  # mid-registration: nothing prepared
                    return False
                old = self._sock.gettimeout()
                self._sock.settimeout(self.TWO_PC_RPC_TIMEOUT_SEC)
                try:
                    self._net_out()
                    P.send_json(self._sock, P.MSG_FINALIZE,
                                {"commit_ts": commit_ts, "decision": decision})
                    msg_type, payload = P.recv_frame(self._sock)
                    self._net_in()
                finally:
                    self._sock.settimeout(old)
                if msg_type == P.MSG_ACK:
                    if decision == "commit":
                        self._note_ack(P.parse_json(
                            payload)["last_commit_ts"])
                    return True
                self._mark_failed("finalize", ValueError(f"nack {msg_type}"))
                return False
            except (ConnectionError, OSError) as e:
                self._mark_failed("finalize", e)
            return False

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self._send_frame_sync(frame)

    def heartbeat(self) -> bool:
        # short timeout: heartbeat holds the per-client lock, and the 2PC
        # commit path (inside the storage engine lock) waits on that same
        # lock — a wedged replica must not stall commits for 30s
        with self._lock:
            try:
                if self._sock is None:
                    return False
                old = self._sock.gettimeout()
                self._sock.settimeout(self.TWO_PC_RPC_TIMEOUT_SEC)
                try:
                    self._net_out()
                    P.send_json(self._sock, P.MSG_HEARTBEAT,
                                {"main_commit_ts":
                                 self.storage.latest_commit_ts()})
                    msg_type, payload = P.recv_frame(self._sock)
                    self._net_in()
                finally:
                    self._sock.settimeout(old)
                if msg_type == P.MSG_ACK:
                    self._note_ack(P.parse_json(payload)["last_commit_ts"])
                    return True
                self._mark_failed("heartbeat",
                                  ValueError(f"nack {msg_type}"))
                return False
            except (ConnectionError, OSError) as e:
                self._mark_failed("heartbeat", e)
            return False

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class ReplicationState:
    """Role + replica registry, owned by the InterpreterContext.

    Reference analog: ReplicationState + ReplicationHandler
    (src/replication/state.hpp, replication_handler.cpp).
    """

    HEARTBEAT_INTERVAL_SEC = 2.0

    def __init__(self, storage, ictx=None, node_name: str | None = None):
        import os as _os
        self.storage = storage
        self.ictx = ictx           # system-state source (auth, dbms)
        self.role = "main"
        # logical node name for the nemesis network model (chaos tests
        # partition links keyed on these names)
        self.node_name = node_name or _os.environ.get(
            "MEMGRAPH_TPU_NODE_NAME", "main")
        # fencing: the promotion epoch this instance last learned from
        # the coordinator (promote/demote RPC) or from a replica's
        # MSG_FENCED refusal. A MAIN that observes a newer epoch than
        # its own has been deposed and must stop acking writes.
        self.fencing_epoch = 0
        self.fenced = False
        # STRICT_SYNC degradation trades safety for availability; a
        # fenced/HA deployment turns it off so a partitioned MAIN can
        # never silently stop waiting for its strict replicas (that is
        # exactly the split-brain ack-loss window)
        self.allow_strict_degradation = True
        self._system_seq = 0
        self.replicas: dict[str, ReplicaClient] = {}
        self.replica_server = None
        self._lock = tracked_lock("ReplicationState._lock")
        self._consumer_registered = False
        # recent-commit ring for the WAL-delta catch-up rung (reference:
        # storage/v2/replication/recovery.hpp ladder): a briefly-behind
        # replica receives just the missed frames instead of a snapshot.
        # _frames_floor = highest commit_ts that may be MISSING from the
        # ring (commits before the consumer registered, or evicted).
        import os as _os
        self._recent_frames: "deque[tuple[int, bytes]]" = deque()
        self._frames_floor = 0
        self._frames_cap = int(_os.environ.get(
            "MEMGRAPH_TPU_REPL_RING", 4096))
        self._frames_lock = tracked_lock("ReplicationState._frames_lock")
        self._heartbeat_thread: threading.Thread | None = None
        self._stop_heartbeat = threading.Event()
        self._reconnecting: set[int] = set()
        from ..utils.sanitize import shared_field
        shared_field(self, "replicas", "_recent_frames", "_frames_floor",
                     "_reconnecting", "_system_seq", "fencing_epoch",
                     "fenced")

    def _ensure_consumer(self) -> None:
        # lazy: commits only pay frame encoding once a replica exists
        if not self._consumer_registered:
            with self._frames_lock:
                # commits made while no consumer ran never reached the
                # ring: everything at/below the current ts needs snapshot
                self._recent_frames.clear()
                self._frames_floor = self.storage.latest_commit_ts()
            self.storage.frame_consumers.append(self._on_commit_frame)
            self.storage.pre_commit_hooks.append(self._on_pre_commit)
            self.storage.commit_abort_hooks.append(self._on_commit_abort)
            self._consumer_registered = True

    def _maybe_remove_consumer(self) -> None:
        # mglint: disable=MG006 — every caller (drop_replica, demote, register failure path) holds self._lock; intraprocedural analysis cannot see it
        if self._consumer_registered and not self.replicas:
            for lst, hook in ((self.storage.frame_consumers,
                               self._on_commit_frame),
                              (self.storage.pre_commit_hooks,
                               self._on_pre_commit),
                              (self.storage.commit_abort_hooks,
                               self._on_commit_abort)):
                try:
                    lst.remove(hook)
                except ValueError:
                    pass
            self._consumer_registered = False

    # --- role management ----------------------------------------------------

    # --- durable state (reference: --replication-restore-state-on-startup,
    # replication/state.hpp persisted role + registry) ----------------------

    def _kv(self):
        return getattr(self.ictx, "kvstore", None) if self.ictx else None

    def _persist_state(self) -> None:
        kv = self._kv()
        if kv is None:
            return
        import json
        with self._lock:
            doc = {"role": self.role,
                   "listen_port": (self.replica_server.port
                                   if self.replica_server else 0),
                   "fencing_epoch": self.fencing_epoch,
                   "replicas": [
                       {"name": r.name, "address": r.address,
                        "mode": r.mode.name}
                       for r in self.replicas.values()]}
        kv.put("replication:state", json.dumps(doc))

    def restore_state(self) -> None:
        """Re-apply the persisted role + replica registry (called at
        startup under --replication-restore-state-on-startup)."""
        kv = self._kv()
        if kv is None:
            return
        import json
        raw = kv.get_str("replication:state")
        if not raw:
            return
        try:
            doc = json.loads(raw)
        except ValueError:
            return
        epoch = int(doc.get("fencing_epoch") or 0)
        if doc.get("role") == "replica" and doc.get("listen_port"):
            self.set_role_replica("0.0.0.0", int(doc["listen_port"]),
                                  epoch=epoch)
            return
        with self._lock:
            self.fencing_epoch = max(self.fencing_epoch, epoch)
        from ..exceptions import QueryException
        for spec in doc.get("replicas", ()):
            try:
                self.register_replica(spec["name"], spec["address"],
                                      ReplicationMode[spec["mode"]])
            except (KeyError, ConnectionError, OSError,
                    QueryException) as e:
                # an unreachable replica must not block startup — it can
                # be re-registered (or will reconnect) later
                log.warning("replication state restore: replica %r not "
                            "restored (%s); re-register it or let the "
                            "heartbeat reconnect it",
                            spec.get("name", "?"), e)
                continue

    def set_role_replica(self, host: str, port: int,
                         epoch: int | None = None) -> None:
        from ..exceptions import QueryException
        from .replica import ReplicaServer
        with self._lock:
            for r in self.replicas.values():
                r.close()
            self.replicas.clear()
            self._maybe_remove_consumer()
            if epoch is not None:
                self.fencing_epoch = max(self.fencing_epoch, int(epoch))
            if self.replica_server is not None:
                self.replica_server.stop()
                self.replica_server = None
            server = ReplicaServer(self.storage, host, port,
                                   ictx=self.ictx,
                                   fencing_epoch=self.fencing_epoch)
            try:
                server.start()
            except OSError as e:
                raise QueryException(
                    f"cannot listen on {host}:{port}: {e}") from e
            self.replica_server = server
            self.role = "replica"
            self.fenced = False    # a demoted node is no longer a main
        self._persist_state()

    def set_role_main(self, epoch: int | None = None) -> None:
        from ..exceptions import FencedException
        with self._lock:
            if epoch is not None and int(epoch) < self.fencing_epoch:
                # a delayed/replayed promote RPC from a PREVIOUS epoch
                # must not resurrect a deposed main
                raise FencedException(
                    f"stale promote epoch {epoch} < known "
                    f"{self.fencing_epoch}")
            server, self.replica_server = self.replica_server, None
        if server is not None:
            # presumed-commit OUTSIDE the state lock (the WAL apply
            # takes the engine lock, whose commit path takes the state
            # lock — holding it here closes a lock cycle): prepared 2PC
            # frames whose finalize never arrived are applied so an
            # acked write on the old MAIN survives this promotion
            server.apply_pending_2pc()
            server.stop()
        with self._lock:
            # re-check under the write lock: a concurrent fence/demote
            # may have advanced the epoch while the 2PC drain ran — a
            # now-stale promote must still be refused (the coordinator's
            # reconcile loop repairs the half-stopped server state)
            if epoch is not None and int(epoch) < self.fencing_epoch:
                raise FencedException(
                    f"stale promote epoch {epoch} < known "
                    f"{self.fencing_epoch} (epoch advanced mid-promote)")
            self.role = "main"
            if epoch is not None:
                self.fencing_epoch = max(self.fencing_epoch, int(epoch))
            self.fenced = False
        self._persist_state()

    def current_epoch(self) -> int:
        """Fencing epoch under the state lock (replica registration,
        mgmt state_check)."""
        from ..utils.sanitize import shared_read
        with self._lock:
            shared_read(self, "fencing_epoch")
            return self.fencing_epoch

    def is_fenced(self) -> bool:
        from ..utils.sanitize import shared_read
        with self._lock:
            shared_read(self, "fenced")
            return self.fenced

    def fencing_info(self) -> tuple[int, bool]:
        """(fencing_epoch, fenced) as one consistent snapshot."""
        from ..utils.sanitize import shared_read
        with self._lock:
            shared_read(self, "fencing_epoch")
            return self.fencing_epoch, self.fenced

    def replica_names(self) -> list[str]:
        """Registered replica names under the state lock (state_check)."""
        with self._lock:
            return sorted(self.replicas)

    def fence(self, observed_epoch: int) -> None:
        """A replica (or the coordinator) proved a newer MAIN exists:
        stop acking writes until promoted again with a fresh epoch."""
        from ..utils.sanitize import shared_write
        with self._lock:
            if observed_epoch <= self.fencing_epoch and self.fenced:
                return
            shared_write(self, "fencing_epoch")
            self.fencing_epoch = max(self.fencing_epoch,
                                     int(observed_epoch))
            self.fenced = True
        global_metrics.increment("replication.fenced_total")
        log.error(
            "MAIN %s FENCED: epoch %d superseded ours — refusing further "
            "write acks until re-promoted", self.node_name, observed_epoch)

    def shutdown(self) -> None:
        """Hard-stop everything this state owns (chaos kill / dbms
        teardown): heartbeat loop, replica clients, replica server."""
        self._stop_heartbeat.set()
        with self._lock:
            clients = list(self.replicas.values())
            server, self.replica_server = self.replica_server, None
        for c in clients:
            c.close()
        if server is not None:
            server.stop()

    # --- replica registry ---------------------------------------------------

    def register_replica(self, name: str, address: str,
                         mode: ReplicationMode) -> None:
        from ..exceptions import FencedException, QueryException
        if self.role != "main":
            raise QueryException("only MAIN can register replicas")
        if self.is_fenced():
            raise FencedException(
                "this MAIN is fenced (a newer epoch exists); it cannot "
                "adopt replicas")
        client = ReplicaClient(name, address, mode, self.storage,
                               src_node=self.node_name,
                               epoch_fn=self.current_epoch)
        client.system_state_provider = self.system_state
        client.recent_frames_provider = self._frames_since
        with self._lock:
            if name in self.replicas:
                raise QueryException(f"replica {name!r} already registered")
            # visible to the commit path BEFORE catch-up starts: frames
            # committed during the snapshot transfer buffer on the client
            # (status RECOVERY) and drain after it — no gap
            self.replicas[name] = client
            self._ensure_consumer()
        try:
            client.connect_and_catch_up()
        except (ConnectionError, OSError, QueryException) as e:
            with self._lock:
                # re-validate under the lock: a concurrent drop+register
                # may have installed a DIFFERENT client under this name
                # while catch-up ran — only unregister our own (MG007)
                if self.replicas.get(name) is client:
                    del self.replicas[name]
                self._maybe_remove_consumer()
            client.close()
            if isinstance(e, FencedError):
                # the replica proved a newer MAIN exists: fence NOW so
                # no further commit on this deposed main gets acked
                self.fence(e.observed_epoch)
                raise FencedException(str(e)) from e
            raise QueryException(
                f"cannot register replica {name!r}: {e}") from e
        self._persist_state()
        self._start_heartbeat()

    def drop_replica(self, name: str) -> None:
        from ..exceptions import QueryException
        with self._lock:
            client = self.replicas.pop(name, None)
            self._maybe_remove_consumer()
        if client is None:
            raise QueryException(f"replica {name!r} is not registered")
        client.close()
        self._persist_state()

    # --- liveness -----------------------------------------------------------

    def _start_heartbeat(self) -> None:
        if self._heartbeat_thread is not None:
            return
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True)
        self._heartbeat_thread.start()

    def _heartbeat_loop(self) -> None:
        while not self._stop_heartbeat.wait(self.HEARTBEAT_INTERVAL_SEC):
            with self._lock:
                clients = list(self.replicas.values())
            for c in clients:
                if c.status is ReplicaStatus.READY:
                    c.heartbeat()
                elif c.status is ReplicaStatus.INVALID and \
                        c.reconnect_due(time.monotonic()):
                    # auto-reconnect on a per-replica worker thread: one
                    # dead replica's connect timeout or long snapshot
                    # transfer must not stall heartbeats to the others;
                    # attempts back off per the client's RetryPolicy
                    self._spawn_reconnect(c)

    def _spawn_reconnect(self, client) -> None:
        name = client.name
        # dedup by client identity, not name: a stale worker for a dropped
        # client must not block reconnects of a re-registered replacement
        key = id(client)
        with self._lock:
            if key in self._reconnecting:
                return
            self._reconnecting.add(key)

        def run():
            # Catch EVERYTHING: one malformed ack must not kill the
            # worker silently mid-bookkeeping (reference: the
            # replication client's retry loop); the WAL-delta rung makes
            # this cheap for briefly-severed replicas.
            try:
                # ownership check BEFORE connecting: a dropped/demoted
                # replica must not receive a snapshot from a main that no
                # longer owns it
                with self._lock:
                    if self.replicas.get(name) is not client:
                        return
                try:
                    client.connect_and_catch_up()
                except FencedError as fe:
                    # the replica now answers to a newer MAIN; stop
                    # reconnecting AND stop acking — we are deposed
                    self.fence(fe.observed_epoch)
                    return
                # re-check: drop may have raced the transfer — don't
                # resurrect a connection the registry no longer owns
                with self._lock:
                    still_ours = self.replicas.get(name) is client
                if not still_ours:
                    client.close()
                else:
                    client.note_reconnect_attempt(True)
                    log.info("replica %s reconnected via %s catch-up",
                             client.name, client.catchup_used)
            except Exception:
                # the streak read + bump is one atomic step inside the
                # client's health lock (mgsan: the old read-then-bump
                # raced other workers into duplicate WARNINGs)
                first = client.note_reconnect_attempt(False)
                # WARNING once per outage (the operator-visible event),
                # debug for the backed-off retries — a dead replica must
                # not spam one warning per attempt forever
                if first:
                    log.warning("replica %s reconnect failed; retrying "
                                "with backoff", client.name,
                                exc_info=True)
                else:
                    log.debug("replica %s reconnect failed again",
                              client.name, exc_info=True)
            finally:
                with self._lock:
                    self._reconnecting.discard(key)

        threading.Thread(target=run, daemon=True,
                         name=f"repl-reconnect-{name}").start()

    def show_replicas(self) -> list[list]:
        rows = []
        with self._lock:
            clients = list(self.replicas.values())
        for c in clients:
            rows.append([c.name, c.address, c.mode.value,
                         c.acked_ts(), c.status.value])
        return rows

    # --- system-state replication -------------------------------------------

    def system_state(self) -> dict:
        """Full system state for catch-up: auth dump + database names
        (reference: the system txn log replayed at replica registration,
        src/system/transaction.cpp)."""
        out = {}
        ictx = self.ictx
        if ictx is not None:
            auth = getattr(ictx, "auth_store", None)
            if auth is not None:
                out["auth"] = auth.to_dict()
            dbms = getattr(ictx, "dbms", None)
            if dbms is not None:
                out["databases"] = dbms.names()
        return out

    def publish_system(self, kind: str, data: dict) -> None:
        """Ship one ordered system transaction to every replica. Best
        effort per replica (a failed replica is marked INVALID and will
        receive the full state on re-registration)."""
        if self.role != "main":
            return
        # seq assignment + per-client enqueue under the state lock (fixes
        # global ordering); DELIVERY happens outside it via each client's
        # ordered drain — a wedged replica must not stall data commits,
        # which also contend on this lock (_on_pre_commit)
        with self._lock:
            self._system_seq += 1
            txn = {"seq": self._system_seq, "kind": kind, "data": data}
            clients = []
            for c in self.replicas.values():
                if c.status in (ReplicaStatus.READY, ReplicaStatus.RECOVERY):
                    c.enqueue_system(txn)
                    clients.append(c)
        for c in clients:
            c.drain_system()

    # --- commit hook --------------------------------------------------------

    def _on_pre_commit(self, frame: bytes, commit_ts: int) -> None:
        """2PC phase 1 (under the engine lock, before WAL + visibility):
        every STRICT_SYNC replica must vote yes or the commit aborts
        (reference: PrepareCommit with vote wait,
        inmemory/storage.cpp:1224-1272)."""
        if self.role != "main":
            return
        epoch, fenced = self.fencing_info()
        if fenced:
            # refused BEFORE any prepare: a deposed main acks nothing
            from ..exceptions import FencedException
            raise FencedException(
                f"write refused: this MAIN is fenced (epoch "
                f"{epoch} superseded it)")
        with self._lock:
            all_strict = [c for c in self.replicas.values()
                          if c.mode is ReplicationMode.STRICT_SYNC]
        # a STRICT_SYNC replica that cannot vote means NO commit may
        # proceed — that is the strict guarantee. RECOVERY counts as
        # unavailable too: with heartbeat auto-reconnect a replica can sit
        # mid-catch-up at commit time, and if that catch-up fails a
        # buffered frame would be silently lost after MAIN committed.
        # Graceful degradation: a replica that has already exhausted its
        # retry budget is DEMOTED to ASYNC catch-up instead of wedging
        # every future commit (loud metric + log; catch-up re-ships what
        # it missed once it returns).
        down = [c for c in all_strict if c.status is not ReplicaStatus.READY]
        still_down = []
        for c in down:
            if self.allow_strict_degradation and \
                    c.retry_budget_exhausted():
                self._demote_strict(c)
            else:
                still_down.append(c)
        if still_down:
            # ReplicaUnavailable (not the generic TransactionException):
            # nothing was prepared anywhere, so this abort is a SAFE
            # "definitely did not happen" — chaos clients rely on that
            from ..exceptions import ReplicaUnavailableException
            raise ReplicaUnavailableException(
                "STRICT_SYNC replica(s) unavailable: "
                + ", ".join(c.name for c in still_down)
                + " — transaction aborted (drop the replica or restore it)")
        # every remaining strict client is READY here (the vote above
        # aborts otherwise; demoted clients left the strict set)
        strict = [c for c in all_strict
                  if c.mode is ReplicationMode.STRICT_SYNC]
        if not strict:
            return
        prepared = []
        failed = []
        for c in strict:
            if c.prepare(frame):
                prepared.append(c)
            else:
                failed.append(c)
        if failed:
            for c in prepared:
                c.finalize(commit_ts, "abort")
            from ..exceptions import TransactionException
            raise TransactionException(
                "STRICT_SYNC replica(s) did not confirm the prepare phase: "
                + ", ".join(c.name for c in failed)
                + " — transaction aborted")

    def _demote_strict(self, client) -> None:
        """STRICT_SYNC → ASYNC-catchup degradation: acknowledged commits
        stop waiting for a replica that exhausted its retry budget. Loud
        by design — an operator must notice the durability downgrade."""
        client.mode = ReplicationMode.ASYNC
        client.degraded_from_strict = True
        global_metrics.increment("replication.strict_sync_demotions")
        global_metrics.set_gauge(
            f"replication.replica_degraded.{client.name}", 1.0)
        log.error(
            "STRICT_SYNC replica %s exhausted its retry budget "
            "(max_retries=%d) — DEMOTED to ASYNC catch-up; commits no "
            "longer wait for its vote (re-register to restore strictness)",
            client.name, client.retry_policy.max_retries)

    def _on_commit_abort(self, commit_ts: int) -> None:
        """Commit failed after the 2PC vote succeeded (e.g. the WAL write
        raised): release the prepared frame on every STRICT_SYNC replica
        so it is not orphaned in its pending-2PC table forever."""
        if self.role != "main":
            return
        # filter by mode only, NOT by READY: a replica that voted yes may
        # have been marked INVALID concurrently (heartbeat thread); sending
        # abort to an un-prepared replica is harmless (it pops nothing)
        with self._lock:
            strict = [c for c in self.replicas.values()
                      if c.mode is ReplicationMode.STRICT_SYNC]
        for c in strict:
            try:
                c.finalize(commit_ts, "abort")
            except Exception:
                # one broken client must not keep the abort from the rest
                log.exception("finalize(abort) failed for replica %s", c.name)

    def _frames_since(self, since_ts: int):
        """WAL frames with commit_ts > since_ts in commit order, or None
        when the ring no longer covers that range (snapshot needed)."""
        from ..utils.sanitize import shared_read
        with self._frames_lock:
            shared_read(self, "_recent_frames")
            if since_ts < self._frames_floor:
                return None
            return [f for ts, f in self._recent_frames if ts > since_ts]

    def _on_commit_frame(self, frame: bytes, commit_ts: int) -> None:
        if self.role != "main":
            return
        from ..utils.sanitize import shared_write
        with self._frames_lock:
            shared_write(self, "_recent_frames")
            self._recent_frames.append((commit_ts, frame))
            while len(self._recent_frames) > self._frames_cap:
                ts, _ = self._recent_frames.popleft()
                if ts > self._frames_floor:
                    self._frames_floor = ts
        with self._lock:
            clients = list(self.replicas.values())
        if not clients:
            return
        for c in clients:
            if c.mode is ReplicationMode.STRICT_SYNC:
                if c.status is ReplicaStatus.READY:
                    # 2PC phase 2: the frame was prepared pre-visibility
                    c.finalize(commit_ts, "commit")
                elif c.status is ReplicaStatus.RECOVERY:
                    c.ship(frame)  # buffers for the catch-up drain
                continue
            ok = c.ship(frame)
            if not ok and c.mode is ReplicationMode.SYNC:
                # the commit is already locally visible — raising here could
                # only corrupt the session; the replica is marked INVALID and
                # surfaces through SHOW REPLICAS
                log.error("replica %s (sync) failed to confirm commit %d",
                          c.name, commit_ts)
