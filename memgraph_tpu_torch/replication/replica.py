"""Replica-side replication server.

Counterpart of the reference's replica handlers
(memgraph/src/dbms/replication_handlers.cpp): accepts a MAIN's
registration, ingests a full snapshot transfer for catch-up, then applies
WAL transaction frames in commit order. Applies bypass MVCC (the replica's
state is always a prefix of MAIN's committed history) — the same direct-
apply model the reference uses on replicas.

Copy of memgraph_tpu/replication/replica.py for the port.  What differs
is the seam to the device's snapshot caches:

- Frames and snapshots apply under the storage's ``apply_gate`` (a
  ``utils.locks.ReadWriteGate`` the server installs while it serves, in
  place of the reference's apply lock).  A snapshot export of the
  replica (``GraphCache.get`` over a ``StorageSource``) reads under the
  same gate at the live version, so a ``CALL pagerank.get()`` on a
  replica answers one committed version, never a mix of two (the
  reference's applies run past MVCC while readers walk the objects).
- As in the reference, a frame's apply ends in
  ``storage._bump_topology(changed)`` with the changed vertex gids of
  ``_apply_wal_txn`` (so the port's ``GraphCache`` and ``LocalWarmPool``
  take a delta export and a ``DeltaPlan`` after a replicated commit) and
  a snapshot's apply in a bump with no changed set (every cache builds
  afresh, as after recovery).
- ``apply_stats`` holds the seconds of the last snapshot apply
  (``snapshot_apply_s``: write, load and rebuild) and of the frames
  (``frames_apply_s``, summed), and the count of frames applied.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

from ..exceptions import MemgraphTpuError
from ..observability import trace as mgtrace
from ..storage.durability import wal as W
from ..utils.locks import ReadWriteGate
from ..storage.durability.recovery import _apply_wal_txn
from . import protocol as P

log = logging.getLogger(__name__)


class ReplicaServer:
    """Listens for the MAIN; applies snapshot + WAL frames to storage."""

    def __init__(self, storage, host: str = "127.0.0.1", port: int = 10000,
                 ictx=None, fencing_epoch: int = 0):
        self.storage = storage
        self.ictx = ictx           # for system-state apply (auth, multi-db)
        self.host = host
        self.port = port
        self.last_system_seq = 0
        self.last_commit_ts = 0
        # fencing: the highest promotion epoch this replica has ever
        # heard (from its own demote RPC or a registering MAIN). A MAIN
        # registering with a LOWER epoch was deposed — its registration
        # is refused with MSG_FENCED so a partitioned-away old MAIN can
        # never feed us stale writes (split-brain guard).
        self.fencing_epoch = int(fencing_epoch or 0)
        self.epoch = self.fencing_epoch    # back-compat alias
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # installed on the storage while this server serves (start/stop)
        self._gate = storage.apply_gate or ReadWriteGate()
        self.apply_stats = {"snapshot_apply_s": 0.0, "frames_apply_s": 0.0,
                            "frames": 0}
        self._conns: list[socket.socket] = []
        # 2PC (STRICT_SYNC): frames received via MSG_PREPARE wait here for
        # the MAIN's MSG_FINALIZE decision (reference: PrepareCommit /
        # FinalizeCommit RPCs, storage/v2/replication/rpc.hpp:59-98)
        self._pending_2pc: dict[int, bytes] = {}

    def start(self) -> None:
        self.storage.apply_gate = self._gate
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]  # resolve port 0 for tests
        self._sock.listen(4)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                # shutdown() wakes the blocked accept() — close() alone
                # leaves the accept thread holding the fd, so the port
                # stays bound and a REPLICA->MAIN->REPLICA role flip on
                # the same port fails with EADDRINUSE
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.storage.apply_gate is self._gate:
            # a MAIN again (or a stopped replica): reads go back to MVCC
            self.storage.apply_gate = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_main, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_main(self, conn: socket.socket) -> None:
        try:
            # TLS handshake on THIS thread (accept loop must never block
            # on a silent peer); timeout inside wrap_cluster_server
            from ..utils.tls import wrap_cluster_server
            conn = wrap_cluster_server(conn)
            while not self._stop.is_set():
                msg_type, payload = P.recv_frame(conn)
                # armed repl.recv faults sever the connection before the
                # received frame is applied or acked (a lost-frame /
                # crashed-replica stand-in) — the MAIN must heal via its
                # retry/catch-up path
                from ..utils import faultinject as FI
                if FI.fire("repl.recv") == "drop":
                    raise FI.FaultInjected("injected drop of received frame")
                if msg_type == P.MSG_REGISTER:
                    info = P.parse_json(payload)
                    main_epoch = int(info.get("epoch") or 0)
                    if main_epoch < self.fencing_epoch:
                        # deposed MAIN: refuse — and TELL it the current
                        # epoch so it can fence itself immediately
                        log.warning(
                            "refusing registration from stale-epoch main "
                            "(theirs %d < ours %d)", main_epoch,
                            self.fencing_epoch)
                        P.send_json(conn, P.MSG_FENCED,
                                    {"fencing_epoch": self.fencing_epoch})
                        continue
                    self.fencing_epoch = max(self.fencing_epoch,
                                             main_epoch)
                    self.epoch = self.fencing_epoch
                    # a (re-)registering MAIN supersedes any in-flight 2PC:
                    # prepared-but-unfinalized frames from the previous
                    # connection would otherwise leak forever
                    self._pending_2pc.clear()
                    P.send_json(conn, P.MSG_REGISTER_OK,
                                {"last_commit_ts": self.last_commit_ts,
                                 "epoch": self.fencing_epoch})
                elif msg_type == P.MSG_SNAPSHOT:
                    self._pending_2pc.clear()
                    self._apply_snapshot_bytes(payload)
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts})
                elif msg_type == P.MSG_WAL_FRAME:
                    self._apply_wal_frame(payload)
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts})
                elif msg_type == P.MSG_PREPARE:
                    # phase 1: durably hold the frame, vote yes
                    txns = list(W.iter_txns_from_bytes(payload))
                    for commit_ts, _ in txns:
                        self._pending_2pc[commit_ts] = payload
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts,
                                 "prepared": [ts for ts, _ in txns]})
                elif msg_type == P.MSG_FINALIZE:
                    info = P.parse_json(payload)
                    commit_ts = info["commit_ts"]
                    frame = self._pending_2pc.pop(commit_ts, None)
                    if info.get("decision") == "commit" and frame is not None:
                        self._apply_wal_frame(frame)
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts})
                elif msg_type == P.MSG_SYSTEM:
                    self._apply_system(P.parse_json(payload))
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts,
                                 "system_seq": self.last_system_seq})
                elif msg_type == P.MSG_HEARTBEAT:
                    P.send_json(conn, P.MSG_ACK,
                                {"last_commit_ts": self.last_commit_ts})
                else:
                    P.send_json(conn, P.MSG_ERROR,
                                {"message": f"unknown message {msg_type}"})
        except (ConnectionError, OSError):
            pass
        except (struct.error, ValueError, MemgraphTpuError) as e:
            # corrupt frame (torn length prefix, garbage JSON) or a
            # refused apply (DurabilityError/StorageError): sever THIS
            # connection loudly instead of killing the serving thread
            # silently — the MAIN heals via its retry/catch-up path
            log.warning("replica connection dropped: %s: %s",
                        type(e).__name__, e)
        finally:
            conn.close()

    def apply_pending_2pc(self) -> int:
        """Presumed-commit on promotion: apply prepared-but-unfinalized
        2PC frames in commit order before this replica becomes MAIN.

        A frame sits here only after the old MAIN collected the full
        strict vote — the common reason the finalize never arrived is
        that the MAIN committed (and ACKED the client) and then lost us.
        Applying is therefore the durability-safe direction; the rare
        aborted-after-vote txn resurfaces as an UN-acked write, which no
        client was promised anything about. Returns the applied count."""
        pending = sorted(self._pending_2pc.items())
        self._pending_2pc.clear()
        for commit_ts, frame in pending:
            if commit_ts <= self.last_commit_ts:
                continue
            self._apply_wal_frame(frame)
        if pending:
            log.warning("promotion: presumed-commit applied %d pending "
                        "2PC frame(s)", len(pending))
        return len(pending)

    # --- appliers -----------------------------------------------------------

    def _apply_snapshot_bytes(self, data: bytes) -> None:
        import os
        import tempfile
        from ..storage.durability.recovery import (_apply_snapshot,
                                                   _clear_storage)
        from ..storage.durability.snapshot import load_snapshot
        t0 = time.perf_counter()
        with self._gate.write():
            with tempfile.NamedTemporaryFile(delete=False,
                                             suffix=".mgsnap") as f:
                f.write(data)
                path = f.name
            try:
                parsed = load_snapshot(path)
                _clear_storage(self.storage)
                _apply_snapshot(self.storage, parsed)
                self.last_commit_ts = parsed["timestamp"]
                self.storage._bump_topology()
            finally:
                os.unlink(path)
        self.apply_stats["snapshot_apply_s"] = time.perf_counter() - t0

    def _apply_system(self, txn: dict) -> None:
        """Apply an ordered system transaction (auth / multi-db DDL) —
        the replica-side half of the reference's system::Transaction
        (memgraph/src/system/transaction.cpp). Deliveries are
        full-state (auth) or idempotent DDL, so replays are harmless."""
        carrier = txn.pop("trace", None)
        with mgtrace.adopt(carrier, retain=True):
            with mgtrace.span("repl.apply") as sp:
                if sp:
                    sp.set(kind=str(txn.get("kind")),
                           seq=txn.get("seq", 0))
                self._apply_system_inner(txn)

    def _apply_system_inner(self, txn: dict) -> None:
        seq = txn.get("seq", 0)
        kind = txn.get("kind")
        if kind == "full":
            # a full-state dump re-baselines the sequence: a restarted MAIN
            # starts its seq counter over
            self.last_system_seq = 0
        elif seq and seq <= self.last_system_seq:
            return
        data = txn.get("data") or {}
        ictx = self.ictx
        if kind in ("auth", "full") and ictx is not None:
            auth = getattr(ictx, "auth_store", None)
            if auth is None:
                from ..auth.auth import Auth
                auth = Auth()
                ictx.auth_store = auth
            dump = data.get("auth") if kind == "full" else data
            if dump is not None:
                auth.apply_dict(dump)
        if kind in ("db_create", "db_drop", "full") and ictx is not None:
            dbms = getattr(ictx, "dbms", None)
            if dbms is not None:
                if kind == "db_create":
                    names = [data["name"]]
                elif kind == "full":
                    names = data.get("databases", [])
                else:
                    names = []
                for name in names:
                    if name not in dbms.names():
                        dbms.create(name)
                if kind == "db_drop" and data["name"] in dbms.names():
                    dbms.drop(data["name"])
        if kind in ("db_suspend", "db_resume") and ictx is not None:
            dbms = getattr(ictx, "dbms", None)
            if dbms is not None:
                try:
                    if kind == "db_suspend":
                        dbms.suspend(data["name"])
                    else:
                        dbms.resume(data["name"])
                except Exception:  # noqa: BLE001 — idempotent replays
                    log.debug("system txn %s for %r already applied "
                              "(idempotent replay)", kind,
                              data.get("name"), exc_info=True)
        if seq:
            self.last_system_seq = seq

    def _apply_wal_frame(self, frame: bytes) -> None:
        t0 = time.perf_counter()
        with self._gate.write():
            changed: set = set()
            for commit_ts, ops in W.iter_txns_from_bytes(frame):
                if commit_ts <= self.last_commit_ts:
                    continue  # duplicate delivery (idempotent)
                changed |= _apply_wal_txn(self.storage, ops)
                self.last_commit_ts = commit_ts
                self.storage._timestamp = max(self.storage._timestamp,
                                              commit_ts)
            # version-keyed delta caches (vector index) refresh O(delta)
            # on replicas too — WAL apply records its changed gids
            self.storage._bump_topology(changed)
        self.apply_stats["frames_apply_s"] += time.perf_counter() - t0
        self.apply_stats["frames"] += 1
