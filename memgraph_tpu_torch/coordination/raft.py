"""Raft consensus (from scratch; control-plane sized).

Implements the core Raft protocol (Ongaro & Ousterhout): follower/candidate/
leader roles, randomized election timeouts, RequestVote and AppendEntries
RPCs over TCP (JSON payloads on the replication framing), log replication
with per-peer nextIndex/matchIndex, commit on majority, and application of
committed entries to a pluggable state machine.

Reference analog: the NuRaft integration in
memgraph/src/coordination/raft_state.cpp — same role in the system,
re-implemented because this environment ships no consensus library.

Copy of memgraph_tpu/coordination/raft.py for the port, on the port's
replication framing: either package's nodes form one cluster.  What
differs: a node's election timeouts come from a ``random.Random`` the
caller gives (``rng=``) or one seeded from ``election_seed``, else from
``MEMGRAPH_TPU_RAFT_SEED`` and the node id, else from the node id alone
(the reference seeds from the OS there), so every schedule replays; and
a node bound to port 0 reads back the port it got.
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..observability import trace as mgtrace
from ..replication import protocol as P
from ..utils.locks import tracked_lock, tracked_rlock

log = logging.getLogger(__name__)

MSG_RAFT = 0x20  # JSON raft message on the shared framing


@dataclass
class LogEntry:
    term: int
    command: dict

    def to_json(self):
        return {"term": self.term, "command": self.command}

    @staticmethod
    def from_json(obj):
        return LogEntry(obj["term"], obj["command"])


@dataclass(frozen=True)
class ProposeResult:
    """Typed outcome of ``RaftNode.propose`` — callers must distinguish
    retryable rejections from fatal ones (a bare bool collapsed "not the
    leader, go elsewhere" and "timed out, maybe committed" into the same
    silent False).

    outcome:
      committed        entry committed on a majority and applied
      not_leader       this node cannot propose; retry against the leader
      timeout          commit not observed in time — the entry MAY still
                       commit later (ambiguous; retries must be
                       idempotent)
      lost_leadership  leadership changed under the proposal; the entry
                       was superseded or its fate belongs to the new
                       leader
    """

    outcome: str
    index: int | None = None
    term: int | None = None

    def __bool__(self) -> bool:
        return self.outcome == "committed"

    @property
    def retryable(self) -> bool:
        """Safe to re-propose (for idempotent commands): the entry was
        rejected or its commit is unresolved, not superseded."""
        return self.outcome in ("not_leader", "timeout")

    COMMITTED = "committed"
    NOT_LEADER = "not_leader"
    TIMEOUT = "timeout"
    LOST_LEADERSHIP = "lost_leadership"


class RaftNode:
    """One Raft participant listening on (host, port).

    peers: {node_id: (host, port)} for the OTHER nodes.
    apply_fn(command: dict) is invoked exactly once per committed entry,
    in log order, on every node.
    """

    ELECTION_TIMEOUT = (0.6, 1.2)   # seconds, randomized
    HEARTBEAT_INTERVAL = 0.15
    COMPACTION_THRESHOLD = 256      # applied entries kept before snapshot
    # leader lease: a leader that cannot reach a majority within this
    # window steps down instead of acting on stale authority (a
    # minority-partitioned leader would otherwise keep serving reads and
    # accepting doomed proposals until something ELSE noticed). Shorter
    # than the minimum election timeout so the old leader abdicates
    # before a partition-side majority can crown a successor.
    LEADER_LEASE = 0.6

    def __init__(self, node_id: str, host: str, port: int,
                 peers: dict[str, tuple[str, int]], apply_fn=None,
                 kvstore=None, snapshot_fn=None, restore_fn=None,
                 compaction_threshold: int | None = None,
                 election_seed: int | None = None,
                 rng: random.Random | None = None):
        self.node_id = node_id
        self.host = host
        self.port = port
        self.peers = dict(peers)
        self.apply_fn = apply_fn or (lambda cmd: None)
        # seedable election jitter: fault-injection cluster tests need the
        # timeout schedule to replay exactly (MEMGRAPH_TPU_RAFT_SEED as
        # env fallback; the node_id keeps same-seed nodes from tying)
        if election_seed is None:
            env_seed = os.environ.get("MEMGRAPH_TPU_RAFT_SEED")
            # crc32, not hash(): per-node derivation must replay
            # across processes (PYTHONHASHSEED salts str hashing)
            election_seed = int(env_seed or 0) ^ zlib.crc32(
                node_id.encode("utf-8"))
        self._rng = rng if rng is not None else random.Random(election_seed)
        # log compaction (Raft §7; reference: coordinator_log_store.cpp +
        # raft_state.cpp:370 install-snapshot): snapshot_fn() returns a
        # JSON-able state-machine snapshot, restore_fn(state) replaces the
        # state machine wholesale. Without them the log grows unboundedly.
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.compaction_threshold = (compaction_threshold
                                     or self.COMPACTION_THRESHOLD)

        # persistent state (Raft §5.1: currentTerm, votedFor, log[] must
        # survive restarts — reference: coordinator_log_store.cpp); durable
        # through the kvstore when one is provided
        self._kv = kvstore
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []
        # entries [0, log_start) live in the snapshot; log[0] has absolute
        # index log_start
        self.log_start = 0
        self.snapshot_last_term = 0
        self.snapshot_state = None
        if kvstore is not None:
            self._restore_persistent_state()

        # volatile (a restored snapshot means everything up to log_start-1
        # is already committed and applied into the state machine)
        self.commit_index = self.log_start - 1
        self.last_applied = self.log_start - 1
        self.role = "follower"
        self.leader_id: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}

        self._lock = tracked_rlock("RaftNode._lock")
        self._stop = threading.Event()
        self._last_heartbeat = time.monotonic()
        self._election_deadline = self._new_deadline()
        # pre-vote (Raft §9.6 / the thesis' "PreVote" extension): a node
        # that heard from a live leader within the minimum election
        # timeout refuses pre-votes, so a flapping partitioned node
        # cannot inflate terms and depose a healthy leader on heal.
        # 0.0 = "never heard from a leader" so bootstrap elections work.
        self._last_leader_contact = 0.0
        # leader lease bookkeeping: last time each peer answered any RPC
        self._peer_ack_at: dict[str, float] = {}
        self._lease_started = 0.0
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._commit_events: dict[int, threading.Event] = {}
        # persistent per-peer RPC connections: with cluster TLS on, a
        # handshake per heartbeat would eat the 0.5s RPC deadline and
        # destabilize leadership; the server loop handles many frames per
        # connection, so reuse one socket per peer (fresh on error)
        self._peer_conns: dict[str, socket.socket] = {}
        self._peer_conns_lock = tracked_lock("RaftNode._peer_conns_lock")

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        for target in (self._accept_loop, self._timer_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._peer_conns_lock:
            conns, self._peer_conns = dict(self._peer_conns), {}
        for sock in conns.values():
            try:
                sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)

    def _new_deadline(self) -> float:
        return time.monotonic() + self._rng.uniform(*self.ELECTION_TIMEOUT)

    # --- durability (Raft persistent state) ---------------------------------

    def _restore_persistent_state(self) -> None:
        term = self._kv.get_str("raft:term")
        if term is not None:
            self.current_term = int(term)
        self.voted_for = self._kv.get_str("raft:voted_for") or None
        snap_raw = self._kv.get_str("raft:snapshot")
        if snap_raw:
            snap = json.loads(snap_raw)
            self.log_start = snap["index"] + 1
            self.snapshot_last_term = snap["term"]
            self.snapshot_state = snap["state"]
            if self.restore_fn is not None and snap["state"] is not None:
                self.restore_fn(snap["state"])
        for key, raw in self._kv.items_with_prefix("raft:log:"):
            idx = int(key.rsplit(":", 1)[1])
            if idx < self.log_start:  # already folded into the snapshot
                self._kv.delete(key)
                continue
            self.log.append(LogEntry.from_json(
                json.loads(raw.decode("utf-8"))))

    def _persist_term_vote(self) -> None:
        # caller holds lock
        if self._kv is not None:
            self._kv.put("raft:term", str(self.current_term))
            self._kv.put("raft:voted_for", self.voted_for or "")

    def _persist_log_from(self, start_abs: int) -> None:
        # caller holds lock; rewrite entries with ABSOLUTE index >= start
        # (truncation-safe keys are zero-padded so prefix iteration
        # returns them in order)
        if self._kv is None:
            return
        for idx in range(max(start_abs, self.log_start), self._abs_len()):
            self._kv.put(f"raft:log:{idx:012d}",
                         json.dumps(self.log[idx - self.log_start]
                                    .to_json()))
        # drop stale tail entries beyond the new log length
        for key, _ in list(self._kv.items_with_prefix("raft:log:")):
            if int(key.rsplit(":", 1)[1]) >= self._abs_len():
                self._kv.delete(key)

    def _persist_snapshot(self) -> None:
        # caller holds lock
        if self._kv is None:
            return
        self._kv.put("raft:snapshot", json.dumps({
            "index": self.log_start - 1,
            "term": self.snapshot_last_term,
            "state": self.snapshot_state}))
        for key, _ in list(self._kv.items_with_prefix("raft:log:")):
            if int(key.rsplit(":", 1)[1]) < self.log_start:
                self._kv.delete(key)

    # --- log index translation (absolute <-> in-memory) ---------------------

    def _abs_len(self) -> int:
        return self.log_start + len(self.log)

    def _entry(self, idx_abs: int) -> LogEntry:
        return self.log[idx_abs - self.log_start]

    def _term_at(self, idx_abs: int) -> int:
        if idx_abs == self.log_start - 1:
            return self.snapshot_last_term
        if idx_abs < self.log_start - 1:
            return -1  # compacted away; only reachable on stale RPCs
        return self.log[idx_abs - self.log_start].term

    def _maybe_compact(self) -> None:
        """Caller holds lock: fold applied entries into a state-machine
        snapshot once enough accumulate (Raft §7)."""
        if self.snapshot_fn is None:
            return
        applied_in_log = self.last_applied - self.log_start + 1
        if applied_in_log < self.compaction_threshold:
            return
        try:
            state = self.snapshot_fn()
        except Exception:
            log.exception("raft snapshot_fn failed; skipping compaction")
            return
        self.snapshot_last_term = self._term_at(self.last_applied)
        del self.log[:applied_in_log]
        self.log_start = self.last_applied + 1
        self.snapshot_state = state
        self._persist_snapshot()
        log.info("raft %s compacted log through %d", self.node_id,
                 self.log_start - 1)

    # --- public API ---------------------------------------------------------

    def is_leader(self) -> bool:
        with self._lock:
            return self.role == "leader"

    def propose(self, command: dict, timeout: float = 5.0) -> ProposeResult:
        """Leader-only: append a command; block until committed (majority).

        Returns a :class:`ProposeResult` (truthy iff committed) so
        callers can tell "retry elsewhere" from "may have committed"
        from "superseded by a new leader"."""
        with self._lock:
            if self.role != "leader":
                return ProposeResult(ProposeResult.NOT_LEADER,
                                     term=self.current_term)
            term = self.current_term
            entry = LogEntry(term, command)
            self.log.append(entry)
            index = self._abs_len() - 1
            self._persist_log_from(index)
            event = threading.Event()
            self._commit_events[index] = event
            # a single-node cluster (or one whose peers are all caught up)
            # can commit immediately — majority may already be satisfied
            self._advance_commit()
        self._broadcast_append()
        ok = event.wait(timeout)
        with self._lock:
            self._commit_events.pop(index, None)
            # commit events are keyed by INDEX: a successor leader's
            # entry at the same index also fires ours, so verify the
            # committed entry carries OUR term. A committed entry that
            # was already compacted away is still ours iff leadership
            # never changed (an overwrite needs a higher-term leader).
            if index >= self.log_start - 1:
                ours = self._term_at(index) == term
            else:
                ours = self.current_term == term and self.role == "leader"
            committed = ok and self.commit_index >= index and ours
            if committed:
                return ProposeResult(ProposeResult.COMMITTED,
                                     index=index, term=term)
            if self.current_term != term or self.role != "leader":
                # a new leader took over mid-proposal; our entry was (or
                # will be) overwritten — re-proposing here could double-
                # apply, the caller must re-evaluate against new state
                return ProposeResult(ProposeResult.LOST_LEADERSHIP,
                                     index=index, term=term)
            return ProposeResult(ProposeResult.TIMEOUT,
                                 index=index, term=term)

    # --- networking ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            # TLS handshake here, NOT in the accept loop: a silent peer
            # must only pin this thread (bounded by the handshake timeout)
            from ..utils.tls import wrap_cluster_server
            conn = wrap_cluster_server(conn)
            while not self._stop.is_set():
                msg_type, payload = P.recv_frame(conn)
                if msg_type != MSG_RAFT:
                    break
                request = json.loads(payload.decode("utf-8"))
                response = self._handle(request)
                P.send_frame(conn, MSG_RAFT,
                             json.dumps(response).encode("utf-8"))
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            conn.close()

    def _call_peer(self, peer_id: str, request: dict,
                   timeout: float = 0.5) -> dict | None:
        from ..utils import faultinject as FI
        carrier = mgtrace.inject()
        if carrier is not None:
            # the raft wire is JSON: RPCs issued while a trace is active
            # (e.g. a coordinator action inside a traced query) carry it
            request = {**request, "trace": carrier}
        with mgtrace.span("raft.rpc") as sp:
            if sp:
                sp.set(peer=peer_id, kind=str(request.get("kind")))
            return self._call_peer_guarded(peer_id, request, timeout, FI)

    def _call_peer_guarded(self, peer_id: str, request: dict,
                           timeout: float, FI) -> dict | None:
        try:
            if FI.fire("raft.rpc") == "drop":
                return None  # RPC lost on the wire
        except FI.FaultInjected:
            return None      # injected network fault == unreachable peer
        # nemesis link model, request direction: a dropped request never
        # reaches the peer; "duplicate" delivers the (idempotent) RPC
        # twice, exercising dedup/at-least-once handling
        net = FI.net_fire(self.node_id, peer_id)
        if net == "drop":
            return None
        response = self._call_peer_once(peer_id, request, timeout)
        if net == "duplicate" and response is not None:
            dup = self._call_peer_once(peer_id, request, timeout)
            response = dup if dup is not None else response
        if response is not None:
            # ack direction: an asymmetric peer→us partition means the
            # peer DID execute the RPC but we never learn the outcome
            if FI.net_fire(peer_id, self.node_id) == "drop":
                return None
        return response

    def _call_peer_once(self, peer_id: str, request: dict,
                        timeout: float = 0.5) -> dict | None:
        host, port = self.peers[peer_id]
        data = json.dumps(request).encode("utf-8")
        # first attempt reuses the pooled connection (may be stale if the
        # peer restarted); second attempt always dials fresh. Both share
        # ONE deadline so a black-holed peer costs at most `timeout`, not
        # 2x — election rounds poll peers sequentially and a doubled stall
        # per dead peer would eat the election deadline.
        deadline = time.monotonic() + timeout
        for attempt in (0, 1):
            budget = deadline - time.monotonic()
            if budget <= 0.0:
                return None
            with self._peer_conns_lock:
                sock = self._peer_conns.pop(peer_id, None)
            try:
                if sock is None:
                    if attempt == 0:
                        continue
                    from ..utils.tls import wrap_cluster_client
                    raw = socket.create_connection((host, port),
                                                   timeout=budget)
                    sock = wrap_cluster_client(raw, server_hostname=host)
                sock.settimeout(budget)
                P.send_frame(sock, MSG_RAFT, data)
                msg_type, payload = P.recv_frame(sock)
                if msg_type != MSG_RAFT:
                    raise ConnectionError("unexpected frame type")
                response = json.loads(payload.decode("utf-8"))
                with self._peer_conns_lock:
                    displaced = self._peer_conns.get(peer_id)
                    self._peer_conns[peer_id] = sock
                if displaced is not None:  # concurrent caller raced us
                    try:
                        displaced.close()
                    except OSError:
                        pass
                return response
            except (ConnectionError, OSError, json.JSONDecodeError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
        return None

    # --- RPC handlers -------------------------------------------------------

    def _handle(self, req: dict) -> dict:
        carrier = req.pop("trace", None)
        if carrier is not None:
            with mgtrace.adopt(carrier, retain=True):
                with mgtrace.span("raft.handle",
                                  kind=str(req.get("kind")),
                                  node=self.node_id):
                    return self._handle_inner(req)
        return self._handle_inner(req)

    def _handle_inner(self, req: dict) -> dict:
        kind = req.get("kind")
        if kind == "request_vote":
            return self._on_request_vote(req)
        if kind == "pre_vote":
            return self._on_pre_vote(req)
        if kind == "append_entries":
            return self._on_append_entries(req)
        if kind == "install_snapshot":
            return self._on_install_snapshot(req)
        return {"ok": False}

    def _maybe_step_down(self, term: int) -> None:
        # caller holds lock
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self.role = "follower"
            self._persist_term_vote()

    def _on_pre_vote(self, req: dict) -> dict:
        """Pre-vote (Raft §9.6): answer "would I vote for you?" WITHOUT
        touching persistent state. Refused while a live leader is heard
        from, so a node returning from a partition cannot force a real
        election (term inflation) against a healthy cluster."""
        with self._lock:
            my_last_index = self._abs_len() - 1
            my_last_term = self._term_at(my_last_index) \
                if my_last_index >= 0 else 0
            up_to_date = (req["last_log_term"] > my_last_term
                          or (req["last_log_term"] == my_last_term
                              and req["last_log_index"] >= my_last_index))
            leader_is_live = (
                self.role == "leader"
                or (self._last_leader_contact > 0.0
                    and time.monotonic() - self._last_leader_contact
                    < self.ELECTION_TIMEOUT[0]))
            grant = (req["term"] >= self.current_term and up_to_date
                     and not leader_is_live)
            return {"kind": "pre_vote_ack", "term": self.current_term,
                    "granted": grant}

    def _on_request_vote(self, req: dict) -> dict:
        with self._lock:
            self._maybe_step_down(req["term"])
            grant = False
            if req["term"] >= self.current_term and \
                    self.voted_for in (None, req["candidate"]):
                my_last_index = self._abs_len() - 1
                my_last_term = self._term_at(my_last_index) \
                    if my_last_index >= 0 else 0
                up_to_date = (req["last_log_term"] > my_last_term
                              or (req["last_log_term"] == my_last_term
                                  and req["last_log_index"] >= my_last_index))
                if up_to_date:
                    grant = True
                    self.voted_for = req["candidate"]
                    self._persist_term_vote()
                    self._election_deadline = self._new_deadline()
            return {"kind": "vote", "term": self.current_term,
                    "granted": grant}

    def _on_append_entries(self, req: dict) -> dict:
        with self._lock:
            self._maybe_step_down(req["term"])
            if req["term"] < self.current_term:
                return {"kind": "append_ack", "term": self.current_term,
                        "success": False}
            self.role = "follower"
            self.leader_id = req["leader"]
            self._election_deadline = self._new_deadline()
            self._last_leader_contact = time.monotonic()

            prev_index = req["prev_log_index"]
            prev_term = req["prev_log_term"]
            if prev_index < self.log_start - 1:
                # the leader's window precedes our snapshot: everything
                # there is committed state already — ack up to the snapshot
                return {"kind": "append_ack", "term": self.current_term,
                        "success": True,
                        "match_index": self.log_start - 1}
            if prev_index >= 0:
                if prev_index >= self._abs_len() or \
                        self._term_at(prev_index) != prev_term:
                    return {"kind": "append_ack",
                            "term": self.current_term, "success": False}
            # append/overwrite entries
            insert_at = prev_index + 1
            changed_from = None
            for i, obj in enumerate(req.get("entries", [])):
                entry = LogEntry.from_json(obj)
                idx = insert_at + i
                if idx < self.log_start:
                    continue  # already folded into our snapshot
                if idx < self._abs_len():
                    if self._term_at(idx) != entry.term:
                        del self.log[idx - self.log_start:]
                        self.log.append(entry)
                        changed_from = idx if changed_from is None \
                            else min(changed_from, idx)
                else:
                    self.log.append(entry)
                    changed_from = idx if changed_from is None \
                        else min(changed_from, idx)
            if changed_from is not None:
                self._persist_log_from(changed_from)
            # advance commit
            leader_commit = req["leader_commit"]
            if leader_commit > self.commit_index:
                self.commit_index = min(leader_commit, self._abs_len() - 1)
            self._apply_committed()
            return {"kind": "append_ack", "term": self.current_term,
                    "success": True,
                    "match_index": prev_index + len(req.get("entries", []))}

    def _on_install_snapshot(self, req: dict) -> dict:
        """Replace log+state with the leader's snapshot (Raft §7.1;
        reference analog: raft_state.cpp:370)."""
        with self._lock:
            self._maybe_step_down(req["term"])
            if req["term"] < self.current_term:
                return {"kind": "snapshot_ack", "term": self.current_term,
                        "success": False}
            self.role = "follower"
            self.leader_id = req["leader"]
            self._election_deadline = self._new_deadline()
            self._last_leader_contact = time.monotonic()
            idx = req["last_included_index"]
            trm = req["last_included_term"]
            if idx <= self.log_start - 1:
                # stale/duplicate snapshot: we already cover it
                return {"kind": "snapshot_ack", "term": self.current_term,
                        "success": True,
                        "match_index": self.log_start - 1}
            if idx < self._abs_len() and self._term_at(idx) == trm:
                # retain the suffix that extends past the snapshot
                del self.log[:idx + 1 - self.log_start]
            else:
                self.log = []
            self.log_start = idx + 1
            self.snapshot_last_term = trm
            self.snapshot_state = req.get("state")
            if self.restore_fn is not None and \
                    self.snapshot_state is not None:
                try:
                    self.restore_fn(self.snapshot_state)
                except Exception:
                    log.exception("raft restore_fn failed")
            self.commit_index = max(self.commit_index, idx)
            self.last_applied = idx
            self._persist_snapshot()
            self._persist_log_from(self.log_start)
            self._apply_committed()
            return {"kind": "snapshot_ack", "term": self.current_term,
                    "success": True, "match_index": idx}

    def _apply_committed(self) -> None:
        # caller holds lock
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entry(self.last_applied)
            if not entry.command.get("_noop"):
                try:
                    self.apply_fn(entry.command)
                except Exception:
                    log.exception("state machine apply failed at %d",
                                  self.last_applied)
            event = self._commit_events.get(self.last_applied)
            if event is not None:
                event.set()
        self._maybe_compact()

    # --- timers / elections -------------------------------------------------

    def _timer_loop(self) -> None:
        while not self._stop.wait(0.05):
            with self._lock:
                role = self.role
                deadline = self._election_deadline
            now = time.monotonic()
            if role == "leader":
                if self._lease_expired(now):
                    with self._lock:
                        if self.role == "leader":
                            log.warning(
                                "raft %s: leader lease expired (no "
                                "majority contact for %.1fs) — stepping "
                                "down", self.node_id, self.LEADER_LEASE)
                            self.role = "follower"
                            self.leader_id = None
                            self._election_deadline = self._new_deadline()
                    continue
                self._broadcast_append()
                time.sleep(self.HEARTBEAT_INTERVAL)
            elif now >= deadline:
                self._run_election()

    def _lease_expired(self, now: float) -> bool:
        """True when this leader has not heard from a majority (self
        included) within LEADER_LEASE — i.e. it may be on the minority
        side of a partition and must stop acting on its authority."""
        if not self.peers:
            return False     # single-node cluster: self IS the majority
        with self._lock:
            acks = sorted((self._peer_ack_at.get(p, self._lease_started)
                           for p in self.peers), reverse=True)
        majority = (len(self.peers) + 1) // 2 + 1
        # self always counts; the (majority-1)-th freshest peer ack must
        # still be inside the lease window
        freshest_needed = acks[majority - 2]
        return now - freshest_needed > self.LEADER_LEASE

    def _run_election(self) -> None:
        if not self._pre_vote():
            return
        with self._lock:
            self.role = "candidate"
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.node_id
            self._persist_term_vote()
            self._election_deadline = self._new_deadline()
            last_index = self._abs_len() - 1
            last_term = self._term_at(last_index) if last_index >= 0 else 0
        votes = 1
        for peer_id in list(self.peers):
            resp = self._call_peer(peer_id, {
                "kind": "request_vote", "term": term,
                "candidate": self.node_id,
                "last_log_index": last_index, "last_log_term": last_term})
            if resp is None:
                continue
            with self._lock:
                if resp["term"] > self.current_term:
                    self._maybe_step_down(resp["term"])
                    return
            if resp.get("granted"):
                votes += 1
        majority = (len(self.peers) + 1) // 2 + 1
        with self._lock:
            if self.role != "candidate" or self.current_term != term:
                return
            if votes >= majority:
                self.role = "leader"
                self.leader_id = self.node_id
                self.next_index = {p: self._abs_len() for p in self.peers}
                self.match_index = {p: -1 for p in self.peers}
                # fresh lease: the election itself just proved majority
                # contact, so the clock starts now
                self._lease_started = time.monotonic()
                self._peer_ack_at = {}
                # Raft §5.4.2: entries from PREVIOUS terms can only be
                # committed alongside a current-term entry — append a
                # no-op immediately so a committed-but-unapplied tail
                # (e.g. the old leader died right after majority ack)
                # becomes visible without waiting for a client write
                self.log.append(LogEntry(term, {"_noop": True}))
                self._persist_log_from(self._abs_len() - 1)
                self._advance_commit()
                log.info("raft %s became leader (term %d)", self.node_id,
                         term)
        if self.is_leader():
            self._broadcast_append()

    def _pre_vote(self) -> bool:
        """Canvass the cluster WITHOUT incrementing the term; only a
        majority of pre-votes (self included) starts a real election."""
        with self._lock:
            if self.role == "leader":
                return False
            term = self.current_term + 1
            last_index = self._abs_len() - 1
            last_term = self._term_at(last_index) if last_index >= 0 else 0
            # re-arm the deadline so a failed canvass retries later
            # instead of spinning the timer loop
            self._election_deadline = self._new_deadline()
        granted = 1
        for peer_id in list(self.peers):
            resp = self._call_peer(peer_id, {
                "kind": "pre_vote", "term": term,
                "candidate": self.node_id,
                "last_log_index": last_index, "last_log_term": last_term})
            if resp is None:
                continue
            with self._lock:
                if resp["term"] > self.current_term:
                    self._maybe_step_down(resp["term"])
                    return False
            if resp.get("granted"):
                granted += 1
        majority = (len(self.peers) + 1) // 2 + 1
        return granted >= majority

    # --- leader replication -------------------------------------------------

    def _broadcast_append(self) -> None:
        for peer_id in list(self.peers):
            threading.Thread(target=self._replicate_to, args=(peer_id,),
                             daemon=True).start()

    def _replicate_to(self, peer_id: str) -> None:
        with self._lock:
            if self.role != "leader":
                return
            term = self.current_term
            next_idx = self.next_index.get(peer_id, self._abs_len())
            if next_idx < self.log_start:
                # peer is behind our compacted window: ship the snapshot
                request = {
                    "kind": "install_snapshot", "term": term,
                    "leader": self.node_id,
                    "last_included_index": self.log_start - 1,
                    "last_included_term": self.snapshot_last_term,
                    "state": self.snapshot_state}
            else:
                prev_index = next_idx - 1
                prev_term = self._term_at(prev_index) \
                    if prev_index >= 0 else 0
                entries = [e.to_json()
                           for e in self.log[next_idx - self.log_start:]]
                request = {
                    "kind": "append_entries", "term": term,
                    "leader": self.node_id,
                    "prev_log_index": prev_index,
                    "prev_log_term": prev_term,
                    "entries": entries,
                    "leader_commit": self.commit_index}
        resp = self._call_peer(peer_id, request)
        if resp is None:
            return
        with self._lock:
            # any response proves the link is alive — feed the lease
            self._peer_ack_at[peer_id] = time.monotonic()
            if resp["term"] > self.current_term:
                self._maybe_step_down(resp["term"])
                return
            if self.role != "leader" or self.current_term != term:
                return
            if resp.get("success"):
                match = resp.get("match_index", next_idx - 1)
                self.match_index[peer_id] = max(
                    self.match_index.get(peer_id, -1), match)
                self.next_index[peer_id] = self.match_index[peer_id] + 1
                self._advance_commit()
            else:
                self.next_index[peer_id] = max(0, next_idx - 1)

    def _advance_commit(self) -> None:
        # caller holds lock; commit entries from the CURRENT term replicated
        # on a majority (Raft §5.4.2 safety rule)
        for idx in range(self._abs_len() - 1, self.commit_index, -1):
            if self._term_at(idx) != self.current_term:
                continue
            replicated = 1 + sum(
                1 for p in self.peers if self.match_index.get(p, -1) >= idx)
            if replicated >= (len(self.peers) + 1) // 2 + 1:
                self.commit_index = idx
                self._apply_committed()
                break
