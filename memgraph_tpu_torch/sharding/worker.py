"""Shard worker: one long-lived process owning one shard's storage.

Each worker owns a FULL storage engine for its hash range — its own WAL
directory (``<base>/shard_<id>`` — per-shard durability and recovery),
its own MVCC, its own indexes — and serves framed requests over the
mp_executor pipe envelope (same trace-carrier and error-transport
machinery, but the worker is a durable owner, not a disposable
snapshot).

Fencing contract (the shard-level half of the epoch chain): the
worker holds a granted ``(shard, epoch)``; writes and 2PC prepares are
refused unless the request's routing epoch equals the grant and the
worker is not fenced, and every write ack carries the grant epoch — so
a client must prove it routed with the current map, and a deposed
owner can never produce an ack a current-map client would accept.

2PC (cross-shard writes): ``prepare`` executes the statement inside a
held-open explicit transaction AND journals it to a small durable
pending log before voting yes; ``decide`` commits or rolls back. A
worker that dies between prepare and decide recovers the pending log:
a later ``commit`` decision re-executes the journaled statement (the
presumed-commit direction replicas already use for voted frames), and
an ``abort`` — or silence — discards it (presumed abort).

Shard-move support: ``begin_move`` snapshots the shard and arms a
committed-frame buffer (the SAME WAL frame encoding replication ships),
``drain_frames`` pages the buffer out for delta catch-up, ``end_move``
fences this owner and returns the final tail.

Copy of memgraph_tpu/sharding/worker.py for the port.  What differs is
the device rule (the reference's worker runs whatever Cypher it is
given, a ``CALL pagerank.get()`` over its own hash range included:
ROADMAP Queue 3 item 19):

- A worker is forked from a process that may have initialised CUDA, so
  it never calls ``torch.cuda``: it freezes what it inherited
  (``gc.freeze``) as it starts, so its collector never finalises a
  tensor of the parent's, and its interpreter context is built with
  ``device="cpu"`` only so that building it asks no card anything.
- Every statement is checked against the plan first, with the read
  pool's rule (``server/mp_executor.device_reason``): a compiled read
  lane or a procedure call raises ``DeviceWorkRefused``, which the
  envelope ships home typed.  Nothing runs on the CPU in its place: the
  context's device is never reached.
"""

from __future__ import annotations

import gc
import json
import os
import pickle
import struct
import time

from ..observability import trace as mgtrace
from ..exceptions import DeviceWorkRefused
from ..server.mp_executor import _recv, _send, device_reason

__all__ = ["shard_worker_main", "PENDING_2PC_FILE"]

PENDING_2PC_FILE = "pending_2pc.json"


def _shard_dir(base_dir: str, shard_id: int, generation: int) -> str:
    """One durability dir per (shard, ownership generation): a respawn
    of the same owner reuses it (recovery), a move target gets a fresh
    one (its cutover snapshot re-baselines durability)."""
    if generation == 0:
        return os.path.join(base_dir, f"shard_{shard_id}")
    return os.path.join(base_dir, f"shard_{shard_id}.g{generation}")


class _WorkerState:
    """Everything the child process owns; built AFTER the fork so the
    storage engine, WAL file handles and interpreter never cross the
    process boundary."""

    def __init__(self, shard_id: int, name: str, data_dir: str,
                 epoch: int) -> None:
        from ..query.interpreter import Interpreter, InterpreterContext
        from ..storage.durability.recovery import recover, wire_durability
        from ..storage.storage import InMemoryStorage, StorageConfig

        self.shard_id = shard_id
        self.name = name
        self.data_dir = data_dir
        self.epoch = epoch
        self.owner_fenced = False
        os.makedirs(data_dir, exist_ok=True)
        self.storage = InMemoryStorage(StorageConfig(
            durability_dir=data_dir, wal_enabled=True))
        recover(self.storage)
        wire_durability(self.storage)
        # device="cpu" so that building the context calls no torch.cuda;
        # _execute refuses every plan that would reach a device
        self.ictx = InterpreterContext(self.storage, device="cpu")
        self.interp = Interpreter(self.ictx)
        self._make_interp = lambda: Interpreter(self.ictx)
        # txn_id -> Interpreter holding an open explicit transaction
        self.held_2pc: dict[str, object] = {}
        # txn_id -> {"query", "params"} journaled before the yes vote;
        # survives a crash so a commit decision can be honored
        self.pending_2pc: dict[str, dict] = self._load_pending()
        # shard-move: buffered (commit_ts, frame) since begin_move
        self.move_frames: list | None = None
        # data applied outside the commit pipeline (snapshot/frames from
        # a move) has no WAL trail yet; snapshot at grant to re-baseline
        self.needs_snapshot = False
        self.ops = 0
        self._buffer_hook = self._buffer_frame

    # -- pending-2PC journal -------------------------------------------------

    def _pending_path(self) -> str:
        return os.path.join(self.data_dir, PENDING_2PC_FILE)

    def _load_pending(self) -> dict:
        try:
            with open(self._pending_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _save_pending(self) -> None:
        tmp = self._pending_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.pending_2pc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._pending_path())

    # -- move-frame buffering ------------------------------------------------

    def _buffer_frame(self, frame: bytes, commit_ts: int) -> None:
        if self.move_frames is not None:
            self.move_frames.append((commit_ts, frame))

    def apply_frame(self, frame: bytes) -> None:
        """Apply a shipped WAL frame (delta catch-up on the move target)
        — the same shared applier recovery and replicas use."""
        from ..storage.durability import wal as W
        from ..storage.durability.recovery import _apply_wal_txn
        changed: set = set()
        for commit_ts, ops in W.iter_txns_from_bytes(frame):
            changed |= _apply_wal_txn(self.storage, ops)
            with self.storage._engine_lock:
                self.storage._timestamp = max(self.storage._timestamp,
                                              commit_ts)
        self.storage._bump_topology(changed)
        self.needs_snapshot = True


def _snapshot_bytes(storage) -> bytes:
    """Serialize the whole shard for a move's initial state transfer
    (the replication snapshot format — the target applies it with the
    same loader replicas use)."""
    from ..storage.durability.snapshot import create_snapshot
    path = create_snapshot(storage)
    with open(path, "rb") as f:
        return f.read()


def _refuse_device_work(ictx, query: str, node) -> None:
    """Raise ``DeviceWorkRefused`` when the Cypher ``node``'s plan reaches
    the device (the read pool's rule)."""
    from ..query.frontend import ast as A
    if not isinstance(node, A.CypherQuery):
        return
    reason = device_reason(ictx, query, node)
    if reason is not None:
        raise DeviceWorkRefused(
            f"a shard worker does not run device work: {reason}; a "
            "shard holds one hash range of the graph")


def _execute(state: _WorkerState, query: str, params: dict,
             read_only: bool):
    """Run one statement on the worker's interpreter; returns
    (columns, rows, summary)."""
    from ..query.frontend import ast as A
    node = state.ictx.cached_parse(query)
    # Cypher plus per-shard schema DDL (indexes/constraints broadcast
    # by the router); everything else — auth, admin, replication —
    # belongs to the routing tier, not a hash range
    if not isinstance(node, (A.CypherQuery, A.IndexQuery,
                             A.ConstraintQuery)):
        raise RuntimeError("only Cypher and index/constraint DDL may "
                           "run on a shard worker (admin runs on the "
                           "routing tier)")
    if read_only and not isinstance(node, A.CypherQuery):
        raise RuntimeError("DDL routed on the read path")
    _refuse_device_work(state.ictx, query, node)
    prepared = state.interp.prepare(query, params)
    if read_only and prepared.is_write:
        state.interp.abort()
        raise RuntimeError("write statement routed on the read path")
    rows, _more, summary = state.interp.pull(-1)
    return prepared.columns, rows, summary


def _handle(state: _WorkerState, op: str, payload: dict):
    """Dispatch one request; returns (status, payload). Raising maps to
    the generic ("err", ...) envelope in the loop."""
    if op == "grant":
        epoch = int(payload["epoch"])
        if epoch < state.epoch:
            return "stale_epoch", {"epoch": state.epoch}
        state.epoch = epoch
        state.owner_fenced = False
        if state.needs_snapshot:
            # moved-in data has no WAL trail in THIS dir yet: snapshot
            # once at cutover so a crash after the grant recovers it
            from ..storage.durability.snapshot import create_snapshot
            create_snapshot(state.storage)
            state.needs_snapshot = False
        return "ok", {"epoch": state.epoch, "shard": state.shard_id}

    if op == "revoke":
        epoch = int(payload["epoch"])
        if epoch >= state.epoch:
            state.owner_fenced = True
        return "ok", {"epoch": state.epoch,
                      "last_ts": state.storage.latest_commit_ts()}

    if op in ("read", "write"):
        if state.owner_fenced:
            return "fenced", {"epoch": state.epoch}
        if op == "write":
            req_epoch = int(payload.get("epoch") or 0)
            if req_epoch != state.epoch:
                # stale map (or a grant still in flight): the client
                # must refresh and re-route — never ack across epochs
                return "stale_epoch", {"epoch": state.epoch}
        cols, rows, summary = _execute(state, payload["query"],
                                       payload.get("params") or {},
                                       read_only=(op == "read"))
        state.ops += 1
        return "ok", {"columns": cols, "rows": rows, "summary": summary,
                      "shard": state.shard_id, "epoch": state.epoch,
                      "owner": state.name}

    if op == "prepare":
        if state.owner_fenced:
            return "fenced", {"epoch": state.epoch}
        if int(payload.get("epoch") or 0) != state.epoch:
            return "stale_epoch", {"epoch": state.epoch}
        txn_id = str(payload["txn_id"])
        statements = payload["statements"]
        for stmt in statements:
            _refuse_device_work(state.ictx, stmt["query"],
                                state.ictx.cached_parse(stmt["query"]))
        interp = state._make_interp()
        interp.execute("BEGIN")
        try:
            for stmt in statements:
                interp.execute(stmt["query"], stmt.get("params") or {})
        except Exception:
            interp.execute("ROLLBACK")
            raise
        # journal BEFORE voting: the yes vote is a durable promise
        state.pending_2pc[txn_id] = {"statements": statements}
        state._save_pending()
        state.held_2pc[txn_id] = interp
        return "ok", {"vote": "yes", "shard": state.shard_id,
                      "epoch": state.epoch}

    if op == "decide":
        txn_id = str(payload["txn_id"])
        decision = payload["decision"]
        interp = state.held_2pc.pop(txn_id, None)
        if interp is not None:
            interp.execute("COMMIT" if decision == "commit"
                           else "ROLLBACK")
            # journal removal strictly AFTER the decision applied: a
            # crash in between leaves the entry behind, and a re-driven
            # commit replays it — never the reverse (entry gone while
            # the commit was lost, a half-committed cross-shard txn)
            if state.pending_2pc.pop(txn_id, None) is not None:
                state._save_pending()
            state.ops += 1
            return "ok", {"shard": state.shard_id, "epoch": state.epoch}
        if decision == "abort":
            # presumed abort: nothing committed here, but a crash
            # between prepare and decide may have left a journal entry
            # — prune it so it can never replay (and never accumulates)
            if state.pending_2pc.pop(txn_id, None) is not None:
                state._save_pending()
            return "ok", {"shard": state.shard_id, "epoch": state.epoch}
        journaled = state.pending_2pc.get(txn_id)
        if journaled is not None:
            # crash between prepare and decide: the journaled
            # statements re-execute against the recovered store (the
            # same presumed-commit direction replicas use for voted
            # frames), atomically via one held transaction; the entry
            # is removed only after that commit succeeds
            interp = state._make_interp()
            interp.execute("BEGIN")
            try:
                for stmt in journaled["statements"]:
                    interp.execute(stmt["query"],
                                   stmt.get("params") or {})
            except Exception:
                interp.execute("ROLLBACK")
                raise
            interp.execute("COMMIT")
            state.pending_2pc.pop(txn_id, None)
            state._save_pending()
            state.ops += 1
            return "ok", {"shard": state.shard_id, "epoch": state.epoch,
                          "replayed": True}
        return "unknown_txn", {"shard": state.shard_id}

    if op == "begin_move":
        state.move_frames = []
        if state._buffer_hook not in state.storage.frame_consumers:
            state.storage.frame_consumers.append(state._buffer_hook)
        snap = _snapshot_bytes(state.storage)
        return "ok", {"snapshot": snap,
                      "ts": state.storage.latest_commit_ts()}

    if op == "drain_frames":
        frames = state.move_frames or []
        state.move_frames = [] if state.move_frames is not None else None
        return "ok", {"frames": frames}

    if op == "end_move":
        epoch = int(payload["epoch"])
        if epoch >= state.epoch:
            state.owner_fenced = True
        frames = state.move_frames or []
        state.move_frames = None
        try:
            state.storage.frame_consumers.remove(state._buffer_hook)
        except ValueError:
            pass
        return "ok", {"frames": frames, "epoch": state.epoch,
                      "last_ts": state.storage.latest_commit_ts()}

    if op == "apply_snapshot":
        from ..storage.durability.recovery import (_apply_snapshot,
                                                   _clear_storage)
        from ..storage.durability.snapshot import load_snapshot
        import tempfile
        with tempfile.NamedTemporaryFile(delete=False,
                                         suffix=".mgsnap") as f:
            f.write(payload["snapshot"])
            path = f.name
        try:
            parsed = load_snapshot(path)
            _clear_storage(state.storage)
            _apply_snapshot(state.storage, parsed)
            with state.storage._engine_lock:
                state.storage._timestamp = max(state.storage._timestamp,
                                               parsed["timestamp"])
            state.storage._bump_topology()
            state.needs_snapshot = True
        finally:
            os.unlink(path)
        return "ok", {"ts": state.storage.latest_commit_ts()}

    if op == "apply_frames":
        for _ts, frame in payload["frames"]:
            state.apply_frame(frame)
        return "ok", {"ts": state.storage.latest_commit_ts()}

    if op == "health":
        return "ok", {"pid": os.getpid(), "shard": state.shard_id,
                      "name": state.name, "epoch": state.epoch,
                      "fenced": state.owner_fenced, "ops": state.ops,
                      "pending_2pc": sorted(state.pending_2pc),
                      "last_ts": state.storage.latest_commit_ts()}

    raise RuntimeError(f"unknown shard op {op!r}")


def shard_worker_main(shard_id: int, name: str, req_fd: int,
                      resp_fd: int, base_dir: str, generation: int,
                      epoch: int) -> None:
    """The child-process loop: build the shard's state, then serve the
    envelope until EOF/None. Every response carries the worker's spans
    (trace carrier machinery shared with mp_executor)."""
    # every object the fork copied goes to the permanent generation: the
    # child's collector never finalises an inherited (CUDA) tensor
    gc.freeze()
    data_dir = _shard_dir(base_dir, shard_id, generation)
    state = _WorkerState(shard_id, name, data_dir, epoch)
    while True:
        try:
            msg = _recv(req_fd)
        except (EOFError, OSError, struct.error, ValueError,
                pickle.UnpicklingError):
            # torn/garbage frame on the request pipe: the plane side
            # is gone or corrupt — exit; the plane respawns this shard
            # with per-shard WAL recovery
            return
        if msg is None:
            return
        op, payload, carrier = msg
        t0 = time.perf_counter()
        try:
            with mgtrace.adopt(carrier):
                with mgtrace.span("shard.worker"):
                    status, out = _handle(state, op, payload or {})
            spans = mgtrace.take_trace(carrier["trace_id"]) \
                if carrier else []
            _send(resp_fd, (status, out,
                            {"elapsed": time.perf_counter() - t0},
                            spans))
        except Exception as e:  # noqa: BLE001 — ship the error back
            try:
                _send(resp_fd, ("err", (type(e).__name__, str(e)),
                                {"elapsed": time.perf_counter() - t0},
                                []))
            except (OSError, ValueError, struct.error):
                return      # response pipe gone: die, get respawned
