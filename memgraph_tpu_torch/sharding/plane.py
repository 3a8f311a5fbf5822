"""ShardPlane: spawn, route to, respawn, kill and MOVE shard workers.

The plane owns the process topology: one long-lived worker per shard
(forked, mp_executor envelope over pipes), a placement authority that
mints the epoch-versioned shard map, and the shard-move protocol
(snapshot ship -> delta catch-up -> epoch bump -> cutover) that lets
the plane rebalance live.

Placement: ``LocalPlacement`` is the single-process stand-in with the
same contract the coordinator provides — every reassignment mints a
strictly-increasing fencing epoch ATOMICALLY with the owner change.
``CoordinatorPlacement`` adapts a real ``CoordinatorInstance`` whose
replicated apply mints the epoch (the fencing stack), so a stale map
can never route an acked write in the clustered deployment either.

Crash handling: a dead worker is detected on the pipe (EOF/EPIPE),
respawned against the SAME per-shard durability directory — recovery
replays its snapshot + WAL — re-granted at the current epoch, and the
in-flight request fails with the typed retryable ``WorkerCrashedError``
so RetryPolicy-driven callers re-route instead of wedging.

Copy of memgraph_tpu/sharding/plane.py for the port: the workers are
the port's (worker.py: forked, never touching ``torch.cuda``, device
work refused typed), the placement through the port's coordinator.
``respawn_s`` holds the seconds of the last respawn of a dead owner
(fork, the worker's recovery of its snapshot and WAL, the grant).
"""

from __future__ import annotations

import logging
import os
import pickle
import signal
import struct
import tempfile
import threading
import time

from ..exceptions import (MemgraphTpuError, StaleShardEpoch,
                          WorkerCrashedError, raise_wire_error)
from ..observability import trace as mgtrace
from ..utils.metrics import global_metrics
from ..server.mp_executor import _recv, _send
from ..utils.locks import tracked_lock
from ..utils.sanitize import shared_field, shared_read, shared_write
from .shard_map import ShardMap

log = logging.getLogger(__name__)

__all__ = ["ShardPlane", "LocalPlacement", "CoordinatorPlacement"]


class LocalPlacement:
    """Single-process placement authority: the mesh-of-1 degeneracy of
    the coordinator's replicated shard map. Epoch minting is atomic
    with the owner change — the same contract the raft apply gives."""

    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards
        self._epoch = 0
        self._owners: dict[int, str] = {}
        self._lock = tracked_lock("LocalPlacement._lock")
        shared_field(self, "_epoch", "_owners")

    def assign(self, shard_id: int, owner: str) -> ShardMap:
        with self._lock:
            shared_write(self, "_owners")
            self._epoch += 1
            self._owners[shard_id] = owner
            return ShardMap(epoch=self._epoch, n_shards=self.n_shards,
                            owners=dict(self._owners))

    def current(self) -> ShardMap:
        with self._lock:
            shared_read(self, "_owners")
            return ShardMap(epoch=self._epoch, n_shards=self.n_shards,
                            owners=dict(self._owners))


class CoordinatorPlacement:
    """Placement through a real CoordinatorInstance: assignment is a
    raft proposal and the fencing epoch is minted inside the replicated
    apply — all coordinators agree on (epoch, owner) by log order."""

    def __init__(self, coordinator, n_shards: int) -> None:
        self.coordinator = coordinator
        self.n_shards = n_shards

    def assign(self, shard_id: int, owner: str) -> ShardMap:
        if not self.coordinator.assign_shard(shard_id, owner):
            raise MemgraphTpuError(
                f"shard {shard_id} assignment to {owner!r} did not "
                "commit (no raft quorum?)")
        return self.current()

    def current(self) -> ShardMap:
        view = self.coordinator.shard_map_view()
        return ShardMap(epoch=view["epoch"], n_shards=self.n_shards,
                        owners={int(k): v
                                for k, v in view["owners"].items()})


class _Worker:
    """Parent-side handle: one forked shard worker + its dispatch lock
    (requests to one shard serialize — the single-threaded model-server
    shape; concurrency comes from shard fan-out)."""

    __slots__ = ("name", "shard_id", "generation", "pid", "req_fd",
                 "resp_fd", "lock", "closed")

    def __init__(self, name, shard_id, generation, pid, req_fd, resp_fd):
        self.name = name
        self.shard_id = shard_id
        self.generation = generation
        self.pid = pid
        self.req_fd = req_fd
        self.resp_fd = resp_fd
        self.lock = threading.Lock()
        # set True (under ``lock``) before the fds are closed: a thread
        # that was queued on the lock must NEVER touch the fds after —
        # the numbers may already be reused by a later-spawned worker's
        # pipes, and a stale write would corrupt an unrelated framing
        # stream (reader blocks forever on a garbage length prefix)
        self.closed = False


class ShardPlane:
    """N shard workers + the shard map + the move/respawn machinery."""

    #: delta catch-up rounds before the cutover fence (each round ships
    #: the frames committed during the previous round's apply)
    MOVE_CATCHUP_ROUNDS = 8

    def __init__(self, n_shards: int = 4, base_dir: str | None = None,
                 placement=None) -> None:
        self.n_shards = n_shards
        self._owns_dir = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="mgshard-")
        self.placement = placement or LocalPlacement(n_shards)
        self._lock = tracked_lock("ShardPlane._lock")
        self._workers: dict[int, _Worker] = {}     # shard -> live owner
        self._generations: dict[int, int] = {}
        self._inflight: dict[int, int] = {}
        self._closed = False
        shared_field(self, "_workers", "_generations", "_inflight",
                     "_closed")
        self.map = ShardMap(epoch=0, n_shards=n_shards, owners={})
        self.respawn_s = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ShardPlane":
        for sid in range(self.n_shards):
            worker = self._spawn(sid, generation=0)
            with self._lock:
                shared_write(self, "_workers")
                self._workers[sid] = worker
                self._generations[sid] = 0
            self.map = self.placement.assign(sid, worker.name)
        self._broadcast_grant()
        return self

    def _spawn(self, shard_id: int, generation: int) -> _Worker:
        name = f"s{shard_id}g{generation}"
        req_r, req_w = os.pipe()
        resp_r, resp_w = os.pipe()
        pid = os.fork()
        if pid == 0:                                  # ---- child ----
            os.close(req_w)
            os.close(resp_r)
            try:
                from .worker import shard_worker_main
                shard_worker_main(shard_id, name, req_r, resp_w,
                                  self.base_dir, generation,
                                  epoch=0)
            finally:
                os._exit(0)
        os.close(req_r)
        os.close(resp_w)
        return _Worker(name, shard_id, generation, pid, req_w, resp_r)

    def close(self) -> None:
        with self._lock:
            shared_write(self, "_workers")
            workers = list(self._workers.values())
            self._workers = {}
            self._closed = True
        for w in workers:
            self._retire(w)
        if self._owns_dir:
            import shutil
            shutil.rmtree(self.base_dir, ignore_errors=True)

    def _retire(self, worker: _Worker) -> None:
        with worker.lock:
            if worker.closed:
                return
            worker.closed = True
            try:
                _send(worker.req_fd, None)
            except OSError:
                pass
            for fd in (worker.req_fd, worker.resp_fd):
                try:
                    os.close(fd)
                except OSError:
                    pass
        try:
            os.waitpid(worker.pid, 0)
        except ChildProcessError:
            pass

    # -- request path --------------------------------------------------------

    def owner(self, shard_id: int) -> _Worker:
        with self._lock:
            shared_read(self, "_workers")
            try:
                return self._workers[shard_id]
            except KeyError:
                raise MemgraphTpuError(
                    f"shard {shard_id} has no live worker "
                    "(plane not started or closed)") from None

    def request(self, shard_id: int, op: str, payload: dict,
                raise_typed: bool = True):
        """One envelope round-trip to a shard's owner. Returns (status,
        payload). Typed raises: a dead worker respawns (with per-shard
        WAL recovery) and raises WorkerCrashedError — ``in_doubt=True``
        when it died after the request was on the wire (writers must
        not blindly re-send), False when it was replaced before the
        send (safe to retry); a stale-epoch/fenced bounce raises
        StaleShardEpoch carrying the owner's epoch unless
        ``raise_typed`` is False."""
        worker = self.owner(shard_id)
        with self._lock:
            shared_write(self, "_inflight")
            depth = self._inflight.get(shard_id, 0) + 1
            self._inflight[shard_id] = depth
        global_metrics.set_gauge(f"shard.queue_depth.{shard_id}",
                                 float(depth))
        global_metrics.increment("shard.requests_total")
        global_metrics.increment(f"shard.ops.{shard_id}")
        t0 = time.perf_counter()
        try:
            with mgtrace.span("shard.request", shard=shard_id, op=op):
                with worker.lock:
                    if worker.closed:
                        # replaced (crash respawn or move cutover)
                        # while we queued on its lock — never touch
                        # the fds; re-route against the fresh owner
                        raise WorkerCrashedError(
                            f"shard {shard_id} worker {worker.name} "
                            "was replaced while this request queued — "
                            "retry")
                    try:
                        _send(worker.req_fd,
                              (op, payload, mgtrace.inject()))
                        out = _recv(worker.resp_fd)
                    except (OSError, EOFError, struct.error,
                            ValueError, pickle.UnpicklingError) as e:
                        # codec failure on the control wire (torn
                        # frame from a dying worker) means the same
                        # thing the pipe errors do: this owner is gone
                        self._handle_dead(shard_id, worker)
                        raise WorkerCrashedError(
                            f"shard {shard_id} worker {worker.name} "
                            f"(pid {worker.pid}) died mid-request; "
                            "respawned with per-shard recovery",
                            in_doubt=True) from e
        finally:
            with self._lock:
                shared_write(self, "_inflight")
                depth = max(self._inflight.get(shard_id, 1) - 1, 0)
                self._inflight[shard_id] = depth
            global_metrics.set_gauge(f"shard.queue_depth.{shard_id}",
                                     float(depth))
            global_metrics.observe(f"shard.op_latency_sec.{shard_id}",
                                   time.perf_counter() - t0)
        status, body, _stats, spans = out
        if spans:
            mgtrace.adopt_spans(spans)
        if status == "err":
            raise_wire_error(body[0], f"shard {shard_id}: {body[1]}")
        if raise_typed and status in ("stale_epoch", "fenced"):
            raise StaleShardEpoch(shard_id, int(body.get("epoch") or 0),
                                  fenced=(status == "fenced"))
        return status, body

    def _handle_dead(self, shard_id: int, worker: _Worker) -> None:
        """Respawn a crashed owner against its durability dir; recovery
        replays the shard's snapshot + WAL, then the worker is
        re-granted at the current epoch. Caller holds ``worker.lock``
        (so setting ``closed`` + closing the fds is race-free against
        queued senders)."""
        worker.closed = True
        try:
            os.waitpid(worker.pid, os.WNOHANG)
        except ChildProcessError:
            pass
        for fd in (worker.req_fd, worker.resp_fd):
            try:
                os.close(fd)
            except OSError:
                pass
        with self._lock:
            shared_write(self, "_workers")
            if self._closed or \
                    self._workers.get(shard_id) is not worker:
                return          # someone else already replaced it
            t0 = time.perf_counter()
            fresh = self._spawn(shard_id, worker.generation)
            self._workers[shard_id] = fresh
        global_metrics.increment("shard.worker_respawn_total")
        self._grant(shard_id, fresh)
        self.respawn_s = time.perf_counter() - t0

    # -- fencing / grants ----------------------------------------------------

    def _grant(self, shard_id: int, worker: _Worker) -> None:
        epoch = self.map.epoch
        try:
            with worker.lock:
                if worker.closed:
                    return
                _send(worker.req_fd,
                      ("grant", {"shard": shard_id, "epoch": epoch},
                       None))
                _recv(worker.resp_fd)
        except (OSError, EOFError, struct.error, ValueError,
                pickle.UnpicklingError):
            # dead owner: the next routed request respawns + re-grants
            log.warning("grant(%d, epoch %d) found worker %s dead",
                        shard_id, epoch, worker.name)
        global_metrics.set_gauge("shard.map_epoch", float(epoch))

    def _broadcast_grant(self) -> None:
        """The table epoch is global: every mint re-grants every live
        owner so no owner is left refusing current-map writes."""
        with self._lock:
            shared_read(self, "_workers")
            workers = dict(self._workers)
        for sid, worker in workers.items():
            self._grant(sid, worker)

    # -- chaos hooks ---------------------------------------------------------

    def kill_worker(self, shard_id: int) -> int:
        """SIGKILL a shard's owner (nemesis: shard_worker_kill). The
        next request detects the death, respawns and recovers."""
        worker = self.owner(shard_id)
        try:
            os.kill(worker.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return worker.pid

    def restart_worker(self, shard_id: int) -> None:
        """Proactive respawn of a killed owner (nemesis heal); a no-op
        when the worker is alive."""
        worker = self.owner(shard_id)
        with worker.lock:
            if worker.closed:
                return   # already replaced by another path
            try:
                pid, _status = os.waitpid(worker.pid, os.WNOHANG)
            except ChildProcessError:
                pid = worker.pid
            if pid == 0:
                return   # still alive
            self._handle_dead(shard_id, worker)

    # -- shard move ----------------------------------------------------------

    def shard_move(self, shard_id: int) -> str:
        """Live rebalance: move a shard to a FRESH worker process.

        Protocol (the acked-write-loss-free order):
          1. spawn the target (next generation, empty store);
          2. ``begin_move`` on the source: snapshot + arm frame buffer;
          3. target applies the snapshot;
          4. bounded delta catch-up rounds ship committed frames;
          5. the placement authority mints the new epoch (stale maps
             can no longer produce accepted acks);
          6. ``end_move`` fences the source and returns the frame tail
             (writes acked at the OLD epoch are all in snapshot+frames);
          7. target applies the tail, is granted at the new epoch (and
             snapshots once, re-baselining its own durability dir);
          8. the source retires.
        Returns the new owner's name.
        """
        t0 = time.perf_counter()
        source = self.owner(shard_id)
        with self._lock:
            # claim the generation in the same region that records it:
            # a failed move burns a generation number (dirs stay
            # unique), it never reuses one
            shared_write(self, "_generations")
            generation = self._generations.get(shard_id, 0) + 1
            self._generations[shard_id] = generation
        target = self._spawn(shard_id, generation)
        ceded = False
        try:
            _status, begin = self._direct(source, "begin_move", {})
            self._direct(target, "apply_snapshot",
                         {"snapshot": begin["snapshot"]})
            for _round in range(self.MOVE_CATCHUP_ROUNDS):
                _status, out = self._direct(source, "drain_frames", {})
                if not out["frames"]:
                    break
                self._direct(target, "apply_frames",
                             {"frames": out["frames"]})
            # epoch bump INSIDE the placement authority: from here a
            # stale-map client's write cannot produce an accepted ack
            self.map = self.placement.assign(shard_id, target.name)
            ceded = True
            _status, end = self._direct(source, "end_move",
                                        {"epoch": self.map.epoch})
            if end["frames"]:
                self._direct(target, "apply_frames",
                             {"frames": end["frames"]})
        except (OSError, EOFError, MemgraphTpuError):
            # presumed abort of the move: retire the half-built target
            self._retire(target)
            if ceded:
                # the epoch already moved to the target: hand ownership
                # back through the placement authority (fresh epoch, so
                # the grant un-fences an end_move-fenced source) — else
                # the still-installed source stale-bounces every write
                # at the new map epoch forever
                try:
                    self.map = self.placement.assign(shard_id,
                                                     source.name)
                    self._grant(shard_id, source)
                except (OSError, EOFError, MemgraphTpuError):
                    log.exception(
                        "shard %d: could not restore source owner %s "
                        "after aborted move; shard stays "
                        "write-unavailable until reassigned", shard_id,
                        source.name)
            raise
        with self._lock:
            shared_write(self, "_workers")
            self._workers[shard_id] = target
        self._broadcast_grant()
        self._retire(source)
        global_metrics.increment("shard.moves_total")
        global_metrics.observe("shard.move_duration_sec",
                               time.perf_counter() - t0)
        return target.name

    def _direct(self, worker: _Worker, op: str, payload: dict):
        """Move-protocol RPC to a specific worker (not via the map)."""
        with worker.lock:
            if worker.closed:
                raise WorkerCrashedError(
                    f"worker {worker.name} already retired")
            _send(worker.req_fd, (op, payload, None))
            out = _recv(worker.resp_fd)
        status, body = out[0], out[1]
        if status == "err":
            raise MemgraphTpuError(
                f"{op} on {worker.name}: {body[0]}: {body[1]}")
        return status, body

    # -- observability -------------------------------------------------------

    def health(self) -> dict:
        out = {}
        with self._lock:
            shared_read(self, "_workers")
            workers = dict(self._workers)
        for sid, worker in workers.items():
            try:
                _status, body = self._direct(worker, "health", {})
                out[sid] = body
            except (OSError, EOFError, MemgraphTpuError) as e:
                out[sid] = {"error": f"{type(e).__name__}: {e}"}
        return out
