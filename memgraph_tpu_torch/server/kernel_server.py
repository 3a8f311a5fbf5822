"""Resident kernel server of the port: one process keeps the card, the
built kernels and resident graph generations warm for short-lived
clients, over a unix socket.

Port of memgraph_tpu/server/kernel_server.py.  A client's first call
costs a socket round trip and the device work: the daemon has already
paid the process start, the CUDA context and the kernels' load.

  * Every dispatch has a TYPED outcome: completed / deadline_exceeded /
    device_error / oom / shed / invalid, and the clients raise one
    exception class per failure (``AdmissionRejected``, ``KernelOom``,
    ``KernelDeviceError``, ``KernelDeadlineExceeded``).
  * A request's ``deadline_s`` bounds the client's wait: the dispatch
    runs on a worker thread, and a stalled card answers
    ``deadline_exceeded`` while the health op reports the overdue
    dispatch (``wedged`` past ``wedge_after_s``).
  * An ADMISSION guard prices each request's device footprint
    (``_ALGO_FOOTPRINT``, fitted on the port's own peaks on the card)
    against a budget: 75% of the card's free bytes when the daemon
    starts (``torch.cuda.mem_get_info``; another process, such as the
    caller's, may hold memory already), ``MEMGRAPH_TPU_HBM_BUDGET_BYTES``
    when set, 4 GiB on the CPU.  The guard has the reference's three
    verdicts (``tier.admission_{verdict}_total``): a request that fits
    runs resident; a pagerank, katz or wcc request over the budget whose
    STREAMED working set fits it (ops/tier.py
    ``streamed_request_bytes``) runs streamed, its edges as host blocks
    copied through the card a sweep at a time (parallel/streamed.py,
    from the generation's ``ensure_tier``; the reply says ``"tier":
    "streamed"``); anything else is shed, typed and counted.
  * Graphs stay resident per ``graph_key`` as generations
    (ops/delta.py ``ResidentGraph`` in a ``ResidentRegistry``): a request
    at a newer ``graph_version`` with the change log's delta payload
    (``changed`` dense ids and those vertices' current incident edges
    ``inc_src`` / ``inc_dst`` / ``inc_w``) moves the generation O(delta),
    and its snapshot refreshes through a ``DeltaPlan`` on the MXU route.
    A repeated request on an unmoved generation returns the stored
    solution's bytes; a moved one seeds the fixpoint under the warm-start
    contract.
  * ``pagerank`` runs the mesh's resumable partition-centric loop
    (parallel/distributed.py ``pagerank_partition_centric``) over the
    generation's sharded variant (``ResidentGraph.ensure_sharded``, moved
    O(delta) by a commit) on ``analytics_mesh()`` or a mesh of 1 on the
    daemon's device, with a host checkpoint every ``checkpoint_every``
    iterations (MEMGRAPH_TPU_CHECKPOINT_EVERY, 16 by default) under the job
    key ``kernel_server:pagerank:<graph_key>`` (with the generation's
    version and the parameters): a device fault mid-run resumes from the
    last checkpoint, bit-exact; no snapshot is placed for it.
    ``semiring``'s pagerank, katz, wcc and labelprop run the port's ops on
    the generation's snapshot (the mesh when MEMGRAPH_TPU_MESH_DEVICES is
    set; else the MXU route at ``MXU_MIN_EDGES`` edges or more on the
    card, the segment route below), and its ``bfs`` always runs the
    mesh's, over the same sharded variant (parallel/analytics.py
    ``bfs_partition_centric``, ``bfs_mesh``'s loop).  Admission prices
    each on the route it runs (``_MESH_FOOTPRINT``).
  * ``ppr`` enters the COALESCING plane (``PprServingPlane``): requests
    gather for a window (``MEMGRAPH_TPU_PPR_BATCH_WINDOW_MS``, 4 ms, or
    ``MEMGRAPH_TPU_PPR_MAX_BATCH``, 32, requests) and run as one batched
    fixpoint per parameter group (K1 over lanes), top-k on the card, one
    host transfer a chunk; a per-source RESULT CACHE keyed on (graph
    key, sources, parameters) answers repeats and keeps stale vectors as
    warm seeds, invalidated by the shipped change set one hop out or
    when the entry's own mass on the changed nodes could move it past
    ``PPR_HIT_BOUND`` (the reference checks the first hop alone).
  * ``lane`` runs the read lane's hop count (ops/pipeline.py
    ``hop_counts``, K1) over the request's edge arrays and masks: ``{"ok":
    true, "rows" / "distinct"}``; a refusal of the lane's exactness
    witness answers ``invalid`` with ``lane_refused: <reason>``, and a
    failed launch is a typed ``device_error``, never a refusal.  A
    request's ``trace`` carrier (observability/trace.py) is adopted on
    the dispatch's thread: the daemon's ``kernel.dispatch`` span and the
    spans the op opens inside it come home in the reply's
    ``trace_spans``, and the dispatch's stage extents (a
    ``StageAccumulator``, observability/stats.py) in its ``stages`` (a
    PPR batch's split evenly over its riders); the client adopts the
    spans and merges the stages into its own active accumulator.

The wire is the reference's, byte for byte, so the JAX package's own
``KernelClient`` talks to this daemon: length-prefixed frames, each a
JSON header ``{op, arrays: [{name, dtype, shape}], ...params}`` and then
the raw array bytes in order.  Ops: ping, health, probe, pagerank,
semiring, ppr, lane, shutdown.

The daemon serves on ``cuda`` unless started with ``--device cpu``:

    python -m memgraph_tpu_torch.server.kernel_server [--socket PATH]
        [--idle-timeout S] [--device cuda|cpu]

Without a card and without ``--device cpu`` it exits non-zero, naming
the cause.  ``ensure_server`` spawns it with its output in a log beside
the socket (``log_path``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np

from ..observability import stats as mgstats
from ..observability import trace as mgtrace
from ..ops.semiring import backend_extent
from ..utils.devicefault import classify_device_error, device_fault_point
from ..utils.metrics import global_metrics
from ..utils.retry import RetryPolicy

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the port's own socket: never the JAX daemon's
DEFAULT_SOCKET = os.environ.get(
    "MEMGRAPH_TPU_TORCH_KERNEL_SERVER_SOCKET",
    os.path.join(_REPO_ROOT, ".kernel_server_torch.sock"))

_CPU_BUDGET_BYTES = 4 << 30

#: how long ``ensure_server`` keeps polling after its own child exited
#: (another spawner's daemon may still be starting)
_SPAWN_RACE_GRACE_S = 3.0


def log_path(socket_path: str) -> str:
    """The log a spawned daemon writes its output to."""
    return socket_path + ".log"


def _resolve_checkpoint_every() -> int:
    """The daemon's checkpoint interval: MEMGRAPH_TPU_CHECKPOINT_EVERY,
    16 by default (0: one full-budget chunk)."""
    try:
        return max(0, int(os.environ.get(
            "MEMGRAPH_TPU_CHECKPOINT_EVERY", "16")))
    except ValueError:
        return 16


def _resolve_hbm_budget(device) -> int:
    """The admission budget: ``MEMGRAPH_TPU_HBM_BUDGET_BYTES``, else 75%
    of the card's free bytes now, else (the CPU) 4 GiB."""
    env = os.environ.get("MEMGRAPH_TPU_HBM_BUDGET_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            log.warning("bad MEMGRAPH_TPU_HBM_BUDGET_BYTES=%r; ignoring",
                        env)
    if device.type == "cuda":
        import torch
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * 0.75)
    return _CPU_BUDGET_BYTES


# --------------------------------------------------------------------------
# admission estimators
# --------------------------------------------------------------------------


def _padded_graph_dims(n_nodes: int, n_edges: int) -> tuple[int, int]:
    """(n_pad, e_pad) that ``from_coo`` allocates for these counts: the
    footprint follows the power-of-two buckets, not the raw counts."""
    from ..ops.csr import _bucket
    return _bucket(int(n_nodes) + 1), _bucket(int(n_edges))


#: per-algorithm device bytes over the padded dims, ``node_bytes * n_pad
#: + edge_bytes * e_pad``: the peak of one cold run on a freshly placed
#: graph (its arrays and the run's temporaries) on the segment route,
#: fitted on the port's peaks (``torch.cuda.max_memory_allocated``) on an
#: H100 at the segment graph (100k nodes, 450k edges) and, for the
#: algorithms that stay on that route, the north star (1M, 10M): 1.16-1.35
#: times the measured peak; chip_smoke.py's ``kernel_server`` phase holds
#: each within [1x, 2x].  "ppr" is the graph part of a batch; its lanes
#: are priced by ``_lane_state_bytes``.
_ALGO_FOOTPRINT = {
    "pagerank": (16, 52),
    "katz": (16, 40),
    "wcc": (64, 54),
    "labelprop": (115, 206),
    "ppr": (30, 44),
}

#: the same where the MXU route serves (PageRank and katz on the card at
#: ``MXU_MIN_EDGES`` edges or more): the placed plan's routes and
#: multipliers beside the graph's arrays, which the reference's model
#: leaves out (katz places its own multipliers beside PageRank's routes);
#: fitted at the north star, 1.16-1.17 times the measured peak
_MXU_FOOTPRINT = {
    "pagerank": (16, 64),
    "katz": (16, 67),
}

#: the mesh routes the daemon serves, over the generation's sharded
#: variant on a mesh of 1 (``ResidentGraph.ensure_sharded``: its rows,
#: ``local_src`` and dst runs, placed by the request) and the loop's
#: temporaries, with no snapshot placed beside it: the ``pagerank`` op's
#: partition-centric loop (keyed "pagerank") and the ``semiring`` op's
#: ``bfs``.  Measured on an H100 (chip_smoke.py ``mesh_route_peak``):
#: 42-52 bytes a real edge, the vertex vectors included, at the segment
#: graph and the north star, so the edge term alone covers an e_pad with
#: no padding; 1.16-1.72 times the measured peaks.
#: A wider mesh holds a share of the same bytes on each device
_MESH_FOOTPRINT = {
    "pagerank": (16, 48),
    "bfs": (16, 42),
}

#: an unknown algorithm is priced at the column-wise max
_ALGO_FOOTPRINT_DEFAULT = tuple(
    max(c) for c in zip(*_ALGO_FOOTPRINT.values(), *_MXU_FOOTPRINT.values(),
                        *_MESH_FOOTPRINT.values()))


def _mxu_route(device, n_edges: int) -> bool:
    """Whether a plus-times fixpoint over ``n_edges`` edges on ``device``
    takes the MXU route (``semiring.route_backend``'s rule)."""
    from types import SimpleNamespace
    from ..ops import pagerank as PR
    from ..ops import semiring as S
    return S.route_backend(SimpleNamespace(n_edges=int(n_edges)), device,
                           min_edges=PR.MXU_MIN_EDGES)[0] == "mxu"


def _graph_footprint_bytes(algorithm, n_nodes: int, n_edges: int,
                           device=None, op: str = "semiring") -> int:
    """The modeled device peak of one fixpoint over the padded graph on
    ``device`` (a graph_key-only request ships no bytes but pays this),
    on the route ``op`` runs it by: the ``pagerank`` op and ``bfs`` on
    the mesh; else the MXU route where it serves, or the segment route's
    (always without a device)."""
    algorithm = str(algorithm)
    if op == "pagerank" or algorithm == "bfs":
        node_b, edge_b = _MESH_FOOTPRINT[
            "pagerank" if op == "pagerank" else algorithm]
    elif algorithm in _MXU_FOOTPRINT and device is not None \
            and _mxu_route(device, n_edges):
        node_b, edge_b = _MXU_FOOTPRINT[algorithm]
    else:
        node_b, edge_b = _ALGO_FOOTPRINT.get(algorithm,
                                             _ALGO_FOOTPRINT_DEFAULT)
    n_pad, e_pad = _padded_graph_dims(n_nodes, n_edges)
    return n_pad * node_b + e_pad * edge_b


def _estimate_request_bytes(header: dict, arrays: dict,
                            device=None, op: str = "semiring") -> int:
    """A request of ``op``'s footprint on ``device``: the fixpoint's
    modeled peak plus one copy of the wire arrays (their host-to-device
    staging)."""
    wire_bytes = sum(int(np.prod(a.shape, dtype=np.int64))
                     * a.dtype.itemsize for a in arrays.values())
    n_nodes = int(header.get("n_nodes") or 0)
    src = arrays.get("src")
    n_edges = int(src.shape[0]) if src is not None \
        else int(header.get("n_edges") or 0)
    return wire_bytes + _graph_footprint_bytes(
        header.get("algorithm", "pagerank"), n_nodes, n_edges, device, op)


def _generation_modeled_bytes(gen) -> int:
    """A resident generation priced at the column-wise worst case: the
    next request's algorithm is unknown."""
    return _graph_footprint_bytes("*", gen.n_nodes, gen.n_edges)


#: f32 values a lane keeps per padded node in the batched PPR (x, the
#: new x, the matvec, the restart vector, the error's scratch, the
#: transfer's copy); K1 sums a lane's runs without materializing an
#: edge's contribution, so no per-edge term (the reference prices 6
#: slots and 6 bytes an edge a lane).  Fitted with ``_ALGO_FOOTPRINT``:
#: 28-31 B a node a lane measured between 1 and 32 lanes.
_PPR_LANE_NODE_SLOTS = 9


def _lane_state_bytes(n_nodes: int, n_edges: int,
                      n_lanes: int = 1) -> int:
    """The bytes a PPR batch pays for its lanes, at the lane bucket the
    batch pads to (ops/pagerank.py ``_bucket_lanes``: 33 lanes run 64)."""
    from ..ops.pagerank import _bucket_lanes
    lanes = _bucket_lanes(max(1, int(n_lanes)))
    n_pad, _ = _padded_graph_dims(n_nodes, n_edges)
    return lanes * n_pad * 4 * _PPR_LANE_NODE_SLOTS


def _ppr_chunk_lanes(n_nodes: int, n_edges: int, budget: int) -> int:
    """The widest lane bucket whose priced batch (graph and lanes) fits
    the budget: the chunk the drain runs.  1 when none fits (admission
    already bounded that case)."""
    from ..ops.pagerank import _PPR_LANE_BUCKETS
    graph = _graph_footprint_bytes("ppr", n_nodes, n_edges)
    for b in reversed(_PPR_LANE_BUCKETS):
        if graph + _lane_state_bytes(n_nodes, n_edges, b) <= budget:
            return b
    return 1


def _tier_precision(precision) -> str:
    """The block codec's precision for a streamed run: the request's when
    the codec has it, f32 otherwise."""
    p = str(precision)
    return p if p in ("f32", "bf16", "int8") else "f32"


#: the algorithms a streamed run serves (parallel/streamed.py)
_STREAMABLE = ("pagerank", "katz", "wcc")


def run_streamed(gen, algorithm: str, header: dict, x0=None, device=None):
    """One streamed algorithm over a generation's paging plan with a
    request's parameters: (host answer, err or None, iterations)."""
    from ..parallel import streamed as ST
    max_iterations = int(header.get("max_iterations", 100))
    precision = _tier_precision(header.get("precision", "f32"))
    if algorithm == "pagerank":
        x, err, iters = ST.pagerank_streamed(
            gen.ensure_tier(precision),
            damping=float(header.get("damping", 0.85)),
            max_iterations=max_iterations,
            tol=float(header.get("tol", 1e-6)), x0=x0, device=device)
    elif algorithm == "katz":
        x, err, iters = ST.katz_streamed(
            gen.ensure_tier(precision),
            alpha=float(header.get("alpha", 0.2)),
            beta=float(header.get("beta", 1.0)),
            max_iterations=max_iterations,
            tol=float(header.get("tol", 1e-6)), x0=x0, device=device)
    elif algorithm == "wcc":
        x, _changed, iters = ST.wcc_streamed(
            gen.ensure_tier("f32"), max_iterations=max_iterations,
            comp0=x0, device=device)
        err = None
    else:
        raise ValueError(f"no streamed run of {algorithm!r}")
    dtype = np.int32 if algorithm == "wcc" else np.float32
    return (np.asarray(x, dtype=dtype),
            None if err is None else float(err), int(iters))


def probe_device(device=None):
    """A small end-to-end check of the device behind the fault point: a
    (128, 128) product read back on the host.  (checksum, device type)."""
    import torch
    from ..device import resolve_device
    device_fault_point()
    dev = resolve_device(device)
    x = torch.ones((128, 128), dtype=torch.float32, device=dev)
    return float((x @ x).sum()), dev.type


def kernel_launches() -> dict:
    """This process's launch counts of the port's hand-written kernels
    (the Benes four, K1 and K2)."""
    from ..ops import benes_cuda as BC
    from ..ops import segment_cuda as SC
    return {"benes_mid": BC.benes_mid.launches,
            "benes_mid_gather": BC.benes_mid_gather.launches,
            "benes_outer": BC.benes_outer.launches,
            "benes_outer_gather": BC.benes_outer_gather.launches,
            "csr_spmm_sum": SC.csr_spmm_sum.launches,
            "lane_sum": SC.lane_sum.launches}


# --------------------------------------------------------------------------
# typed client errors (one per server outcome)
# --------------------------------------------------------------------------


class KernelServerError(RuntimeError):
    """A kernel-server failure with its typed outcome."""

    def __init__(self, message: str, outcome: str = "invalid",
                 retryable: bool = False) -> None:
        super().__init__(message)
        self.outcome = outcome
        self.retryable = retryable


class AdmissionRejected(KernelServerError):
    """Shed by the admission guard (outcome "shed"); not retryable: the
    same request sheds again against the same budget."""

    def __init__(self, message: str) -> None:
        super().__init__(message, outcome="shed", retryable=False)


class KernelOom(KernelServerError):
    """Device memory exhausted in the dispatch (outcome "oom")."""

    def __init__(self, message: str) -> None:
        super().__init__(message, outcome="oom", retryable=False)


class KernelDeviceError(KernelServerError):
    """A device failure in the dispatch (outcome "device_error"); the ops
    are pure, so a retry is safe."""

    def __init__(self, message: str) -> None:
        super().__init__(message, outcome="device_error", retryable=True)


class KernelDeadlineExceeded(KernelServerError):
    """The dispatch missed its deadline (outcome "deadline_exceeded"),
    perhaps a stalled card."""

    def __init__(self, message: str) -> None:
        super().__init__(message, outcome="deadline_exceeded",
                         retryable=True)


_OUTCOME_ERRORS = {
    "shed": AdmissionRejected,
    "oom": KernelOom,
    "device_error": KernelDeviceError,
    "deadline_exceeded": KernelDeadlineExceeded,
}


def _raise_for_reply(header: dict):
    outcome = header.get("outcome", "invalid")
    cls = _OUTCOME_ERRORS.get(outcome)
    msg = header.get("error", "kernel server error")
    if cls is not None:
        raise cls(msg)
    raise KernelServerError(msg, outcome=outcome,
                            retryable=bool(header.get("retryable")))


def _failure(outcome: str, retryable: bool, error: str) -> dict:
    return {"ok": False, "outcome": outcome, "retryable": retryable,
            "error": error}


def _typed_failure(e: BaseException) -> dict:
    """The typed reply of an exception a dispatch raised."""
    kind = classify_device_error(e)
    if kind == "oom":
        outcome, retryable = "oom", False
    elif kind in ("device_error", "device_lost"):
        outcome, retryable = "device_error", True
    else:
        outcome, retryable = "invalid", False
    return _failure(outcome, retryable, f"{type(e).__name__}: {e}")


# --------------------------------------------------------------------------
# framing (the reference's wire, byte for byte)
# --------------------------------------------------------------------------


def _send_msg(sock: socket.socket, header: dict,
              arrays: dict[str, np.ndarray] | None = None) -> None:
    arrays = arrays or {}
    header = dict(header)
    header["arrays"] = [
        {"name": k, "dtype": str(v.dtype), "shape": list(v.shape)}
        for k, v in arrays.items()]
    hb = json.dumps(header).encode("utf-8")
    parts = [struct.pack("<I", len(hb)), hb]
    for v in arrays.values():
        parts.append(np.ascontiguousarray(v).tobytes())
    sock.sendall(b"".join(parts))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen))
    arrays = {}
    for spec in header.pop("arrays", []):
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"], dtype=np.int64)) if spec["shape"] \
            else 1
        raw = _recv_exact(sock, count * dt.itemsize)
        arrays[spec["name"]] = np.frombuffer(raw, dtype=dt).reshape(
            spec["shape"])
    return header, arrays


# --------------------------------------------------------------------------
# PPR serving plane: result cache + coalescing queue
# --------------------------------------------------------------------------


def _inject_trace(header: dict) -> None:
    """Put the current trace's carrier on a request header (armed
    tracing inside a trace only)."""
    carrier = mgtrace.inject()
    if carrier is not None:
        header["trace"] = carrier


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: above this neighbourhood size an entry records None ("invalidate on
#: any change") instead of an exact set
PPR_NEIGH_CAP = 4096


def _source_neighborhood(graph, sources, cap: int = PPR_NEIGH_CAP):
    """The dense ids whose change invalidates a PPR vector restarted on
    ``sources``: the sources and their out-neighbours (one pass over the
    host COO).  None: unbounded (any change invalidates)."""
    if graph.host_coo is None:
        return None
    src, dst, _w = graph.host_coo
    sel = np.isin(np.asarray(src), np.asarray(sources))
    neigh = set(int(i) for i in np.asarray(dst)[sel])
    neigh.update(int(s) for s in np.asarray(sources))
    if len(neigh) > cap:
        return None
    return frozenset(neigh)


#: a hit may differ from the PPR of the graph's newest version by at most
#: this fraction of the vector's largest entry (PERF.md §2's PPR bound)
PPR_HIT_BOUND = 1e-4


class _PprCacheEntry:
    """One cached PPR vector: ``fresh`` entries answer hits; stale ones
    only seed the recomputation (a warm start).  ``drift`` bounds the L1
    distance between ``ranks`` and the PPR of ``version``'s graph."""

    __slots__ = ("version", "ranks", "err", "iters", "neigh", "fresh",
                 "drift")

    def __init__(self, version, ranks, err, iters, neigh) -> None:
        self.version = version
        self.ranks = ranks              # np (n_nodes,) float32
        self.err = err
        self.iters = iters
        self.neigh = neigh              # frozenset | None (= any change)
        self.fresh = True
        self.drift = 0.0

    def carries_over(self, changed: np.ndarray, damping: float) -> bool:
        """Whether the vector stays a hit across a change of the nodes
        ``changed`` (dense ids, an int array), and if so add the change's
        bound to ``drift``.  PPR x = (1-d) e + d Pᵀx: a change of the
        rows of the nodes C moves x by at most 2d/(1-d) Σ_{v∈C} x_v in
        L1, and x's true mass on C is at most the cached mass plus the
        drift so far."""
        ids = changed[changed < self.ranks.shape[0]]
        mass = float(np.sum(self.ranks[ids], dtype=np.float64))
        drift = self.drift + 2.0 * damping / (1.0 - damping) * (
            mass + self.drift)
        if drift > PPR_HIT_BOUND * float(np.max(self.ranks, initial=0.0)):
            return False
        self.drift = drift
        return True


class PprResultCache:
    """Per-source PPR results, keyed on (graph_key, sources, damping,
    tol, precision), a bounded LRU (``capacity``, 512 by default).
    ``note_version`` applies a request's shipped delta: entries whose
    neighbourhood (the sources and their out-neighbours) meets the
    changed set become warm seeds; so do entries whose own mass on the
    changed nodes could move the vector by more than ``PPR_HIT_BOUND``
    of its largest entry (``_PprCacheEntry.carries_over``: PPR depends
    on every node the sources reach, not on the first hop only); the
    others move to the new version and keep their hits.  An unknowable
    delta demotes every entry of the key, and a moved dense-id layout
    drops them.  The reference keeps the first rule alone, which answers
    a change two or more hops out with the old version's vector."""

    def __init__(self, capacity: int = 512) -> None:
        from collections import OrderedDict
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _PprCacheEntry]" = OrderedDict()
        self._known: dict = {}    # graph_key -> newest version

    @staticmethod
    def key(graph_key, sources, damping, tol, precision) -> tuple:
        return (graph_key, tuple(int(s) for s in sources),
                float(damping), float(tol), str(precision))

    def note_version(self, graph_key, version: int, base_version,
                     changed, ids_stable: bool) -> None:
        """Advance ``graph_key`` to ``version``; ``changed`` is the dense
        change set of (base_version, version], or None when unknowable."""
        if graph_key is None:
            return
        with self._lock:
            known = self._known.get(graph_key)
            if known is None or version <= known:
                self._known.setdefault(graph_key, version)
                return
            targeted = (ids_stable and base_version == known
                        and changed is not None)
            changed_ids = np.unique(np.asarray(
                [int(i) for i in changed], dtype=np.int64)) \
                if targeted else None
            changed_set = frozenset(changed_ids.tolist()) \
                if targeted else None
            for key, entry in list(self._entries.items()):
                if key[0] != graph_key:
                    continue
                if targeted:
                    if entry.neigh is not None and \
                            not (entry.neigh & changed_set) and \
                            entry.carries_over(changed_ids, key[2]):
                        entry.version = version      # within the bound
                        continue
                    entry.fresh = False              # a warm seed
                elif ids_stable:
                    entry.fresh = False
                else:
                    # the dense ids moved: the vector indexes other nodes
                    del self._entries[key]
                global_metrics.increment("ppr.cache_invalidate_total")
            self._known[graph_key] = version

    def lookup(self, key: tuple):
        """("hit", entry) | ("warm", entry) | ("miss", None)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return "miss", None
            if entry.fresh and entry.version == self._known.get(key[0]):
                self._entries.move_to_end(key)
                return "hit", entry
            return "warm", entry

    def insert(self, key: tuple, entry: _PprCacheEntry) -> None:
        with self._lock:
            known = self._known.get(key[0])
            if known is not None and entry.version < known:
                return          # a newer delta landed mid-compute
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)


class _PprPending:
    """One queued PPR request awaiting its batch."""

    __slots__ = ("header", "arrays", "event", "reply", "out_arrays",
                 "warm_entry", "abandoned", "carrier")

    def __init__(self, header, arrays, warm_entry, carrier=None) -> None:
        self.header = header
        self.arrays = arrays
        self.carrier = carrier
        self.event = threading.Event()
        self.reply = None
        self.out_arrays = None
        self.warm_entry = warm_entry
        self.abandoned = False


def _topk_host(vec: np.ndarray, k: int):
    """Top-k of a cached vector on the host (a hit touches no device),
    O(n): the values above the k-th largest, then the lowest indices
    holding it; ties go to the lower index, as in ``ppr_topk``."""
    k = max(1, min(int(k), len(vec)))
    kth = np.partition(vec, len(vec) - k)[len(vec) - k]
    above = np.flatnonzero(vec > kth)
    idx = np.concatenate([above, np.flatnonzero(vec == kth)[:k - len(above)]])
    idx = idx[np.argsort(-vec[idx], kind="stable")]
    return vec[idx].astype(np.float32), idx.astype(np.int32)


class PprServingPlane:
    """Coalescing batched PPR with a result cache.

    ``ppr`` requests gather for a window, time- or count-triggered
    (``MEMGRAPH_TPU_PPR_BATCH_WINDOW_MS``, 4 ms; ``_MAX_BATCH``, 32), and
    each parameter group runs as one batched fixpoint (requests of other
    damping, tol, iterations or precision never share one).  Admission
    prices the batch and chunks it at ``_ppr_chunk_lanes``; a bad member
    is answered ``invalid`` without poisoning its batch; a full queue
    (``_MAX_QUEUE``, 256) sheds.  ``ppr.*`` metrics count the plane,
    ``ppr.drain_s`` and ``ppr.neighborhood_s`` time a group's dispatch
    and its members' neighbourhood scans."""

    def __init__(self, server: "KernelServer") -> None:
        self.server = server
        self.window_s = _env_float(
            "MEMGRAPH_TPU_PPR_BATCH_WINDOW_MS", 4.0) / 1e3
        self.max_batch = max(1, _env_int("MEMGRAPH_TPU_PPR_MAX_BATCH", 32))
        self.max_queue = max(1, _env_int("MEMGRAPH_TPU_PPR_MAX_QUEUE", 256))
        self.cache = PprResultCache()
        self._queue: "queue.Queue[_PprPending]" = queue.Queue()
        self._thread = None
        self._thread_lock = threading.Lock()
        self._graph_versions: dict = {}   # under the dispatch lock

    # --- request side (connection threads) ---------------------------------

    def submit(self, header: dict, arrays: dict):
        """Cache probe, admission, the coalescing queue: (reply,
        arrays), on the connection's thread."""
        global_metrics.increment("ppr.requests_total")
        sources = arrays.get("sources")
        if sources is None or len(sources) == 0:
            return (_failure("invalid", False,
                             "ppr request carries no sources"), None)
        carrier = header.pop("trace", None)
        graph_key = header.get("graph_key")
        version = int(header.get("graph_version") or 0)
        self.cache.note_version(
            graph_key, version, header.get("base_version"),
            arrays.get("changed") if header.get("has_delta") else None,
            bool(header.get("ids_stable", True)))
        ckey = self.cache.key(graph_key, sources,
                              header.get("damping", 0.85),
                              header.get("tol", 1e-6),
                              header.get("precision", "f32"))
        warm_entry = None
        if graph_key is not None:
            t0 = time.perf_counter()
            t_wall = time.time()
            status, entry = self.cache.lookup(ckey)
            if status == "hit":
                global_metrics.increment("ppr.cache_hit_total")
                self._absorb_payload(header, arrays)
                return self._reply_from_vector(
                    header, entry.ranks, entry.err, entry.iters,
                    cache="hit", batch_size=1, coalesced=False,
                    carrier=carrier, t_wall=t_wall,
                    dur=time.perf_counter() - t0)
            if status == "warm":
                warm_entry = entry
            global_metrics.increment("ppr.cache_miss_total")

        n_nodes = int(header.get("n_nodes") or 0)
        src = arrays.get("src")
        n_edges = int(src.shape[0]) if src is not None else 0
        if src is None and graph_key is not None:
            # a graph_key-only request ships no edges: price the resident
            # generation's counts (an unlocked peek: admission must not
            # queue behind a dispatch)
            gen = self.server._graphs.peek(graph_key)
            if gen is not None:
                n_nodes = n_nodes or gen.n_nodes
                n_edges = gen.n_edges
        est = _estimate_request_bytes(
            {**header, "algorithm": "ppr", "n_nodes": n_nodes,
             "n_edges": n_edges}, arrays, self.server.device) \
            + _lane_state_bytes(n_nodes, n_edges, 1)
        if est > self.server.hbm_budget_bytes:
            return self._shed(
                f"estimated footprint {est} bytes exceeds HBM budget "
                f"{self.server.hbm_budget_bytes} bytes")
        depth = self._queue.qsize()
        if depth >= self.max_queue:
            return self._shed(
                f"PPR coalescing queue saturated ({depth} >= "
                f"{self.max_queue} pending)")
        pending = _PprPending(header, arrays, warm_entry, carrier)
        self._ensure_thread()
        self._queue.put(pending)
        global_metrics.set_gauge("ppr.queue_depth",
                                 float(self._queue.qsize()))
        deadline_s = header.get("deadline_s")
        wait_s = float(deadline_s) if deadline_s \
            else self.server.wedge_after_s + 30.0
        if not pending.event.wait(wait_s):
            pending.abandoned = True
            self.server._count("deadline_exceeded")
            log.warning("ppr: request exceeded its %.3fs deadline in the "
                        "coalescing plane", wait_s)
            return (_failure("deadline_exceeded", True,
                             f"ppr request exceeded {wait_s}s deadline"),
                    None)
        return pending.reply, pending.out_arrays

    def _absorb_payload(self, header: dict, arrays: dict) -> None:
        """Move the key's resident generation by a hit's payload (its edge
        arrays, or its delta at a newer ``graph_version``) before the hit
        is answered.  A client ships a version's payload once: dropped
        here, the key's next payload-free request would find the old
        generation and be answered ``invalid``.  A failure is logged and
        leaves the hit standing: its vector is the version's answer
        either way."""
        if "src" not in arrays and not ("changed" in arrays
                                        and "inc_src" in arrays):
            return
        key = header.get("graph_key")
        gen = self.server._graphs.peek(key)
        if gen is not None \
                and int(header.get("graph_version") or 0) <= gen.version:
            return
        server = self.server
        did = server._dispatch_begin(server.wedge_after_s)
        try:
            with server._dispatch_lock:
                gen = server._resolve_generation(header, arrays)
                if gen is not None:
                    self._graph_versions[key] = max(
                        gen.version, self._graph_versions.get(key) or 0)
        except Exception as e:  # noqa: BLE001 — the hit stays valid
            log.warning("ppr: a hit's payload for %r was not applied "
                        "(%s: %s)", key, type(e).__name__, e)
        finally:
            server._dispatch_end(did)

    def _shed(self, why: str):
        self.server._count("shed")
        global_metrics.increment("ppr.shed_total")
        global_metrics.increment("kernel_server.admission_rejected_total")
        log.warning("ppr: SHED request: %s", why)
        return _failure("shed", False, f"AdmissionRejected: {why}"), None

    @staticmethod
    def _reply_from_vector(header, ranks, err, iters, *, cache, batch_size,
                           coalesced, topk=None, stages=None, carrier=None,
                           t_wall=None, dur=None):
        k = int(header.get("top_k") or 0)
        reply = {"ok": True, "outcome": "completed", "err": float(err),
                 "iters": int(iters), "cache": cache,
                 "batch_size": int(batch_size),
                 "coalesced": bool(coalesced)}
        if stages:
            reply["stages"] = stages
        if carrier and carrier.get("trace_id"):
            with mgtrace.adopt(carrier):
                mgtrace.record_span(
                    "kernel.dispatch", t_wall or time.time(), dur or 0.0,
                    op="ppr", batch=int(batch_size), cache=cache)
            spans = mgtrace.take_trace(carrier["trace_id"])
            if spans:
                reply["trace_spans"] = spans
        if k > 0:
            if topk is not None:
                vals, idx = topk
                vals, idx = vals[:k], idx[:k]
            else:
                vals, idx = _topk_host(np.asarray(ranks), k)
            return reply, {"topk_val": np.asarray(vals, dtype=np.float32),
                           "topk_idx": np.asarray(idx, dtype=np.int32)}
        return reply, {"ranks": np.asarray(ranks, dtype=np.float32)}

    # --- batch side (the one batcher thread) -------------------------------

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ks-ppr-batcher")
            self._thread.start()

    def _run(self) -> None:
        while not self.server._shutdown.is_set():
            try:
                first = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=max(rem, 0.0005)))
                except queue.Empty:
                    break
            global_metrics.set_gauge("ppr.queue_depth",
                                     float(self._queue.qsize()))
            groups: dict = {}
            for m in batch:
                h = m.header
                gk = (h.get("graph_key"), float(h.get("damping", 0.85)),
                      float(h.get("tol", 1e-6)),
                      int(h.get("max_iterations", 100)),
                      str(h.get("precision", "f32")))
                groups.setdefault(gk, []).append(m)
            for members in groups.values():
                try:
                    self._execute_group(members)
                except Exception:   # noqa: BLE001 — serving must survive
                    log.exception("ppr: group execution failed")
                    self._fail_group(members, "invalid", False,
                                     "internal ppr batch failure")
        # pending requests must not leave connection threads blocked
        while True:
            try:
                m = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_group([m], "invalid", False,
                             "kernel server shutting down")

    def _fail_group(self, members, outcome, retryable, error) -> None:
        """The same typed failure for every member still waiting: a
        batch answers whole or fails whole."""
        for m in members:
            if m.reply is not None:
                continue
            self.server._count(outcome)
            m.reply = _failure(outcome, retryable, error)
            m.event.set()

    def _resolve_group_graph(self, members):
        """The group's snapshot, under the dispatch lock: the member that
        can advance the resident generation furthest (full edge arrays,
        or the delta payload) resolves it."""
        key = members[0].header.get("graph_key")
        carrier = None

        def version(m):
            return int(m.header.get("graph_version") or 0)

        for m in members:
            if ("src" in m.arrays or ("changed" in m.arrays
                                      and "inc_src" in m.arrays)) \
                    and (carrier is None or version(m) > version(carrier)):
                carrier = m
        m = carrier or members[0]
        gen = self.server._resolve_generation(m.header, m.arrays)
        if gen is None:
            return None
        if key is not None:
            self._graph_versions[key] = max(
                gen.version, self._graph_versions.get(key) or 0)
        return gen.graph

    def _execute_group(self, members) -> None:
        """One parameter group: one batched fixpoint dispatch."""
        server = self.server
        did = server._dispatch_begin(server.wedge_after_s)
        global_metrics.increment("ppr.batches_total")
        global_metrics.observe("ppr.batch_size", float(len(members)))
        if len(members) > 1:
            global_metrics.increment("ppr.coalesced_total",
                                     delta=len(members))
        t0 = time.perf_counter()
        t_wall = time.time()
        acc = mgstats.StageAccumulator()
        try:
            try:
                with mgstats.collecting_stages(acc), server._dispatch_lock:
                    device_fault_point()
                    g = self._resolve_group_graph(members)
                    if g is None:
                        self._fail_group(
                            members, "invalid", False,
                            "unknown graph_key and no edge arrays supplied")
                        return
                    live, results = self._compute(g, members)
            except BaseException as e:  # noqa: BLE001 — classified here
                reply = _typed_failure(e)
                log.warning("ppr: batch of %d failed [%s]: %s",
                            len(members), reply["outcome"], e)
                self._fail_group(members, reply["outcome"],
                                 reply["retryable"], reply["error"])
                return
            dur = time.perf_counter() - t0
            global_metrics.observe("ppr.drain_s", dur)
            # the batch's device seconds split evenly over its riders, so
            # the callers' sums stay the batch's
            share = 1.0 / max(1, len(live))
            stages = {name: {"seconds": slot["seconds"] * share,
                             "count": slot["count"]}
                      for name, slot in acc.snapshot().items()}
            for m, (ranks, err, iters, cache_state, topk) in zip(live,
                                                                 results):
                m.reply, m.out_arrays = self._reply_from_vector(
                    m.header, ranks, err, iters, cache=cache_state,
                    batch_size=len(members), coalesced=len(members) > 1,
                    topk=topk, stages=stages, carrier=m.carrier,
                    t_wall=t_wall, dur=dur)
                server._count("completed")
                m.event.set()
        finally:
            server._dispatch_end(did)

    def _compute(self, g, members):
        """The group's batched fixpoint, under the dispatch lock: (live
        members, their (ranks, err, iters, cache state, top-k)).  A member
        with sources out of range is answered ``invalid`` here."""
        import torch
        from ..ops.pagerank import personalized_pagerank_batch, ppr_topk
        h0 = members[0].header
        damping = float(h0.get("damping", 0.85))
        tol = float(h0.get("tol", 1e-6))
        max_iterations = int(h0.get("max_iterations", 100))
        precision = str(h0.get("precision", "f32"))
        graph_key = h0.get("graph_key")
        version = self._graph_versions.get(graph_key, 0)

        live = []
        for m in members:
            sources = np.asarray(m.arrays["sources"], dtype=np.int64)
            if sources.size == 0 or sources.min() < 0 \
                    or sources.max() >= g.n_nodes:
                self.server._count("invalid")
                m.reply = _failure("invalid", False,
                                   f"sources out of range for graph with "
                                   f"{g.n_nodes} nodes")
                m.event.set()
                continue
            live.append(m)
        if not live:
            return [], []

        max_lanes = _ppr_chunk_lanes(g.n_nodes, g.n_edges,
                                     self.server.hbm_budget_bytes)
        n = g.n_nodes
        results = []
        for lo in range(0, len(live), max_lanes):
            chunk = live[lo:lo + max_lanes]
            b = len(chunk)
            source_sets = [np.asarray(m.arrays["sources"], dtype=np.int64)
                           for m in chunk]
            x0 = None
            warm_lanes = set()
            if any(m.warm_entry is not None
                   and len(m.warm_entry.ranks) == n for m in chunk):
                x0 = np.zeros((g.n_pad, b), dtype=np.float32)
                for lane, m in enumerate(chunk):
                    e = m.warm_entry
                    if e is not None and len(e.ranks) == n:
                        x0[:n, lane] = e.ranks
                        warm_lanes.add(lane)
                        global_metrics.increment("ppr.warm_start_total")
                    else:
                        s = source_sets[lane]
                        x0[s, lane] = np.float32(1.0) / np.float32(len(s))
            x_dev, err_dev, iter_dev = personalized_pagerank_batch(
                g, source_sets, damping=damping,
                max_iterations=max_iterations, tol=tol,
                precision=precision, x0=x0, raw=True)
            k_max = max((int(m.header.get("top_k") or 0) for m in chunk),
                        default=0)
            # the chunk's one host transfer: the lanes' vectors, errors,
            # iterations and top-k in one float32 buffer (the integers
            # travel as their bits)
            parts = [x_dev[:n, :b].T.reshape(-1), err_dev[:b],
                     iter_dev[:b].contiguous().view(torch.float32)]
            if k_max > 0:
                tv, ti = ppr_topk(x_dev.T[:b], n, k_max, raw=True)
                k = tv.shape[1]
                parts += [tv.reshape(-1),
                          ti.contiguous().view(torch.float32).reshape(-1)]
            host = torch.cat(parts).cpu().numpy()
            ranks = host[:b * n].reshape(b, n)
            errs = host[b * n:b * n + b]
            iters = host[b * n + b:b * n + 2 * b].view(np.int32)
            tvals = tidx = None
            if k_max > 0:
                off = b * n + 2 * b
                tvals = host[off:off + b * k].reshape(b, k)
                tidx = host[off + b * k:].view(np.int32).reshape(b, k)
            for lane, m in enumerate(chunk):
                vec = np.ascontiguousarray(ranks[lane])
                if graph_key is not None:
                    t1 = time.perf_counter()
                    neigh = _source_neighborhood(g, m.arrays["sources"])
                    global_metrics.observe("ppr.neighborhood_s",
                                           time.perf_counter() - t1)
                    self.cache.insert(
                        self.cache.key(graph_key, m.arrays["sources"],
                                       damping, tol, precision),
                        _PprCacheEntry(version, vec, float(errs[lane]),
                                       int(iters[lane]), neigh))
                topk = (tvals[lane], tidx[lane]) \
                    if tvals is not None else None
                results.append((vec, float(errs[lane]), int(iters[lane]),
                                "warm" if lane in warm_lanes else "miss",
                                topk))
        return live, results


# --------------------------------------------------------------------------
# the resident algorithms
# --------------------------------------------------------------------------

#: algorithm -> (reply array, its dtype, whether the reply has err and
#: precision); each rides the generation's hits and warm seeds
_RESIDENT = {
    "pagerank": ("ranks", np.float32, True),
    "katz": ("ranks", np.float32, True),
    "wcc": ("components", np.int32, False),
    "labelprop": ("labels", np.int32, False),
}


def _params_key(algorithm: str, header: dict) -> tuple:
    """The parameters a stored solution must share to answer a request
    (the reference's keys)."""
    precision = str(header.get("precision", "f32"))
    if algorithm == "pagerank":
        return ("pagerank", float(header.get("damping", 0.85)),
                float(header.get("tol", 1e-6)), precision)
    if algorithm == "katz":
        return ("katz", float(header.get("alpha", 0.2)),
                float(header.get("beta", 1.0)),
                float(header.get("tol", 1e-6)), precision)
    if algorithm == "wcc":
        return ("wcc",)
    return ("labelprop", float(header.get("self_weight", 0.0)),
            bool(header.get("directed", False)))


def run_algorithm(graph, algorithm: str, header: dict, x0=None,
                  device=None):
    """One resident algorithm on a snapshot with a request's parameters
    (the reference's keys and defaults): (host answer, err or None,
    iterations)."""
    max_iterations = int(header.get("max_iterations", 100))
    precision = str(header.get("precision", "f32"))
    if algorithm == "pagerank":
        from ..ops.pagerank import pagerank
        x, err, iters = pagerank(
            graph, damping=float(header.get("damping", 0.85)),
            max_iterations=max_iterations,
            tol=float(header.get("tol", 1e-6)), precision=precision, x0=x0,
            device=device)
    elif algorithm == "katz":
        from ..ops.katz import katz_centrality
        x, err, iters = katz_centrality(
            graph, alpha=float(header.get("alpha", 0.2)),
            beta=float(header.get("beta", 1.0)),
            max_iterations=max_iterations,
            tol=float(header.get("tol", 1e-6)), precision=precision, x0=x0,
            device=device)
    elif algorithm == "wcc":
        from ..ops.components import weakly_connected_components
        x, iters = weakly_connected_components(
            graph, max_iterations=max_iterations, comp0=x0, device=device)
        err = None
    elif algorithm == "labelprop":
        from ..ops.labelprop import label_propagation
        x, iters = label_propagation(
            graph, max_iterations=max_iterations,
            self_weight=float(header.get("self_weight", 0.0)),
            directed=bool(header.get("directed", False)), labels0=x0,
            device=device)
        err = None
    elif algorithm == "bfs":
        from ..ops.traversal import bfs_levels
        x, iters = bfs_levels(graph, int(header.get("source", 0)),
                              max_iterations=max_iterations, device=device)
        err = None
    else:
        raise ValueError(f"unknown semiring algorithm {algorithm!r}")
    if hasattr(x, "cpu"):
        x = x.cpu().numpy()
    dtype = np.int32 if algorithm in ("wcc", "labelprop", "bfs") \
        else np.float32
    return (np.asarray(x, dtype=dtype),
            None if err is None else float(err), int(iters))


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------


class KernelServer:
    """One thread per connection; device dispatches serialized by
    ``_dispatch_lock`` (one card).  Every supervised dispatch runs on a
    worker thread under its deadline, and the ``health`` op, which never
    takes the dispatch lock, reports an overdue one."""

    MAX_CACHED_GRAPHS = 8     # resident generations (LRU)

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 idle_timeout_s: float = 0.0,
                 hbm_budget_bytes: int | None = None,
                 wedge_after_s: float = 60.0,
                 device=None, checkpoint_every: int | None = None) -> None:
        from ..device import resolve_device
        from ..ops.delta import ResidentRegistry
        self.socket_path = socket_path
        self.idle_timeout_s = idle_timeout_s
        self.device = resolve_device(device)
        self.hbm_budget_bytes = hbm_budget_bytes \
            if hbm_budget_bytes is not None \
            else _resolve_hbm_budget(self.device)
        self.checkpoint_every = checkpoint_every \
            if checkpoint_every is not None else _resolve_checkpoint_every()
        self.wedge_after_s = wedge_after_s
        # written only under _dispatch_lock (admission peeks)
        self._graphs = ResidentRegistry(self.MAX_CACHED_GRAPHS)
        self._dispatch_lock = threading.Lock()
        self._shutdown = threading.Event()
        # leaf locks, never held across a dispatch: health must not wait
        # behind a stalled card
        self._activity_lock = threading.Lock()
        self._last_activity = time.monotonic()
        self._stats_lock = threading.Lock()
        self._active: dict[int, tuple[float, float | None]] = {}
        self._dispatch_seq = 0
        self._graphs_cached = 0
        self._modeled_peaks: dict = {}
        self._started = time.monotonic()
        self._platform = "unknown"
        self._sock_ino = None        # inode of OUR bound socket path
        global_metrics.set_gauge("kernel_server.hbm_budget_bytes",
                                 float(self.hbm_budget_bytes))
        global_metrics.set_gauge("kernel_server.hbm_modeled_peak_bytes",
                                 0.0)
        self._ppr = PprServingPlane(self)

    def _touch_activity(self) -> None:
        with self._activity_lock:
            self._last_activity = time.monotonic()

    def _idle_for(self) -> float:
        with self._activity_lock:
            return time.monotonic() - self._last_activity

    def _warm(self) -> None:
        """Touch the device, and on the card load the kernels and the
        native builders, so that the first request pays no start-up."""
        if self.device.type == "cuda":
            from ..ops._build import load_kernels
            from ..ops.native import get_csr_builder, get_router
            load_kernels()
            get_router()
            get_csr_builder()
        _, platform = probe_device(self.device)
        with self._stats_lock:
            self._platform = platform

    def serve_forever(self) -> None:
        import errno
        # never unlink before bind: a live responder on the path means
        # another daemon won the spawn race; only a path nobody answers
        # on is reclaimed, and shutdown unlinks only our own inode
        try:
            probe = KernelClient(self.socket_path, timeout=5.0)
            alive = probe.ping()
            probe.close()
            if alive:
                return
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(self.socket_path)
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
            srv.bind(self.socket_path)
        try:
            self._sock_ino = os.stat(self.socket_path).st_ino
        except OSError:
            self._sock_ino = None
        # bursts of concurrent clients must not bounce off the backlog
        srv.listen(128)
        self._warm()
        self._touch_activity()
        srv.settimeout(1.0)
        while not self._shutdown.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if self.idle_timeout_s and \
                        self._idle_for() > self.idle_timeout_s:
                    break
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        self._shutdown.set()
        srv.close()
        try:
            if self._sock_ino is not None and \
                    os.stat(self.socket_path).st_ino == self._sock_ino:
                os.unlink(self.socket_path)
        except OSError:
            pass

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    header, arrays = _recv_msg(conn)
                except (ConnectionError, struct.error, OSError,
                        ValueError):
                    # a garbage header or a closed peer drops the
                    # connection, not the serving thread
                    return
                self._touch_activity()
                op = header.get("op")
                try:
                    if op == "ping":
                        _send_msg(conn, {"ok": True, "pid": os.getpid()})
                    elif op == "health":
                        _send_msg(conn, self._health_reply())
                    elif op == "shutdown":
                        _send_msg(conn, {"ok": True})
                        self._shutdown.set()
                        return
                    elif op == "ppr":
                        reply, out_arrays = self._ppr.submit(header, arrays)
                        _send_msg(conn, reply, out_arrays)
                    elif op in ("pagerank", "semiring", "probe", "lane"):
                        # the reply ships after the dispatch lock is
                        # released: a slow client holds up no dispatch
                        reply, out_arrays = self._supervised(op, header,
                                                             arrays)
                        _send_msg(conn, reply, out_arrays)
                    else:
                        _send_msg(conn, {"ok": False, "outcome": "invalid",
                                         "error": f"unknown op {op!r}"})
                except KernelServerError as e:
                    try:
                        _send_msg(conn, _failure(e.outcome, e.retryable,
                                                 str(e)))
                    except (OSError, ValueError, struct.error):
                        return
                except Exception as e:  # noqa: BLE001 — report, continue
                    try:
                        _send_msg(conn, {"ok": False, "outcome": "invalid",
                                         "error": str(e)})
                    except (OSError, ValueError, struct.error):
                        return
        finally:
            conn.close()

    # --- supervised dispatch ----------------------------------------------

    def _count(self, outcome: str) -> None:
        global_metrics.increment(f"kernel_server.dispatch.{outcome}_total")

    def _dispatch_begin(self, deadline_s) -> int:
        with self._stats_lock:
            self._dispatch_seq += 1
            did = self._dispatch_seq
            self._active[did] = (time.monotonic(), deadline_s)
            global_metrics.set_gauge("kernel_server.in_flight",
                                     float(len(self._active)))
        return did

    def _dispatch_end(self, did: int) -> None:
        with self._stats_lock:
            self._active.pop(did, None)
            global_metrics.set_gauge("kernel_server.in_flight",
                                     float(len(self._active)))

    def _supervised(self, op: str, header: dict, arrays: dict):
        """Admission, then the dispatch on a worker thread under the
        request's deadline, then the typed outcome."""
        est = _estimate_request_bytes(header, arrays, self.device, op)
        if op in ("pagerank", "semiring"):
            est = self._admit_graph_op(op, header, arrays, est)
        if est > self.hbm_budget_bytes:
            self._count("shed")
            global_metrics.increment(
                "kernel_server.admission_rejected_total")
            log.warning("kernel_server: SHED %s request: estimated "
                        "footprint %d bytes exceeds HBM budget %d bytes",
                        op, est, self.hbm_budget_bytes)
            return (_failure("shed", False,
                             f"AdmissionRejected: estimated footprint "
                             f"{est} bytes exceeds HBM budget "
                             f"{self.hbm_budget_bytes} bytes"), None)

        deadline_s = header.get("deadline_s")
        deadline_s = float(deadline_s) if deadline_s else None
        carrier = header.pop("trace", None)
        did = self._dispatch_begin(deadline_s or self.wedge_after_s)
        box: dict = {}
        t_dispatch = time.perf_counter()

        def work():
            try:
                # the activation is thread-local: the worker adopts the
                # remote context itself; the accumulator's snapshot ships
                # home in the reply
                acc = mgstats.StageAccumulator()
                with mgstats.collecting_stages(acc), \
                        mgtrace.adopt(carrier), \
                        mgtrace.span("kernel.dispatch", op=op,
                                     pid=os.getpid()), \
                        self._dispatch_lock:
                    device_fault_point()
                    box["result"] = self._dispatch_op(op, header, arrays)
                box["stages"] = acc.snapshot()
            except BaseException as e:  # noqa: BLE001 — classified below
                box["exc"] = e
            finally:
                self._dispatch_end(did)

        def ship_trace(reply: dict) -> dict:
            """This dispatch's spans and stage extents, on the reply."""
            if carrier and carrier.get("trace_id"):
                spans = mgtrace.take_trace(carrier["trace_id"])
                if spans:
                    reply["trace_spans"] = spans
            if box.get("stages"):
                reply["stages"] = box["stages"]
            return reply

        t = threading.Thread(target=work, daemon=True,
                             name=f"ks-dispatch-{did}")
        t.start()
        t.join(deadline_s)
        if t.is_alive():
            # overdue: it stays in _active, so health reports the server
            # as wedged until it ends
            self._count("deadline_exceeded")
            log.warning("kernel_server: dispatch %d (%s) exceeded its "
                        "%.3fs deadline: device possibly wedged", did, op,
                        deadline_s)
            return (_failure("deadline_exceeded", True,
                             f"dispatch exceeded {deadline_s}s deadline"),
                    None)
        global_metrics.observe("kernel_server.dispatch_latency_sec",
                               time.perf_counter() - t_dispatch)
        if "exc" in box:
            reply = _typed_failure(box["exc"])
            self._count(reply["outcome"])
            log.warning("kernel_server: dispatch %d (%s) failed [%s]: %s",
                        did, op, reply["outcome"], box["exc"])
            return ship_trace(reply), None
        reply, out_arrays = box["result"]
        if reply.get("ok", True):
            reply.setdefault("outcome", "completed")
        else:
            reply.setdefault("outcome", "invalid")
        self._count(reply["outcome"])
        return ship_trace(reply), out_arrays

    def _admit_graph_op(self, op: str, header: dict, arrays: dict,
                        est: int) -> int:
        """The three verdicts of a graph-shaped request: its estimate
        priced on the wire's edges, or a graph_key-only request's on the
        resident generation's current counts (an unlocked peek: admission
        must not wait behind a dispatch); over the budget a streamable
        request whose streamed working set fits is marked streamed and
        priced at that.  Returns the estimate of the chosen mode."""
        from ..ops import tier as mgtier
        algorithm = "pagerank" if op == "pagerank" \
            else str(header.get("algorithm", "pagerank"))
        n_nodes = int(header.get("n_nodes") or 0)
        n_edges = int(arrays["src"].shape[0]) if "src" in arrays else 0
        if "src" not in arrays:
            gen = self._graphs.peek(header.get("graph_key"))
            if gen is not None:
                n_nodes = n_nodes or gen.n_nodes
                n_edges = gen.n_edges
                est = max(est, _graph_footprint_bytes(
                    algorithm, n_nodes, n_edges, self.device, op))
        verdict, est_run = mgtier.admission_verdict(
            est, self.hbm_budget_bytes, n_nodes=n_nodes, n_edges=n_edges,
            streamable=algorithm in _STREAMABLE,
            precision=_tier_precision(header.get("precision", "f32")),
            algorithm=algorithm)
        global_metrics.increment(f"tier.admission_{verdict}_total")
        if verdict != "streamed":
            return est
        header["_tier_streamed"] = True
        log.info("kernel_server: STREAMED %s request: resident estimate %d "
                 "bytes exceeds the budget %d, the streamed working set %d "
                 "bytes fits", op, est, self.hbm_budget_bytes, est_run)
        return est_run

    def _dispatch_op(self, op: str, header: dict, arrays: dict):
        """Under _dispatch_lock, on the worker thread."""
        if op == "probe":
            checksum, platform = probe_device(self.device)
            return {"ok": True, "platform": platform, "sum": checksum}, None
        if op == "lane":
            return self._op_lane(header, arrays)
        if op == "pagerank":
            return self._op_semiring({**header, "algorithm": "pagerank"},
                                     arrays, mesh_route=True)
        return self._op_semiring(header, arrays)

    def _mesh(self):
        """The mesh the resident mesh routes run on: the environment's
        (``analytics_mesh``), else a mesh of 1 on the daemon's device."""
        from ..parallel.mesh import analytics_mesh, get_mesh_context
        return analytics_mesh(self.device) or get_mesh_context(
            1, device=self.device)

    def _mesh_pagerank(self, gen, header, x0, params_key):
        """The ``pagerank`` op's compute: the partition-centric loop over
        the generation's sharded variant (the snapshot stays lazy: a
        commit costs O(delta)), checkpointed every ``checkpoint_every``
        iterations under the job key ``kernel_server:pagerank:<key>``
        with the generation's version, the parameters and the iteration
        budget: a run that raised leaves a checkpoint that only a request
        of the same graph and parameters resumes."""
        from ..parallel.distributed import pagerank_partition_centric
        ctx = self._mesh()
        key = header.get("graph_key")
        max_iterations = int(header.get("max_iterations", 100))
        if key:
            key = f"{key}:{gen.version}:{params_key}:{max_iterations}"
        scsr = gen.ensure_sharded(ctx, by="src")
        with backend_extent("mesh"):
            ranks, err, iters = pagerank_partition_centric(
                scsr, ctx, damping=float(header.get("damping", 0.85)),
                max_iterations=max_iterations,
                tol=float(header.get("tol", 1e-6)),
                precision=str(header.get("precision", "f32")), x0=x0,
                checkpoint_every=self.checkpoint_every,
                job=f"kernel_server:pagerank:{key}" if key else None)
        return ranks.cpu().numpy().astype(np.float32), err, iters

    def _health_reply(self) -> dict:
        """Liveness, the wedge verdict and the counters; never takes the
        dispatch lock.  Besides the reference's fields it ships this
        process's kernel launches (``launches``) and plan builds
        (``plans``: full builds and delta plans), which a client in
        another process cannot read otherwise."""
        from ..ops import spmv_mxu
        now = time.monotonic()
        with self._stats_lock:
            entries = list(self._active.values())
            cached = self._graphs_cached
            platform = self._platform
            peaks = dict(self._modeled_peaks)
        ages = [now - t0 for t0, _dl in entries]
        wedged = any(dl is not None and now - t0 > dl
                     for t0, dl in entries)
        counters = {name: value for name, _kind, value
                    in global_metrics.snapshot()
                    if name.startswith(("kernel_server.", "analytics.",
                                        "ppr.", "delta.", "lane.",
                                        "tier."))}
        reply = {"ok": True, "pid": os.getpid(),
                 "uptime_s": round(now - self._started, 3),
                 "in_flight": len(entries),
                 "oldest_dispatch_s": round(max(ages, default=0.0), 3),
                 "wedged": wedged,
                 "graphs_cached": cached,
                 "hbm_budget_bytes": self.hbm_budget_bytes,
                 "memory": {
                     "hbm_budget_bytes": self.hbm_budget_bytes,
                     "modeled_peak_bytes": sum(peaks.values()),
                     "headroom_bytes": self.hbm_budget_bytes
                     - sum(peaks.values()),
                     "resident_generations": peaks,
                 },
                 "wedge_after_s": self.wedge_after_s,
                 "platform": platform,
                 "device": str(self.device),
                 "launches": kernel_launches(),
                 "plans": dict(spmv_mxu.plan_counts),
                 "counters": counters}
        if self.device.type == "cuda":
            import torch
            reply["memory"]["allocated_bytes"] = \
                torch.cuda.memory_allocated(self.device)
            reply["memory"]["peak_allocated_bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
        return reply

    def _update_memory_gauge(self) -> None:
        """The modeled-peak gauge and the per-generation snapshot health
        serves; under the caller's _dispatch_lock."""
        peaks = {str(key): _generation_modeled_bytes(g)
                 for key, g in self._graphs.items()}
        global_metrics.set_gauge("kernel_server.hbm_modeled_peak_bytes",
                                 float(sum(peaks.values())))
        with self._stats_lock:
            self._modeled_peaks = peaks
            self._graphs_cached = len(self._graphs)

    def _resolve_generation(self, header, arrays, place: bool = True):
        """The request's resident generation, under _dispatch_lock: the
        key's generation, moved O(delta) when the request is at a newer
        ``graph_version`` with the delta payload on its
        ``base_version``; a stale generation without a usable delta is
        dropped and re-imported from the request's edge arrays (never
        served); a new key imports them with the snapshot on the host,
        placed on the device at its first read unless ``place`` is False
        (a streamed run keeps its edges on the host; the mesh routes read
        the sharded variants, never the snapshot).  None: nothing to run
        on (the caller answers invalid)."""
        from ..ops import delta as mgdelta
        from ..ops.csr import from_coo
        key = header.get("graph_key")
        want = header.get("graph_version")
        gen = self._graphs.get(key) if key else None
        if gen is not None and want is not None and int(want) > gen.version:
            base = header.get("base_version")
            applied = False
            if header.get("has_delta") \
                    and header.get("ids_stable", True) \
                    and base is not None and int(base) == gen.version \
                    and "changed" in arrays and "inc_src" in arrays:
                d = mgdelta.diff_incident(
                    gen.coo, arrays["changed"], arrays["inc_src"],
                    arrays["inc_dst"], arrays.get("inc_w"), gen.n_nodes,
                    int(base), int(want))
                applied = gen.apply(d)
            if not applied:
                self._graphs.pop(key)
                gen = None
            self._update_memory_gauge()
        if gen is None:
            if "src" not in arrays:
                return None
            g = from_coo(arrays["src"].astype(np.int64),
                         arrays["dst"].astype(np.int64),
                         arrays.get("weights"),
                         n_nodes=header.get("n_nodes"))
            gen = mgdelta.ResidentGraph(
                key, int(want or 0), g, device=self.device if place else None)
            if key:
                self._graphs.put(gen)
                self._update_memory_gauge()
        return gen

    def _op_semiring(self, header, arrays, mesh_route: bool = False):
        """A resident algorithm over the request's generation, under
        _dispatch_lock: a hit returns the stored bytes, a moved
        generation seeds the fixpoint under the contract; ``bfs`` is
        source-dependent and runs cold, on the mesh over the generation's
        sharded variant.  ``mesh_route`` (the ``pagerank`` op) computes a
        resident PageRank by ``_mesh_pagerank``; its solutions are keyed
        apart from the ``semiring`` op's, whose pagerank sums in another
        order."""
        from ..ops import delta as mgdelta
        streamed = bool(header.pop("_tier_streamed", False))
        gen = self._resolve_generation(header, arrays, place=not streamed)
        if gen is None:
            return ({"ok": False, "error": "unknown graph_key and no edge "
                     "arrays supplied"}, None)
        algorithm = str(header.get("algorithm", "pagerank"))
        precision = str(header.get("precision", "f32"))
        max_iterations = int(header.get("max_iterations", 100))
        if algorithm == "bfs":
            from ..parallel.analytics import bfs_partition_centric
            ctx = self._mesh()
            scsr = gen.ensure_sharded(ctx, by="src")
            with backend_extent("mesh"):
                levels, iters = bfs_partition_centric(
                    scsr, ctx, int(header.get("source", 0)),
                    max_iterations=max_iterations, precision=precision,
                    checkpoint_every=self.checkpoint_every)
            return ({"ok": True, "iters": int(iters),
                     "algorithm": algorithm, "precision": precision},
                    {"levels": np.asarray(levels, dtype=np.int32)})
        if algorithm not in _RESIDENT:
            return ({"ok": False,
                     "error": f"unknown semiring algorithm {algorithm!r}"},
                    None)
        name, dtype, has_err = _RESIDENT[algorithm]
        params_key = _params_key(algorithm, header)
        if mesh_route:
            params_key += ("op", "pagerank")
        reply = {"ok": True, "algorithm": algorithm,
                 "graph_version": gen.version}
        if has_err:
            reply["precision"] = precision
        hit = gen.cached_result(algorithm, params_key, max_iterations)
        if hit is not None:
            reply.update(iters=int(hit.iters or 0), cache="hit",
                         warm_started=True)
            if has_err:
                reply["err"] = float(hit.err or 0.0)
            return reply, {name: np.asarray(hit.x, dtype=dtype)}
        x0, _reason = gen.warm_x0(algorithm, params_key)
        if streamed:
            # the snapshot is never built: the paging plan comes straight
            # off the generation's host COO
            x, err, iters = run_streamed(gen, algorithm, header, x0,
                                         self.device)
        elif mesh_route:
            x, err, iters = self._mesh_pagerank(gen, header, x0, params_key)
        else:
            x, err, iters = run_algorithm(gen.graph, algorithm, header, x0,
                                          self.device)
        gen.note_solution(algorithm, params_key, x, err=err, iters=iters,
                          max_iterations=max_iterations)
        if x0 is not None:
            mgdelta.record_warm_start(algorithm, iters)
        reply.update(iters=iters, warm_started=x0 is not None,
                     tier="streamed" if streamed else "resident")
        if has_err:
            reply["err"] = float(err)
        return reply, {name: x}

    def _op_lane(self, header, arrays):
        """The read lane's hop count over the request's edges and masks
        (ops/pipeline.py ``hop_counts``, the in-process lane's program),
        under _dispatch_lock.  A refusal of the exactness witness answers
        invalid with its reason; a kernel's failure raises on, to its
        typed outcome."""
        from ..ops import pipeline as pl
        for need in ("src", "dst", "emask", "smask", "midmask", "tmask"):
            if need not in arrays:
                return ({"ok": False,
                         "error": f"lane op needs array {need!r}"}, None)
        global_metrics.increment("lane.remote_dispatch_total")
        try:
            totals = pl.hop_counts(
                arrays["src"], arrays["dst"], arrays["emask"],
                arrays["smask"], arrays["midmask"], arrays["tmask"],
                int(header.get("n_nodes", len(arrays["smask"]))),
                hops=int(header.get("hops", 2)),
                include_lower=bool(header.get("include_lower", False)),
                edge_unique=bool(header.get("edge_unique", True)),
                need_rows=bool(header.get("need_rows", True)),
                need_distinct=bool(header.get("need_distinct", False)),
                fingerprint=header.get("fingerprint"), device=self.device)
        except pl.LaneRefused as e:
            return ({"ok": False, "outcome": "invalid",
                     "lane_refused": e.reason,
                     "error": f"lane refused: {e.reason}"}, None)
        return ({"ok": True, **totals}, None)


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------


def _serving_arrays(arrays: dict, changed, inc_src, inc_dst,
                    inc_w) -> None:
    """Attach the delta payload: the change log's dense changed ids and
    those vertices' current incident edges."""
    if changed is not None:
        arrays["changed"] = np.asarray(changed, dtype=np.int32)
    if inc_src is not None:
        arrays["inc_src"] = np.asarray(inc_src, dtype=np.int64)
        arrays["inc_dst"] = np.asarray(inc_dst, dtype=np.int64)
        if inc_w is not None:
            arrays["inc_w"] = np.asarray(inc_w, dtype=np.float32)


def _graph_arrays(src, dst, weights) -> dict:
    arrays = {}
    if src is not None:
        arrays["src"] = np.asarray(src, dtype=np.int64)
        arrays["dst"] = np.asarray(dst, dtype=np.int64)
        if weights is not None:
            arrays["weights"] = np.asarray(weights, dtype=np.float32)
    return arrays


def _version_fields(header: dict, graph_version, base_version, ids_stable,
                    changed) -> None:
    if graph_version is not None:
        header["graph_version"] = int(graph_version)
        header["base_version"] = base_version
        header["ids_stable"] = bool(ids_stable)
        header["has_delta"] = changed is not None


class KernelClient:
    """One connection to a kernel server."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout: float = 300.0) -> None:
        self.socket_path = socket_path
        self.process = None       # the daemon's Popen, when we spawned it
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        try:
            self._sock.connect(socket_path)
        except OSError:
            self._sock.close()
            raise

    def settimeout(self, timeout: float | None) -> None:
        self._sock.settimeout(timeout)

    def call(self, header: dict, arrays=None):
        _send_msg(self._sock, header, arrays)
        h, out = _recv_msg(self._sock)
        # the spans the daemon recorded for this trace, and the
        # dispatch's stage extents, join the caller's
        spans = h.pop("trace_spans", None)
        if spans:
            mgtrace.adopt_spans(spans)
        mgstats.merge_stages(h.pop("stages", None))
        return h, out

    def ping(self) -> bool:
        try:
            h, _ = self.call({"op": "ping"})
            return bool(h.get("ok"))
        except (OSError, ConnectionError):
            return False

    def health(self) -> dict:
        h, _ = self.call({"op": "health"})
        return h

    def probe(self) -> dict:
        """The typed device probe on the daemon."""
        header = {"op": "probe"}
        _inject_trace(header)
        h, _ = self.call(header)
        return h

    def pagerank(self, src=None, dst=None, weights=None, n_nodes=None,
                 graph_key=None, deadline_s=None, graph_version=None,
                 base_version=None, ids_stable=True, changed=None,
                 inc_src=None, inc_dst=None, inc_w=None, **params):
        """(ranks, err, iters) on the daemon; ``graph_version`` /
        ``base_version`` / ``changed`` / ``inc_*`` are the delta
        protocol (the server's ``_resolve_generation``)."""
        h, out = self.call_pagerank(
            src=src, dst=dst, weights=weights, n_nodes=n_nodes,
            graph_key=graph_key, deadline_s=deadline_s,
            graph_version=graph_version, base_version=base_version,
            ids_stable=ids_stable, changed=changed, inc_src=inc_src,
            inc_dst=inc_dst, inc_w=inc_w, **params)
        return out["ranks"], h["err"], h["iters"]

    def call_pagerank(self, src=None, dst=None, weights=None, n_nodes=None,
                      graph_key=None, deadline_s=None, graph_version=None,
                      base_version=None, ids_stable=True, changed=None,
                      inc_src=None, inc_dst=None, inc_w=None, **params):
        """``pagerank`` with its whole reply: (header, arrays)."""
        arrays = _graph_arrays(src, dst, weights)
        _serving_arrays(arrays, changed, inc_src, inc_dst, inc_w)
        header = {"op": "pagerank", "graph_key": graph_key,
                  "n_nodes": n_nodes, **params}
        _version_fields(header, graph_version, base_version, ids_stable,
                        changed)
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        _inject_trace(header)
        h, out = self.call(header, arrays)
        if not h.get("ok"):
            _raise_for_reply(h)
        return h, out

    def ppr(self, sources, src=None, dst=None, weights=None, n_nodes=None,
            graph_key=None, graph_version=0, base_version=None,
            ids_stable=True, changed=None, inc_src=None, inc_dst=None,
            inc_w=None, top_k=0, damping=0.85, tol=1e-6,
            max_iterations=100, precision="f32", deadline_s=None):
        """One PPR through the coalescing plane: (reply header, arrays),
        the arrays ``ranks`` (top_k 0) or ``topk_val`` / ``topk_idx``."""
        arrays = {"sources": np.asarray(sources, dtype=np.int32),
                  **_graph_arrays(src, dst, weights)}
        _serving_arrays(arrays, changed, inc_src, inc_dst, inc_w)
        header = {"op": "ppr", "graph_key": graph_key, "n_nodes": n_nodes,
                  "graph_version": int(graph_version),
                  "base_version": base_version,
                  "ids_stable": bool(ids_stable),
                  "has_delta": changed is not None,
                  "damping": float(damping), "tol": float(tol),
                  "max_iterations": int(max_iterations),
                  "precision": str(precision), "top_k": int(top_k)}
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        _inject_trace(header)
        h, out = self.call(header, arrays)
        if not h.get("ok"):
            _raise_for_reply(h)
        return h, out

    def semiring(self, algorithm: str = "pagerank", src=None, dst=None,
                 weights=None, n_nodes=None, graph_key=None,
                 precision: str = "f32", deadline_s=None,
                 graph_version=None, base_version=None, ids_stable=True,
                 changed=None, inc_src=None, inc_dst=None, inc_w=None,
                 **params):
        """A resident algorithm on the daemon: (reply header, arrays);
        pagerank / katz give ``ranks``, wcc ``components``, labelprop
        ``labels``, bfs ``levels``."""
        arrays = _graph_arrays(src, dst, weights)
        _serving_arrays(arrays, changed, inc_src, inc_dst, inc_w)
        header = {"op": "semiring", "algorithm": algorithm,
                  "graph_key": graph_key, "n_nodes": n_nodes,
                  "precision": precision, **params}
        _version_fields(header, graph_version, base_version, ids_stable,
                        changed)
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        _inject_trace(header)
        h, out = self.call(header, arrays)
        if not h.get("ok"):
            _raise_for_reply(h)
        return h, out

    def lane_hops(self, src, dst, emask, smask, midmask, tmask, *,
                  n_nodes, hops=2, include_lower=False, edge_unique=True,
                  need_rows=True, need_distinct=False, deadline_s=None,
                  fingerprint=None) -> dict:
        """One read-lane hop count on the daemon: {"rows": n, "distinct":
        n} per the request's flags.  A refusal raises the lane's
        ``LaneRefused`` with its reason, as the in-process lane does."""
        from ..ops.pipeline import LaneRefused
        arrays = {"src": np.asarray(src, dtype=np.int32),
                  "dst": np.asarray(dst, dtype=np.int32),
                  "emask": np.asarray(emask, dtype=bool),
                  "smask": np.asarray(smask, dtype=bool),
                  "midmask": np.asarray(midmask, dtype=np.float32),
                  "tmask": np.asarray(tmask, dtype=np.float32)}
        header = {"op": "lane", "n_nodes": int(n_nodes), "hops": int(hops),
                  "include_lower": bool(include_lower),
                  "edge_unique": bool(edge_unique),
                  "need_rows": bool(need_rows),
                  "need_distinct": bool(need_distinct),
                  "fingerprint": fingerprint}
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        _inject_trace(header)
        h, _out = self.call(header, arrays)
        if not h.get("ok"):
            if h.get("lane_refused"):
                raise LaneRefused(h["lane_refused"], h.get("error", ""))
            _raise_for_reply(h)
        return {k: int(v) for k, v in h.items()
                if k in ("rows", "distinct")}

    def shutdown(self) -> None:
        try:
            self.call({"op": "shutdown"})
        except (OSError, ConnectionError):
            pass

    def close(self) -> None:
        self._sock.close()


# --------------------------------------------------------------------------
# client-side supervisor
# --------------------------------------------------------------------------


class SupervisedKernelClient:
    """The client half of the resilience contract: idempotent requests
    retry under a ``RetryPolicy``; a lost connection (a daemon that died)
    respawns the daemon through ``ensure_server`` when ``spawn`` is set;
    ``check_once`` (and the optional health loop) restarts a wedged or
    unreachable daemon (SIGKILL, then the next call respawns it); shed and
    oom propagate at once."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 retry: RetryPolicy | None = None,
                 spawn_timeout_s: float = 120.0,
                 idle_timeout_s: float = 900.0,
                 deadline_s: float | None = None,
                 spawn: bool = True, device: str = "cuda") -> None:
        self.socket_path = socket_path
        self.retry = retry or RetryPolicy(
            base_delay=0.2, max_delay=2.0, max_retries=4,
            attempt_timeout=300.0)
        self.spawn_timeout_s = spawn_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.deadline_s = deadline_s
        self.spawn = spawn
        self.device = device
        # a leaf lock over (client, pid): socket I/O happens outside it
        self._state_lock = threading.Lock()
        self._client: KernelClient | None = None
        self._pid: int | None = None
        self._stop = threading.Event()
        self._health_thread = None

    # --- connection management ---------------------------------------------

    def _install(self, client: KernelClient | None):
        with self._state_lock:
            old, self._client = self._client, client
        if old is not None:
            try:
                old.close()
            except OSError as e:
                log.debug("closing stale kernel client: %s", e)
        return client

    def _current(self) -> KernelClient | None:
        with self._state_lock:
            return self._client

    def _set_pid(self, pid: int | None) -> None:
        with self._state_lock:
            self._pid = pid

    def _get_pid(self) -> int | None:
        with self._state_lock:
            return self._pid

    def _connect(self) -> KernelClient:
        c = self._current()
        if c is not None:
            return c
        timeout = self.retry.attempt_timeout or 300.0
        if self.spawn:
            c = ensure_server(self.socket_path,
                              spawn_timeout_s=self.spawn_timeout_s,
                              idle_timeout_s=self.idle_timeout_s,
                              device=self.device)
            if c is None:
                raise ConnectionError(
                    "kernel server spawn starved (no responder within "
                    f"{self.spawn_timeout_s}s)")
            c.settimeout(timeout)
        else:
            c = KernelClient(self.socket_path, timeout=timeout)
        try:
            h, _ = c.call({"op": "ping"})
            self._set_pid(h.get("pid"))
        except (OSError, ConnectionError) as e:
            log.debug("post-connect ping failed: %s", e)
        return self._install(c)

    def _drop(self) -> None:
        self._install(None)

    # --- supervision --------------------------------------------------------

    def health(self, timeout: float = 5.0) -> dict | None:
        """The daemon's health over a fresh connection, or None when
        nothing answers."""
        try:
            c = KernelClient(self.socket_path, timeout=timeout)
        except OSError:
            return None
        try:
            return c.health()
        except (OSError, ConnectionError):
            return None
        finally:
            c.close()

    def check_once(self) -> str:
        """One supervision round: "ok", or "restarted" after a wedged or
        unreachable daemon was killed."""
        global_metrics.increment(
            "kernel_server.supervisor.health_checks_total")
        h = self.health()
        if h is None:
            self.restart_server(reason="unreachable")
            return "restarted"
        if h.get("wedged"):
            global_metrics.increment(
                "kernel_server.supervisor.wedge_detected_total")
            self.restart_server(reason="wedged", pid=h.get("pid"))
            return "restarted"
        self._set_pid(h.get("pid"))
        return "ok"

    def restart_server(self, reason: str = "manual",
                       pid: int | None = None) -> None:
        """Kill the daemon and let the next call respawn it (its
        stale-socket reclaim makes the SIGKILL safe)."""
        pid = pid or self._get_pid()
        self._drop()
        self._set_pid(None)
        if pid and pid != os.getpid():
            try:
                os.kill(pid, signal.SIGKILL)
            except (OSError, ProcessLookupError) as e:
                log.debug("kernel server pid %s already gone: %s", pid, e)
        global_metrics.increment("kernel_server.supervisor.restarts_total")
        log.warning("kernel_server supervisor: restarting server "
                    "(reason=%s pid=%s)", reason, pid)

    def start_health_loop(self, interval_s: float = 5.0) -> None:
        """A background ``check_once`` every ``interval_s``; idempotent."""
        if self._health_thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001 — supervision survives
                    log.exception("kernel_server supervisor health check "
                                  "failed")

        self._health_thread = threading.Thread(
            target=loop, daemon=True, name="ks-supervisor")
        self._health_thread.start()

    # --- supervised calls ---------------------------------------------------

    def _call_supervised(self, op: str, invoke, idempotent: bool):
        """``invoke(client)`` under the retry policy: shed and oom raise
        at once; a deadline, a device error or a lost connection retry
        when the op is idempotent (a deadline after a health round that
        may restart the daemon)."""
        last: Exception | None = None
        for _attempt in self.retry.attempts():
            try:
                c = self._connect()
                t0 = time.perf_counter()
                with mgtrace.span("kernel.request", op=op,
                                  attempt=_attempt):
                    result = invoke(c)
                # the caller-observed round trip (request, device, reply)
                mgstats.record_stage("kernel_dispatch",
                                     time.perf_counter() - t0)
                return result
            except (AdmissionRejected, KernelOom):
                raise
            except KernelDeadlineExceeded as e:
                last = e
                if not idempotent:
                    raise
                global_metrics.increment(
                    "kernel_server.client.retries_total")
                self.check_once()
            except KernelDeviceError as e:
                last = e
                if not idempotent:
                    raise
                global_metrics.increment(
                    "kernel_server.client.retries_total")
            except (ConnectionError, OSError) as e:
                last = e
                self._drop()
                if not idempotent:
                    raise
                global_metrics.increment(
                    "kernel_server.client.retries_total")
        raise KernelServerError(
            f"kernel request failed after {self.retry.max_retries + 1} "
            f"supervised attempts: {last}",
            outcome=getattr(last, "outcome", "invalid"),
            retryable=False) from last

    def pagerank(self, src=None, dst=None, weights=None, n_nodes=None,
                 graph_key=None, idempotent: bool = True,
                 deadline_s: float | None = None, **params):
        """PageRank with supervised retries (pure: idempotent unless the
        caller says otherwise)."""
        if deadline_s is None:
            deadline_s = self.deadline_s
        return self._call_supervised(
            "pagerank",
            lambda c: c.pagerank(src=src, dst=dst, weights=weights,
                                 n_nodes=n_nodes, graph_key=graph_key,
                                 deadline_s=deadline_s, **params),
            idempotent)

    def lane_hops(self, src, dst, emask, smask, midmask, tmask, *,
                  n_nodes, idempotent: bool = True,
                  deadline_s: float | None = None, **params):
        """Read-lane hop counts with supervised retries (pure:
        idempotent); a ``LaneRefused`` passes through untouched, so the
        caller's typed fallback fires instead of a retry."""
        if deadline_s is None:
            deadline_s = self.deadline_s
        return self._call_supervised(
            "lane",
            lambda c: c.lane_hops(src, dst, emask, smask, midmask, tmask,
                                  n_nodes=n_nodes, deadline_s=deadline_s,
                                  **params),
            idempotent)

    def ppr(self, sources, idempotent: bool = True,
            deadline_s: float | None = None, **params):
        """Coalesced PPR with supervised retries."""
        if deadline_s is None:
            deadline_s = self.deadline_s
        return self._call_supervised(
            "ppr", lambda c: c.ppr(sources, deadline_s=deadline_s, **params),
            idempotent)

    def close(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10)
            self._health_thread = None
        self._drop()


def log_tail(socket_path: str, n_bytes: int = 4000) -> str:
    """The end of a spawned daemon's log ("" when there is none)."""
    try:
        with open(log_path(socket_path), "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def ensure_server(socket_path: str = DEFAULT_SOCKET,
                  spawn_timeout_s: float = 120.0,
                  idle_timeout_s: float = 900.0, device: str = "cuda",
                  env: dict | None = None):
    """A client of the daemon on ``socket_path``, spawning it (on
    ``device``, its output appended to ``log_path(socket_path)``) when
    none answers; the client's ``process`` is the spawned daemon's
    ``Popen`` (None when another process's daemon answered), for its
    spawner to reap.  None when the spawn timed out (the stillborn
    daemon is killed); RuntimeError, with the log's tail, when it died
    during its start."""
    try:
        c = KernelClient(socket_path, timeout=spawn_timeout_s)
        if c.ping():
            return c
        c.close()
    except OSError:
        pass
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, child_env.get("PYTHONPATH")) if p)
    with open(log_path(socket_path), "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "memgraph_tpu_torch.server.kernel_server",
             "--socket", socket_path, "--idle-timeout", str(idle_timeout_s),
             "--device", str(device)],
            stdin=subprocess.DEVNULL, stdout=out, stderr=out, env=child_env,
            start_new_session=True)   # outlives the spawning client
    deadline = time.monotonic() + spawn_timeout_s
    died_at = None
    while time.monotonic() < deadline:
        # keep polling a while after our child died: in a spawn race the
        # loser exits while the winner is still starting
        try:
            c = KernelClient(socket_path, timeout=spawn_timeout_s)
            if c.ping():
                c.process = proc
                return c
            c.close()
        except OSError:
            if proc.poll() is not None:
                died_at = died_at or time.monotonic()
                if time.monotonic() - died_at > _SPAWN_RACE_GRACE_S:
                    break
            time.sleep(0.1)
    if proc.poll() is not None:
        raise RuntimeError(
            f"kernel server died during init (rc={proc.returncode}); the "
            f"end of {log_path(socket_path)}:\n{log_tail(socket_path)}")
    try:
        proc.kill()               # a starved spawn must not linger
        proc.wait(timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        pass
    return None


#: process-wide supervised clients, one per socket
_SHARED_CLIENTS: dict = {}
_shared_clients_guard = threading.Lock()


def shared_client(socket_path: str = DEFAULT_SOCKET,
                  spawn: bool = False,
                  device: str = "cuda") -> SupervisedKernelClient:
    """The process's SupervisedKernelClient for a socket, shared by the
    ops-level route and the procedures."""
    with _shared_clients_guard:
        client = _SHARED_CLIENTS.get(socket_path)
        if client is None:
            client = _SHARED_CLIENTS[socket_path] = \
                SupervisedKernelClient(socket_path, spawn=spawn,
                                       device=device)
        return client


def route_client(kernel):
    """(socket path, client) of a kernel route: ``kernel`` is a client
    (its ``socket_path``), or a socket path (True, "1" or "default": the
    port's default socket) whose ``shared_client`` serves it."""
    if hasattr(kernel, "socket_path"):
        return kernel.socket_path, kernel
    sock = DEFAULT_SOCKET if kernel in (True, "1", "default") \
        else str(kernel)
    return sock, shared_client(sock)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="The port's resident kernel server.")
    ap.add_argument("--socket", default=DEFAULT_SOCKET)
    ap.add_argument("--idle-timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(process)d %(name)s %(levelname)s %(message)s")
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"kernel_server: no CUDA device is available "
              f"(torch.cuda.is_available() is false); start with "
              f"--device cpu to serve on the CPU", file=sys.stderr)
        return 2
    log.info("kernel_server: serving %s on %s", args.socket, args.device)
    KernelServer(args.socket, idle_timeout_s=args.idle_timeout,
                 device=args.device).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
