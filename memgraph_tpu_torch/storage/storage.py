"""The in-memory MVCC storage engine.

Re-design of the reference's InMemoryStorage
(memgraph/src/storage/v2/inmemory/storage.hpp:109): optimistic MVCC
with undo-delta chains (mvcc.py), commit serialization under an engine lock,
abort via reverse-undo, and epoch-style GC that truncates delta chains older
than the oldest active transaction. Two storage modes:

  IN_MEMORY_TRANSACTIONAL — full MVCC (default)
  IN_MEMORY_ANALYTICAL    — no MVCC/WAL, direct mutation, bulk-load fast path

TPU-first twist: the engine keeps a monotonically bumped `topology_version`
so the device CSR snapshot cache (memgraph_tpu.ops.csr) knows when graph
topology changed and a re-export is needed.

Copy of memgraph_tpu/storage/storage.py for the port (its imports the port's own).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..exceptions import ConstraintViolation, SerializationError, StorageError
from ..utils.ids import NameIdMapper
from ..utils.locks import tracked_lock
from ..utils.sanitize import (mvcc_event, shared_field, shared_read,
                              shared_write)
from .common import (TRANSACTION_ID_START, Gid, IsolationLevel, StorageMode,
                     View)
from .constraints import Constraints
from .delta import CommitInfo, DeltaAction
from .indexes import Indices
from .mvcc import (materialize_edge, materialize_vertex, prepare_for_write,
                   push_delta)
from .objects import (ADJ_INDEX_THRESHOLD, Edge, Vertex, adj_map_add,
                      adj_map_build, adj_map_remove)

log = logging.getLogger(__name__)


class ChangeLogUnknowable:
    """Typed "unknowable" verdict from :meth:`Storage.changes_between`.

    The bounded change log cannot always answer a (v_from, v_to] query:
    the deque may have wrapped past v_from (``reason="log_wrapped"``), a
    bump may not have recorded its gids (``reason="untracked_bump"``),
    or the log may be empty for a non-empty range. Consumers MUST
    branch on this explicitly (falsy, so ``if changed:`` treats it like
    an unusable delta) and fall back to a full rebuild — silently
    treating it as "no changes" would serve stale data.
    """

    __slots__ = ("reason", "oldest_logged_version")

    def __init__(self, reason: str, oldest_logged_version: int) -> None:
        self.reason = reason
        self.oldest_logged_version = oldest_logged_version

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return (f"ChangeLogUnknowable({self.reason!r}, "
                f"oldest_logged_version={self.oldest_logged_version})")


@dataclass
class StorageConfig:
    storage_mode: StorageMode = StorageMode.IN_MEMORY_TRANSACTIONAL
    isolation_level: IsolationLevel = IsolationLevel.SNAPSHOT_ISOLATION
    gc_interval_sec: float = 30.0
    durability_dir: Optional[str] = None
    wal_enabled: bool = False
    # WAL v2 segments rotate at this size; old segments are pruned once
    # the newest snapshot covers them (reference: --storage-wal-file-size-kib)
    wal_segment_size: int = 64 * 1024 * 1024
    snapshot_on_exit: bool = False
    properties_on_edges: bool = True
    snapshot_retention_count: int = 3
    # skip the delta/WAL record when a SET writes the identical value
    # (reference: --storage-delta-on-identical-property-update)
    delta_on_identical_property_update: bool = True
    # auto-create label / edge-type indexes for labels and types first
    # touched by a commit (reference: --storage-automatic-*-index-
    # creation-enabled)
    automatic_label_index: bool = False
    automatic_edge_type_index: bool = False
    # run a GC cycle after every committing transaction instead of only
    # on the periodic timer (reference: --storage-gc-aggressive)
    gc_aggressive: bool = False
    # continue with whatever recovered instead of failing startup when
    # durability files are damaged (reference:
    # --storage-allow-recovery-failure)
    allow_recovery_failure: bool = False


@dataclass
class BatchInsert:
    """One batch_insert() call's created objects, recorded on the owning
    transaction so commit can emit a single columnar BATCH_INSERT WAL
    record instead of one record per object."""
    vertices: list = field(default_factory=list)
    edges: list = field(default_factory=list)


class _Namer:
    """Adapter giving constraints readable names in error messages."""

    def __init__(self, storage: "InMemoryStorage") -> None:
        self._s = storage

    def label(self, label_id: int) -> str:
        return self._s.label_mapper.id_to_name(label_id)

    def prop(self, prop_id: int) -> str:
        return self._s.property_mapper.id_to_name(prop_id)


class Transaction:
    __slots__ = ("id", "start_ts", "commit_info", "deltas", "isolation",
                 "storage", "touched_vertices", "touched_edges", "commit_ts",
                 "topology_snapshot", "batches", "edge_prop_endpoint_gids",
                 "stream_offsets")

    def __init__(self, txn_id: int, start_ts: int, isolation: IsolationLevel,
                 storage: "InMemoryStorage") -> None:
        self.id = txn_id
        self.start_ts = start_ts
        self.commit_info = CommitInfo(txn_id)
        self.deltas = []
        self.isolation = isolation
        self.storage = storage
        self.touched_vertices: dict[int, Vertex] = {}
        self.touched_edges: dict[int, Edge] = {}
        self.commit_ts: Optional[int] = None   # set at commit
        self.topology_snapshot = 0             # set by _begin_transaction
        self.batches = None  # list[BatchInsert] once batch_insert is used
        # endpoint gids of edges touched WITHOUT their vertices entering
        # touched_vertices (only _edge_set_property) — lets the commit/abort
        # topology bump skip re-walking every touched edge's endpoints
        self.edge_prop_endpoint_gids = None
        # stream name -> source position, WAL-framed inside THIS commit
        # (exactly-once boundary for streaming ingestion)
        self.stream_offsets = None

    def effective_start_ts(self) -> int:
        # Once committed, the transaction's snapshot ADVANCES to its commit
        # ts: accessors returned to the client (RETURN n materialized after
        # stream exhaustion) must see the transaction's own committed state
        # — commit rewrote the deltas' timestamps to commit_ts, so the
        # own-write (ts == txn_id) rule no longer identifies them
        # (reference: storage/v2/mvcc.hpp:37-64 visibility rules).
        if self.commit_ts is not None:
            return self.commit_ts
        if self.isolation is IsolationLevel.SNAPSHOT_ISOLATION:
            return self.start_ts
        # READ_COMMITTED / READ_UNCOMMITTED see the latest committed state
        return self.storage.latest_commit_ts()


class VertexAccessor:
    """Transactional view over one vertex. Cheap to construct."""

    __slots__ = ("vertex", "_acc")

    def __init__(self, vertex: Vertex, acc: "Accessor") -> None:
        self.vertex = vertex
        self._acc = acc

    # --- identity -----------------------------------------------------------

    @property
    def gid(self) -> Gid:
        return self.vertex.gid

    def __eq__(self, other):
        # gid equality, not object identity: the disk mode can re-load a
        # fresh object for the same gid; gids are never reused
        return isinstance(other, VertexAccessor) and \
            other.vertex.gid == self.vertex.gid

    def __hash__(self):
        return hash(("v", self.vertex.gid))

    # --- reads --------------------------------------------------------------

    def _state(self, view: View, need_edges: bool = True):
        return self._acc._vertex_state(self.vertex, view, need_edges)

    def is_visible(self, view: View = View.OLD) -> bool:
        st = self._state(view, need_edges=False)
        return st.exists and not st.deleted

    def labels(self, view: View = View.NEW) -> list[int]:
        return sorted(self._state(view, need_edges=False).labels)

    def has_label(self, label_id: int, view: View = View.NEW) -> bool:
        return label_id in self._state(view, need_edges=False).labels

    def properties(self, view: View = View.NEW) -> dict[int, object]:
        return dict(self._state(view, need_edges=False).properties)

    def get_property(self, prop_id: int, view: View = View.NEW):
        value = self._state(view, need_edges=False).properties.get(prop_id)
        mvcc_event("read", txn=self._acc.txn.id, gid=self.vertex.gid,
                   prop=prop_id, value=value)
        return value

    def in_edges(self, view: View = View.NEW, edge_types=None,
                 from_vertex=None) -> list["EdgeAccessor"]:
        if from_vertex is not None:
            entries = self._acc._neighbor_entries(
                self.vertex, "in", from_vertex.vertex.gid, view)
            if entries is not None:
                return self._filter_entries(entries, view, edge_types, None)
        st = self._state(view)
        out = []
        for (etype, other, edge) in st.in_edges:
            if edge_types is not None and etype not in edge_types:
                continue
            if from_vertex is not None and \
                    other.gid != from_vertex.vertex.gid:
                continue
            ea = EdgeAccessor(edge, self._acc)
            if ea.is_visible(view) and self._acc._fg_edge_ok(ea, view):
                out.append(ea)
        return out

    def out_edges(self, view: View = View.NEW, edge_types=None,
                  to_vertex=None) -> list["EdgeAccessor"]:
        if to_vertex is not None:
            entries = self._acc._neighbor_entries(
                self.vertex, "out", to_vertex.vertex.gid, view)
            if entries is not None:
                return self._filter_entries(entries, view, edge_types, None)
        st = self._state(view)
        out = []
        for (etype, other, edge) in st.out_edges:
            if edge_types is not None and etype not in edge_types:
                continue
            if to_vertex is not None and other.gid != to_vertex.vertex.gid:
                continue
            ea = EdgeAccessor(edge, self._acc)
            if ea.is_visible(view) and self._acc._fg_edge_ok(ea, view):
                out.append(ea)
        return out

    def _filter_entries(self, entries, view, edge_types, _unused):
        out = []
        for (etype, _other, edge) in entries:
            if edge_types is not None and etype not in edge_types:
                continue
            ea = EdgeAccessor(edge, self._acc)
            if ea.is_visible(view) and self._acc._fg_edge_ok(ea, view):
                out.append(ea)
        return out

    def in_degree(self, view: View = View.NEW) -> int:
        return len(self.in_edges(view))

    def out_degree(self, view: View = View.NEW) -> int:
        return len(self.out_edges(view))

    # --- writes -------------------------------------------------------------

    def add_label(self, label_id: int) -> bool:
        return self._acc._vertex_add_label(self.vertex, label_id)

    def remove_label(self, label_id: int) -> bool:
        return self._acc._vertex_remove_label(self.vertex, label_id)

    def set_property(self, prop_id: int, value) -> object:
        return self._acc._vertex_set_property(self.vertex, prop_id, value)


class EdgeAccessor:
    __slots__ = ("edge", "_acc")

    def __init__(self, edge: Edge, acc: "Accessor") -> None:
        self.edge = edge
        self._acc = acc

    @property
    def gid(self) -> Gid:
        return self.edge.gid

    @property
    def edge_type(self) -> int:
        return self.edge.edge_type

    def __eq__(self, other):
        return isinstance(other, EdgeAccessor) and \
            other.edge.gid == self.edge.gid

    def __hash__(self):
        return hash(("e", self.edge.gid))

    def from_vertex(self) -> VertexAccessor:
        return VertexAccessor(self.edge.from_vertex, self._acc)

    def to_vertex(self) -> VertexAccessor:
        return VertexAccessor(self.edge.to_vertex, self._acc)

    def _state(self, view: View):
        return self._acc._edge_state(self.edge, view)

    def is_visible(self, view: View = View.OLD) -> bool:
        st = self._state(view)
        return st.exists and not st.deleted

    def properties(self, view: View = View.NEW) -> dict[int, object]:
        return dict(self._state(view).properties)

    def get_property(self, prop_id: int, view: View = View.NEW):
        value = self._state(view).properties.get(prop_id)
        mvcc_event("read", txn=self._acc.txn.id, gid=("e", self.edge.gid),
                   prop=prop_id, value=value)
        return value

    def set_property(self, prop_id: int, value) -> object:
        return self._acc._edge_set_property(self.edge, prop_id, value)


class Accessor:
    """One transaction's handle on the storage (reference: Storage::Accessor).

    Usable as a context manager; __exit__ aborts if not committed.
    """

    fine_grained = None  # optional FgStorageView (auth/fine_grained.py)

    def __init__(self, storage: "InMemoryStorage",
                 isolation: IsolationLevel) -> None:
        from ..observability import trace as mgtrace
        self.storage = storage
        with mgtrace.span("mvcc.begin") as sp:
            self.txn = storage._begin_transaction(isolation)
            if sp:
                sp.set(txn_id=self.txn.id,
                       isolation=str(isolation.value))
        self._finished = False
        self._analytical = storage.config.storage_mode is StorageMode.IN_MEMORY_ANALYTICAL
        # what this reader's MVCC snapshot corresponds to: commits AFTER
        # this accessor began are invisible to it, so version-keyed caches
        # built through it must key on THIS, not the live version
        # (vector-index delta maintenance, NOTES_ROUND2 hole #2).
        # Captured by _begin_transaction under the engine lock, atomically
        # with the snapshot timestamp.
        self.topology_snapshot = self.txn.topology_snapshot

    # --- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "Accessor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._finished:
            self.abort()

    def commit(self) -> None:
        from ..observability import trace as mgtrace
        if self._finished:
            raise StorageError("transaction already finished")
        try:
            with mgtrace.span("mvcc.commit") as sp:
                commit_ts = self.storage._commit(self.txn)
                if sp:
                    sp.set(txn_id=self.txn.id, commit_ts=commit_ts)
        except Exception:
            # constraint violation etc. → roll back so objects aren't left owned
            self.storage._abort(self.txn)
            self._finished = True
            raise
        self._finished = True
        self._auto_create_indexes()
        # hooks run strictly after the commit is final: a failing hook must
        # never trigger rollback of already-visible data
        for hook in self.storage.on_commit_hooks:
            hook(self.txn, commit_ts)

    def _auto_create_indexes(self) -> None:
        """--storage-automatic-*-index-creation-enabled: index any label /
        edge type this commit touched that has no index yet (reference:
        flags/general.cpp; runs post-commit so the build scans committed
        state)."""
        cfg = self.storage.config
        if cfg.automatic_label_index:
            idx = self.storage.indices.label
            for v in self.txn.touched_vertices.values():
                for lid in v.labels:
                    if not idx.has(lid):
                        self.storage.create_label_index(lid)
        if cfg.automatic_edge_type_index:
            idx = self.storage.indices.edge_type
            for e in self.txn.touched_edges.values():
                if not idx.has(e.edge_type):
                    self.storage.create_edge_type_index(e.edge_type)

    def stage_stream_offset(self, name: str, position) -> None:
        """Stage a stream's source position into THIS transaction: the
        offset becomes a WAL record inside the same commit frame as the
        batch's data, making it the exactly-once boundary (replayed on
        recovery, shipped over replication)."""
        if self._finished:
            raise StorageError("transaction already finished")
        if self.txn.stream_offsets is None:
            self.txn.stream_offsets = {}
        self.txn.stream_offsets[name] = position

    def abort(self) -> None:
        if self._finished:
            return
        self.storage._abort(self.txn)
        self._finished = True

    def periodic_commit(self) -> None:
        """Commit and immediately re-begin on the SAME accessor object
        (reference: InMemoryStorage::Accessor::PeriodicCommit). Every
        live VertexAccessor/EdgeAccessor and in-flight scan iterator
        dereferences this accessor dynamically, so they all migrate to
        the fresh transaction — writes after the boundary land in the
        new transaction instead of stamping deltas onto a finished one."""
        isolation = self.txn.isolation
        self.commit()
        self.txn = self.storage._begin_transaction(isolation)
        self.topology_snapshot = self.txn.topology_snapshot
        self._finished = False

    # --- object creation / deletion -----------------------------------------

    def create_vertex(self, gid: Optional[Gid] = None) -> VertexAccessor:
        storage = self.storage
        with storage._gid_lock:
            shared_write(storage, "_next_vertex_gid")
            if gid is None:
                gid = storage._next_vertex_gid
                storage._next_vertex_gid += 1
            else:
                if gid in storage._vertices:
                    raise StorageError(f"vertex with gid {gid} already exists")
                storage._next_vertex_gid = max(storage._next_vertex_gid, gid + 1)
            # publish under the SAME lock as the uniqueness check: two
            # concurrent explicit-gid creates could both pass the check
            # and the loser's vertex silently vanished (check-then-act,
            # MG007 pattern — mgsan sweep). The undo delta goes on BEFORE
            # publication so a concurrent scanner never sees the vertex
            # as committed.
            vertex = Vertex(gid)
            if not self._analytical:
                push_delta(vertex, self.txn, DeltaAction.DELETE_OBJECT,
                           None)
            storage._vertices[gid] = vertex
        self.txn.touched_vertices[gid] = vertex
        if self._analytical:
            # analytical commits skip the commit-time bump; transactional
            # per-op bumps would only flood the bounded change log (a
            # 30k-op transaction would wrap it) — the commit-time bump
            # logs the txn's full touched set in ONE entry
            storage._bump_topology({gid})
        return VertexAccessor(vertex, self)

    def delete_vertex(self, va: VertexAccessor, detach: bool = False):
        """Delete a vertex; with detach=True also deletes incident edges.

        Returns (deleted_vertex_accessor, deleted_edge_accessors) or raises.
        """
        if self.fine_grained is not None:
            self.fine_grained.check_vertex_delete(va.vertex.labels)
        vertex = va.vertex
        deleted_edges: list[EdgeAccessor] = []
        with vertex.lock:
            if not self._analytical:
                prepare_for_write(vertex, self.txn)
            if vertex.deleted:
                return None, []
            in_list = list(vertex.in_edges)
            out_list = list(vertex.out_edges)
        if in_list or out_list:
            if not detach:
                raise StorageError(
                    "Vertex has edges and cannot be deleted without DETACH")
            for (etype, other, edge) in out_list:
                ea = EdgeAccessor(edge, self)
                if ea.is_visible(View.NEW):
                    self.delete_edge(ea)
                    deleted_edges.append(ea)
            for (etype, other, edge) in in_list:
                ea = EdgeAccessor(edge, self)
                if ea.is_visible(View.NEW):
                    self.delete_edge(ea)
                    deleted_edges.append(ea)
        with vertex.lock:
            if not self._analytical:
                prepare_for_write(vertex, self.txn)
                push_delta(vertex, self.txn, DeltaAction.RECREATE_OBJECT, None)
            vertex.deleted = True
        self.txn.touched_vertices[vertex.gid] = vertex
        if self._analytical:
            self.storage._bump_topology({vertex.gid})
        return va, deleted_edges

    def create_edge(self, from_va: VertexAccessor, to_va: VertexAccessor,
                    edge_type: int, gid: Optional[Gid] = None) -> EdgeAccessor:
        if self.fine_grained is not None:
            self.fine_grained.check_edge_create_delete(edge_type)
        storage = self.storage
        from_v, to_v = from_va.vertex, to_va.vertex
        # the gid lock is held across validation AND publication: the old
        # check-then-publish split let two explicit-gid creates both pass
        # the uniqueness check and silently drop one edge (check-then-act,
        # MG007 pattern — mgsan sweep). Ordering stays gid_lock ->
        # Vertex.lock everywhere; no path takes the gid lock under a
        # vertex lock.
        with storage._gid_lock:
            shared_write(storage, "_next_edge_gid")
            if gid is None:
                gid = storage._next_edge_gid
                storage._next_edge_gid += 1
            else:
                if gid in storage._edges:
                    raise StorageError(f"edge with gid {gid} already exists")
                storage._next_edge_gid = max(storage._next_edge_gid, gid + 1)
            edge = Edge(gid, edge_type, from_v, to_v)

            # lock both endpoints in gid order to avoid deadlock
            first, second = (from_v, to_v) if from_v.gid <= to_v.gid \
                else (to_v, from_v)
            first.lock.acquire()
            if second is not first:
                second.lock.acquire()
            try:
                if not self._analytical:
                    prepare_for_write(from_v, self.txn)
                    if to_v is not from_v:
                        prepare_for_write(to_v, self.txn)
                if from_v.deleted or to_v.deleted:
                    raise StorageError(
                        "cannot create edge on a deleted vertex")
                out_entry = (edge_type, to_v, edge)
                in_entry = (edge_type, from_v, edge)
                if not self._analytical:
                    push_delta(edge, self.txn, DeltaAction.DELETE_OBJECT,
                               None)
                    push_delta(from_v, self.txn,
                               DeltaAction.REMOVE_OUT_EDGE, out_entry)
                    push_delta(to_v, self.txn, DeltaAction.REMOVE_IN_EDGE,
                               in_entry)
                from_v.out_edges.append(out_entry)
                to_v.in_edges.append(in_entry)
                adj_map_add(from_v, "out", out_entry)
                adj_map_add(to_v, "in", in_entry)
            finally:
                if second is not first:
                    second.lock.release()
                first.lock.release()
            storage._edges[gid] = edge
        storage.indices.edge_type.add(edge)
        self.txn.touched_edges[gid] = edge
        self.txn.touched_vertices[from_v.gid] = from_v
        self.txn.touched_vertices[to_v.gid] = to_v
        if self._analytical:
            storage._bump_topology({from_v.gid, to_v.gid})
        return EdgeAccessor(edge, self)

    def delete_edge(self, ea: EdgeAccessor):
        if self.fine_grained is not None:
            self.fine_grained.check_edge_create_delete(ea.edge.edge_type)
        edge = ea.edge
        from_v, to_v = edge.from_vertex, edge.to_vertex
        with edge.lock:
            if not self._analytical:
                prepare_for_write(edge, self.txn)
            if edge.deleted:
                return None
            if not self._analytical:
                push_delta(edge, self.txn, DeltaAction.RECREATE_OBJECT, None)
            edge.deleted = True
        out_entry = (edge.edge_type, to_v, edge)
        in_entry = (edge.edge_type, from_v, edge)
        with from_v.lock:
            if not self._analytical:
                prepare_for_write(from_v, self.txn)
                push_delta(from_v, self.txn, DeltaAction.ADD_OUT_EDGE, out_entry)
            try:
                from_v.out_edges.remove(out_entry)
            except ValueError:
                pass
            adj_map_remove(from_v, "out", out_entry)
        with to_v.lock:
            if not self._analytical:
                prepare_for_write(to_v, self.txn)
                push_delta(to_v, self.txn, DeltaAction.ADD_IN_EDGE, in_entry)
            try:
                to_v.in_edges.remove(in_entry)
            except ValueError:
                pass
            adj_map_remove(to_v, "in", in_entry)
        self.txn.touched_edges[edge.gid] = edge
        self.txn.touched_vertices[from_v.gid] = from_v
        self.txn.touched_vertices[to_v.gid] = to_v
        if self._analytical:
            self.storage._bump_topology({from_v.gid, to_v.gid})
        return ea

    # --- bulk-write fast lane ----------------------------------------------

    def batch_insert(self, vertices=(), edges=()):
        """Bulk-create vertices and edges with per-batch (not per-row)
        overhead: one gid-counter reservation, one undo delta per object
        (plus one bulk adjacency undo per pre-existing endpoint), deferred
        bulk-merged index maintenance, and a single change-log bump. The
        batch stays one MVCC transaction: invisible to other readers until
        commit, fully undone by abort, and encoded as one BATCH_INSERT
        WAL/replication record at commit.

        vertices: sequence of (label_ids, props) — label_ids an iterable of
          label ids, props a dict[prop_id, value] (ownership transfers).
        edges: sequence of (edge_type_id, from_ref, to_ref, props) — a ref
          is an int index into this call's `vertices`, or a Vertex /
          VertexAccessor for a pre-existing endpoint.

        Returns (new_vertices, new_edges) as raw storage objects.
        """
        import numpy as np
        storage = self.storage
        txn = self.txn
        analytical = self._analytical
        vertices = list(vertices)
        edges = list(edges)
        nv, ne = len(vertices), len(edges)
        if not nv and not ne:
            return [], []
        fg = self.fine_grained
        if fg is not None:
            seen_sets: set = set()
            for labels, _props in vertices:
                t = tuple(labels)
                if t not in seen_sets:
                    seen_sets.add(t)
                    for lid in t:
                        fg.check_label_modify(lid)
                    fg.check_vertex_update(set(t))
            seen_types: set = set()
            for etype, _f, _t, _p in edges:
                if etype not in seen_types:
                    seen_types.add(etype)
                    fg.check_edge_create_delete(etype)

        # (a) vectorized gid allocation: one counter reservation per batch
        with storage._gid_lock:
            shared_write(storage, "_next_vertex_gid")
            v_base = storage._next_vertex_gid
            storage._next_vertex_gid += nv
            e_base = storage._next_edge_gid
            storage._next_edge_gid += ne
        v_gids = np.arange(v_base, v_base + nv, dtype=np.int64).tolist()

        from .delta import Delta
        commit_info = txn.commit_info
        deltas = txn.deltas
        _DELETE = DeltaAction.DELETE_OBJECT

        new_vertices: list[Vertex] = []
        append_vertex = new_vertices.append
        for gid, (labels, props) in zip(v_gids, vertices):
            v = Vertex(gid)
            if labels:
                v.labels = set(labels)
            if props:
                v.properties = props if isinstance(props, dict) \
                    else dict(props)
            if not analytical:
                d = Delta(_DELETE, None, commit_info, None, v)
                v.delta = d
                deltas.append(d)
            append_vertex(v)

        props_on_edges = storage.config.properties_on_edges
        new_edges: list[Edge] = []
        append_edge = new_edges.append
        # pre-existing endpoints: entries grouped per vertex (object-keyed,
        # identity hash) so each gets ONE lock round + ONE bulk undo delta
        # for the whole batch
        pending_in: dict[Vertex, list] = {}
        pending_out: dict[Vertex, list] = {}
        egid = e_base
        for etype, fref, tref, props in edges:
            from_new = type(fref) is int
            to_new = type(tref) is int
            from_v = new_vertices[fref] if from_new else \
                (fref.vertex if type(fref) is VertexAccessor else fref)
            to_v = new_vertices[tref] if to_new else \
                (tref.vertex if type(tref) is VertexAccessor else tref)
            edge = Edge(egid, etype, from_v, to_v)
            egid += 1
            if props:
                if not props_on_edges:
                    raise StorageError("properties on edges are disabled")
                edge.properties = props if isinstance(props, dict) \
                    else dict(props)
            if not analytical:
                d = Delta(_DELETE, None, commit_info, None, edge)
                edge.delta = d
                deltas.append(d)
            out_entry = (etype, to_v, edge)
            in_entry = (etype, from_v, edge)
            if from_new:
                # unpublished: no lock, no adjacency undo needed — the
                # vertex's own DELETE_OBJECT undo covers its whole state
                from_v.out_edges.append(out_entry)
                if from_v.adj_out is not None:
                    adj_map_add(from_v, "out", out_entry)
            else:
                group = pending_out.get(from_v)
                if group is None:
                    group = pending_out[from_v] = []
                group.append(out_entry)
            if to_new:
                to_v.in_edges.append(in_entry)
                if to_v.adj_in is not None:
                    adj_map_add(to_v, "in", in_entry)
            else:
                group = pending_in.get(to_v)
                if group is None:
                    group = pending_in[to_v] = []
                group.append(in_entry)
            append_edge(edge)

        # (e) amortized supernode bookkeeping: one lock round + one bulk
        # undo per pre-existing endpoint per direction, however many edges
        # it gained
        touched_v = txn.touched_vertices
        changed = {v.gid for v in new_vertices}
        changed_add = changed.add
        _IN_BULK = DeltaAction.REMOVE_IN_EDGES_BULK
        _OUT_BULK = DeltaAction.REMOVE_OUT_EDGES_BULK
        for side, bulk_action, pending in (
                ("in", _IN_BULK, pending_in),
                ("out", _OUT_BULK, pending_out)):
            is_in = side == "in"
            for v, entries in pending.items():
                lock = v.lock
                lock.acquire()
                try:
                    if not analytical:
                        prepare_for_write(v, txn)
                    if v.deleted:
                        raise StorageError(
                            "cannot create edge on a deleted vertex")
                    if not analytical:
                        d = Delta(bulk_action, tuple(entries), commit_info,
                                  v.delta, v)
                        v.delta = d
                        deltas.append(d)
                    if is_in:
                        v.in_edges.extend(entries)
                        if v.adj_in is not None:
                            for entry in entries:
                                adj_map_add(v, "in", entry)
                    else:
                        v.out_edges.extend(entries)
                        if v.adj_out is not None:
                            for entry in entries:
                                adj_map_add(v, "out", entry)
                finally:
                    lock.release()
                gid = v.gid
                touched_v[gid] = v
                changed_add(gid)

        # publish
        storage._vertices.update(zip(v_gids, new_vertices))
        storage._edges.update((e.gid, e) for e in new_edges)

        # (c) deferred index maintenance: one sorted bulk-merge per index
        if new_vertices:
            per_label: dict[int, list] = {}
            for v in new_vertices:
                for lid in v.labels:
                    per_label.setdefault(lid, []).append(v)
            for lid, group in per_label.items():
                storage.indices.label.bulk_add(lid, group)
            storage.indices.label_property.bulk_add(new_vertices)
        if new_edges:
            storage.indices.edge_type.bulk_add(new_edges)

        txn.touched_vertices.update((v.gid, v) for v in new_vertices)
        txn.touched_edges.update((e.gid, e) for e in new_edges)
        if not analytical:
            if txn.batches is None:
                txn.batches = []
            txn.batches.append(BatchInsert(new_vertices, new_edges))

        # (d) one change-log record per batch (gids collected while hot
        # in the loops above); transactional batches are covered by the
        # commit-time bump (every gid is in touched_vertices), so only
        # analytical mode needs the immediate record
        if analytical:
            storage._bump_topology(changed)

        if nv + ne >= 1024:
            # bulk-load pacing: graph objects are long-lived by
            # construction, but CPython's cyclic GC rescans every one of
            # them on each gen-2 collection — at millions of objects the
            # scans ate >50% of ingest wall time. Freeze the
            # current heap into the permanent generation; collect_garbage()
            # unfreezes before sweeping so deleted vertex<->edge cycles
            # stay reclaimable.
            import gc as _gc
            _gc.freeze()
        return new_vertices, new_edges

    # --- vertex mutations (called through VertexAccessor) -------------------

    def _vertex_add_label(self, vertex: Vertex, label_id: int) -> bool:
        if self.fine_grained is not None:
            self.fine_grained.check_label_modify(label_id)
        with vertex.lock:
            if not self._analytical:
                prepare_for_write(vertex, self.txn)
            if vertex.deleted:
                raise StorageError("cannot modify a deleted vertex")
            if label_id in vertex.labels:
                return False
            if not self._analytical:
                push_delta(vertex, self.txn, DeltaAction.REMOVE_LABEL, label_id)
            vertex.labels.add(label_id)
        self.storage.indices.label.add(label_id, vertex)
        self.storage.indices.label_property.update_on_change(vertex)
        self.txn.touched_vertices[vertex.gid] = vertex
        if self._analytical:
            # analytical commits skip the commit-time bump; invalidate
            # device/columnar snapshot caches per write instead
            self.storage._bump_topology({vertex.gid})
        return True

    def _vertex_remove_label(self, vertex: Vertex, label_id: int) -> bool:
        if self.fine_grained is not None:
            self.fine_grained.check_label_modify(label_id)
        with vertex.lock:
            if not self._analytical:
                prepare_for_write(vertex, self.txn)
            if vertex.deleted:
                raise StorageError("cannot modify a deleted vertex")
            if label_id not in vertex.labels:
                return False
            if not self._analytical:
                push_delta(vertex, self.txn, DeltaAction.ADD_LABEL, label_id)
            vertex.labels.discard(label_id)
        self.storage.indices.label_property.update_on_change(vertex)
        self.txn.touched_vertices[vertex.gid] = vertex
        if self._analytical:
            self.storage._bump_topology({vertex.gid})
        return True

    def _vertex_set_property(self, vertex: Vertex, prop_id: int, value):
        if self.fine_grained is not None:
            self.fine_grained.check_vertex_update(vertex.labels)
        with vertex.lock:
            if not self._analytical:
                prepare_for_write(vertex, self.txn)
            if vertex.deleted:
                raise StorageError("cannot modify a deleted vertex")
            old = vertex.properties.get(prop_id)
            if not self.storage.config.delta_on_identical_property_update \
                    and old == value and type(old) is type(value) \
                    and value is not None:
                return old      # identical rewrite: no delta, no WAL
            if not self._analytical:
                push_delta(vertex, self.txn, DeltaAction.SET_PROPERTY,
                           (prop_id, old))
            if value is None:
                vertex.properties.pop(prop_id, None)
            else:
                vertex.properties[prop_id] = value
        mvcc_event("write", txn=self.txn.id, gid=vertex.gid, prop=prop_id,
                   value=value)
        self.storage.indices.label_property.update_on_change(vertex)
        self.txn.touched_vertices[vertex.gid] = vertex
        if self._analytical:
            self.storage._bump_topology({vertex.gid})
        return old

    def _edge_set_property(self, edge: Edge, prop_id: int, value):
        if self.fine_grained is not None:
            self.fine_grained.check_edge_update(edge.edge_type)
        if not self.storage.config.properties_on_edges:
            raise StorageError("properties on edges are disabled")
        with edge.lock:
            if not self._analytical:
                prepare_for_write(edge, self.txn)
            if edge.deleted:
                raise StorageError("cannot modify a deleted edge")
            old = edge.properties.get(prop_id)
            if not self._analytical:
                push_delta(edge, self.txn, DeltaAction.SET_PROPERTY,
                           (prop_id, old))
            if value is None:
                edge.properties.pop(prop_id, None)
            else:
                edge.properties[prop_id] = value
        mvcc_event("write", txn=self.txn.id, gid=("e", edge.gid),
                   prop=prop_id, value=value)
        self.txn.touched_edges[edge.gid] = edge
        eps = self.txn.edge_prop_endpoint_gids
        if eps is None:
            eps = self.txn.edge_prop_endpoint_gids = set()
        eps.add(edge.from_vertex.gid)
        eps.add(edge.to_vertex.gid)
        if self._analytical:
            self.storage._bump_topology(
                {edge.from_vertex.gid, edge.to_vertex.gid})
        return old

    # --- reads --------------------------------------------------------------

    def _vertex_state(self, vertex: Vertex, view: View,
                      need_edges: bool = True):
        txn = self.txn
        if (txn.isolation is IsolationLevel.READ_UNCOMMITTED
                or self._analytical):
            from .delta import MaterializedState
            with vertex.lock:
                return MaterializedState(
                    exists=True, deleted=vertex.deleted,
                    labels=set(vertex.labels),
                    properties=dict(vertex.properties),
                    in_edges=list(vertex.in_edges) if need_edges else [],
                    out_edges=list(vertex.out_edges) if need_edges else [])
        return materialize_vertex(vertex, txn, view, need_edges)

    def _neighbor_entries(self, vertex: Vertex, side: str, other_gid: int,
                          view: View):
        """Supernode fast path for bound-endpoint edge lookups: candidate
        adjacency entries between `vertex` and `other_gid`, or None when the
        caller must fall back to the full materialize-and-scan.

        Only valid when the reader's view of the vertex equals its live
        fields (state_is_current): then the live adjacency map is
        authoritative and the O(degree) state copy is skipped. Each
        returned entry's edge still gets the normal per-edge visibility
        check, so an invisible concurrent edge never leaks through."""
        from .mvcc import state_is_current
        live = vertex.in_edges if side == "in" else vertex.out_edges
        if len(live) < ADJ_INDEX_THRESHOLD:
            return None
        with vertex.lock:
            if not (self._analytical
                    or self.txn.isolation is IsolationLevel.READ_UNCOMMITTED
                    or state_is_current(vertex, self.txn, view)):
                return None
            adj = vertex.adj_in if side == "in" else vertex.adj_out
            if adj is None:
                adj = adj_map_build(vertex, side)
            return list(adj.get(other_gid, ()))

    def _edge_state(self, edge: Edge, view: View):
        txn = self.txn
        if (txn.isolation is IsolationLevel.READ_UNCOMMITTED
                or self._analytical):
            from .delta import MaterializedState
            with edge.lock:
                return MaterializedState(
                    exists=True, deleted=edge.deleted,
                    properties=dict(edge.properties))
        return materialize_edge(edge, txn, view)

    def find_vertex(self, gid: Gid, view: View = View.NEW
                    ) -> Optional[VertexAccessor]:
        vertex = self.storage._vertices.get(gid)
        if vertex is None:
            return None
        va = VertexAccessor(vertex, self)
        if not va.is_visible(view):
            return None
        return va if self._fg_vertex_ok(va, view) else None

    def find_edge(self, gid: Gid, view: View = View.NEW) -> Optional[EdgeAccessor]:
        edge = self.storage._edges.get(gid)
        if edge is None:
            return None
        ea = EdgeAccessor(edge, self)
        if not ea.is_visible(view):
            return None
        return ea if self._fg_edge_ok(ea, view) else None

    def _fg_vertex_ok(self, va: "VertexAccessor", view: View) -> bool:
        fg = self.fine_grained
        return fg is None or fg.can_read_vertex(
            va._state(view, need_edges=False).labels)

    def _fg_edge_ok(self, ea: "EdgeAccessor", view: View) -> bool:
        fg = self.fine_grained
        if fg is None:
            return True
        if not fg.can_read_edge(ea.edge.edge_type):
            return False
        return fg.can_read_vertex(
            ea.from_vertex()._state(view, need_edges=False).labels) and \
            fg.can_read_vertex(
                ea.to_vertex()._state(view, need_edges=False).labels)

    def vertices(self, view: View = View.OLD) -> Iterator[VertexAccessor]:
        for vertex in list(self.storage._vertices.values()):
            va = VertexAccessor(vertex, self)
            if va.is_visible(view) and self._fg_vertex_ok(va, view):
                yield va

    def edges(self, view: View = View.OLD) -> Iterator[EdgeAccessor]:
        for edge in list(self.storage._edges.values()):
            ea = EdgeAccessor(edge, self)
            if ea.is_visible(view) and self._fg_edge_ok(ea, view):
                yield ea

    def vertices_by_label(self, label_id: int,
                          view: View = View.OLD) -> Iterator[VertexAccessor]:
        candidates = self.storage.indices.label.candidates(label_id)
        if candidates is None:
            # no index: full scan filter (planner avoids this when possible)
            for va in self.vertices(view):
                if va.has_label(label_id, view):
                    yield va
            return
        fg = self.fine_grained
        served = 0
        try:
            for vertex in candidates:
                st = self._vertex_state(vertex, view, need_edges=False)
                if not st.exists or st.deleted or label_id not in st.labels:
                    continue
                if fg is not None and not fg.can_read_vertex(st.labels):
                    continue
                served += 1
                yield VertexAccessor(vertex, self)
        finally:
            # mgstat: one usage record per index-served scan (flushed on
            # abandon too — LIMIT still accounts what it consumed)
            self.storage.indices.label.note_usage(label_id, served)

    def vertices_by_label_property_value(self, label_id: int,
                                         prop_ids: tuple[int, ...], values,
                                         view: View = View.OLD):
        candidates = self.storage.indices.label_property.candidates_equal(
            label_id, prop_ids, values)
        if candidates is None:
            for va in self.vertices_by_label(label_id, view):
                props = va.properties(view)
                if all(props.get(p) == v and props.get(p) is not None
                       for p, v in zip(prop_ids, values)):
                    yield va
            return
        fg = self.fine_grained
        served = 0
        try:
            for vertex in candidates:
                # one props-only materialization covers visibility, label,
                # auth, and value revalidation (was four walks per candidate)
                st = self._vertex_state(vertex, view, need_edges=False)
                if not st.exists or st.deleted or label_id not in st.labels:
                    continue
                if fg is not None and not fg.can_read_vertex(st.labels):
                    continue
                props = st.properties
                if all(props.get(p) == v for p, v in zip(prop_ids, values)):
                    served += 1
                    yield VertexAccessor(vertex, self)
        finally:
            self.storage.indices.label_property.note_usage(
                label_id, prop_ids, served)

    def vertices_by_label_property_range(self, label_id: int,
                                         prop_ids: tuple[int, ...],
                                         lower=None, upper=None,
                                         lower_inclusive=True,
                                         upper_inclusive=True,
                                         view: View = View.OLD):
        from .ordering import order_key
        candidates = self.storage.indices.label_property.candidates_range(
            label_id, prop_ids, lower, upper, lower_inclusive, upper_inclusive)
        index_served = candidates is not None
        if candidates is None:
            candidates = []
            for va in self.vertices_by_label(label_id, view):
                candidates.append(va.vertex)
        seen: set[int] = set()  # add-only index can hold several keys per gid
        served = 0
        try:
            for vertex in candidates:
                if vertex.gid in seen:
                    continue
                seen.add(vertex.gid)
                va = VertexAccessor(vertex, self)
                if not va.is_visible(view) or not va.has_label(label_id,
                                                               view):
                    continue
                if not self._fg_vertex_ok(va, view):
                    continue
                val = va.get_property(prop_ids[0], view)
                if val is None:
                    continue
                k = order_key(val)
                if lower is not None:
                    lk = order_key(lower)
                    if k < lk or (k == lk and not lower_inclusive):
                        continue
                if upper is not None:
                    uk = order_key(upper)
                    if k > uk or (k == uk and not upper_inclusive):
                        continue
                served += 1
                yield va
        finally:
            if index_served:
                self.storage.indices.label_property.note_usage(
                    label_id, prop_ids, served)

    def edges_by_type(self, edge_type_id: int,
                      view: View = View.OLD) -> Iterator[EdgeAccessor]:
        candidates = self.storage.indices.edge_type.candidates(edge_type_id)
        if candidates is None:
            for ea in self.edges(view):
                if ea.edge_type == edge_type_id:
                    yield ea
            return
        served = 0
        try:
            for edge in candidates:
                ea = EdgeAccessor(edge, self)
                if ea.is_visible(view) and self._fg_edge_ok(ea, view):
                    served += 1
                    yield ea
        finally:
            self.storage.indices.edge_type.note_usage(edge_type_id, served)

    # --- counts for the planner ---------------------------------------------

    def approx_vertex_count(self, label_id=None, prop_ids=None) -> int:
        if label_id is None:
            return len(self.storage._vertices)
        if prop_ids is None:
            if self.storage.indices.label.has(label_id):
                return self.storage.indices.label.approx_count(label_id)
            return len(self.storage._vertices)
        return self.storage.indices.label_property.approx_count(label_id, prop_ids)

    def approx_edge_count(self) -> int:
        return len(self.storage._edges)


class InMemoryStorage:
    """The storage engine. Owns objects, indexes, constraints, mappers."""

    # the planner's bulk-write fast lane (query/plan/bulk.py) only routes
    # through batch_insert() on engines that declare support — subclasses
    # with their own persistence model (disk storage) opt out
    supports_batch_insert = True

    def __init__(self, config: Optional[StorageConfig] = None) -> None:
        self.config = config or StorageConfig()
        self.label_mapper = NameIdMapper()
        self.property_mapper = NameIdMapper()
        self.edge_type_mapper = NameIdMapper()
        self.indices = Indices()
        self.constraints = Constraints()
        self.namer = _Namer(self)

        self._vertices: dict[Gid, Vertex] = {}
        self._edges: dict[Gid, Edge] = {}
        self._next_vertex_gid = 0
        self._next_edge_gid = 0
        self._gid_lock = tracked_lock("Storage._gid_lock")

        self._timestamp = 1  # commit timestamps; 0 reserved
        self._next_txn_id = TRANSACTION_ID_START + 1
        self._engine_lock = tracked_lock("Storage._engine_lock")
        self._active_txns: dict[int, Transaction] = {}
        # frame shipping order: sequence assigned under the engine lock,
        # consumers invoked strictly in sequence order (replicas must see
        # commits in commit-timestamp order)
        self._ship_cond = threading.Condition()
        self._next_ship_seq = 0
        self._frame_seq = 0

        self._topology_version = 0
        # bounded (version, frozenset(gids)|None) log backing
        # changes_between(); 1024 entries cover bursts of small commits
        from collections import deque
        self._change_log = deque(maxlen=1024)
        # monotone low-water mark: the version of the OLDEST entry the
        # log still holds. deque(maxlen=) drops entries silently, so wrap
        # detection must not depend on what happens to be retained —
        # changes_between answers (v_from, v_to] iff v_from + 1 >=
        # _oldest_logged_version, and returns a typed ChangeLogUnknowable
        # otherwise instead of a silently-partial delta.
        self._oldest_logged_version = 1
        self._change_log_lock = tracked_lock("Storage._change_log_lock")
        # mgsan shared-state declarations (MG006/MG007 + race detector):
        # gid counters under _gid_lock, engine bookkeeping under
        # _engine_lock, change log under _change_log_lock. The object
        # maps (_vertices/_edges) and per-object delta chains are
        # deliberately NOT declared: they synchronize through per-object
        # plain locks + GIL-atomic dict publication, and their
        # correctness is witnessed end-to-end by the MVCC isolation
        # checker instead of field annotations.
        shared_field(self, "_next_vertex_gid", "_next_edge_gid",
                     "_timestamp", "_next_txn_id", "_active_txns",
                     "_topology_version", "_change_log",
                     "_oldest_logged_version")
        # durability wiring: receives (frame_bytes, commit_ts) under the
        # engine lock, BEFORE the visibility flip (write-ahead ordering)
        self.wal_sink: Optional[Callable] = None
        # 2PC vote stage: run under the engine lock BEFORE the WAL write and
        # visibility flip; raising aborts the commit (STRICT_SYNC replicas)
        self.pre_commit_hooks: list[Callable] = []
        # replication etc.: receive the same (frame_bytes, commit_ts) after
        # the commit is visible (outside the engine lock)
        self.frame_consumers: list[Callable] = []
        self.on_commit_hooks: list[Callable] = []  # triggers (txn, commit_ts)
        # called with commit_ts when a commit fails AFTER the 2PC vote
        # succeeded (e.g. wal_sink raised) — lets replication send
        # finalize('abort') so replicas don't orphan prepared frames
        self.commit_abort_hooks: list[Callable] = []
        # stream name -> last durably-committed source position; written
        # by committing stream transactions, restored by recovery
        # (snapshot section + OP_STREAM_OFFSET replay) and by replication
        self.stream_offsets: dict[str, object] = {}

    # --- transactions -------------------------------------------------------

    def access(self, isolation: Optional[IsolationLevel] = None) -> Accessor:
        if getattr(self, "suspended", False):
            # a session that kept its USE DATABASE reference across a
            # SUSPEND must fail loudly, not write into an orphaned store
            raise StorageError(
                "this database is suspended; RESUME it first")
        return Accessor(self, isolation or self.config.isolation_level)

    def _begin_transaction(self, isolation: IsolationLevel) -> Transaction:
        with self._engine_lock:
            # gate + registration must be ATOMIC: a check outside this
            # lock could let a transaction slip past the suspend drain.
            # _suspend_internal lets the suspend flow's own snapshot
            # reader through after the drain completed.
            if getattr(self, "suspended", False) and                     not getattr(self, "_suspend_internal", False):
                raise StorageError(
                    "this database is suspended; RESUME it first")
            shared_write(self, "_next_txn_id")
            txn_id = self._next_txn_id
            self._next_txn_id += 1
            start_ts = self._timestamp
            txn = Transaction(txn_id, start_ts, isolation, self)
            self._active_txns[txn_id] = txn
            mvcc_event("begin", txn=txn_id, start_ts=start_ts)
            # captured under the SAME lock as the commit-side visibility
            # flip + bump, so an accessor's MVCC snapshot and its
            # topology snapshot can never disagree (version-keyed caches
            # would otherwise cache wrong data under this version)
            txn.topology_snapshot = self._topology_version
            return txn

    def latest_commit_ts(self) -> int:
        # single GIL-atomic int read; a stale value only makes a replica
        # lag gauge or catch-up decision conservative, never wrong
        return self._timestamp  # mglint: disable=MG006 — lock-free monotonic read is the contract

    def _check_db_memory_limit(self, txn: "Transaction") -> None:
        """Tenant-profile `storage_limit` (per-DB arena cap, reference:
        memory/db_arena.cpp): refuse GROWING commits once the database's
        estimated footprint exceeds it. Transactions that create no
        objects (deletes, label/property updates) always pass — an
        over-limit database must stay recoverable in-band via DETACH
        DELETE. The O(sample) estimate is recomputed at most every 5s
        and immediately when the limit value changes; writes inside
        that staleness window are admitted (sampling estimator, not an
        allocator hook — documented deviation)."""
        fn = getattr(self, "memory_limit_fn", None)
        if fn is None:
            return
        limit = fn()
        if not limit:
            return
        # growing = the txn created vertices/edges (their undo action
        # is DELETE_OBJECT); delete-only / update-only txns pass
        if not any(d.action is DeltaAction.DELETE_OBJECT
                   for d in txn.deltas):
            return
        import time as _time
        now = _time.monotonic()
        cached = getattr(self, "_arena_estimate", None)
        if cached is None or now - cached[0] > 5.0 or cached[2] != limit:
            cached = (now, self.memory_usage_estimate(), limit)
            self._arena_estimate = cached
        if cached[1] > limit:
            raise StorageError(
                f"database memory limit exceeded: ~{cached[1]:,} bytes "
                f"used, storage_limit {limit:,} (tenant profile)")

    def _commit(self, txn: Transaction) -> int:
        storage_mode = self.config.storage_mode
        if storage_mode is StorageMode.IN_MEMORY_ANALYTICAL or \
                not (txn.deltas or txn.stream_offsets):
            with self._engine_lock:
                self._active_txns.pop(txn.id, None)
                mvcc_event("commit", txn=txn.id, commit_ts=None, ro=True)
                # commit_ts stays None: a no-delta txn has no own writes to
                # expose, and advancing would leak later commits into a
                # read-only SI transaction's retained accessors
                return self._timestamp
        self._check_db_memory_limit(txn)

        # existence + type + unique constraints all walk the touched set —
        # skipped (and never materialized) when none are defined: bulk
        # commits touch hundreds of thousands of vertices
        constrained = bool(self.constraints.existence._constraints
                           or self.constraints.type._constraints
                           or self.constraints.unique._maps)
        touched = list(txn.touched_vertices.values()) if constrained else ()
        if self.constraints.existence._constraints or \
                self.constraints.type._constraints:
            for v in touched:
                if not v.deleted:
                    self.constraints.existence.validate_vertex(
                        v.labels, v.properties, self.namer)
                    self.constraints.type.validate_vertex(
                        v.labels, v.properties, self.namer)

        frame = None
        ship_seq = None
        with self._engine_lock:
            registrations = self.constraints.unique.validate_commit(
                touched, self.namer)
            shared_write(self, "_timestamp")
            self._timestamp += 1
            commit_ts = self._timestamp
            if self.wal_sink is not None or self.frame_consumers \
                    or self.pre_commit_hooks:
                # encode ONCE under the lock: object fields hold exactly this
                # transaction's final state here (no later writer can have
                # touched them yet — they'd need the lock to commit)
                # WAL frames come with the port's durability slice
                raise StorageError(
                    "commit hooks need WAL frames, which memgraph_tpu_torch "
                    "does not encode yet")
                for hook in self.pre_commit_hooks:
                    # 2PC vote: a raise here aborts the commit before any
                    # durability or visibility effect
                    hook(frame, commit_ts)
                if self.wal_sink is not None:
                    try:
                        self.wal_sink(frame, commit_ts)
                    except BaseException:
                        # the vote already succeeded: tell prepared replicas
                        # to drop the pending frame, or it is orphaned forever
                        for hook in self.commit_abort_hooks:
                            try:
                                hook(commit_ts)
                            except Exception:
                                log.exception(
                                    "commit abort hook failed for ts %d",
                                    commit_ts)
                        raise
                if self.frame_consumers:
                    ship_seq = self._frame_seq
                    self._frame_seq += 1
            # visibility flip: all the txn's deltas share this CommitInfo
            txn.commit_info.timestamp = commit_ts
            txn.commit_ts = commit_ts
            self.constraints.unique.apply_registrations(registrations)
            self._active_txns.pop(txn.id, None)
            # committed state changed → device snapshot caches must
            # re-export. INSIDE the engine lock: the bump must be atomic
            # with the visibility flip relative to _begin_transaction's
            # (start_ts, topology_snapshot) capture, or a reader could
            # key a cache entry at a version whose data it cannot see
            # edge-property commits must invalidate both endpoints too: the
            # delta-refresh path diffs edges of CHANGED nodes.
            # Every OTHER edge-touching path already put its endpoints in
            # touched_vertices, so only _edge_set_property's endpoint set
            # needs unioning — not a walk over every touched edge.
            changed = set(txn.touched_vertices)
            if txn.edge_prop_endpoint_gids:
                changed |= txn.edge_prop_endpoint_gids
            self._bump_topology(changed)
            if txn.stream_offsets:
                # the offsets are durable (WAL-framed above) — publish
                # them atomically with the commit's visibility flip
                self.stream_offsets.update(txn.stream_offsets)
            mvcc_event("commit", txn=txn.id, commit_ts=commit_ts)
        if ship_seq is not None:
            # strict shipping order across concurrent committers
            with self._ship_cond:
                while self._next_ship_seq != ship_seq:
                    self._ship_cond.wait()
            try:
                for consumer in self.frame_consumers:
                    consumer(frame, commit_ts)
            finally:
                with self._ship_cond:
                    self._next_ship_seq = ship_seq + 1
                    self._ship_cond.notify_all()
        if txn.batches:
            self._retire_batch_deltas(txn, commit_ts)
        if self.config.gc_aggressive:
            # eager delta reclamation after every commit
            # (reference: --storage-gc-aggressive)
            self.collect_garbage()
        return commit_ts

    def _retire_batch_deltas(self, txn: Transaction, commit_ts: int) -> None:
        """Eagerly sever the undo deltas of a committed bulk insert when no
        active transaction's snapshot predates the commit — the same rule
        GC's truncate applies, hit at the moment it is cheapest. A bulk
        load otherwise accumulates one delta per inserted object until the
        next GC cycle (millions of objects whose refcount cycles through
        obj.delta ↔ delta.obj), which measurably poisons cache locality at
        the 5M-edge scale."""
        if self.oldest_active_start_ts() <= commit_ts:
            return     # a concurrent reader may still need the undos
        ci = txn.commit_info
        for batch in txn.batches:
            for obj in batch.vertices:
                d = obj.delta
                if d is not None and d.commit_info is ci and d.next is None:
                    with obj.lock:
                        if obj.delta is d and d.next is None:
                            obj.delta = None
            for obj in batch.edges:
                d = obj.delta
                if d is not None and d.commit_info is ci and d.next is None:
                    with obj.lock:
                        if obj.delta is d and d.next is None:
                            obj.delta = None

    def _abort(self, txn: Transaction) -> None:
        # undo in reverse; our deltas are contiguous at each object's head
        mvcc_event("abort", txn=txn.id)
        from .delta import DeltaAction as A
        for delta in reversed(txn.deltas):
            obj = delta.obj
            with obj.lock:
                a = delta.action
                if a is A.DELETE_OBJECT:
                    obj.deleted = True  # created in this txn → now dead, GC removes
                elif a is A.RECREATE_OBJECT:
                    obj.deleted = False
                elif a is A.ADD_LABEL:
                    obj.labels.add(delta.payload)
                elif a is A.REMOVE_LABEL:
                    obj.labels.discard(delta.payload)
                elif a is A.SET_PROPERTY:
                    pid, prev = delta.payload
                    if prev is None:
                        obj.properties.pop(pid, None)
                    else:
                        obj.properties[pid] = prev
                elif a is A.ADD_IN_EDGE:
                    obj.in_edges.append(delta.payload)
                elif a is A.REMOVE_IN_EDGE:
                    try:
                        obj.in_edges.remove(delta.payload)
                    except ValueError:
                        pass
                elif a is A.ADD_OUT_EDGE:
                    obj.out_edges.append(delta.payload)
                elif a is A.REMOVE_OUT_EDGE:
                    try:
                        obj.out_edges.remove(delta.payload)
                    except ValueError:
                        pass
                elif a is A.REMOVE_IN_EDGES_BULK:
                    drop = set(delta.payload)
                    obj.in_edges = [e for e in obj.in_edges if e not in drop]
                elif a is A.REMOVE_OUT_EDGES_BULK:
                    drop = set(delta.payload)
                    obj.out_edges = [e for e in obj.out_edges
                                     if e not in drop]
                assert obj.delta is delta, "abort: delta chain corrupted"
                obj.delta = delta.next
        for v in txn.touched_vertices.values():
            # the undo loop rewrote adjacency lists directly; drop any lazy
            # adjacency maps so they rebuild from the restored lists
            v.adj_in = None
            v.adj_out = None
            self.indices.label_property.update_on_change(v)
        with self._engine_lock:
            self._active_txns.pop(txn.id, None)
        changed = set(txn.touched_vertices)
        if txn.edge_prop_endpoint_gids:
            changed |= txn.edge_prop_endpoint_gids
        self._bump_topology(changed)

    # --- GC -----------------------------------------------------------------

    def oldest_active_start_ts(self) -> int:
        with self._engine_lock:
            if not self._active_txns:
                return self._timestamp + 1
            return min(t.start_ts for t in self._active_txns.values())

    def collect_garbage(self) -> dict:
        """Truncate delta chains invisible to every active txn; drop dead objects.

        Reference analog: InMemoryStorage::CollectGarbage
        (inmemory/storage.cpp:573) + skip-list GC.
        """
        oldest = self.oldest_active_start_ts()
        stats = {"deltas_freed": 0, "vertices_freed": 0, "edges_freed": 0}
        # bulk ingest freezes the heap (batch_insert) so cyclic GC stops
        # rescanning live graph objects; thaw here so the vertex<->edge
        # reference cycles of objects THIS sweep drops become collectable
        import gc as _gc
        _gc.unfreeze()

        def truncate(obj) -> None:
            with obj.lock:
                delta = obj.delta
                prev = None
                while delta is not None:
                    ts = delta.commit_info.timestamp
                    if ts < TRANSACTION_ID_START and ts < oldest:
                        # this and everything older is invisible to all readers
                        n = 0
                        d = delta
                        while d is not None:
                            n += 1
                            d = d.next
                        stats["deltas_freed"] += n
                        if prev is None:
                            obj.delta = None
                        else:
                            prev.next = None
                        return
                    prev = delta
                    delta = delta.next

        dead_vertices = []
        for gid, v in list(self._vertices.items()):
            truncate(v)
            if v.deleted and v.delta is None:
                dead_vertices.append((gid, v))
        dead_edges = []
        for gid, e in list(self._edges.items()):
            truncate(e)
            if e.deleted and e.delta is None:
                dead_edges.append((gid, e))

        for gid, v in dead_vertices:
            for label_id in list(v.labels):
                self.indices.label.remove_entry(label_id, v)
            self.indices.label_property.remove_entry(v)
            self._vertices.pop(gid, None)
            stats["vertices_freed"] += 1
        for gid, e in dead_edges:
            self.indices.edge_type.remove_entry(e)
            self._edges.pop(gid, None)
            stats["edges_freed"] += 1
        stats["index_entries_swept"] = (self.indices.label.sweep()
                                        + self.indices.label_property.sweep())
        return stats

    # --- schema operations (run outside transactions, like the reference's
    #     unique-accessor index/constraint DDL) ------------------------------

    def create_label_index(self, label_id: int,
                           background: bool = False):
        """background=True returns immediately with the index populating
        on a worker thread (reference: async_indexer.cpp); queries during
        the build fall back to full scans — correct, just unindexed —
        until the returned ready event fires."""
        if background:
            # materialized lazily AFTER the bucket registers (concurrent
            # writers' add() must have a bucket to land in), as a list
            # (the live dict view would race commits)
            return self.indices.label.create_in_background(
                label_id, lambda: list(self._vertices.values()))
        self.indices.label.create(label_id, self._vertices.values())
        return None

    def create_label_property_index(self, label_id: int,
                                    prop_ids: tuple[int, ...]) -> None:
        self.indices.label_property.create(label_id, prop_ids,
                                           self._vertices.values())

    def create_edge_type_index(self, edge_type_id: int) -> None:
        self.indices.edge_type.create(edge_type_id, self._edges.values())

    def create_existence_constraint(self, label_id: int, prop_id: int) -> None:
        self.constraints.existence.create(label_id, prop_id,
                                          self._vertices.values(), self.namer)

    def create_unique_constraint(self, label_id: int,
                                 prop_ids: tuple[int, ...]) -> None:
        self.constraints.unique.create(label_id, prop_ids,
                                       self._vertices.values(), self.namer)

    def create_type_constraint(self, label_id: int, prop_id: int,
                               type_name: str) -> None:
        self.constraints.type.create(label_id, prop_id, type_name,
                                     self._vertices.values(), self.namer)

    # --- TPU snapshot cache signal ------------------------------------------

    def _bump_topology(self, changed_gids=None) -> None:
        """Bump the cache-invalidation version. changed_gids: vertex gids
        whose visible state may differ across the bump (None = unknown —
        consumers must fully rebuild). The bounded change log lets
        version-keyed caches (vector index) refresh O(delta) instead of
        O(n): every mutation path funnels here, INCLUDING replica WAL
        apply and recovery, so deltas are never silently missed
        (NOTES_ROUND2 hole #1)."""
        with self._change_log_lock:
            shared_write(self, "_change_log")
            self._topology_version += 1
            if len(self._change_log) == self._change_log.maxlen:
                # the append below silently drops the oldest entry —
                # advance the monotone low-water mark FIRST so wrap
                # detection never depends on the retained entries
                shared_write(self, "_oldest_logged_version")
                self._oldest_logged_version = self._change_log[0][0] + 1
            self._change_log.append(
                (self._topology_version,
                 frozenset(changed_gids) if changed_gids is not None
                 else None))

    @property
    def topology_version(self) -> int:
        # same contract as latest_commit_ts: monotonic int, stale reads
        # only cause an extra cache refresh
        return self._topology_version  # mglint: disable=MG006 — lock-free monotonic read is the contract

    @property
    def oldest_logged_version(self) -> int:
        """Monotone low-water mark of the bounded change log: the oldest
        version changes_between can still reach back PAST (a query with
        ``v_from + 1 < oldest_logged_version`` is unknowable)."""
        return self._oldest_logged_version  # mglint: disable=MG006 — lock-free monotonic read is the contract

    def changes_between(self, v_from: int, v_to: int):
        """Union of vertex gids changed in versions (v_from, v_to], or a
        falsy :class:`ChangeLogUnknowable` when the log cannot answer
        (the deque wrapped past v_from, or a bump in the range didn't
        record its gids). Consumers must handle the unknowable verdict
        explicitly and fall back to a full rebuild."""
        if v_from == v_to:
            return frozenset()
        with self._change_log_lock:
            shared_read(self, "_change_log")
            entries = list(self._change_log)
            shared_read(self, "_oldest_logged_version")
            oldest = self._oldest_logged_version
        if v_from + 1 < oldest or not entries:
            # log no longer reaches back to v_from (or never logged the
            # range at all) — detected via the monotone low-water mark,
            # not the retained entries, so a wrapped deque can never
            # produce a silently-partial delta
            return ChangeLogUnknowable("log_wrapped", oldest)
        out: set = set()
        for version, gids in entries:
            if version <= v_from or version > v_to:
                continue
            if gids is None:
                return ChangeLogUnknowable("untracked_bump", oldest)
            out |= gids
        return frozenset(out)

    # --- info ---------------------------------------------------------------

    def memory_usage_estimate(self) -> int:
        """Approximate live bytes held by THIS database's graph objects.

        Behavioral counterpart of the reference's per-DB arena
        accounting (memory/db_arena.cpp:204-283 — jemalloc arenas per
        database); CPython has no per-object arena hooks, so this
        samples up to 512 vertices/edges, deep-sizes them
        (object + labels + property keys/values + adjacency tuples),
        and scales by the population. O(sample), computed on demand."""
        import sys
        from itertools import islice

        def deep(obj) -> int:
            n = sys.getsizeof(obj)
            if isinstance(obj, dict):
                n += sum(deep(k) + deep(v) for k, v in obj.items())
            elif isinstance(obj, (list, tuple, set, frozenset)):
                n += sum(deep(x) for x in obj)
            return n

        def sample_total(pop: dict, size_fn) -> int:
            # snapshot the values list first: concurrent commits/GC
            # mutate these dicts (same defense as the GC sweep)
            values = list(pop.values())
            count = len(values)
            if count == 0:
                return 0
            sample = list(islice(values, 512))
            return int(sum(size_fn(o) for o in sample)
                       / len(sample) * count)

        v_bytes = sample_total(self._vertices, lambda v: (
            sys.getsizeof(v) + deep(v.labels) + deep(v.properties)
            + sys.getsizeof(v.in_edges) + sys.getsizeof(v.out_edges)
            + 72 * (len(v.in_edges) + len(v.out_edges))))
        e_bytes = sample_total(self._edges, lambda e: (
            sys.getsizeof(e) + deep(e.properties)))
        return v_bytes + e_bytes

    def info(self) -> dict:
        from ..utils.memory_tracker import GLOBAL
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return {
            "vertex_count": len(self._vertices),
            "edge_count": len(self._edges),
            "average_degree": (2 * len(self._edges) / len(self._vertices)
                               if self._vertices else 0.0),
            "storage_mode": self.config.storage_mode.value,
            "isolation_level": self.config.isolation_level.value,
            # tracked query-materialization memory + process peak RSS
            # (reference: utils/memory_tracker.cpp counters in storage info)
            "memory_tracked": GLOBAL.current,
            "peak_memory_tracked": GLOBAL.peak,
            "peak_memory_res": rss_kb * 1024,
            "memory_limit": GLOBAL.limit,
            # per-DB arena estimate (reference: memory/db_arena.cpp)
            "memory_usage_db_estimate": self.memory_usage_estimate(),
        }
