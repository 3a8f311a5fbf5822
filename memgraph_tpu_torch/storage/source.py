"""The port's storage read as a snapshot source.

The device layers of the port (``ops/csr.py``'s ``GraphCache``,
``ops/columnar.py``'s ``ColumnarCache``, the procedures) read a graph
through a duck-typed **source** (its protocol is in ops/csr.py's module
docstring), so that they import nothing of the storage that owns it.
These classes are that source over an ``Accessor`` of the port's own
``InMemoryStorage``.

``StorageSource`` reads as memgraph_tpu/ops/csr.py's ``export_csr`` and
``export_csr_delta`` read the accessor: the storage's vertex and edge
maps in their order, objects without a delta chain directly, the others
through MVCC at ``view`` (``View.OLD`` by default), with no session's
fine-grained filter (a cached snapshot is every session's).  Its
``version`` is the transaction's topology snapshot.

``ScanSource`` reads as memgraph_tpu/ops/columnar.py's
``export_columns`` and ``export_edges`` read the accessor: its own
``vertices`` / ``vertices_by_label`` / ``edges`` walks at the query's
view, fine-grained filter and index usage accounting included (without a
fine-grained filter the edges as ``StorageSource`` reads them: the same
edges in the same order).  Its
``version`` is the storage's live topology version, and ``cacheable``
says whether a snapshot of this view may be shared (the reference's
``ColumnarCache._cacheable``).
"""

from __future__ import annotations

from .common import IsolationLevel, View
from .storage import ChangeLogUnknowable, EdgeAccessor, VertexAccessor


class StorageSource:
    """The snapshot source over ``accessor`` at ``view``."""

    def __init__(self, accessor, view: View = View.OLD) -> None:
        self.accessor = accessor
        self.storage = accessor.storage
        self.view = view

    @property
    def version(self):
        v = getattr(self.accessor, "topology_snapshot", None)
        return self.storage.topology_version if v is None else v

    def changes_between(self, v_from, v_to):
        from ..ops.csr import ChangeLogUnknowable as Unknowable
        got = self.storage.changes_between(v_from, v_to)
        if isinstance(got, ChangeLogUnknowable):
            return Unknowable(got.reason, got.oldest_logged_version)
        return got

    def _prop(self, name):
        """A property's id: names are looked up, ids pass through."""
        if isinstance(name, str):
            return self.storage.property_mapper.maybe_name_to_id(name)
        return name

    def vertices(self, label_filter=None):
        acc, view = self.accessor, self.view
        out = []
        for vertex in list(self.storage._vertices.values()):
            if vertex.delta is None:
                if vertex.deleted or (label_filter is not None
                                      and label_filter not in vertex.labels):
                    continue
            else:
                va = VertexAccessor(vertex, acc)
                if not va.is_visible(view) or (
                        label_filter is not None
                        and not va.has_label(label_filter, view)):
                    continue
            out.append(vertex.gid)
        return out

    def _visible_edges(self):
        """(edge, its properties at the view) of each visible edge."""
        acc, view = self.accessor, self.view
        for edge in list(self.storage._edges.values()):
            if edge.delta is None:
                if edge.deleted:
                    continue
                yield edge, edge.properties
            else:
                ea = EdgeAccessor(edge, acc)
                if ea.is_visible(view):
                    yield edge, ea.properties(view)

    def edges(self, weight_property=None, edge_type_filter=None):
        wp = self._prop(weight_property)
        src, dst, ws = [], [], []
        for edge, props in self._visible_edges():
            if edge_type_filter is not None \
                    and edge.edge_type not in edge_type_filter:
                continue
            src.append(edge.from_vertex.gid)
            dst.append(edge.to_vertex.gid)
            ws.append(props.get(wp) if props else None)
        return src, dst, (ws if wp is not None else None)

    def edge_keys(self):
        gids, types = [], []
        for edge, _props in self._visible_edges():
            gids.append(edge.gid)
            types.append(edge.edge_type)
        return gids, types

    def incident(self, gid, weight_property=None, edge_type_filter=None,
                 label_filter=None):
        acc, view = self.accessor, self.view
        vertex = self.storage._vertices.get(gid)
        if vertex is None:
            return None
        va = VertexAccessor(vertex, acc)
        visible = va.is_visible(view)
        if label_filter is not None and visible:
            visible = va.has_label(label_filter, view)
        if not visible:
            return None
        wp = self._prop(weight_property)
        # the accessor's raw state: no session filter
        st = acc._vertex_state(vertex, view)
        out = []
        for entries, far in ((st.out_edges, "to_vertex"),
                             (st.in_edges, "from_vertex")):
            gids, ws = [], []
            for (etype, _other, edge) in entries:
                if edge_type_filter is not None \
                        and etype not in edge_type_filter:
                    continue
                ea = EdgeAccessor(edge, acc)
                if not ea.is_visible(view):
                    continue
                gids.append(getattr(edge, far).gid)
                ws.append(ea.properties(view).get(wp))
            out += [gids, ws if wp is not None else None]
        return tuple(out)

    def _accessor_of(self, gid):
        """The visible vertex of ``gid`` at the view, or None."""
        vertex = self.storage._vertices.get(int(gid))
        if vertex is None:
            return None
        va = VertexAccessor(vertex, self.accessor)
        return va if va.is_visible(self.view) else None

    def vertex_property(self, name, gids):
        pid = self._prop(name)
        if pid is None:
            return None
        out = []
        for gid in gids:
            va = self._accessor_of(gid)
            out.append(None if va is None
                       else va.get_property(pid, self.view))
        return out

    def vertex_records(self, gids):
        storage, view = self.storage, self.view
        out = []
        for gid in gids:
            va = self._accessor_of(gid)
            if va is None:
                out.append(None)
                continue
            labels = [storage.label_mapper.id_to_name(lb)
                      for lb in va.labels(view)]
            props = {storage.property_mapper.id_to_name(pid): val
                     for pid, val in va.properties(view).items()}
            out.append((labels, props))
        return out


class ScanSource(StorageSource):
    """The source the read lane's columnar scans read: the accessor's own
    walks at the query's view (see the module docstring)."""

    def __init__(self, accessor, view: View = View.OLD) -> None:
        super().__init__(accessor, view)
        self._walked: dict = {}
        self._edge_walk = None

    @property
    def version(self):
        return self.storage.topology_version

    @property
    def cacheable(self) -> bool:
        """Whether this view is the latest committed state, so that a
        snapshot of it may be shared: not under a fine-grained filter,
        not for a transaction with writes of its own, and only for a
        snapshot-isolation transaction that began after the newest
        commit."""
        acc = self.accessor
        if getattr(acc, "fine_grained", None) is not None:
            return False
        txn = acc.txn
        if txn is None:
            return True
        if getattr(txn, "deltas", None):
            return False
        if txn.isolation is not IsolationLevel.SNAPSHOT_ISOLATION:
            return False
        return txn.effective_start_ts() >= self.storage.latest_commit_ts()

    def vertices(self, label_filter=None):
        acc, view = self.accessor, self.view
        it = (acc.vertices(view) if label_filter is None
              else acc.vertices_by_label(label_filter, view))
        walked = {}
        for va in it:
            walked[va.gid] = va
        self._walked = walked
        return list(walked)

    def vertex_property(self, name, gids):
        pid = self._prop(name)
        if pid is None:
            return None
        out = []
        for gid in gids:
            va = self._walked.get(int(gid))
            if va is None:
                va = self._accessor_of(gid)
            out.append(None if va is None
                       else va.properties(self.view).get(pid))
        return out

    def _visible_edges(self):
        """(edge, its properties at the view) of each visible edge, as the
        accessor's ``edges`` walk gives them: under a fine-grained filter
        that walk itself, else ``StorageSource``'s (the same edges in the
        same order, delta-free ones read directly).  Walked once and kept
        for the export's later reads (its keys and each property
        column)."""
        if self._edge_walk is None:
            acc, view = self.accessor, self.view
            if getattr(acc, "fine_grained", None) is None:
                walk = super()._visible_edges()
            else:
                walk = ((ea.edge, ea.properties(view))
                        for ea in acc.edges(view))
            self._edge_walk = list(walk)
        return self._edge_walk
