"""Columnar property snapshots: the read lane's input.

Port of memgraph_tpu/ops/columnar.py.  A scan's property reads are
exported once into dense typed columns (the export-and-cache contract of
the CSR snapshot in ops/csr.py), and the read lane (ops/pipeline.py)
filters and aggregates whole columns at once.

The port reads a storage through the duck-typed source of ops/csr.py, not
through a storage accessor: ``vertices(label_filter)`` gives the visible
vertex gids in the storage's order and ``vertex_property(name, gids)``
each one's value (None where absent).  An edge table reads
``edges(prop, None)`` once a property (its raw values, one an edge in the
storage's edge order) and, for the edges' own gids and type ids, the
source's optional ``edge_keys()`` ((gids, type ids) in that order; edge
i's position i and type 0 when the source has none).

Columns:
  kind "int"   int64 values  (aggregates over them stay integers)
  kind "float" float64 values
  kind "bool"  int8 0/1
  kind "str"   int32 dictionary codes + vocab (equality only)
  kind "other" present mask only (count(prop) works; predicates do not)
Absent properties are absent from ``present``.

``ColumnarCache`` keys a snapshot by (source version, label) with the
reference's column-level sharing: a later query that needs more
properties sweeps only the missing columns.  A source whose
``cacheable`` is false (storage/source.py's ``ScanSource`` of a
transaction with its own uncommitted writes, of a snapshot-isolation
transaction older than the newest commit, or of a fine-grained view: the
reference's ``_cacheable``) is exported fresh and never stored; a source
without the attribute is one committed view, and is cached.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Column:
    kind: str                      # int | float | bool | str | other
    values: np.ndarray | None      # typed values (None for "other")
    present: np.ndarray            # (n,) bool
    vocab: dict | None = None      # str value -> code, for kind "str"
    big: bool = False              # int column holds |v| > 2^53: a float
    #                                rhs comparison would lose exactness
    mixed: bool = False            # float column coerced from int+float
    #                                values: original per-row types lost


@dataclass
class ColumnarSnapshot:
    n: int
    gids: np.ndarray               # (n,) int64 storage gids
    columns: dict = field(default_factory=dict)   # prop name -> Column


def _classify(values: list, present: np.ndarray) -> Column:
    """Pick the narrowest uniform kind covering all present values."""
    kinds = set()
    for v, p in zip(values, present):
        if not p:
            continue
        if isinstance(v, bool):
            kinds.add("bool")
        elif isinstance(v, int):
            kinds.add("int")
        elif isinstance(v, float):
            kinds.add("float")
        elif isinstance(v, str):
            kinds.add("str")
        else:
            kinds.add("other")
        if len(kinds) > 1 and kinds != {"int", "float"}:
            return Column("other", None, present)
    if not kinds:
        return Column("other", None, present)
    if kinds == {"int"}:
        if any(p and not -2**63 <= v < 2**63
               for v, p in zip(values, present)):
            return Column("other", None, present)   # beyond int64
        out = np.zeros(len(values), dtype=np.int64)
        for i, (v, p) in enumerate(zip(values, present)):
            if p:
                out[i] = v
        big = any(p and not -2**53 <= v <= 2**53
                  for v, p in zip(values, present))
        return Column("int", out, present, big=big)
    if kinds <= {"int", "float"}:
        # mixed numerics coerce to f64; an int beyond 2^53 would lose
        # exactness (= / < would diverge from the row path): opt out
        if any(p and isinstance(v, int) and not -2**53 <= v <= 2**53
               for v, p in zip(values, present)):
            return Column("other", None, present)
        out = np.zeros(len(values), dtype=np.float64)
        for i, (v, p) in enumerate(zip(values, present)):
            if p:
                out[i] = v
        return Column("float", out, present, mixed=("int" in kinds))
    if kinds == {"bool"}:
        out = np.zeros(len(values), dtype=np.int8)
        for i, (v, p) in enumerate(zip(values, present)):
            if p:
                out[i] = 1 if v else 0
        return Column("bool", out, present)
    if kinds == {"str"}:
        vocab: dict = {}
        out = np.zeros(len(values), dtype=np.int32)
        for i, (v, p) in enumerate(zip(values, present)):
            if p:
                out[i] = vocab.setdefault(v, len(vocab))
        return Column("str", out, present, vocab)
    return Column("other", None, present)


def _python_values(raw, n: int) -> list:
    """A source's property read as one python value (or None) a row: a
    numpy array's scalars become python ints, floats and bools, which is
    what ``_classify`` sorts by."""
    if raw is None:
        return [None] * n
    if isinstance(raw, np.ndarray):
        if raw.ndim != 1:
            return [list(r) for r in raw.tolist()]
        return raw.tolist()
    return [v.item() if isinstance(v, np.generic) else v for v in raw]


def _numeric_column(raw: np.ndarray) -> Column | None:
    """``_classify``'s answer for a 1-D numeric array (every row present),
    found without a python loop; None for any other array."""
    if raw.ndim != 1 or raw.dtype.kind not in "iubf" or len(raw) == 0:
        return None
    present = np.ones(len(raw), dtype=bool)
    if raw.dtype.kind == "b":
        return Column("bool", raw.astype(np.int8), present)
    if raw.dtype.kind == "f":
        return Column("float", raw.astype(np.float64), present)
    lo, hi = int(raw.min()), int(raw.max())
    if lo < -2**63 or hi >= 2**63:
        return Column("other", None, present)      # beyond int64
    return Column("int", raw.astype(np.int64), present,
                  big=lo < -2**53 or hi > 2**53)


def _column(raw, n: int) -> Column:
    if isinstance(raw, np.ndarray):
        col = _numeric_column(raw)
        if col is not None:
            return col
    vals = _python_values(raw, n)
    present = np.fromiter((v is not None for v in vals), dtype=bool,
                          count=n)
    return _classify(vals, present)


def export_columns(source, label, props: tuple[str, ...],
                   abort_check=None) -> ColumnarSnapshot:
    """The source's visible vertices of ``label`` (or all), with the
    requested properties as typed columns.  ``abort_check`` (if given)
    is called once a column, so a terminated query stops the export."""
    gids = np.asarray(source.vertices(label), dtype=np.int64)
    snap = ColumnarSnapshot(n=len(gids), gids=gids)
    for p in props:
        if abort_check is not None:
            abort_check()
        snap.columns[p] = _column(source.vertex_property(p, gids),
                                  len(gids))
    return snap


@dataclass
class EdgeSnapshot:
    """Columnar edge table: one row per visible edge, with endpoint gids,
    type ids and requested edge-property columns (the edge analog of
    ColumnarSnapshot; feeds the columnar Expand collapse)."""
    n: int
    gids: np.ndarray               # (n,) int64 edge gids
    src: np.ndarray                # (n,) int64 from-vertex gids
    dst: np.ndarray                # (n,) int64 to-vertex gids
    type_ids: np.ndarray           # (n,) int32 edge type ids
    columns: dict = field(default_factory=dict)   # prop name -> Column


def export_edges(source, props: tuple[str, ...],
                 abort_check=None) -> EdgeSnapshot:
    """The source's visible edges with the requested properties."""
    src, dst, _ = source.edges(None, None)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n = len(src)
    keys = getattr(source, "edge_keys", None)
    if keys is not None:
        gids, types = keys()
    else:
        gids, types = np.arange(n), np.zeros(n)
    snap = EdgeSnapshot(n=n, gids=np.asarray(gids, dtype=np.int64),
                        src=src, dst=dst,
                        type_ids=np.asarray(types, dtype=np.int32))
    for p in props:
        if abort_check is not None:
            abort_check()
        snap.columns[p] = _column(source.edges(p, None)[2], n)
    return snap


class ColumnarCache:
    """Per-storage cache keyed by (source version, label, props).

    A snapshot is stored only when the source's version did not move
    while it was read (a mixed sweep is served once, never shared)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _get_cached(self, source, key, props, export_fn):
        """Per (version, key) entries with column-level sharing: a later
        query needing extra properties sweeps only the missing columns
        (row order is stable within a version, so columns from separate
        sweeps align; checked by row count).  The version is read by the
        caller before the sweep, embedded in ``key``."""
        storage = source.storage
        with self._lock:
            per = self._cache.get(storage)
            entry = per.get(key) if per else None
        missing = tuple(p for p in props
                        if entry is None or p not in entry.columns)
        if missing or entry is None:
            snap = export_fn(missing)
            if source.version != key[0]:
                # the version moved mid-sweep: never store it; serve this
                # caller a fresh full (uncached) build
                if missing != props:
                    snap = export_fn(props)
                return snap
            with self._lock:
                per = self._cache.get(storage) or {}
                per = {k: v for k, v in per.items() if k[0] == key[0]}
                entry = per.get(key)
                if entry is None:
                    entry = snap
                elif entry.n == snap.n:
                    for p in missing:
                        entry.columns.setdefault(p, snap.columns[p])
                else:   # should not happen within one version
                    entry = snap
                per[key] = entry
                self._cache[storage] = per
        return entry

    def get(self, source, label, props: tuple[str, ...],
            abort_check=None) -> ColumnarSnapshot:
        version = source.version
        if not getattr(source, "cacheable", True):
            return export_columns(source, label, props, abort_check)
        return self._get_cached(
            source, (version, label), tuple(props),
            lambda ps: export_columns(source, label, ps, abort_check))

    def get_edges(self, source, props: tuple[str, ...],
                  abort_check=None) -> EdgeSnapshot:
        """The edge table under (version, _EDGES_KEY), as ``get``."""
        version = source.version
        if not getattr(source, "cacheable", True):
            return export_edges(source, props, abort_check)
        return self._get_cached(
            source, (version, _EDGES_KEY), tuple(props),
            lambda ps: export_edges(source, ps, abort_check))


_EDGES_KEY = "\x00edges"   # no label can collide (labels never hold NUL)

COLUMNAR_CACHE = ColumnarCache()
