"""Label and label+property indexes.

Capability map to the reference's storage/v2/indices/: LabelIndex and
LabelPropertyIndex (incl. composite properties and range scans) with
MVCC-correct reads — index entries are inserted eagerly at mutation time and
*revalidated against the reader's snapshot* at scan time; stale entries are
swept by GC. Per-index counts feed the planner's cost model
(plan/cost_estimator analog).

Ordered range scans use bisect over a sorted (order_key, gid) list that is
maintained incrementally; point lookups use hash buckets.

Copy of memgraph_tpu/storage/indexes.py for the port (its imports the port's own).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict

from ..utils.locks import tracked_lock
from .ordering import order_key


class IndexUsage:
    """Per-index usage accounting: lookups served, rows
    returned, last-used wall time — surfaced by SHOW INDEX INFO so an
    index that only ever absorbs writes is visible instead of silent
    overhead. Updated once per scan (the scan's row count accumulates
    locally and flushes in the iterator's ``finally``), so abandoned
    iterators (LIMIT) still account what they served."""

    __slots__ = ("lookups", "rows", "last_used")

    def __init__(self) -> None:
        self.lookups = 0
        self.rows = 0
        self.last_used = 0.0

    def note(self, rows: int) -> None:
        import time
        self.lookups += 1
        self.rows += rows
        self.last_used = time.time()


class LabelIndex:
    """label_id -> insertion-ordered dict of candidate vertices.

    Supports BACKGROUND population (reference:
    src/storage/v2/async_indexer.cpp): a populating index accepts live
    writer additions but serves no candidates until its ready gate opens,
    so concurrent readers fall back to full scans and never see a
    half-built index.
    """

    def __init__(self) -> None:
        self._lock = tracked_lock("LabelIndex._lock")
        self._index: dict[int, dict] = {}
        self._ready: dict[int, threading.Event] = {}
        self._usage: dict[int, IndexUsage] = {}

    def create(self, label_id: int, vertices) -> None:
        with self._lock:
            bucket = self._index.setdefault(label_id, {})
            event = self._ready.setdefault(label_id, threading.Event())
        for v in vertices:
            if label_id in v.labels and not v.deleted:
                bucket[v.gid] = v
        event.set()

    def create_in_background(self, label_id: int,
                             vertices_fn) -> threading.Event:
        """Register the index immediately, populate on a worker thread;
        returns the ready event. `vertices_fn` materializes the vertex
        snapshot and is called only AFTER registration, so a concurrent
        writer's add() cannot fall in the unregistered window and be
        lost."""
        with self._lock:
            bucket = self._index.setdefault(label_id, {})
            event = self._ready.setdefault(label_id, threading.Event())
            if event.is_set():
                return event            # already populated

        def populate():
            try:
                for v in vertices_fn():
                    if label_id in v.labels and not v.deleted:
                        bucket[v.gid] = v
                with self._lock:
                    still_ours = self._ready.get(label_id) is event
            except Exception:
                # failed population: drop the shell so readers keep the
                # (correct) fallback path and DDL can retry
                import logging
                logging.getLogger(__name__).exception(
                    "background population of label index %d failed — "
                    "dropping the shell; CREATE INDEX can be retried",
                    label_id)
                self.drop(label_id)
                still_ours = False
            # ALWAYS wake waiters; serving is gated on the registry so a
            # concurrently-dropped index is never resurrected (we write
            # only into the captured bucket, never re-register)
            event.set()
            if not still_ours:
                bucket.clear()

        threading.Thread(target=populate, daemon=True,
                         name=f"index-build-{label_id}").start()
        return event

    def drop(self, label_id: int) -> bool:
        with self._lock:
            self._ready.pop(label_id, None)
            self._usage.pop(label_id, None)
            return self._index.pop(label_id, None) is not None

    def note_usage(self, label_id: int, rows: int) -> None:
        with self._lock:
            usage = self._usage.get(label_id)
            if usage is None:
                usage = self._usage[label_id] = IndexUsage()
            usage.note(rows)

    def usage(self, label_id: int) -> IndexUsage | None:
        return self._usage.get(label_id)

    def has(self, label_id: int) -> bool:
        return label_id in self._index

    def ready(self, label_id: int) -> bool:
        event = self._ready.get(label_id)
        return event is not None and event.is_set()

    def wait_ready(self, label_id: int, timeout: float | None = None) -> bool:
        event = self._ready.get(label_id)
        return event.wait(timeout) if event is not None else False

    def labels(self) -> list[int]:
        return list(self._index)

    def add(self, label_id: int, vertex) -> None:
        # populating buckets take live additions too: a commit racing the
        # background build must not be lost
        bucket = self._index.get(label_id)
        if bucket is not None:
            bucket[vertex.gid] = vertex

    def bulk_add(self, label_id: int, vertices) -> None:
        """Deferred batch maintenance: one dict update for a whole batch
        instead of per-row add() calls."""
        bucket = self._index.get(label_id)
        if bucket is not None:
            bucket.update((v.gid, v) for v in vertices)

    def candidates(self, label_id: int):
        bucket = self._index.get(label_id)
        if bucket is None or not self.ready(label_id):
            return None                 # not (yet) usable: callers scan
        return list(bucket.values())

    def approx_count(self, label_id: int) -> int:
        bucket = self._index.get(label_id)
        return len(bucket) if bucket is not None else 0

    def remove_entry(self, label_id: int, vertex) -> None:
        bucket = self._index.get(label_id)
        if bucket is not None:
            bucket.pop(vertex.gid, None)

    def sweep(self) -> int:
        """Drop entries for settled vertices that no longer carry the label."""
        removed = 0
        with self._lock:
            for label_id, bucket in self._index.items():
                stale = [gid for gid, v in bucket.items()
                         if v.delta is None
                         and (v.deleted or label_id not in v.labels)]
                for gid in stale:
                    del bucket[gid]
                removed += len(stale)
        return removed


class LabelPropertyIndex:
    """(label_id, (prop_id, ...)) -> sorted entries for range scans.

    Composite keys supported, as in the reference's composite label+property
    indexes. Entries are (sort_key, gid, vertex, values) kept sorted so range
    scans are bisect + slice.

    MVCC discipline (same as the reference's skip-list indexes): entries are
    **add-only** — a property change *adds* an entry under the new key and
    keeps the old one, because concurrent snapshot readers may still need to
    find the vertex under its old value. Scans revalidate every candidate
    against the reader's snapshot; stale entries are swept by GC once the
    vertex's delta chain is fully collected (no reader can need them).
    """

    def __init__(self) -> None:
        self._lock = tracked_lock("LabelPropertyIndex._lock")
        # key -> {"sorted": list[(key_tuple, gid, vertex, values)],
        #         "by_gid": dict[gid, set[key_tuple]],
        #         "eq": dict[key_tuple, list[vertex]]}   (point lookups)
        self._index: dict[tuple[int, tuple[int, ...]], dict] = {}
        self._usage: dict[tuple[int, tuple[int, ...]], IndexUsage] = {}

    @staticmethod
    def _entry_key(values) -> tuple:
        return tuple(order_key(v) for v in values)

    def create(self, label_id: int, prop_ids: tuple[int, ...], vertices) -> None:
        with self._lock:
            slot = self._index.setdefault((label_id, prop_ids),
                                          {"sorted": [], "by_gid": {},
                                           "eq": {}})
        for v in vertices:
            self.maybe_add(label_id, prop_ids, v)
        # created concurrently with writes in principle; final sort for safety
        slot["sorted"].sort(key=lambda e: (e[0], e[1]))

    def drop(self, label_id: int, prop_ids: tuple[int, ...]) -> bool:
        with self._lock:
            self._usage.pop((label_id, prop_ids), None)
            return self._index.pop((label_id, prop_ids), None) is not None

    def note_usage(self, label_id: int, prop_ids: tuple[int, ...],
                   rows: int) -> None:
        with self._lock:
            key = (label_id, prop_ids)
            usage = self._usage.get(key)
            if usage is None:
                usage = self._usage[key] = IndexUsage()
            usage.note(rows)

    def usage(self, label_id: int,
              prop_ids: tuple[int, ...]) -> IndexUsage | None:
        return self._usage.get((label_id, prop_ids))

    def has(self, label_id: int, prop_ids: tuple[int, ...]) -> bool:
        return (label_id, prop_ids) in self._index

    def keys(self) -> list[tuple[int, tuple[int, ...]]]:
        return list(self._index)

    def relevant_to(self, label_id: int):
        """All composite keys on this label (for planner rewrites)."""
        return [k for k in self._index if k[0] == label_id]

    def maybe_add(self, label_id: int, prop_ids: tuple[int, ...], vertex) -> None:
        """Insert vertex if it currently has the label and all properties."""
        slot = self._index.get((label_id, prop_ids))
        if slot is None:
            return
        if label_id not in vertex.labels or vertex.deleted:
            return
        values = []
        for pid in prop_ids:
            if pid not in vertex.properties:
                return
            values.append(vertex.properties[pid])
        self._insert(slot, vertex, values)

    def _insert(self, slot, vertex, values) -> None:
        key = self._entry_key(values)
        with self._lock:
            keys = slot["by_gid"].setdefault(vertex.gid, set())
            if key in keys:
                return
            keys.add(key)
            bisect.insort(slot["sorted"], (key, vertex.gid, vertex, tuple(values)),
                          key=lambda e: (e[0], e[1]))
            slot["eq"].setdefault(key, []).append(vertex)

    def update_on_change(self, vertex) -> None:
        """Add entries for the vertex's current state (add-only, see class doc)."""
        for (label_id, prop_ids) in list(self._index):
            self.maybe_add(label_id, prop_ids, vertex)

    def bulk_add(self, vertices) -> None:
        """Deferred batch maintenance: per index, collect every qualifying
        entry for the batch, sort ONCE, and splice into the sorted entry
        list with a single linear merge — replacing one O(log n) bisect +
        O(n) insort memmove per row with O((n+m)) per batch."""
        for (label_id, prop_ids), slot in list(self._index.items()):
            fresh = []
            for v in vertices:
                if label_id not in v.labels or v.deleted:
                    continue
                values = []
                for pid in prop_ids:
                    if pid not in v.properties:
                        values = None
                        break
                    values.append(v.properties[pid])
                if values is None:
                    continue
                fresh.append((self._entry_key(values), v.gid, v,
                              tuple(values)))
            if not fresh:
                continue
            fresh.sort(key=lambda e: (e[0], e[1]))
            with self._lock:
                by_gid = slot["by_gid"]
                deduped = []
                for entry in fresh:
                    keys = by_gid.setdefault(entry[1], set())
                    if entry[0] in keys:
                        continue
                    keys.add(entry[0])
                    deduped.append(entry)
                if not deduped:
                    continue
                eq = slot["eq"]
                for entry in deduped:
                    eq.setdefault(entry[0], []).append(entry[2])
                old = slot["sorted"]
                if old and (old[-1][0], old[-1][1]) <= \
                        (deduped[0][0], deduped[0][1]):
                    # common bulk-load case: fresh keys all sort after the
                    # existing tail (monotonic ids) — plain extend
                    old.extend(deduped)
                else:
                    merged = []
                    i = j = 0
                    while i < len(old) and j < len(deduped):
                        if (old[i][0], old[i][1]) <= \
                                (deduped[j][0], deduped[j][1]):
                            merged.append(old[i])
                            i += 1
                        else:
                            merged.append(deduped[j])
                            j += 1
                    merged.extend(old[i:])
                    merged.extend(deduped[j:])
                    slot["sorted"] = merged

    def remove_entry(self, vertex) -> None:
        """Drop every entry for a dead (GC'd) vertex."""
        with self._lock:
            for slot in self._index.values():
                keys = slot["by_gid"].pop(vertex.gid, None)
                if keys is not None:
                    slot["sorted"] = [e for e in slot["sorted"]
                                      if e[1] != vertex.gid]
                    eq = slot["eq"]
                    for key in keys:
                        bucket = eq.get(key)
                        if bucket is not None:
                            bucket[:] = [v for v in bucket
                                         if v.gid != vertex.gid]
                            if not bucket:
                                del eq[key]

    def sweep(self) -> int:
        """Drop stale entries for settled vertices (delta chain fully GC'd).

        Called from storage GC. A settled vertex has exactly one visible
        state, so any entry whose key no longer matches it is unreachable.
        """
        removed = 0
        with self._lock:
            for (label_id, prop_ids), slot in self._index.items():
                keep = []
                by_gid: dict[int, set] = {}
                for entry in slot["sorted"]:
                    key, gid, vertex, values = entry
                    if vertex.delta is None:
                        stale = (vertex.deleted
                                 or label_id not in vertex.labels
                                 or any(p not in vertex.properties
                                        for p in prop_ids)
                                 or self._entry_key(
                                     [vertex.properties[p] for p in prop_ids])
                                 != key)
                        if stale:
                            removed += 1
                            continue
                    keep.append(entry)
                    by_gid.setdefault(gid, set()).add(key)
                eq: dict = {}
                for key, _gid, vertex, _values in keep:
                    eq.setdefault(key, []).append(vertex)
                slot["sorted"] = keep
                slot["by_gid"] = by_gid
                slot["eq"] = eq
        return removed

    # --- scans --------------------------------------------------------------

    def candidates_equal(self, label_id, prop_ids, values):
        slot = self._index.get((label_id, prop_ids))
        if slot is None:
            return None
        # hash bucket per key: point lookups skip the sorted list entirely
        return list(slot["eq"].get(self._entry_key(values), ()))

    def candidates_range(self, label_id, prop_ids, lower=None, upper=None,
                         lower_inclusive=True, upper_inclusive=True):
        """Range over the FIRST property of the composite key."""
        slot = self._index.get((label_id, prop_ids))
        if slot is None:
            return None
        entries = slot["sorted"]
        lo_i, hi_i = 0, len(entries)
        if lower is not None:
            k = (order_key(lower),)
            lo_i = (bisect.bisect_left(entries, k, key=lambda e: (e[0][0],))
                    if lower_inclusive else
                    bisect.bisect_right(entries, k, key=lambda e: (e[0][0],)))
        if upper is not None:
            k = (order_key(upper),)
            hi_i = (bisect.bisect_right(entries, k, key=lambda e: (e[0][0],))
                    if upper_inclusive else
                    bisect.bisect_left(entries, k, key=lambda e: (e[0][0],)))
        return [e[2] for e in entries[lo_i:hi_i]]

    def candidates_all(self, label_id, prop_ids):
        slot = self._index.get((label_id, prop_ids))
        if slot is None:
            return None
        return [e[2] for e in slot["sorted"]]

    def approx_count(self, label_id, prop_ids) -> int:
        slot = self._index.get((label_id, prop_ids))
        return len(slot["sorted"]) if slot is not None else 0


class EdgeTypeIndex:
    """edge_type_id -> dict of candidate edges (reference: indices/edge_type_index)."""

    def __init__(self) -> None:
        self._index: dict[int, dict] = {}
        self._usage: dict[int, IndexUsage] = {}

    def create(self, edge_type_id: int, edges) -> None:
        bucket = self._index.setdefault(edge_type_id, {})
        for e in edges:
            if e.edge_type == edge_type_id and not e.deleted:
                bucket[e.gid] = e

    def drop(self, edge_type_id: int) -> bool:
        self._usage.pop(edge_type_id, None)
        return self._index.pop(edge_type_id, None) is not None

    def note_usage(self, edge_type_id: int, rows: int) -> None:
        usage = self._usage.get(edge_type_id)
        if usage is None:
            usage = self._usage[edge_type_id] = IndexUsage()
        usage.note(rows)

    def usage(self, edge_type_id: int) -> IndexUsage | None:
        return self._usage.get(edge_type_id)

    def has(self, edge_type_id: int) -> bool:
        return edge_type_id in self._index

    def types(self) -> list[int]:
        return list(self._index)

    def add(self, edge) -> None:
        bucket = self._index.get(edge.edge_type)
        if bucket is not None:
            bucket[edge.gid] = edge

    def bulk_add(self, edges) -> None:
        """Deferred batch maintenance: group by type, one update per bucket."""
        if not self._index:
            return
        by_type: dict[int, list] = {}
        for e in edges:
            by_type.setdefault(e.edge_type, []).append(e)
        for etype, group in by_type.items():
            bucket = self._index.get(etype)
            if bucket is not None:
                bucket.update((e.gid, e) for e in group)

    def candidates(self, edge_type_id: int):
        bucket = self._index.get(edge_type_id)
        if bucket is None:
            return None
        return list(bucket.values())

    def approx_count(self, edge_type_id: int) -> int:
        bucket = self._index.get(edge_type_id)
        return len(bucket) if bucket is not None else 0

    def remove_entry(self, edge) -> None:
        bucket = self._index.get(edge.edge_type)
        if bucket is not None:
            bucket.pop(edge.gid, None)


class Indices:
    """Bundle owned by the storage engine."""

    def __init__(self) -> None:
        self.label = LabelIndex()
        self.label_property = LabelPropertyIndex()
        self.edge_type = EdgeTypeIndex()
        # ANALYZE GRAPH results: (label_id, prop_id_tuple) -> stats dict
        # (() for plain label indexes); dropped alongside the index
        self.analyze_stats: dict = {}
        # vector / text / point indexes attach here (separate modules)
        self.vector = None
        self.text = None
        self.point = None

    def drop_stats(self, label_id: int, prop_ids: tuple = None) -> None:
        """Forget ANALYZE stats for a dropped index (all prefixes)."""
        if prop_ids is None:
            self.analyze_stats.pop((label_id, ()), None)
            return
        for k in [k for k in self.analyze_stats
                  if k[0] == label_id and k[1]
                  and k[1] == prop_ids[:len(k[1])]]:
            del self.analyze_stats[k]
