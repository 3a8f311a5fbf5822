"""Recovery: latest snapshot + newer WAL transactions → storage state.

Counterpart of the reference's recovery orchestration
(memgraph/src/storage/v2/durability/durability.cpp): pick the newest
loadable snapshot, rebuild objects/indexes/constraints, then replay WAL
transactions with commit_ts greater than the snapshot timestamp.

Copy of memgraph_tpu/storage/durability/recovery.py for the port.  What
differs: ``recover``'s stats also give its seconds by stage (``load_s``:
reading the snapshot file, ``apply_s``: rebuilding objects, indexes and
constraints from it, ``replay_s``: the WAL).  As in the reference, every
recovery ends in ``storage._bump_topology()`` with no changed set: the
recovered objects are new, so the port's snapshot cache and warm pool
must export and plan them afresh, never by a delta from a snapshot of
what was there before.
"""

from __future__ import annotations

import logging
import os
import time
from io import BytesIO

from ...exceptions import DurabilityError
from ...utils.ids import NameIdMapper
from .snapshot import list_snapshots, load_snapshot
from . import wal as W
from ..property_store import _read_varint, decode_value

log = logging.getLogger(__name__)


def recover(storage) -> dict:
    """Full recovery into an (assumed empty) storage. Returns stats.

    WAL segments replay streamed (constant memory) in seqnum order; a
    damaged record truncates that segment's replay at the last complete
    transaction before it, and a hole in the segment chain refuses
    recovery outright (replaying around it would forge history)."""
    stats = {"snapshot": None, "wal_transactions": 0, "wal_corruption": [],
             "load_s": 0.0, "apply_s": 0.0, "replay_s": 0.0}
    snaps = list_snapshots(storage)
    snapshot_ts = 0
    if snaps:
        path = snaps[-1][0]
        t0 = time.perf_counter()
        data = load_snapshot(path)
        t1 = time.perf_counter()
        _apply_snapshot(storage, data)
        stats["load_s"] = t1 - t0
        stats["apply_s"] = time.perf_counter() - t1
        snapshot_ts = data["timestamp"]
        stats["snapshot"] = path
        del data
    t0 = time.perf_counter()
    segments = W.list_wal_segments(storage)
    W.check_segment_chain(segments)
    for wal_path, _seq in segments:
        def note(reason, offset, _p=wal_path):
            stats["wal_corruption"].append((_p, reason, offset))
        for commit_ts, ops in W.iter_wal_transactions(wal_path, note):
            if commit_ts <= snapshot_ts:
                continue
            _apply_wal_txn(storage, ops)
            stats["wal_transactions"] += 1
            with storage._engine_lock:
                storage._timestamp = max(storage._timestamp, commit_ts)
    stats["replay_s"] = time.perf_counter() - t0
    storage._bump_topology()
    return stats


def recover_snapshot_from(storage, source: str) -> None:
    """RECOVER SNAPSHOT FROM "<uri>": load a snapshot from an explicit
    local path, http(s):// URL, or s3:// object (reference:
    storage/v2/inmemory/storage.hpp:158-168 remote snapshot load).

    The remote bytes are staged into the snapshots directory first
    (atomic rename), so a half-downloaded file is never loaded and the
    snapshot also becomes part of the local retention set."""
    import os
    import tempfile
    import time as _time
    from .snapshot import create_snapshot, snapshot_dir

    def _stage(reader, suffix="remote"):
        """Download to a tmp file, VALIDATE, only then rename into the
        snapshots dir — a corrupt download must never become the
        "latest" snapshot and poison every later recovery."""
        d = snapshot_dir(storage)
        final = os.path.join(
            d, f"snapshot_{int(_time.time() * 1e6)}_{suffix}.mgsnap")
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                while True:
                    chunk = reader(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            staged = load_snapshot(tmp)      # raises on corrupt payload
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return final, staged

    if source.startswith(("http://", "https://")):
        import urllib.request
        from ...utils.retry import RetryPolicy

        def _download():
            with urllib.request.urlopen(source, timeout=60) as resp:
                return _stage(resp.read)

        try:
            # transient fetch failures (droppy link, restarting peer) get
            # a bounded backoff instead of failing the whole RECOVER
            path, data = RetryPolicy(
                base_delay=0.2, max_delay=5.0, max_retries=3).call(
                _download,
                on_retry=lambda attempt, e: log.warning(
                    "snapshot download from %s failed (attempt %d): %s — "
                    "retrying", source, attempt + 1, e))
        except OSError as e:   # URLError/HTTPError/timeouts subclass this
            raise DurabilityError(
                f"cannot fetch snapshot from {source!r}: {e}") from e
    elif source.startswith("s3://"):
        try:
            import boto3
        except ImportError as e:
            raise DurabilityError(
                "s3:// snapshot sources need the boto3 client library, "
                "which is not installed in this environment") from e
        bucket, _, key = source[len("s3://"):].partition("/")
        body = boto3.client("s3").get_object(Bucket=bucket,
                                             Key=key)["Body"]
        path, data = _stage(body.read)
    else:
        if not os.path.exists(source):
            raise DurabilityError(f"snapshot source {source!r} not found")
        data = load_snapshot(source)
    _clear_storage(storage)
    _apply_snapshot(storage, data)
    # NEW durability epoch: the local WAL predates the foreign snapshot
    # and must never replay on top of it at the next restart — advance
    # past every local WAL commit and persist a fresh local snapshot
    # that restart recovery will pick as the baseline
    max_wal_ts = 0
    for wal_path in W.list_wal_files(storage):
        try:
            for commit_ts, _ops in W.iter_wal_transactions(wal_path):
                max_wal_ts = max(max_wal_ts, commit_ts)
        except DurabilityError:
            pass
    with storage._engine_lock:
        storage._timestamp = max(storage._timestamp, max_wal_ts + 1)
    create_snapshot(storage)
    storage._bump_topology()


def recover_latest_snapshot(storage) -> None:
    """RECOVER SNAPSHOT query: wipe current state, load newest snapshot."""
    snaps = list_snapshots(storage)
    if not snaps:
        raise DurabilityError("no snapshots available")
    _clear_storage(storage)
    data = load_snapshot(snaps[-1][0])
    _apply_snapshot(storage, data)
    storage._bump_topology()


def _clear_storage(storage) -> None:
    storage._vertices.clear()
    storage._edges.clear()
    storage.stream_offsets.clear()
    from ..indexes import Indices
    from ..constraints import Constraints
    storage.indices = Indices()
    storage.constraints = Constraints()


def _apply_snapshot(storage, data: dict) -> None:
    storage.label_mapper = NameIdMapper.from_list(data.get("labels", []))
    storage.property_mapper = NameIdMapper.from_list(
        data.get("properties", []))
    storage.edge_type_mapper = NameIdMapper.from_list(
        data.get("edge_types", []))

    from ..objects import Edge, Vertex
    top_vgid = -1
    for (gid, labels, props) in data.get("vertices", []):
        v = Vertex(gid)
        v.labels = set(labels)
        v.properties = dict(props)
        storage._vertices[gid] = v
        top_vgid = max(top_vgid, gid)
    top_egid = -1
    for (gid, etype, from_gid, to_gid, props) in data.get("edges", []):
        from_v = storage._vertices.get(from_gid)
        to_v = storage._vertices.get(to_gid)
        if from_v is None or to_v is None:
            raise DurabilityError(
                f"edge {gid} references missing vertex")
        e = Edge(gid, etype, from_v, to_v)
        e.properties = dict(props)
        from_v.out_edges.append((etype, to_v, e))
        to_v.in_edges.append((etype, from_v, e))
        storage._edges[gid] = e
        top_egid = max(top_egid, gid)

    # snapshot apply also runs LIVE on replicas (remote-snapshot
    # catch-up) while readers hold storage accessors: the gid counters
    # and the visibility timestamp publish under their owning locks,
    # bumped once per snapshot rather than once per row
    with storage._gid_lock:
        storage._next_vertex_gid = max(storage._next_vertex_gid,
                                       top_vgid + 1)
        storage._next_edge_gid = max(storage._next_edge_gid,
                                     top_egid + 1)
    with storage._engine_lock:
        storage._timestamp = max(storage._timestamp,
                                 data["timestamp"] + 1)

    for lid in data.get("label_indices", []):
        storage.create_label_index(lid)
    for (lid, pids) in data.get("label_property_indices", []):
        storage.create_label_property_index(lid, pids)
    for tid in data.get("edge_type_indices", []):
        storage.create_edge_type_index(tid)
    for (lid, pid) in data.get("existence_constraints", []):
        storage.create_existence_constraint(lid, pid)
    for (lid, pids) in data.get("unique_constraints", []):
        storage.create_unique_constraint(lid, pids)
    for (lid, pid, tname) in data.get("type_constraints", []):
        storage.create_type_constraint(lid, pid, tname)
    # WAL segments older than the snapshot are pruned, so the snapshot
    # must carry the stream-offset table itself
    for name, position in (data.get("stream_offsets") or {}).items():
        storage.stream_offsets[name] = position


def _apply_batch_vertices(storage, vertices, changed) -> None:
    """Replay the vertex half of a BATCH_INSERT record with the same
    amortization as the live path: objects rebuilt row-by-row, indexes
    updated with one bulk merge per index."""
    from ..objects import Vertex
    fresh = []
    top_gid = -1
    for (gid, labels, props) in vertices:
        changed.add(gid)
        v = storage._vertices.get(gid)
        if v is None:
            v = Vertex(gid)
            storage._vertices[gid] = v
            top_gid = max(top_gid, gid)
        v.labels = set(labels)
        v.properties = dict(props)
        fresh.append(v)
    if top_gid >= 0:
        with storage._gid_lock:
            storage._next_vertex_gid = max(storage._next_vertex_gid,
                                           top_gid + 1)
    per_label: dict = {}
    for v in fresh:
        for lid in v.labels:
            per_label.setdefault(lid, []).append(v)
    for lid, group in per_label.items():
        storage.indices.label.bulk_add(lid, group)
    storage.indices.label_property.bulk_add(fresh)


def _apply_batch_edges(storage, edges, changed) -> None:
    from ..objects import Edge, adj_map_add
    fresh = []
    top_gid = -1
    for (gid, etype, from_gid, to_gid, props) in edges:
        changed.add(from_gid)
        changed.add(to_gid)
        if gid in storage._edges:
            storage._edges[gid].properties = dict(props)
            continue
        from_v = storage._vertices.get(from_gid)
        to_v = storage._vertices.get(to_gid)
        if from_v is None or to_v is None:
            raise DurabilityError(
                f"batch edge {gid} references missing vertex")
        e = Edge(gid, etype, from_v, to_v)
        e.properties = dict(props)
        out_entry = (etype, to_v, e)
        in_entry = (etype, from_v, e)
        from_v.out_edges.append(out_entry)
        adj_map_add(from_v, "out", out_entry)
        to_v.in_edges.append(in_entry)
        adj_map_add(to_v, "in", in_entry)
        storage._edges[gid] = e
        top_gid = max(top_gid, gid)
        fresh.append(e)
    if top_gid >= 0:
        with storage._gid_lock:
            storage._next_edge_gid = max(storage._next_edge_gid,
                                         top_gid + 1)
    storage.indices.edge_type.bulk_add(fresh)


def _apply_wal_txn(storage, ops):
    """Replay one committed transaction's forward records (idempotent).

    BATCH_INSERT vertices apply in frame order, but BATCH_INSERT edges are
    deferred to the end of the transaction so they may reference vertices
    created by per-row records appearing later in the same transaction.

    Returns the set of vertex gids whose state changed (for the
    topology change log: replica WAL apply must feed version-keyed
    delta caches exactly like local commits do)."""
    from ..objects import Edge, Vertex
    changed: set = set()
    batches = []   # decoded BATCH_INSERT payloads, replayed across passes
    for kind, payload in ops:
        buf = BytesIO(payload)
        if kind == W.OP_BATCH_INSERT:
            vertices, edges = W.decode_batch_insert(buf)
            _apply_batch_vertices(storage, vertices, changed)
            batches.append(edges)
        elif kind == W.OP_MAPPER_SYNC:
            tables = []
            for _ in range(3):
                n = _read_varint(buf)
                tables.append([buf.read(_read_varint(buf)).decode("utf-8")
                               for _ in range(n)])
            storage.label_mapper = NameIdMapper.from_list(tables[0])
            storage.property_mapper = NameIdMapper.from_list(tables[1])
            storage.edge_type_mapper = NameIdMapper.from_list(tables[2])
        elif kind in (W.OP_CREATE_VERTEX, W.OP_VERTEX_STATE):
            gid = _read_varint(buf)
            changed.add(gid)
            labels = {_read_varint(buf) for _ in range(_read_varint(buf))}
            props = {}
            for _ in range(_read_varint(buf)):
                pid = _read_varint(buf)
                props[pid] = decode_value(buf)
            v = storage._vertices.get(gid)
            if v is None:
                v = Vertex(gid)
                storage._vertices[gid] = v
                # WAL apply runs live on replicas: counter publication
                # takes the same lock the allocation path holds
                with storage._gid_lock:
                    storage._next_vertex_gid = max(
                        storage._next_vertex_gid, gid + 1)
            v.labels = labels
            v.properties = props
            for lid in labels:
                storage.indices.label.add(lid, v)
            storage.indices.label_property.update_on_change(v)
        elif kind == W.OP_DELETE_VERTEX:
            gid = _read_varint(buf)
            changed.add(gid)
            v = storage._vertices.pop(gid, None)
            if v is not None:
                v.deleted = True
                for lid in list(v.labels):
                    storage.indices.label.remove_entry(lid, v)
                storage.indices.label_property.remove_entry(v)
        elif kind == W.OP_CREATE_EDGE:
            gid = _read_varint(buf)
            etype = _read_varint(buf)
            from_gid = _read_varint(buf)
            to_gid = _read_varint(buf)
            changed.add(from_gid)
            changed.add(to_gid)
            props = {}
            for _ in range(_read_varint(buf)):
                pid = _read_varint(buf)
                props[pid] = decode_value(buf)
            if gid in storage._edges:
                storage._edges[gid].properties = props
                continue
            from_v = storage._vertices.get(from_gid)
            to_v = storage._vertices.get(to_gid)
            if from_v is None or to_v is None:
                raise DurabilityError(
                    f"WAL edge {gid} references missing vertex")
            e = Edge(gid, etype, from_v, to_v)
            e.properties = props
            from ..objects import adj_map_add
            out_entry = (etype, to_v, e)
            in_entry = (etype, from_v, e)
            from_v.out_edges.append(out_entry)
            adj_map_add(from_v, "out", out_entry)
            to_v.in_edges.append(in_entry)
            adj_map_add(to_v, "in", in_entry)
            storage._edges[gid] = e
            storage.indices.edge_type.add(e)
            with storage._gid_lock:
                storage._next_edge_gid = max(storage._next_edge_gid,
                                             gid + 1)
        elif kind == W.OP_EDGE_STATE:
            gid = _read_varint(buf)
            props = {}
            for _ in range(_read_varint(buf)):
                pid = _read_varint(buf)
                props[pid] = decode_value(buf)
            e = storage._edges.get(gid)
            if e is not None:
                e.properties = props
        elif kind == W.OP_DELETE_EDGE:
            gid = _read_varint(buf)
            e = storage._edges.pop(gid, None)
            if e is not None:
                from ..objects import adj_map_remove
                entry_out = (e.edge_type, e.to_vertex, e)
                entry_in = (e.edge_type, e.from_vertex, e)
                try:
                    e.from_vertex.out_edges.remove(entry_out)
                except ValueError:
                    pass
                adj_map_remove(e.from_vertex, "out", entry_out)
                try:
                    e.to_vertex.in_edges.remove(entry_in)
                except ValueError:
                    pass
                adj_map_remove(e.to_vertex, "in", entry_in)
                storage.indices.edge_type.remove_entry(e)
                changed.add(e.from_vertex.gid)
                changed.add(e.to_vertex.gid)
        elif kind == W.OP_STREAM_OFFSET:
            # stream offsets ride the data commit: restoring them here is
            # what makes recovery (and replica apply — replication shares
            # this function) resume ingestion exactly once
            name, position = W.decode_stream_offset(buf)
            storage.stream_offsets[name] = position
        else:
            raise DurabilityError(f"unknown WAL op 0x{kind:02x}")
    for edges in batches:
        _apply_batch_edges(storage, edges, changed)
    return changed


def wire_durability(storage) -> "W.WalFile | None":
    """Attach a WAL sink if configured; returns the WalFile."""
    if not storage.config.wal_enabled or not storage.config.durability_dir:
        return None
    wal_file = W.WalFile(storage)
    storage.wal_sink = wal_file.sink
    # snapshot-time WAL retention needs the active segment path
    storage.wal_file = wal_file
    return wal_file
