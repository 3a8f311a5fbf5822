"""Binary snapshots of the full storage state.

Counterpart of the reference's sectioned snapshot format
(memgraph/src/storage/v2/durability/snapshot.cpp, marker.hpp):
magic + version header, interning tables, vertices, edges, index +
constraint metadata, all encoded with the property codec. Snapshots are
written atomically (tmp + rename) into <durability_dir>/snapshots.

Format v2 chunks the vertex and edge sections (varint chunk count, then
per chunk varint byte-length + varint item-count + payload) so create
and load pipeline each chunk through a worker pool — the same
parallel-durability shape as the reference's threaded snapshot writers
(memgraph.cpp:531-534 --storage-parallel-schema-recovery). v1 files
remain readable.

Copy of memgraph_tpu/storage/durability/snapshot.py for the port: the
same format, so each package loads the other's snapshots.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

from ...exceptions import DurabilityError
from ..property_store import (_read_varint, _write_varint, decode_value,
                              encode_value)

MAGIC = b"MGTPUSNAP"
VERSION = 3   # v3: per-chunk flag byte (bit0 = zlib payload)
CHUNK_ITEMS = 50_000

_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


POOL_WORKERS = 0          # 0 = cpu count (--storage-snapshot-thread-count)


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=POOL_WORKERS or max(2, (os.cpu_count() or 2)),
                thread_name_prefix="snapshot-worker")
        return _POOL


def _reset_pool_after_fork() -> None:
    """fork() copies the executor OBJECT but none of its worker
    threads: a forked child (mp_executor / mgshard workers) that
    inherited a live pool would submit snapshot chunks no thread will
    ever run and hang forever. Drop the carcass so the child lazily
    builds its own pool on first use."""
    global _POOL
    _POOL = None
    # the lock may have been held by a parent thread at fork time;
    # replace it rather than inherit a permanently-locked instance
    globals()["_POOL_LOCK"] = threading.Lock()


os.register_at_fork(after_in_child=_reset_pool_after_fork)

# section markers
SEC_MAPPERS = 0x01
SEC_VERTICES = 0x02
SEC_EDGES = 0x03
SEC_INDICES = 0x04
SEC_CONSTRAINTS = 0x05
SEC_STREAM_OFFSETS = 0x06
SEC_END = 0xFF


def _encode_vertex_chunk(items) -> bytes:
    from ...storage.common import View
    buf = BytesIO()
    for va in items:
        _write_varint(buf, va.gid)
        labels = va.labels(View.OLD)
        _write_varint(buf, len(labels))
        for l in labels:
            _write_varint(buf, l)
        props = va.properties(View.OLD)
        _write_varint(buf, len(props))
        for pid in sorted(props):
            _write_varint(buf, pid)
            encode_value(buf, props[pid])
    return buf.getvalue()


def _encode_edge_chunk(items) -> bytes:
    from ...storage.common import View
    buf = BytesIO()
    for ea in items:
        _write_varint(buf, ea.gid)
        _write_varint(buf, ea.edge_type)
        _write_varint(buf, ea.from_vertex().gid)
        _write_varint(buf, ea.to_vertex().gid)
        props = ea.properties(View.OLD)
        _write_varint(buf, len(props))
        for pid in sorted(props):
            _write_varint(buf, pid)
            encode_value(buf, props[pid])
    return buf.getvalue()


def _write_chunked(buf, items, encode_chunk) -> None:
    chunks = [items[i:i + CHUNK_ITEMS]
              for i in range(0, len(items), CHUNK_ITEMS)] or [[]]
    payloads = list(_pool().map(encode_chunk, chunks))
    _write_varint(buf, len(chunks))
    from ..property_store import COMPRESSION
    for chunk, payload in zip(chunks, payloads):
        flags = 0
        if COMPRESSION["enabled"] and len(payload) >= 512:
            import zlib
            packed = zlib.compress(payload, COMPRESSION["level"])
            if len(packed) < len(payload):
                payload, flags = packed, 1
        _write_varint(buf, len(payload))
        _write_varint(buf, len(chunk))
        buf.write(bytes([flags]))
        buf.write(payload)


def _read_chunked(buf, decode_chunk, version=VERSION) -> list:
    n_chunks = _read_varint(buf)
    raw = []
    for _ in range(n_chunks):
        nbytes = _read_varint(buf)
        count = _read_varint(buf)
        flags = buf.read(1)[0] if version >= 3 else 0
        payload = buf.read(nbytes)
        if flags & 1:
            import zlib
            payload = zlib.decompress(payload)
        raw.append((payload, count))
    out: list = []
    for part in _pool().map(lambda rc: decode_chunk(*rc), raw):
        out.extend(part)
    return out


def _decode_vertex_chunk(payload: bytes, count: int) -> list:
    buf = BytesIO(payload)
    return [_decode_v1_vertex(buf) for _ in range(count)]


def _decode_edge_chunk(payload: bytes, count: int) -> list:
    buf = BytesIO(payload)
    return [_decode_v1_edge(buf) for _ in range(count)]


def _decode_v1_vertex(buf):
    gid = _read_varint(buf)
    labels = [_read_varint(buf) for _ in range(_read_varint(buf))]
    props = {}
    for _ in range(_read_varint(buf)):
        pid = _read_varint(buf)
        props[pid] = decode_value(buf)
    return (gid, labels, props)


def _decode_v1_edge(buf):
    gid = _read_varint(buf)
    etype = _read_varint(buf)
    from_gid = _read_varint(buf)
    to_gid = _read_varint(buf)
    props = {}
    for _ in range(_read_varint(buf)):
        pid = _read_varint(buf)
        props[pid] = decode_value(buf)
    return (gid, etype, from_gid, to_gid, props)


def snapshot_dir(storage) -> str:
    base = storage.config.durability_dir
    if not base:
        raise DurabilityError("durability_dir is not configured")
    path = os.path.join(base, "snapshots")
    os.makedirs(path, exist_ok=True)
    return path


def create_snapshot(storage) -> str:
    """Write a consistent snapshot; returns its path.

    Consistency: takes the engine lock to pin a commit timestamp, then
    reads settled state (the storage-level accessor guarantees no
    concurrent DDL; concurrent txn writes carry uncommitted deltas which
    are skipped via the delta==None fast path or materialized as OLD).
    """
    # direct Accessor construction: access() is gated for SUSPENDED
    # databases, but the suspend path itself snapshots through here
    from ..storage import Accessor
    acc = Accessor(storage, storage.config.isolation_level)
    try:
        ts = acc.txn.start_ts
        buf = BytesIO()
        buf.write(MAGIC)
        buf.write(struct.pack("<HQQ", VERSION, ts, int(time.time())))

        # mappers
        buf.write(bytes((SEC_MAPPERS,)))
        for mapper in (storage.label_mapper, storage.property_mapper,
                       storage.edge_type_mapper):
            names = mapper.to_list()
            _write_varint(buf, len(names))
            for name in names:
                raw = name.encode("utf-8")
                _write_varint(buf, len(raw))
                buf.write(raw)

        # vertices + edges: chunked, encoded in parallel on the pool
        from ...storage.common import View
        vertices = list(acc.vertices(View.OLD))
        buf.write(bytes((SEC_VERTICES,)))
        _write_chunked(buf, vertices, _encode_vertex_chunk)

        edges = list(acc.edges(View.OLD))
        buf.write(bytes((SEC_EDGES,)))
        _write_chunked(buf, edges, _encode_edge_chunk)

        # indices
        buf.write(bytes((SEC_INDICES,)))
        label_idx = storage.indices.label.labels()
        _write_varint(buf, len(label_idx))
        for lid in label_idx:
            _write_varint(buf, lid)
        lp_idx = storage.indices.label_property.keys()
        _write_varint(buf, len(lp_idx))
        for (lid, pids) in lp_idx:
            _write_varint(buf, lid)
            _write_varint(buf, len(pids))
            for p in pids:
                _write_varint(buf, p)
        et_idx = storage.indices.edge_type.types()
        _write_varint(buf, len(et_idx))
        for tid in et_idx:
            _write_varint(buf, tid)

        # constraints
        buf.write(bytes((SEC_CONSTRAINTS,)))
        existence = storage.constraints.existence.all()
        _write_varint(buf, len(existence))
        for (lid, pid) in existence:
            _write_varint(buf, lid)
            _write_varint(buf, pid)
        unique = storage.constraints.unique.all()
        _write_varint(buf, len(unique))
        for (lid, pids) in unique:
            _write_varint(buf, lid)
            _write_varint(buf, len(pids))
            for p in pids:
                _write_varint(buf, p)
        typec = storage.constraints.type.all()
        _write_varint(buf, len(typec))
        for (lid, pid, tname) in typec:
            _write_varint(buf, lid)
            _write_varint(buf, pid)
            raw = tname.encode("utf-8")
            _write_varint(buf, len(raw))
            buf.write(raw)

        # stream-offset table: the WAL segments holding OP_STREAM_OFFSET
        # records are pruned once this snapshot covers them, so the
        # snapshot must carry the offsets itself
        offsets = dict(storage.stream_offsets)
        buf.write(bytes((SEC_STREAM_OFFSETS,)))
        _write_varint(buf, len(offsets))
        for name in sorted(offsets):
            raw = name.encode("utf-8")
            _write_varint(buf, len(raw))
            buf.write(raw)
            pos = json.dumps(offsets[name], sort_keys=True).encode("utf-8")
            _write_varint(buf, len(pos))
            buf.write(pos)

        buf.write(bytes((SEC_END,)))
        data = buf.getvalue()
    finally:
        acc.abort()

    # atomic publish: tmp write + fsync + rename + directory fsync — a
    # crash at any point leaves either the old snapshot set or the new
    # one, never a half-written "latest"
    path = os.path.join(snapshot_dir(storage),
                        f"snapshot_{int(time.time() * 1e6)}_{ts}.mgsnap")
    tmp = f"{path}.{os.getpid()}.tmp"
    from ...utils import faultinject as FI
    from . import wal as W
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        FI.fire("snapshot.rename")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    W.fsync_dir(snapshot_dir(storage))
    _apply_retention(storage,
                     keep=getattr(storage.config,
                                  'snapshot_retention_count', 3))
    # WAL retention rides the snapshot cadence: segments fully covered by
    # this snapshot will never be replayed again
    wal_file = getattr(storage, "wal_file", None)
    W.prune_wal_segments(storage, ts,
                         active_path=wal_file.path if wal_file else None)
    return path


def _apply_retention(storage, keep: int = 3) -> None:
    keep = max(1, keep)          # snaps[:-0] would retain EVERYTHING
    d = snapshot_dir(storage)
    snaps = sorted(p for p in os.listdir(d) if p.endswith(".mgsnap"))
    for old in snaps[:-keep]:
        try:
            os.remove(os.path.join(d, old))
        except OSError:
            pass


def list_snapshots(storage):
    d = snapshot_dir(storage)
    out = []
    for p in sorted(os.listdir(d)):
        if p.endswith(".mgsnap"):
            full = os.path.join(d, p)
            out.append((full, os.path.getmtime(full)))
    return out


def load_snapshot(path: str) -> dict:
    """Parse a snapshot file into a plain dict (applied by recovery)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = BytesIO(data)
    if buf.read(len(MAGIC)) != MAGIC:
        raise DurabilityError(f"{path}: bad snapshot magic")
    version, ts, wall = struct.unpack("<HQQ", buf.read(18))
    if version not in (1, 2, 3):
        raise DurabilityError(f"{path}: unsupported snapshot version "
                              f"{version}")
    out = {"timestamp": ts, "wall_time": wall}

    def read_name_list():
        n = _read_varint(buf)
        return [buf.read(_read_varint(buf)).decode("utf-8")
                for _ in range(n)]

    while True:
        marker = buf.read(1)[0]
        if marker == SEC_END:
            break
        if marker == SEC_MAPPERS:
            out["labels"] = read_name_list()
            out["properties"] = read_name_list()
            out["edge_types"] = read_name_list()
        elif marker == SEC_VERTICES:
            if version >= 2:
                out["vertices"] = _read_chunked(buf, _decode_vertex_chunk, version)
            else:
                n = _read_varint(buf)
                out["vertices"] = [_decode_v1_vertex(buf)
                                   for _ in range(n)]
        elif marker == SEC_EDGES:
            if version >= 2:
                out["edges"] = _read_chunked(buf, _decode_edge_chunk, version)
            else:
                n = _read_varint(buf)
                out["edges"] = [_decode_v1_edge(buf) for _ in range(n)]
        elif marker == SEC_INDICES:
            out["label_indices"] = [_read_varint(buf)
                                    for _ in range(_read_varint(buf))]
            lp = []
            for _ in range(_read_varint(buf)):
                lid = _read_varint(buf)
                pids = tuple(_read_varint(buf)
                             for _ in range(_read_varint(buf)))
                lp.append((lid, pids))
            out["label_property_indices"] = lp
            out["edge_type_indices"] = [_read_varint(buf)
                                        for _ in range(_read_varint(buf))]
        elif marker == SEC_CONSTRAINTS:
            out["existence_constraints"] = [
                (_read_varint(buf), _read_varint(buf))
                for _ in range(_read_varint(buf))]
            uq = []
            for _ in range(_read_varint(buf)):
                lid = _read_varint(buf)
                pids = tuple(_read_varint(buf)
                             for _ in range(_read_varint(buf)))
                uq.append((lid, pids))
            out["unique_constraints"] = uq
            tc = []
            for _ in range(_read_varint(buf)):
                lid = _read_varint(buf)
                pid = _read_varint(buf)
                tname = buf.read(_read_varint(buf)).decode("utf-8")
                tc.append((lid, pid, tname))
            out["type_constraints"] = tc
        elif marker == SEC_STREAM_OFFSETS:
            offsets = {}
            for _ in range(_read_varint(buf)):
                name = buf.read(_read_varint(buf)).decode("utf-8")
                offsets[name] = json.loads(
                    buf.read(_read_varint(buf)).decode("utf-8"))
            out["stream_offsets"] = offsets
        else:
            raise DurabilityError(f"{path}: unknown section 0x{marker:02x}")
    return out
