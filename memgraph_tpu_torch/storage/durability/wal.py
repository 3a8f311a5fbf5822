"""Write-ahead log: per-commit forward-operation records.

Counterpart of the reference's WAL (memgraph/src/storage/v2/
durability/wal.hpp — WalDeltaData records ordered by commit timestamp).
Design difference, chosen for the undo-delta MVCC model: instead of
re-deriving fine-grained forward deltas from undo chains, each commit logs
the *final state* of every object it touched (create/state/delete records).
Replay is idempotent per record, which also makes these records directly
shippable to replicas (replication reuses this encoder).

Record framing v2: [u32 length][u8 kind][u32 crc32][payload] where
length = 5 + len(payload) and the CRC covers kind + payload; txn frame:
  TXN_BEGIN(commit_ts) op* TXN_END(commit_ts)
fsync policy: every commit (default) or batched.

On-disk WAL segments (v2) carry a 19-byte header —
  [9s magic "MGTPUWAL2"][u16 version][u64 seqnum]
— and are named wal_<seqnum:012d>.mgwal with a monotonic segment
sequence number persisted by the filenames themselves (the previous
wall-clock-microsecond names could collide or reorder across a clock
step). Segments rotate at StorageConfig.wal_segment_size bytes; closed
segments whose every transaction is covered by the newest snapshot are
pruned (oldest-first only, so the seqnum chain never gets a hole).
Recovery streams each segment in chunks, verifies per-record CRCs,
truncates at the first damaged record (logging what it dropped), and
refuses a seqnum gap in the chain. Legacy headerless v1 files
([u32 length][u8 kind][payload], no CRC) remain readable.

Copy of memgraph_tpu/storage/durability/wal.py for the port: the same
frames, byte for byte (no field of a frame holds a wall clock), so each
package replays the other's segments; its counters go to the port's
``utils.metrics.global_metrics``.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from io import BytesIO

from ...exceptions import DurabilityError
from ...utils import faultinject as FI
from ...utils.locks import tracked_lock
from ..property_store import _read_varint, _write_varint, decode_value, \
    encode_value

log = logging.getLogger(__name__)

WAL_MAGIC = b"MGTPUWAL2"
WAL_VERSION = 2
_HEADER_LEN = len(WAL_MAGIC) + 10          # magic + u16 version + u64 seq
_RECORD_HEADER = struct.Struct("<IBI")     # length, kind, crc32
_MAX_RECORD_BYTES = 1 << 30                # length-field sanity bound
DEFAULT_SEGMENT_SIZE = 64 * 1024 * 1024

OP_TXN_BEGIN = 0x01
OP_TXN_END = 0x02
OP_CREATE_VERTEX = 0x10     # gid, labels, props
OP_VERTEX_STATE = 0x11      # gid, labels, props (overwrite)
OP_DELETE_VERTEX = 0x12     # gid
OP_CREATE_EDGE = 0x20       # gid, type, from, to, props
OP_EDGE_STATE = 0x21        # gid, props
OP_DELETE_EDGE = 0x22       # gid
OP_MAPPER_SYNC = 0x30       # label/property/edge-type name tables
OP_BATCH_INSERT = 0x40      # one bulk-insert batch, columnar layout
OP_STREAM_OFFSET = 0x50     # stream name + source position, in-txn


def _crc(kind: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(bytes((kind,))))


def frame_record(kind: int, payload: bytes) -> bytes:
    """One v2 record: [u32 length][u8 kind][u32 crc32][payload]."""
    return _RECORD_HEADER.pack(len(payload) + 5, kind,
                               _crc(kind, payload)) + payload


def _encode_batch_insert(batch, deleted_v, deleted_e) -> bytes:
    """Columnar payload for one batch_insert() call: delta-encoded gid
    ranges, a label-set dictionary, and per-property value columns with
    presence bitmaps — one record per batch instead of one per object.
    Objects that also died inside the transaction are filtered out (they
    never become durable), matching the per-object encoder's rule."""
    vertices = [v for v in batch.vertices if v not in deleted_v]
    edges = [e for e in batch.edges
             if e not in deleted_e and e.from_vertex not in deleted_v
             and e.to_vertex not in deleted_v]
    p = BytesIO()

    def gid_column(objs) -> None:
        prev = 0
        for i, o in enumerate(objs):
            _write_varint(p, o.gid if i == 0 else o.gid - prev)
            prev = o.gid

    def prop_columns(objs) -> None:
        cols: dict[int, list] = {}
        for i, o in enumerate(objs):
            for pid, value in o.properties.items():
                cols.setdefault(pid, []).append((i, value))
        _write_varint(p, len(cols))
        n = len(objs)
        for pid in sorted(cols):
            _write_varint(p, pid)
            present = bytearray((n + 7) // 8)
            for i, _v in cols[pid]:
                present[i >> 3] |= 1 << (i & 7)
            p.write(bytes(present))
            for _i, value in cols[pid]:
                encode_value(p, value)

    _write_varint(p, len(vertices))
    gid_column(vertices)
    # label-set dictionary: bulk rows overwhelmingly share one label set
    label_sets: dict[tuple, int] = {}
    set_idx = []
    for v in vertices:
        key = tuple(sorted(v.labels))
        idx = label_sets.setdefault(key, len(label_sets))
        set_idx.append(idx)
    _write_varint(p, len(label_sets))
    for key in label_sets:
        _write_varint(p, len(key))
        for lid in key:
            _write_varint(p, lid)
    for idx in set_idx:
        _write_varint(p, idx)
    prop_columns(vertices)

    _write_varint(p, len(edges))
    gid_column(edges)
    for e in edges:
        _write_varint(p, e.edge_type)
    for e in edges:
        _write_varint(p, e.from_vertex.gid)
    for e in edges:
        _write_varint(p, e.to_vertex.gid)
    prop_columns(edges)
    return p.getvalue()


def encode_stream_offset(name: str, position) -> bytes:
    """OP_STREAM_OFFSET payload: varint-length-prefixed stream name +
    varint-length-prefixed JSON position (FileSource byte offsets and
    Kafka per-(topic, partition) offset maps both fit)."""
    import json
    p = BytesIO()
    raw = name.encode("utf-8")
    _write_varint(p, len(raw))
    p.write(raw)
    pos = json.dumps(position, sort_keys=True).encode("utf-8")
    _write_varint(p, len(pos))
    p.write(pos)
    return p.getvalue()


def decode_stream_offset(buf: BytesIO) -> tuple[str, object]:
    """Decode one OP_STREAM_OFFSET payload into (name, position)."""
    import json
    name = buf.read(_read_varint(buf)).decode("utf-8")
    position = json.loads(buf.read(_read_varint(buf)).decode("utf-8"))
    return name, position


def decode_batch_insert(buf: BytesIO):
    """Decode one OP_BATCH_INSERT payload into
    (vertices: [(gid, labels, props)], edges: [(gid, etype, from, to, props)]).
    """
    def gid_column(n) -> list[int]:
        gids = []
        prev = 0
        for i in range(n):
            d = _read_varint(buf)
            prev = d if i == 0 else prev + d
            gids.append(prev)
        return gids

    def prop_columns(n) -> list[dict]:
        props: list[dict] = [{} for _ in range(n)]
        for _ in range(_read_varint(buf)):
            pid = _read_varint(buf)
            present = buf.read((n + 7) // 8)
            rows = [i for i in range(n) if present[i >> 3] & (1 << (i & 7))]
            for i in rows:
                props[i][pid] = decode_value(buf)
        return props

    n_v = _read_varint(buf)
    v_gids = gid_column(n_v)
    label_sets = []
    for _ in range(_read_varint(buf)):
        label_sets.append([_read_varint(buf)
                           for _ in range(_read_varint(buf))])
    v_labels = [label_sets[_read_varint(buf)] for _ in range(n_v)]
    v_props = prop_columns(n_v)
    vertices = list(zip(v_gids, v_labels, v_props))

    n_e = _read_varint(buf)
    e_gids = gid_column(n_e)
    e_types = [_read_varint(buf) for _ in range(n_e)]
    e_from = [_read_varint(buf) for _ in range(n_e)]
    e_to = [_read_varint(buf) for _ in range(n_e)]
    e_props = prop_columns(n_e)
    edges = list(zip(e_gids, e_types, e_from, e_to, e_props))
    return vertices, edges


def encode_txn_ops(storage, txn, commit_ts: int) -> bytes:
    """Build the WAL byte frame for a transaction at commit time.

    Called under the engine lock, BEFORE the visibility flip — objects'
    direct fields hold the transaction's final state (MVCC keeps older
    versions in undo chains, which WAL doesn't need).
    """
    from ..delta import DeltaAction

    created_v, deleted_v = set(), set()
    created_e, deleted_e = set(), set()
    for delta in txn.deltas:
        if delta.action is DeltaAction.DELETE_OBJECT:
            from ..objects import Vertex
            (created_v if isinstance(delta.obj, Vertex)
             else created_e).add(delta.obj)
        elif delta.action is DeltaAction.RECREATE_OBJECT:
            from ..objects import Vertex
            (deleted_v if isinstance(delta.obj, Vertex)
             else deleted_e).add(delta.obj)

    buf = BytesIO()

    def frame(kind: int, payload: bytes) -> None:
        buf.write(frame_record(kind, payload))

    p = BytesIO()
    _write_varint(p, commit_ts)
    frame(OP_TXN_BEGIN, p.getvalue())

    # mapper sync keeps name tables replayable without separate logging
    p = BytesIO()
    for mapper in (storage.label_mapper, storage.property_mapper,
                   storage.edge_type_mapper):
        names = mapper.to_list()
        _write_varint(p, len(names))
        for name in names:
            raw = name.encode("utf-8")
            _write_varint(p, len(raw))
            p.write(raw)
    frame(OP_MAPPER_SYNC, p.getvalue())

    def vertex_state_payload(v) -> bytes:
        p = BytesIO()
        _write_varint(p, v.gid)
        _write_varint(p, len(v.labels))
        for l in sorted(v.labels):
            _write_varint(p, l)
        _write_varint(p, len(v.properties))
        for pid in sorted(v.properties):
            _write_varint(p, pid)
            encode_value(p, v.properties[pid])
        return p.getvalue()

    # bulk-insert batches: one columnar BATCH_INSERT record per batch;
    # their objects are then excluded from the per-object loops below
    # (final state read here, under the engine lock, so later in-txn
    # mutations of batch-created objects are captured by the record)
    batch_objs: set = set()
    for batch in (getattr(txn, "batches", None) or ()):
        frame(OP_BATCH_INSERT,
              _encode_batch_insert(batch, deleted_v, deleted_e))
        batch_objs.update(batch.vertices)
        batch_objs.update(batch.edges)

    for v in txn.touched_vertices.values():
        if v in batch_objs:
            continue  # carried by a BATCH_INSERT record
        if v in created_v and v in deleted_v:
            continue  # created and deleted within the txn
        if v in deleted_v:
            p = BytesIO()
            _write_varint(p, v.gid)
            frame(OP_DELETE_VERTEX, p.getvalue())
        elif v in created_v:
            frame(OP_CREATE_VERTEX, vertex_state_payload(v))
        else:
            frame(OP_VERTEX_STATE, vertex_state_payload(v))

    for e in txn.touched_edges.values():
        if e in batch_objs:
            continue  # carried by a BATCH_INSERT record
        if e in created_e and e in deleted_e:
            continue
        if e in deleted_e:
            p = BytesIO()
            _write_varint(p, e.gid)
            frame(OP_DELETE_EDGE, p.getvalue())
        elif e in created_e:
            p = BytesIO()
            _write_varint(p, e.gid)
            _write_varint(p, e.edge_type)
            _write_varint(p, e.from_vertex.gid)
            _write_varint(p, e.to_vertex.gid)
            _write_varint(p, len(e.properties))
            for pid in sorted(e.properties):
                _write_varint(p, pid)
                encode_value(p, e.properties[pid])
            frame(OP_CREATE_EDGE, p.getvalue())
        else:
            p = BytesIO()
            _write_varint(p, e.gid)
            _write_varint(p, len(e.properties))
            for pid in sorted(e.properties):
                _write_varint(p, pid)
                encode_value(p, e.properties[pid])
            frame(OP_EDGE_STATE, p.getvalue())

    # stream offsets ride the same commit frame: replayed on recovery
    # and shipped over replication, so consumer-side commit() is an
    # optimization, not the exactly-once boundary
    for name in sorted(getattr(txn, "stream_offsets", None) or {}):
        frame(OP_STREAM_OFFSET,
              encode_stream_offset(name, txn.stream_offsets[name]))

    p = BytesIO()
    _write_varint(p, commit_ts)
    frame(OP_TXN_END, p.getvalue())
    return buf.getvalue()


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is durable (a
    crashed rename otherwise may resurrect the old directory entry)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WalFile:
    """Append-only segmented WAL writer with fsync-per-commit
    (configurable) and size-based rotation."""

    def __init__(self, storage, sync_every_commit: bool = True) -> None:
        base = storage.config.durability_dir
        if not base:
            raise DurabilityError("durability_dir is not configured")
        self.dir = os.path.join(base, "wal")
        os.makedirs(self.dir, exist_ok=True)
        self.segment_size = getattr(storage.config, "wal_segment_size",
                                    DEFAULT_SEGMENT_SIZE)
        self._lock = tracked_lock("WalFile._lock")
        self.sync_every_commit = sync_every_commit
        self.storage = storage
        self._seq = next_segment_seq(self.dir)
        # bytes flushed but not yet fsynced (batched-fsync mode): the
        # saturation plane's wal_fsync_backlog check reads this gauge —
        # a growing backlog is acked-but-volatile data at risk
        self._unsynced_bytes = 0
        self._open_segment()

    def _open_segment(self) -> None:
        self.path = os.path.join(self.dir, f"wal_{self._seq:012d}.mgwal")
        self._file = open(self.path, "ab")
        if self._file.tell() == 0:
            self._file.write(WAL_MAGIC
                             + struct.pack("<HQ", WAL_VERSION, self._seq))
            self._file.flush()
            os.fsync(self._file.fileno())
            fsync_dir(self.dir)  # the new segment's dirent is durable

    def sink(self, frame: bytes, commit_ts: int) -> None:
        """storage.wal_sink hook: frame pre-encoded under the engine lock."""
        from ...utils.metrics import global_metrics
        with self._lock:
            FI.faulty_write("wal.write", self._file, frame)
            self._file.flush()
            if self.sync_every_commit:
                FI.fire("wal.fsync")
                import time
                t0 = time.perf_counter()
                os.fsync(self._file.fileno())
                global_metrics.observe("wal.fsync_latency_sec",
                                       time.perf_counter() - t0)
            else:
                self._unsynced_bytes += len(frame)
                global_metrics.set_gauge("wal.fsync_backlog_bytes",
                                         float(self._unsynced_bytes))
            if self._file.tell() >= self.segment_size:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        from ...utils.metrics import global_metrics
        self._file.flush()
        os.fsync(self._file.fileno())
        if self._unsynced_bytes:
            self._unsynced_bytes = 0
            global_metrics.set_gauge("wal.fsync_backlog_bytes", 0.0)
        self._file.close()
        self._seq += 1
        self._open_segment()
        global_metrics.increment("wal.segments_rotated")

    def rotate(self) -> str:
        """Force a rotation (returns the new active segment path)."""
        with self._lock:
            self._rotate_locked()
            return self.path

    def close(self) -> None:
        with self._lock:
            self._file.close()


# --- reading ---------------------------------------------------------------


def iter_records_from_bytes(data: bytes, on_corruption=None):
    """Yield (kind, payload_bytes) v2 records from an in-memory frame;
    stops cleanly at a truncated tail or the first bad-CRC record
    (invoking on_corruption(reason, offset) if given)."""
    pos = 0
    n = len(data)
    while pos + 9 <= n:
        length, kind, crc = _RECORD_HEADER.unpack_from(data, pos)
        if length < 5 or length > _MAX_RECORD_BYTES:
            if on_corruption:
                on_corruption("bad record length", pos)
            return
        payload_len = length - 5
        start = pos + 9
        if start + payload_len > n:
            if on_corruption:
                on_corruption("truncated record", pos)
            return  # torn tail (crash mid-write) — stop cleanly
        payload = data[start:start + payload_len]
        if _crc(kind, payload) != crc:
            if on_corruption:
                on_corruption("crc mismatch", pos)
            return
        yield kind, payload
        pos = start + payload_len


def _iter_records_stream(f, first: bytes, base_offset: int,
                         on_corruption=None, chunk_size: int = 1 << 20):
    """Stream v2 records from an open file in chunks — recovery of a
    multi-GB segment must not double peak RSS by slurping the file."""
    buf = bytearray(first)
    off = 0            # parse position inside buf
    consumed = base_offset   # absolute file offset of buf[0]
    eof = False

    def fill(need: int) -> bool:
        nonlocal eof
        while len(buf) - off < need and not eof:
            chunk = f.read(chunk_size)
            if not chunk:
                eof = True
            else:
                buf.extend(chunk)
        return len(buf) - off >= need

    while True:
        if off > chunk_size:   # compact the consumed prefix
            del buf[:off]
            consumed += off
            off = 0
        if not fill(9):
            if len(buf) - off and on_corruption:
                on_corruption("truncated record header", consumed + off)
            return
        length, kind, crc = _RECORD_HEADER.unpack_from(buf, off)
        if length < 5 or length > _MAX_RECORD_BYTES:
            if on_corruption:
                on_corruption("bad record length", consumed + off)
            return
        if not fill(4 + length):
            if on_corruption:
                on_corruption("truncated record", consumed + off)
            return
        payload = bytes(buf[off + 9:off + 4 + length])
        if _crc(kind, payload) != crc:
            if on_corruption:
                on_corruption("crc mismatch", consumed + off)
            return
        yield kind, payload
        off += 4 + length


def _iter_records_stream_v1(f, first: bytes, chunk_size: int = 1 << 20):
    """Legacy v1 framing ([u32 len][u8 kind][payload], no CRC), streamed."""
    buf = bytearray(first)
    off = 0
    eof = False

    def fill(need: int) -> bool:
        nonlocal eof
        while len(buf) - off < need and not eof:
            chunk = f.read(chunk_size)
            if not chunk:
                eof = True
            else:
                buf.extend(chunk)
        return len(buf) - off >= need

    while True:
        if off > chunk_size:
            del buf[:off]
            off = 0
        if not fill(5):
            return
        length, kind = struct.unpack_from("<IB", buf, off)
        if length < 1 or length > _MAX_RECORD_BYTES or not fill(4 + length):
            return  # truncated tail — stop cleanly
        yield kind, bytes(buf[off + 5:off + 4 + length])
        off += 4 + length


def read_segment_header(path: str) -> tuple[int, int] | None:
    """(version, seqnum) for a v2 segment; None for a legacy v1 file."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_LEN)
    if not head.startswith(WAL_MAGIC) or len(head) < _HEADER_LEN:
        return None
    version, seq = struct.unpack_from("<HQ", head, len(WAL_MAGIC))
    return version, seq


def iter_wal_records(path: str, on_corruption=None):
    """Stream (kind, payload) records from one segment file. Damage
    truncates iteration at the first bad record; what was dropped is
    logged (and counted) so operators can see the data loss boundary."""
    def report(reason: str, offset: int) -> None:
        from ...utils.metrics import global_metrics
        try:
            dropped = os.path.getsize(path) - offset
        except OSError:
            dropped = -1
        log.warning("WAL %s: %s at offset %d — truncating recovery here "
                    "(%d trailing byte(s) dropped)", path, reason, offset,
                    dropped)
        global_metrics.increment("wal.recovery_truncations")
        if on_corruption:
            on_corruption(reason, offset)

    with open(path, "rb") as f:
        head = f.read(_HEADER_LEN)
        if head.startswith(WAL_MAGIC):
            if len(head) < _HEADER_LEN:
                report("truncated segment header", 0)
                return
            version = struct.unpack_from("<H", head, len(WAL_MAGIC))[0]
            if version > WAL_VERSION:
                raise DurabilityError(
                    f"{path}: unsupported WAL version {version}")
            yield from _iter_records_stream(f, b"", _HEADER_LEN, report)
        else:
            yield from _iter_records_stream_v1(f, head)


def _group_txns(records):
    """Group (kind, payload) records into (commit_ts, ops) transactions.
    Incomplete transactions (no TXN_END) are discarded."""
    current_ts = None
    ops = []
    for kind, payload in records:
        if kind == OP_TXN_BEGIN:
            current_ts = _read_varint(BytesIO(payload))
            ops = []
        elif kind == OP_TXN_END:
            end_ts = _read_varint(BytesIO(payload))
            if current_ts is not None and end_ts == current_ts:
                yield current_ts, ops
            current_ts = None
            ops = []
        else:
            if current_ts is not None:
                ops.append((kind, payload))


def iter_txns_from_bytes(data: bytes):
    yield from _group_txns(iter_records_from_bytes(data))


def iter_wal_transactions(path: str, on_corruption=None):
    yield from _group_txns(iter_wal_records(path, on_corruption))


# --- segment chain management ----------------------------------------------


def list_wal_segments(storage) -> list[tuple[str, int | None]]:
    """All WAL segments in replay order: legacy (headerless) files first
    in name order, then v2 segments by seqnum. Each entry is
    (path, seqnum-or-None)."""
    base = storage.config.durability_dir
    if not base:
        return []
    d = os.path.join(base, "wal")
    if not os.path.isdir(d):
        return []
    legacy, v2 = [], []
    for name in sorted(os.listdir(d)):
        if not name.endswith(".mgwal"):
            continue
        path = os.path.join(d, name)
        try:
            header = read_segment_header(path)
        except OSError:
            continue
        if header is None:
            legacy.append((path, None))
        else:
            v2.append((path, header[1]))
    v2.sort(key=lambda item: item[1])
    return legacy + v2


def check_segment_chain(segments) -> None:
    """Refuse a hole in the v2 seqnum chain: a missing middle segment
    means committed transactions are gone, and replaying around the gap
    would silently resurrect a torn history."""
    seqs = [seq for _, seq in segments if seq is not None]
    for prev, cur in zip(seqs, seqs[1:]):
        if cur != prev + 1:
            raise DurabilityError(
                f"WAL segment chain has a gap: segment {prev} is followed "
                f"by {cur} (missing {prev + 1}..{cur - 1}) — refusing to "
                "replay a torn history")


def list_wal_files(storage) -> list[str]:
    return [path for path, _seq in list_wal_segments(storage)]


def next_segment_seq(wal_dir: str) -> int:
    """Next monotonic segment seqnum: one past the highest existing v2
    header seq (legacy files don't participate — they sort before every
    v2 segment in replay order)."""
    best = 0
    if os.path.isdir(wal_dir):
        for name in os.listdir(wal_dir):
            if not name.endswith(".mgwal"):
                continue
            try:
                header = read_segment_header(os.path.join(wal_dir, name))
            except OSError:
                continue
            if header is not None:
                best = max(best, header[1])
    return best + 1


def prune_wal_segments(storage, snapshot_ts: int,
                       active_path: str | None = None) -> list[str]:
    """Delete leading segments fully covered by the newest snapshot.

    Only a PREFIX of the chain is ever removed (stop at the first
    segment holding a transaction newer than the snapshot), so the
    seqnum chain stays contiguous. The active segment is never touched.
    Returns the deleted paths."""
    deleted = []
    for path, _seq in list_wal_segments(storage):
        if active_path is not None and \
                os.path.abspath(path) == os.path.abspath(active_path):
            break
        max_ts = 0
        for commit_ts, _ops in iter_wal_transactions(path):
            max_ts = max(max_ts, commit_ts)
        if max_ts > snapshot_ts:
            break
        try:
            os.remove(path)
            deleted.append(path)
        except OSError:
            break
    if deleted:
        fsync_dir(os.path.join(storage.config.durability_dir, "wal"))
        log.info("WAL retention: pruned %d segment(s) covered by "
                 "snapshot ts %d", len(deleted), snapshot_ts)
    return deleted
