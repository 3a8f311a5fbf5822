"""The port's durability (memgraph_tpu_torch/storage/durability, kvstore,
the WAL seam of the commit) on the CPU.

- The cases of tests/test_durability.py, test_parallel_durability.py and
  test_remote_snapshot.py run through the port (the http source served
  on localhost); DUMP DATABASE and triggers belong to a later slice.
- File compatibility with the JAX package: a snapshot and a WAL written
  by one package recover in the other to the same vertices, edges,
  properties, indexes and constraints; the same Cypher script (and the
  same ``batch_insert``) gives byte-equal WAL segments, and snapshots
  equal but for the header's wall clock; a data directory written by
  ``main.build_database`` carries its DDL, settings, users and profiles
  across.
- The crash harness: this module run as a script (``python
  tests/test_torch_durability.py <dir> <acked> <n>``) is a child that
  commits two-vertex pairs under ``MEMGRAPH_TPU_FAULTS``; killed at a
  torn WAL write, before an fsync or before a snapshot's rename, every
  acked pair recovers whole and no half pair is visible.
- The refresh rule: a live ``RECOVER SNAPSHOT`` and a resumed tenant
  bump the topology version with no changed set, so ``pagerank.get``
  exports and plans the recovered graph afresh (the MXU route forced on
  the CPU) and answers for it.
"""

import http.server
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
from io import BytesIO

import numpy as np
import pytest
import torch

from memgraph_tpu_torch.query.interpreter import Interpreter
from memgraph_tpu_torch.query.interpreter import \
    InterpreterContext as _PortContext
from memgraph_tpu_torch.storage import InMemoryStorage, StorageConfig, View
from memgraph_tpu_torch.storage.durability import snapshot as snap
from memgraph_tpu_torch.storage.durability.recovery import (recover,
                                                            wire_durability)
from memgraph_tpu_torch.storage.durability.snapshot import (create_snapshot,
                                                            load_snapshot)

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def InterpreterContext(storage, config=None):
    """The port's context on the CPU."""
    return _PortContext(storage, config, device="cpu")


# --- the cases of tests/test_durability.py ---


def _config(tmp_path, wal=True):
    return StorageConfig(durability_dir=str(tmp_path), wal_enabled=wal)


def _seed(storage):
    ictx = InterpreterContext(storage)
    interp = Interpreter(ictx)
    interp.execute("CREATE INDEX ON :Person(name)")
    interp.execute("CREATE CONSTRAINT ON (n:Person) ASSERT n.name IS UNIQUE")
    interp.execute("""CREATE (a:Person {name: 'ana', tags: ['x', 'y']}),
                             (b:Person {name: 'ben', height: 1.8}),
                             (a)-[:KNOWS {since: 2020}]->(b)""")
    return ictx


def _query(storage, text):
    interp = Interpreter(InterpreterContext(storage))
    _, rows, _ = interp.execute(text)
    return rows


def test_snapshot_roundtrip(tmp_path):
    storage = InMemoryStorage(_config(tmp_path, wal=False))
    _seed(storage)
    path = create_snapshot(storage)
    assert os.path.exists(path)
    data = load_snapshot(path)
    assert len(data["vertices"]) == 2
    assert len(data["edges"]) == 1

    restored = InMemoryStorage(_config(tmp_path, wal=False))
    stats = recover(restored)
    assert stats["snapshot"] == path
    rows = _query(restored, "MATCH (a:Person)-[r:KNOWS]->(b) "
                            "RETURN a.name, r.since, b.name, b.height")
    assert rows == [["ana", 2020, "ben", 1.8]]
    # indexes + constraints survived
    rows = _query(restored, "SHOW INDEX INFO")
    assert any(r[0] == "label+property" for r in rows)
    from memgraph_tpu_torch.exceptions import ConstraintViolation
    with pytest.raises(ConstraintViolation):
        _query(restored, "CREATE (:Person {name: 'ana'})")


def test_wal_replay_without_snapshot(tmp_path):
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)
    _query(storage, "MATCH (n {name: 'ben'}) SET n.height = 1.9")
    wal.close()

    restored = InMemoryStorage(_config(tmp_path))
    stats = recover(restored)
    assert stats["wal_transactions"] >= 2
    rows = _query(restored, "MATCH (n:Person) RETURN n.name, n.height "
                            "ORDER BY n.name")
    assert rows == [["ana", None], ["ben", 1.9]]
    rows = _query(restored, "MATCH ()-[r]->() RETURN count(r)")
    assert rows == [[1]]


def test_wal_delete_replay(tmp_path):
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)
    _query(storage, "MATCH (n {name: 'ben'}) DETACH DELETE n")
    wal.close()

    restored = InMemoryStorage(_config(tmp_path))
    recover(restored)
    rows = _query(restored, "MATCH (n) RETURN count(n)")
    assert rows == [[1]]
    rows = _query(restored, "MATCH ()-[r]->() RETURN count(r)")
    assert rows == [[0]]


def test_snapshot_plus_wal(tmp_path):
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)
    create_snapshot(storage)
    _query(storage, "CREATE (:Person {name: 'cy'})")  # after the snapshot
    wal.close()

    restored = InMemoryStorage(_config(tmp_path))
    stats = recover(restored)
    assert stats["snapshot"] is not None
    rows = _query(restored, "MATCH (n:Person) RETURN count(n)")
    assert rows == [[3]]


def test_truncated_wal_tail(tmp_path):
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)
    wal.close()
    # simulate crash mid-write: chop bytes off the wal tail
    wal_path = wal.path
    size = os.path.getsize(wal_path)
    with open(wal_path, "r+b") as f:
        f.truncate(size - 7)

    restored = InMemoryStorage(_config(tmp_path))
    recover(restored)  # must not raise; applies only complete transactions
    rows = _query(restored, "MATCH (n) RETURN count(n)")
    assert rows[0][0] in (0, 2)  # the txn is either fully there or absent


def test_wal_crc_detects_flipped_byte(tmp_path):
    """A flipped byte mid-record must truncate replay at the last good
    transaction instead of applying garbage."""
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)                                                # txn 1
    _query(storage, "MATCH (n {name: 'ben'}) SET n.height = 1.9")  # txn 2
    wal.close()
    size = os.path.getsize(wal.path)
    with open(wal.path, "r+b") as f:
        f.seek(size - 10)       # inside txn 2's tail record
        byte = f.read(1)[0]
        f.seek(size - 10)
        f.write(bytes([byte ^ 0xFF]))

    restored = InMemoryStorage(_config(tmp_path))
    stats = recover(restored)
    assert stats["wal_corruption"], "corruption must be surfaced in stats"
    rows = _query(restored, "MATCH (n:Person) RETURN n.name, n.height "
                            "ORDER BY n.name")
    # txn 2 (damaged) dropped wholesale; txn 1 fully intact
    assert rows == [["ana", None], ["ben", 1.8]]


def _rotating_config(tmp_path):
    return StorageConfig(durability_dir=str(tmp_path), wal_enabled=True,
                         wal_segment_size=128)


def test_wal_segment_rotation_and_recovery(tmp_path):
    from memgraph_tpu_torch.storage.durability import wal as W
    storage = InMemoryStorage(_rotating_config(tmp_path))
    wal = wire_durability(storage)
    for i in range(6):
        _query(storage, f"CREATE (:R {{v: {i}}})")
    wal.close()
    segs = W.list_wal_segments(storage)
    assert len(segs) >= 3, "256-byte segments must have rotated"
    seqs = [seq for _, seq in segs]
    assert all(b == a + 1 for a, b in zip(seqs, seqs[1:])), seqs

    restored = InMemoryStorage(_rotating_config(tmp_path))
    recover(restored)
    assert _query(restored, "MATCH (n:R) RETURN count(n)") == [[6]]


def test_wal_refuses_segment_gap(tmp_path):
    from memgraph_tpu_torch.exceptions import DurabilityError
    from memgraph_tpu_torch.storage.durability import wal as W
    storage = InMemoryStorage(_rotating_config(tmp_path))
    wal = wire_durability(storage)
    for i in range(6):
        _query(storage, f"CREATE (:G {{v: {i}}})")
    wal.close()
    segs = W.list_wal_segments(storage)
    assert len(segs) >= 3
    os.remove(segs[1][0])       # hole in the middle of the chain

    restored = InMemoryStorage(_rotating_config(tmp_path))
    with pytest.raises(DurabilityError, match="gap"):
        recover(restored)


def test_wal_retention_after_snapshot(tmp_path):
    from memgraph_tpu_torch.storage.durability import wal as W
    storage = InMemoryStorage(_rotating_config(tmp_path))
    wal = wire_durability(storage)
    for i in range(6):
        _query(storage, f"CREATE (:K {{v: {i}}})")
    assert len(W.list_wal_segments(storage)) >= 3
    create_snapshot(storage)
    # every closed segment is covered by the snapshot; only the active
    # segment survives, and the chain stays contiguous
    remaining = W.list_wal_segments(storage)
    assert len(remaining) == 1
    assert remaining[0][0] == wal.path
    wal.close()

    restored = InMemoryStorage(_rotating_config(tmp_path))
    recover(restored)
    assert _query(restored, "MATCH (n:K) RETURN count(n)") == [[6]]


def test_wal_seq_monotonic_across_opens(tmp_path):
    """Segment names come from a persisted monotonic seqnum — two opens
    can no longer collide or reorder under a clock step (the old names
    were wall-clock microseconds)."""
    from memgraph_tpu_torch.storage.durability import wal as W
    storage = InMemoryStorage(_config(tmp_path))
    w1 = wire_durability(storage)
    p1 = w1.path
    w1.close()
    w2 = W.WalFile(storage)
    p2 = w2.path
    w2.close()
    assert p1 != p2
    assert W.read_segment_header(p2)[1] == W.read_segment_header(p1)[1] + 1


def test_legacy_v1_wal_still_readable(tmp_path):
    """Headerless v1 files (no CRC) written before the v2 format must
    still replay."""
    import struct
    from io import BytesIO
    from memgraph_tpu_torch.storage.durability import wal as W
    from memgraph_tpu_torch.storage.property_store import _write_varint
    d = tmp_path / "wal"
    d.mkdir()
    ts = BytesIO()
    _write_varint(ts, 41)
    payload = ts.getvalue()
    raw = b""
    for kind in (W.OP_TXN_BEGIN, W.OP_TXN_END):
        raw += struct.pack("<IB", len(payload) + 1, kind) + payload
    (d / "wal_1700000000000000.mgwal").write_bytes(raw)
    txns = list(W.iter_wal_transactions(str(d / "wal_1700000000000000.mgwal")))
    assert txns == [(41, [])]


def test_streamed_wal_reader_matches_bulk(tmp_path):
    """The chunked reader must parse exactly what the in-memory parser
    sees (recovery no longer slurps whole segments into RAM)."""
    from memgraph_tpu_torch.storage.durability import wal as W
    storage = InMemoryStorage(_config(tmp_path))
    wal = wire_durability(storage)
    _seed(storage)
    _query(storage, "MATCH (n {name: 'ben'}) SET n.height = 1.9")
    wal.close()
    with open(wal.path, "rb") as f:
        data = f.read()
    from_bytes = list(W.iter_records_from_bytes(data[W._HEADER_LEN:]))
    # force tiny chunks through the streaming path
    streamed = []
    with open(wal.path, "rb") as f:
        head = f.read(W._HEADER_LEN)
        assert head.startswith(W.WAL_MAGIC)
        streamed = list(W._iter_records_stream(f, b"", W._HEADER_LEN,
                                               chunk_size=7))
    assert streamed == from_bytes
    assert len(streamed) > 3


def test_create_snapshot_via_cypher(tmp_path):
    storage = InMemoryStorage(_config(tmp_path, wal=False))
    ictx = _seed(storage)
    interp = Interpreter(ictx)
    _, rows, _ = interp.execute("CREATE SNAPSHOT")
    assert rows and rows[0][0].endswith(".mgsnap")
    _, rows, _ = interp.execute("SHOW SNAPSHOT")
    assert len(rows) == 1


# --- the cases of tests/test_parallel_durability.py ---


def _populate(storage, n_vertices, n_edges_per=1, prop_every=1):
    acc = storage.access()
    lid = storage.label_mapper.name_to_id("P")
    pid = storage.property_mapper.name_to_id("v")
    et = storage.edge_type_mapper.name_to_id("E")
    vs = []
    for i in range(n_vertices):
        v = acc.create_vertex()
        v.add_label(lid)
        if i % prop_every == 0:
            v.set_property(pid, i)
        vs.append(v)
    for i in range(n_vertices - 1):
        for _ in range(n_edges_per):
            acc.create_edge(vs[i], vs[i + 1], et)
    acc.commit()
    return lid, pid


@pytest.fixture
def storage(tmp_path):
    return InMemoryStorage(StorageConfig(durability_dir=str(tmp_path)))


def test_chunked_snapshot_roundtrip_multiple_chunks(storage, monkeypatch):
    """> CHUNK_ITEMS items: several chunks, parallel encode+decode,
    byte-exact state recovery."""
    monkeypatch.setattr(snap, "CHUNK_ITEMS", 1000)  # force many chunks
    _populate(storage, 3500)
    path = snap.create_snapshot(storage)
    data = snap.load_snapshot(path)
    assert len(data["vertices"]) == 3500
    assert len(data["edges"]) == 3499
    got = {gid: (sorted(labels), props)
           for gid, labels, props in data["vertices"]}
    acc = storage.access()
    for va in acc.vertices(View.OLD):
        labels, props = got[va.gid]
        assert labels == va.labels(View.OLD)
        assert props == va.properties(View.OLD)
    acc.abort()


def test_snapshot_v1_files_still_load(storage, tmp_path):
    """Forward-compat: a v1 (unchunked) snapshot file parses."""
    _populate(storage, 5)
    # hand-write a v1 snapshot from the v2 writer's data
    path = snap.create_snapshot(storage)
    v2 = snap.load_snapshot(path)
    buf = BytesIO()
    buf.write(snap.MAGIC)
    buf.write(struct.pack("<HQQ", 1, 7, 7))
    buf.write(bytes((snap.SEC_VERTICES,)))
    snap._write_varint(buf, len(v2["vertices"]))
    for gid, labels, props in v2["vertices"]:
        snap._write_varint(buf, gid)
        snap._write_varint(buf, len(labels))
        for l in labels:
            snap._write_varint(buf, l)
        snap._write_varint(buf, len(props))
        for pid in sorted(props):
            snap._write_varint(buf, pid)
            snap.encode_value(buf, props[pid])
    buf.write(bytes((snap.SEC_END,)))
    v1_path = str(tmp_path / "old.mgsnap")
    with open(v1_path, "wb") as f:
        f.write(buf.getvalue())
    v1 = snap.load_snapshot(v1_path)
    assert v1["vertices"] == v2["vertices"]


def test_recovery_from_chunked_snapshot(tmp_path):
    """Full restart path: create -> snapshot -> fresh storage recovers."""
    from memgraph_tpu_torch.storage.durability.recovery import recover
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    s1 = InMemoryStorage(cfg)
    _populate(s1, 200)
    snap.create_snapshot(s1)

    s2 = InMemoryStorage(StorageConfig(durability_dir=str(tmp_path)))
    recover(s2)
    acc = s2.access()
    assert sum(1 for _ in acc.vertices(View.OLD)) == 200
    assert sum(1 for _ in acc.edges(View.OLD)) == 199
    acc.abort()


def test_background_index_build_with_concurrent_queries():
    """Queries DURING a background index build stay correct (scan
    fallback), and the index serves once ready — including writes that
    raced the build."""
    storage = InMemoryStorage()
    lid, pid = _populate(storage, 20_000, n_edges_per=0)

    event = storage.create_label_index(lid, background=True)
    assert event is not None
    # concurrent query while (possibly) still populating: full correct set
    acc = storage.access()
    count_during = sum(1 for _ in acc.vertices_by_label(lid, View.OLD))
    acc.abort()
    assert count_during == 20_000

    # a write racing the build must not be lost
    acc = storage.access()
    v = acc.create_vertex()
    v.add_label(lid)
    acc.commit()

    assert event.wait(30), "background build never finished"
    assert storage.indices.label.ready(lid)
    acc = storage.access()
    count_after = sum(1 for _ in acc.vertices_by_label(lid, View.OLD))
    acc.abort()
    assert count_after == 20_001
    # and the index is actually used now (candidates served)
    assert storage.indices.label.candidates(lid) is not None
    assert storage.indices.label.approx_count(lid) >= 20_001


def test_parallel_snapshot_speed_report(storage, capsys):
    """Measured create+load timing at 100k vertices (the parallel shape;
    on one core the pool adds no CPU speedup — asserted is the CHUNKING,
    which is what scales on multi-core hosts)."""
    _populate(storage, 100_000, n_edges_per=0, prop_every=2)
    t0 = time.perf_counter()
    path = snap.create_snapshot(storage)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = snap.load_snapshot(path)
    load_s = time.perf_counter() - t0
    assert len(data["vertices"]) == 100_000
    n_chunks = -(-100_000 // snap.CHUNK_ITEMS)
    print(f"\nsnapshot 100k vertices: create {create_s:.2f}s "
          f"load {load_s:.2f}s ({n_chunks} chunks, "
          f"pool={snap._pool()._max_workers} workers)")
    assert n_chunks >= 2


# --- the cases of tests/test_remote_snapshot.py ---


def _mk(tmp_path, sub):
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    return InterpreterContext(InMemoryStorage(StorageConfig(
        durability_dir=str(d), wal_enabled=True)))


def run(ictx, q, params=None):
    _, rows, _ = Interpreter(ictx).execute(q, params)
    return rows


def test_recover_from_local_path(tmp_path):
    src = _mk(tmp_path, "src")
    run(src, "CREATE (:T {v: 1}), (:T {v: 2})")
    run(src, "CREATE SNAPSHOT")
    snap = max((tmp_path / "src" / "snapshots").glob("*.mgsnap"))

    dst = _mk(tmp_path, "dst")
    run(dst, "CREATE (:Junk)")
    run(dst, f'RECOVER SNAPSHOT FROM "{snap}"')
    assert run(dst, "MATCH (t:T) RETURN sum(t.v)") == [[3]]
    assert run(dst, "MATCH (j:Junk) RETURN count(j)") == [[0]]


def test_recover_from_http(tmp_path):
    src = _mk(tmp_path, "src")
    run(src, "CREATE (:H {v: 41}), (:H {v: 1})")
    run(src, "CREATE SNAPSHOT")
    snap = max((tmp_path / "src" / "snapshots").glob("*.mgsnap"))
    serve_dir = tmp_path / "www"
    serve_dir.mkdir()
    shutil.copy(snap, serve_dir / "backup.mgsnap")

    import functools

    class _Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a, **k):
            pass

    handler = functools.partial(_Quiet, directory=str(serve_dir))
    httpd = http.server.HTTPServer(("127.0.0.1", 0), handler)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        dst = _mk(tmp_path, "dst")
        run(dst, f'RECOVER SNAPSHOT FROM '
                 f'"http://127.0.0.1:{port}/backup.mgsnap"')
        assert run(dst, "MATCH (h:H) RETURN sum(h.v)") == [[42]]
        # the downloaded snapshot joined the local retention set
        assert list((tmp_path / "dst" / "snapshots").glob("*.mgsnap"))
    finally:
        httpd.shutdown()


def test_recover_missing_source_fails_cleanly(tmp_path):
    dst = _mk(tmp_path, "dst")
    with pytest.raises(Exception, match="not found"):
        run(dst, 'RECOVER SNAPSHOT FROM "/nope/missing.mgsnap"')
    with pytest.raises(Exception, match="boto3"):
        run(dst, 'RECOVER SNAPSHOT FROM "s3://bucket/key.mgsnap"')


def test_issu_v1_format_upgrades_in_place(tmp_path):
    """ISSU: a data dir written by the PREVIOUS format version (v1
    unchunked snapshots) starts cleanly under the current build."""
    import struct
    from memgraph_tpu_torch.storage.durability import snapshot as snap

    src = _mk(tmp_path, "old")
    run(src, "CREATE (:Old {v: 7})-[:E {w: 1}]->(:Old {v: 35})")
    run(src, "CREATE SNAPSHOT")
    new_path = max((tmp_path / "old" / "snapshots").glob("*.mgsnap"))
    data = snap.load_snapshot(str(new_path))

    # rewrite as a faithful v1 file (unchunked sections)
    from io import BytesIO
    buf = BytesIO()
    buf.write(snap.MAGIC)
    buf.write(struct.pack("<HQQ", 1, data["timestamp"], data["wall_time"]))
    buf.write(bytes((snap.SEC_MAPPERS,)))
    for names in (data["labels"], data["properties"], data["edge_types"]):
        snap._write_varint(buf, len(names))
        for name in names:
            raw = name.encode()
            snap._write_varint(buf, len(raw))
            buf.write(raw)
    buf.write(bytes((snap.SEC_VERTICES,)))
    snap._write_varint(buf, len(data["vertices"]))
    for gid, labels, props in data["vertices"]:
        snap._write_varint(buf, gid)
        snap._write_varint(buf, len(labels))
        for l in labels:
            snap._write_varint(buf, l)
        snap._write_varint(buf, len(props))
        for pid in sorted(props):
            snap._write_varint(buf, pid)
            snap.encode_value(buf, props[pid])
    buf.write(bytes((snap.SEC_EDGES,)))
    snap._write_varint(buf, len(data["edges"]))
    for gid, etype, f, t, props in data["edges"]:
        for x in (gid, etype, f, t):
            snap._write_varint(buf, x)
        snap._write_varint(buf, len(props))
        for pid in sorted(props):
            snap._write_varint(buf, pid)
            snap.encode_value(buf, props[pid])
    buf.write(bytes((snap.SEC_END,)))

    old_dir = tmp_path / "upgraded"
    (old_dir / "snapshots").mkdir(parents=True)
    (old_dir / "snapshots" / "snapshot_1_1.mgsnap").write_bytes(
        buf.getvalue())

    # "new version" boots on the old-format directory
    upgraded = InterpreterContext(InMemoryStorage(StorageConfig(
        durability_dir=str(old_dir), wal_enabled=True)))
    from memgraph_tpu_torch.storage.durability.recovery import recover
    recover(upgraded.storage)
    assert run(upgraded, "MATCH (o:Old) RETURN sum(o.v)") == [[42]]
    # and writing a NEW snapshot from the upgraded instance emits v2
    run(upgraded, "CREATE SNAPSHOT")
    latest = max((old_dir / "snapshots").glob("*.mgsnap"),
                 key=os.path.getmtime)
    version = struct.unpack(
        "<H", latest.read_bytes()[len(snap.MAGIC):len(snap.MAGIC) + 2])[0]
    assert version == snap.VERSION    # rewritten at the current format


def test_corrupt_remote_download_does_not_poison_recovery(tmp_path):
    """A 200 response with garbage must neither load nor become the
    newest local snapshot."""
    import functools

    serve_dir = tmp_path / "www2"
    serve_dir.mkdir()
    (serve_dir / "garbage.mgsnap").write_bytes(b"<html>not a snapshot")

    class _Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a, **k):
            pass

    httpd = http.server.HTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet,
                                            directory=str(serve_dir)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        dst = _mk(tmp_path, "dst2")
        run(dst, "CREATE (:Live {v: 1})")
        run(dst, "CREATE SNAPSHOT")
        port = httpd.server_address[1]
        with pytest.raises(Exception, match="magic"):
            run(dst, f'RECOVER SNAPSHOT FROM '
                     f'"http://127.0.0.1:{port}/garbage.mgsnap"')
        # the corrupt file was discarded; plain recovery still works
        run(dst, "RECOVER SNAPSHOT")
        assert run(dst, "MATCH (l:Live) RETURN count(l)") == [[1]]
    finally:
        httpd.shutdown()


def test_recover_from_source_starts_new_wal_epoch(tmp_path):
    """Old local WAL must not replay on top of a foreign snapshot after
    a restart."""
    src = _mk(tmp_path, "srcw")
    run(src, "CREATE (:F {v: 10})")
    run(src, "CREATE SNAPSHOT")
    snap = max((tmp_path / "srcw" / "snapshots").glob("*.mgsnap"))

    dst_dir = tmp_path / "dstw"
    dst = _mk(tmp_path, "dstw")
    for i in range(5):
        run(dst, "CREATE (:LocalJunk {i: $i})", {"i": i})
    run(dst, f'RECOVER SNAPSHOT FROM "{snap}"')
    assert run(dst, "MATCH (f:F) RETURN sum(f.v)") == [[10]]

    # restart: recovery must yield the foreign state, not resurrect junk
    from memgraph_tpu_torch.storage.durability.recovery import recover
    fresh = InterpreterContext(InMemoryStorage(StorageConfig(
        durability_dir=str(dst_dir), wal_enabled=True)))
    recover(fresh.storage)
    assert run(fresh, "MATCH (f:F) RETURN sum(f.v)") == [[10]]
    assert run(fresh, "MATCH (j:LocalJunk) RETURN count(j)") == [[0]]


# --- file compatibility with the JAX package -------------------------------

#: a script over the value kinds, the DDL and the mutations the WAL records
COMPAT_SCRIPT = [
    "CREATE INDEX ON :Person",
    "CREATE INDEX ON :Person(name)",
    "CREATE EDGE INDEX ON :KNOWS",
    "CREATE CONSTRAINT ON (n:Person) ASSERT n.name IS UNIQUE",
    "CREATE CONSTRAINT ON (n:Person) ASSERT EXISTS (n.name)",
    "CREATE CONSTRAINT ON (n:City) ASSERT n.code IS TYPED STRING",
    "CREATE (a:Person {name: 'ana', age: 31, height: 1.62, tags: ['x', 'y'],"
    " ok: true, born: date('1993-04-05'), meta: {k: 1, s: 'v'}}), "
    "(b:Person:Admin {name: 'ben', age: -7, nested: [[1, 2], ['a']]}), "
    "(c:City {code: 'LJ', pop: 280000}), "
    "(a)-[:KNOWS {since: 2020, w: 0.5}]->(b), (b)-[:LIVES_IN]->(c)",
    "UNWIND range(0, 29) AS i CREATE (:Item {i: i, s: toString(i * 7)})",
    "MATCH (n:Person {name: 'ben'}) SET n.age = 42, n.height = null",
    "MATCH (n:Item) WHERE n.i % 3 = 0 SET n:Third",
    "MATCH (a:Item {i: 1}), (b:Item {i: 2}) CREATE (a)-[:NEXT {d: 1}]->(b)",
    "MATCH (a:Item {i: 2}), (b:Item {i: 3}) CREATE (a)-[:NEXT {d: 2}]->(b)",
    "MATCH ()-[r:NEXT {d: 1}]->() SET r.d = 10",
    "MATCH (n:Item {i: 5}) DELETE n",
    "MATCH (n:Item {i: 3}) DETACH DELETE n",
    "MATCH (c:City) REMOVE c.pop",
]


def _package(pkg):
    """(InMemoryStorage, StorageConfig, interpreter module, recovery,
    snapshot) of one package."""
    if pkg == "jax":
        from memgraph_tpu.query import interpreter as I
        from memgraph_tpu.storage import InMemoryStorage as S
        from memgraph_tpu.storage import StorageConfig as C
        from memgraph_tpu.storage.durability import recovery as R
        from memgraph_tpu.storage.durability import snapshot as N
    else:
        from memgraph_tpu_torch.query import interpreter as I
        from memgraph_tpu_torch.storage import InMemoryStorage as S
        from memgraph_tpu_torch.storage import StorageConfig as C
        from memgraph_tpu_torch.storage.durability import recovery as R
        from memgraph_tpu_torch.storage.durability import snapshot as N
    return S, C, I, R, N


def _context(pkg, storage):
    _S, _C, I, _R, _N = _package(pkg)
    return (I.InterpreterContext(storage) if pkg == "jax"
            else I.InterpreterContext(storage, device="cpu"))


def _write(pkg, d, script, snapshot_after=None, batch=False):
    """Run ``script`` on a WAL-backed storage of ``pkg`` in ``d``; CREATE
    SNAPSHOT after statement ``snapshot_after``; with ``batch`` also a
    ``batch_insert`` transaction of 40 vertices and 60 edges."""
    S, C, I, R, _N = _package(pkg)
    storage = S(C(durability_dir=str(d), wal_enabled=True))
    wal = R.wire_durability(storage)
    interp = I.Interpreter(_context(pkg, storage))
    for i, q in enumerate(script):
        interp.execute(q)
        if i == snapshot_after:
            interp.execute("CREATE SNAPSHOT")
    if batch:
        rng = np.random.default_rng(3)
        lid = storage.label_mapper.name_to_id("Bulk")
        pid = storage.property_mapper.name_to_id("v")
        et = storage.edge_type_mapper.name_to_id("LINK")
        acc = storage.access()
        s = rng.integers(0, 40, 60).tolist()
        t = rng.integers(0, 40, 60).tolist()
        vs = acc.batch_insert(
            vertices=[([lid], {pid: k} if k % 4 else {}) for k in range(40)],
            edges=[(et, a, b, {pid: a / 3}) for a, b in zip(s, t)])[0]
        acc.commit()
        acc = storage.access()      # edges between committed vertices
        acc.batch_insert(edges=[(et, vs[a], vs[b], {}) for a, b in
                                zip(t[:20], s[:20])])
        acc.commit()
    wal.close()
    return storage


def _norm(v):
    """A value by kind and text, so that each package's classes compare."""
    if isinstance(v, (list, tuple)):
        return ("list", [_norm(x) for x in v])
    if isinstance(v, dict):
        return ("map", sorted((k, _norm(x)) for k, x in v.items()))
    return (type(v).__name__, str(v))


def _state(storage):
    """Everything recovery restores, by name: vertices and edges by gid,
    the indexes and the constraints."""
    lm, pm, tm = (storage.label_mapper, storage.property_mapper,
                  storage.edge_type_mapper)
    acc = storage.access()
    try:
        vertices = {
            v.gid: (sorted(lm.id_to_name(l) for l in v.labels(View.OLD)),
                    sorted((pm.id_to_name(p), _norm(x))
                           for p, x in v.properties(View.OLD).items()))
            for v in acc.vertices(View.OLD)}
        edges = {
            e.gid: (tm.id_to_name(e.edge_type), e.from_vertex().gid,
                    e.to_vertex().gid,
                    sorted((pm.id_to_name(p), _norm(x))
                           for p, x in e.properties(View.OLD).items()))
            for e in acc.edges(View.OLD)}
    finally:
        acc.abort()
    ix, cs = storage.indices, storage.constraints
    return {
        "vertices": vertices, "edges": edges,
        "label": sorted(lm.id_to_name(l) for l in ix.label.labels()),
        "label_property": sorted(
            (lm.id_to_name(l), [pm.id_to_name(p) for p in ps])
            for l, ps in ix.label_property.keys()),
        "edge_type": sorted(tm.id_to_name(t) for t in ix.edge_type.types()),
        "existence": sorted((lm.id_to_name(l), pm.id_to_name(p))
                            for l, p in cs.existence.all()),
        "unique": sorted((lm.id_to_name(l), [pm.id_to_name(p) for p in ps])
                         for l, ps in cs.unique.all()),
        "type": sorted((lm.id_to_name(l), pm.id_to_name(p), t)
                       for l, p, t in cs.type.all())}


def _recovered(pkg, d):
    S, C, _I, R, _N = _package(pkg)
    storage = S(C(durability_dir=str(d), wal_enabled=True))
    stats = R.recover(storage)
    return storage, stats


#: where the snapshot falls: none (the WAL alone), mid-script (a snapshot
#: and a WAL tail), after the script (the snapshot alone)
LAYOUTS = {"wal": None, "snapshot_and_wal": 8, "snapshot": None}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_a_data_directory_recovers_in_the_other_package(tmp_path, writer,
                                                        reader, layout):
    written = _write(writer, tmp_path, COMPAT_SCRIPT,
                     snapshot_after=LAYOUTS[layout], batch=True)
    if layout == "snapshot":
        _S, _C, _I, _R, N = _package(writer)
        N.create_snapshot(written)
    want = _state(written)
    got, stats = _recovered(reader, tmp_path)
    assert (stats["snapshot"] is None) == (layout == "wal")
    state = _state(got)
    # what the writer's own package recovers: without a snapshot the DDL
    # is the kvstore's (a DbmsHandler restores it), not the WAL's
    assert state == _state(_recovered(writer, tmp_path)[0])
    if layout == "wal":
        assert not state["label"] and not state["unique"]
        state.update({k: want[k] for k in state
                      if k not in ("vertices", "edges")})
    assert state == want
    assert len(want["vertices"]) == 3 + 28 + 40 and len(want["edges"]) == 83
    # and the reader writes on: the next gid follows the recovered ones
    _I = _package(reader)[2]
    _I.Interpreter(_context(reader, got)).execute("CREATE (:After)")
    assert max(_state(got)["vertices"]) == max(want["vertices"]) + 1


@pytest.mark.parametrize("batch", [False, True], ids=["cypher", "batch"])
def test_the_same_script_writes_byte_equal_wal_segments(tmp_path, batch):
    for pkg in ("jax", "torch"):
        _write(pkg, tmp_path / pkg, COMPAT_SCRIPT, batch=batch)
    names = {pkg: sorted(os.listdir(tmp_path / pkg / "wal"))
             for pkg in ("jax", "torch")}
    assert names["jax"] == names["torch"] and names["jax"]
    for name in names["jax"]:
        j = (tmp_path / "jax" / "wal" / name).read_bytes()
        t = (tmp_path / "torch" / "wal" / name).read_bytes()
        assert len(j) > 1000 and j == t


def test_the_same_state_writes_equal_snapshots_but_the_wall_clock(tmp_path):
    """A snapshot's header holds its wall-clock second after the magic,
    the version and the timestamp; every other byte is equal."""
    wall = len(snap.MAGIC) + 2 + 8
    data = {}
    for pkg in ("jax", "torch"):
        storage = _write(pkg, tmp_path / pkg, COMPAT_SCRIPT, batch=True)
        path = _package(pkg)[4].create_snapshot(storage)
        data[pkg] = open(path, "rb").read()
    j, t = data["jax"], data["torch"]
    assert len(j) == len(t) > 1000
    assert j[:wall] == t[:wall] and j[wall + 8:] == t[wall + 8:]


#: the system state a data directory carries besides the graph: DDL and
#: data, settings, users, roles, privileges, user and tenant profiles
SYSTEM_SCRIPT = [
    "CREATE INDEX ON :P(name)",
    "CREATE CONSTRAINT ON (n:P) ASSERT n.name IS UNIQUE",
    "CREATE (:P {name: 'x'})-[:R]->(:P {name: 'y'})",
    "SET DATABASE SETTING 'log.level' TO 'DEBUG'",
    "CREATE PROFILE p1 LIMIT sessions 5",
    "CREATE TENANT PROFILE tp LIMIT memory_limit 100MB",
    "CREATE ROLE readers",
    "GRANT MATCH TO readers",
    "CREATE USER alice IDENTIFIED BY 'alice-pw'",
    "SET ROLE FOR alice TO readers",
    "SET PROFILE FOR alice TO p1",
]
SYSTEM_READS = [
    "SHOW INDEX INFO", "SHOW CONSTRAINT INFO",
    "MATCH (a:P)-[:R]->(b:P) RETURN a.name, b.name",
    "SHOW DATABASE SETTINGS", "SHOW PROFILES", "SHOW PROFILE FOR alice",
    "SHOW TENANT PROFILES", "SHOW USERS", "SHOW ROLES",
    "SHOW PRIVILEGES FOR readers",
]


def _main_of(pkg):
    if pkg == "jax":
        from memgraph_tpu import main as M
        from memgraph_tpu.query import interpreter as I
        return M, I, []
    from memgraph_tpu_torch import main as M
    from memgraph_tpu_torch.query import interpreter as I
    return M, I, ["--device", "cpu"]


def _system_reads(pkg, d):
    M, I, extra = _main_of(pkg)
    ictx = M.build_database(M.build_config(
        ["--data-directory", str(d), "--storage-gc-cycle-sec", "0",
         "--memory-warning-threshold", "0"] + extra))
    interp = I.Interpreter(ictx, system=True)
    out = []
    for q in SYSTEM_READS:
        rows = interp.execute(q)[1]
        out.append(sorted(map(repr, rows)))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_ddl_settings_users_and_profiles_cross_a_restart(tmp_path, writer,
                                                          reader):
    M, I, extra = _main_of(writer)
    ictx = M.build_database(M.build_config(
        ["--data-directory", str(tmp_path), "--storage-gc-cycle-sec", "0",
         "--memory-warning-threshold", "0"] + extra))
    interp = I.Interpreter(ictx, system=True)
    for q in SYSTEM_SCRIPT:
        interp.execute(q)
    want = _system_reads(writer, tmp_path)
    got = _system_reads(reader, tmp_path)
    assert got == want
    assert any("DEBUG" in r for r in got[3]) and any("alice" in r
                                                     for r in got[7])


# --- the crash harness -------------------------------------------------------

def crash_child(dur_dir, acked_path, n_txns) -> int:
    """The child: a durable workload of two-vertex pairs, each pair's id
    appended (fsynced) to ``acked_path`` after its commit returned.
    Faults come from ``MEMGRAPH_TPU_FAULTS``; ``CRASH_CHILD_SNAPSHOT``
    takes a snapshot every that many transactions."""
    if any(m == "jax" or m.startswith(("jax.", "memgraph_tpu."))
           for m in sys.modules):
        print("the child imported JAX or the JAX package")
        return 3
    storage = InMemoryStorage(StorageConfig(
        durability_dir=dur_dir, wal_enabled=True, wal_segment_size=4096))
    recover(storage)
    wire_durability(storage)
    interp = Interpreter(InterpreterContext(storage))
    snap_every = int(os.environ.get("CRASH_CHILD_SNAPSHOT", 0))
    with open(acked_path, "a") as acked:
        for i in range(n_txns):
            interp.execute(f"CREATE (:P {{pair: {i}, half: 1}}), "
                           f"(:P {{pair: {i}, half: 2}})")
            acked.write(f"{i}\n")
            acked.flush()
            os.fsync(acked.fileno())
            if snap_every and (i + 1) % snap_every == 0:
                create_snapshot(storage)
    print("workload complete")
    return 0


def _run_child(tmp_path, faults, n, snapshot_every=0):
    dur = tmp_path / "data"
    dur.mkdir(exist_ok=True)
    acked = tmp_path / "acked.txt"
    env = dict(os.environ, MEMGRAPH_TPU_FAULTS=faults,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("CRASH_CHILD_SNAPSHOT", None)
    if snapshot_every:
        env["CRASH_CHILD_SNAPSHOT"] = str(snapshot_every)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(dur), str(acked),
         str(n)], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    ids = [int(x) for x in acked.read_text().split()] \
        if acked.exists() else []
    return proc, dur, ids


def _recovered_pairs(dur):
    storage = InMemoryStorage(StorageConfig(durability_dir=str(dur),
                                            wal_enabled=True))
    recover(storage)
    rows = Interpreter(InterpreterContext(storage)).execute(
        "MATCH (p:P) RETURN p.pair, count(*) ORDER BY p.pair")[1]
    return {r[0]: r[1] for r in rows}


#: torn WAL writes at several byte offsets, a kill before a write and
#: before an fsync, and a kill before a snapshot's rename (segments of 4
#: KiB rotate every few transactions)
CRASHES = [
    ("wal.write=kill@2", 0),
    ("wal.write=torn:1+kill@2", 0),
    ("wal.write=torn:9+kill@4", 0),
    ("wal.write=torn:64+kill@6", 0),
    ("wal.write=torn:300+kill@7", 0),
    ("wal.fsync=kill@5", 0),
    ("snapshot.rename=kill@1", 3),
]


@pytest.mark.parametrize("faults,snapshot_every", CRASHES)
def test_every_acked_pair_survives_a_crash(tmp_path, faults,
                                           snapshot_every):
    proc, dur, acked = _run_child(tmp_path, faults, 8, snapshot_every)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    pairs = _recovered_pairs(dur)
    for i in acked:
        assert pairs.get(i) == 2, (i, pairs, proc.stderr)
    assert all(c == 2 for c in pairs.values()), pairs
    # the acked prefix, and at most the one transaction durable but not
    # acked when the process died
    assert len(set(pairs) - set(acked)) <= 1, (pairs, acked)


def test_the_crash_child_completes_without_faults(tmp_path):
    proc, dur, acked = _run_child(tmp_path, "", 6)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert acked == list(range(6))
    assert _recovered_pairs(dur) == {i: 2 for i in range(6)}


# --- the refresh rule ---------------------------------------------------------

def _mxu_on_cpu(monkeypatch):
    """The MXU route (plan, placement, Benes gathers) on the CPU, and a
    count of the plans built."""
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops import spmv_mxu
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.setattr(PR, "MXU_MIN_EDGES", 0)
    built = []
    real = spmv_mxu.build_plan

    def counted(*args, **kw):
        built.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(spmv_mxu, "build_plan", counted)
    return built


CALL = "CALL pagerank.get() YIELD node, rank RETURN node.id AS id, rank"


def _ranks(interp, n):
    out = np.full(n, np.nan)
    for uid, rank in interp.execute(CALL)[1]:
        out[uid] = rank
    return out


def _graph(interp, n, edges):
    interp.execute("UNWIND range(0, $n - 1) AS i CREATE (:U {id: i})",
                   {"n": n})
    interp.execute("CREATE INDEX ON :U(id)")
    interp.execute("UNWIND $e AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]}) "
                   "CREATE (a)-[:F]->(b)", {"e": edges})


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, m), rng.integers(0, n, m)],
                    1).tolist()


def _fresh_ranks(d, n):
    """pagerank.get on a storage recovered anew from ``d``, with caches of
    its own."""
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.delta import LocalWarmPool
    from memgraph_tpu_torch.procedures import graph_algorithms as P
    from memgraph_tpu_torch.storage.source import StorageSource
    storage = InMemoryStorage(StorageConfig(durability_dir=str(d)))
    recover(storage)
    acc = storage.access()
    try:
        got = P.pagerank_get(StorageSource(acc), cache=GraphCache(),
                             pool=LocalWarmPool(), device="cpu")
    finally:
        acc.abort()
    ids = {v.gid: v.properties[storage.property_mapper.name_to_id("id")]
           for v in storage._vertices.values()}
    out = np.full(n, np.nan)
    out[[ids[int(g)] for g in got["node_gids"]]] = got["rank"]
    return out


def test_a_live_recover_snapshot_is_exported_and_planned_afresh(
        tmp_path, monkeypatch):
    from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
    from memgraph_tpu_torch.storage.storage import ChangeLogUnknowable
    built = _mxu_on_cpu(monkeypatch)
    n = 300
    storage = InMemoryStorage(StorageConfig(durability_dir=str(tmp_path)))
    interp = Interpreter(InterpreterContext(storage))
    _graph(interp, n, _edges(n, 1500, 1))
    interp.execute("CREATE SNAPSHOT")
    interp.execute("UNWIND $e AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]}) "
                   "CREATE (a)-[:F]->(b)", {"e": _edges(n // 10, 400, 2)})
    before = _ranks(interp, n)
    assert len(built) == 1
    full0 = GLOBAL_GRAPH_CACHE.counters["export.full"]
    version = storage.topology_version
    interp.execute("RECOVER SNAPSHOT")
    # the bump is one entry with no changed set: unknowable to every
    # version-keyed cache, which must rebuild
    assert storage.topology_version == version + 1
    assert isinstance(storage.changes_between(version, version + 1),
                      ChangeLogUnknowable)
    after = _ranks(interp, n)
    assert GLOBAL_GRAPH_CACHE.counters["export.full"] == full0 + 1
    assert len(built) == 2
    want = _fresh_ranks(tmp_path, n)
    assert np.abs(after - want).sum() <= 1e-5
    assert np.abs(before - want).sum() > 1e-2     # the graphs differ


def test_a_resumed_tenant_is_exported_and_planned_afresh(tmp_path,
                                                         monkeypatch):
    from memgraph_tpu_torch.dbms.dbms import DbmsHandler
    from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
    built = _mxu_on_cpu(monkeypatch)
    n = 200
    dbms = DbmsHandler(StorageConfig(durability_dir=str(tmp_path),
                                     wal_enabled=True), device="cpu")
    interp = Interpreter(dbms.default())
    interp.execute("CREATE DATABASE t1")
    interp.execute("USE DATABASE t1")
    _graph(interp, n, _edges(n, 1000, 4))
    before = _ranks(interp, n)
    old = dbms.get("t1").storage
    interp.execute("USE DATABASE memgraph")
    interp.execute("SUSPEND DATABASE t1")
    interp.execute("RESUME DATABASE t1")
    interp.execute("USE DATABASE t1")
    assert dbms.get("t1").storage is not old
    full0, n_built = GLOBAL_GRAPH_CACHE.counters["export.full"], len(built)
    after = _ranks(interp, n)
    assert GLOBAL_GRAPH_CACHE.counters["export.full"] == full0 + 1
    assert len(built) == n_built + 1
    assert np.array_equal(after, before)
    # a commit on the resumed tenant refreshes from its own plan
    interp.execute("UNWIND $e AS p MATCH (a:U {id: p[0]}), (b:U {id: p[1]}) "
                   "CREATE (a)-[:F]->(b)", {"e": _edges(n, 50, 5)})
    moved = _ranks(interp, n)
    assert np.isfinite(moved).all() and not np.array_equal(moved, after)
    assert len(built) == n_built + 1


if __name__ == "__main__":
    sys.exit(crash_child(sys.argv[1], sys.argv[2], int(sys.argv[3])))
