"""The port's kvstore (memgraph_tpu_torch/storage/kvstore.py) and what a
data directory keeps in it, on the CPU: the cases of tests/test_kvstore.py
that need no triggers or streams (a later slice's), through the port's
``DbmsHandler(device="cpu")``, plus each package opening the other's
``kvstore.db`` and the ``kvstore.put`` fault point."""

import pytest
import torch

from memgraph_tpu_torch.dbms.dbms import DbmsHandler as _Dbms
from memgraph_tpu_torch.exceptions import (SLICE_HOST_FEATURES,
                                           ConstraintViolation,
                                           NotPortedException)
from memgraph_tpu_torch.query.interpreter import Interpreter
from memgraph_tpu_torch.storage import StorageConfig
from memgraph_tpu_torch.storage.kvstore import KVStore, Settings
from memgraph_tpu_torch.utils import faultinject as FI

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def DbmsHandler(cfg=None, recover_on_startup=True):
    """The port's handler on the CPU."""
    return _Dbms(cfg, recover_on_startup=recover_on_startup, device="cpu")


def test_kvstore_basics(tmp_path):
    kv = KVStore(str(tmp_path / "kv.db"))
    kv.put("a", b"1")
    kv.put("a", "2")
    kv.put("b:x", b"3")
    kv.put("b:y", b"4")
    assert kv.get("a") == b"2"
    assert kv.get_str("a") == "2"
    assert kv.get("missing") is None
    assert dict(kv.items_with_prefix("b:")) == {"b:x": b"3", "b:y": b"4"}
    assert kv.delete("a") and not kv.delete("a")
    assert kv.delete_prefix("b:") == 2
    assert dict(kv.items_with_prefix("b:")) == {}
    kv.put("c", b"5")
    kv.close()
    # durability across reopen
    kv2 = KVStore(str(tmp_path / "kv.db"))
    assert kv2.get("c") == b"5"
    kv2.close()


def test_settings_observers(tmp_path):
    kv = KVStore(str(tmp_path / "kv.db"))
    s = Settings(kv)
    seen = []
    s.observe("log_level", seen.append)
    s.set("log_level", "DEBUG")
    assert seen == ["DEBUG"]
    # reload from disk
    s2 = Settings(KVStore(str(tmp_path / "kv.db")))
    assert s2.get("log_level") == "DEBUG"
    assert s2.all() == {"log_level": "DEBUG"}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_opens_the_others_kvstore(tmp_path, writer):
    from memgraph_tpu.storage import kvstore as J
    from memgraph_tpu_torch.storage import kvstore as T
    w, r = (J, T) if writer == "jax" else (T, J)
    kv = w.KVStore(str(tmp_path / "kvstore.db"))
    w.Settings(kv).set("log.level", "TRACE")
    kv.put("ddl:index:[\"label\", \"A\"]", "")
    kv.put("blob", bytes(range(256)))
    kv.close()
    kv = r.KVStore(str(tmp_path / "kvstore.db"))
    assert r.Settings(kv).get("log.level") == "TRACE"
    assert kv.get("blob") == bytes(range(256))
    assert [k for k, _ in kv.items_with_prefix("ddl:")] == \
        ['ddl:index:["label", "A"]']
    kv.close()


def test_database_settings_cypher(tmp_path):
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    dbms = DbmsHandler(cfg)
    interp = Interpreter(dbms.default())
    interp.execute('SET DATABASE SETTING "log.level" TO "DEBUG"')
    _, rows, _ = interp.execute('SHOW DATABASE SETTING "log.level"')
    assert rows == [["log.level", "DEBUG"]]
    _, rows, _ = interp.execute("SHOW DATABASE SETTINGS")
    assert ["log.level", "DEBUG"] in rows
    # durable across a new handler
    dbms2 = DbmsHandler(cfg)
    interp2 = Interpreter(dbms2.default())
    _, rows, _ = interp2.execute('SHOW DATABASE SETTING "log.level"')
    assert rows == [["log.level", "DEBUG"]]


def test_index_and_constraint_ddl_survive_wal_restart(tmp_path):
    """DDL restores from the kvstore when only WAL (no snapshot) exists."""
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    dbms = DbmsHandler(cfg)
    interp = Interpreter(dbms.default())
    interp.execute("CREATE INDEX ON :P(name)")
    interp.execute("CREATE CONSTRAINT ON (n:P) ASSERT n.name IS UNIQUE")
    interp.execute("CREATE (:P {name: 'x'})")

    dbms2 = DbmsHandler(cfg)
    interp2 = Interpreter(dbms2.default())
    _, rows, _ = interp2.execute("SHOW INDEX INFO")
    assert any(r[0] == "label+property" for r in rows)
    _, rows, _ = interp2.execute("SHOW CONSTRAINT INFO")
    assert rows and rows[0][0] == "unique"
    with pytest.raises(ConstraintViolation):
        interp2.execute("CREATE (:P {name: 'x'})")
    # dropped DDL stays dropped
    interp2.execute("DROP INDEX ON :P(name)")
    dbms3 = DbmsHandler(cfg)
    interp3 = Interpreter(dbms3.default())
    _, rows, _ = interp3.execute("SHOW INDEX INFO")
    assert not any(r[0] == "label+property" for r in rows)


def test_keyword_named_labels_and_properties(tmp_path):
    """Regression: names colliding with keywords (User, key, type, point)
    must keep their case and identity through parse/intern."""
    dbms = DbmsHandler()
    interp = Interpreter(dbms.default())
    interp.execute("CREATE (:User {key: 1, type: 'x', point: 2, count: 3})")
    _, rows, _ = interp.execute(
        "MATCH (n:User) RETURN n.key, n.type, n.point, n.count")
    assert rows == [[1, "x", 2, 3]]
    assert "User" in dbms.default().storage.label_mapper.all_names()


def test_ddl_drop_wins_over_snapshot(tmp_path):
    """An index dropped AFTER the last snapshot must stay dropped."""
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    dbms = DbmsHandler(cfg)
    interp = Interpreter(dbms.default())
    interp.execute("CREATE INDEX ON :Q(name)")
    interp.execute("CREATE SNAPSHOT")
    interp.execute("DROP INDEX ON :Q(name)")
    dbms2 = DbmsHandler(cfg)
    _, rows, _ = Interpreter(dbms2.default()).execute("SHOW INDEX INFO")
    assert not any(r[0] == "label+property" for r in rows)


def test_type_constraint_drop_case_insensitive_persist(tmp_path):
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    dbms = DbmsHandler(cfg)
    interp = Interpreter(dbms.default())
    interp.execute("CREATE CONSTRAINT ON (n:P) ASSERT n.a IS TYPED STRING")
    interp.execute("DROP CONSTRAINT ON (n:P) ASSERT n.a IS TYPED string")
    dbms2 = DbmsHandler(cfg)
    _, rows, _ = Interpreter(dbms2.default()).execute("SHOW CONSTRAINT INFO")
    assert rows == []  # must NOT resurrect


def test_restore_ddl_respects_recover_flag(tmp_path):
    cfg = StorageConfig(durability_dir=str(tmp_path), wal_enabled=True)
    dbms = DbmsHandler(cfg)
    Interpreter(dbms.default()).execute("CREATE INDEX ON :R(name)")
    dbms2 = DbmsHandler(cfg, recover_on_startup=False)
    _, rows, _ = Interpreter(dbms2.default()).execute("SHOW INDEX INFO")
    assert rows == []


def test_a_kvstore_holding_enums_names_their_slice(tmp_path):
    """Enums are the host features' slice: a data directory whose kvstore
    holds them (written by the JAX package) is refused, typed, rather than
    recovered without them."""
    KVStore(str(tmp_path / "kvstore.db")).put("enums", '[["S", ["A"]]]')
    with pytest.raises(NotPortedException) as e:
        DbmsHandler(StorageConfig(durability_dir=str(tmp_path)))
    assert e.value.slice == SLICE_HOST_FEATURES


def test_kvstore_put_fault_point(tmp_path):
    FI.reset()
    kv = KVStore(str(tmp_path / "kv.db"))
    try:
        kv.put("a", "1")
        FI.arm("kvstore.put", "raise", at=FI.hit_count("kvstore.put") + 1)
        with pytest.raises(FI.FaultInjected):
            kv.put("b", "2")
        kv.put("c", "3")          # the store keeps working after the fault
        assert kv.get_str("a") == "1"
        assert kv.get_str("b") is None
        assert kv.get_str("c") == "3"
    finally:
        FI.reset()
        kv.close()


def test_fault_grammar_parses_the_durability_points():
    FI.reset()
    try:
        FI.arm_from_string("wal.write=torn:7+kill@3,wal.fsync=raise@2;5,"
                           "snapshot.rename=delay:0.01,kvstore.put=raise@1")
        spec = FI._SPECS["wal.write"][0]
        assert (spec.action, spec.arg, spec.then) == ("torn", 7, "kill")
        assert FI._SPECS["wal.fsync"][0].hits == frozenset({2, 5})
        assert FI._SPECS["snapshot.rename"][0].hits is None
        with pytest.raises(ValueError):
            FI.arm_from_string("wal.write=torn:7+explode@1")
        with pytest.raises(ValueError):
            FI.arm("wal.wrte", "raise")
    finally:
        FI.reset()


def test_faulty_write_tears_at_the_exact_offset(tmp_path):
    FI.reset()
    path = tmp_path / "f.bin"
    try:
        FI.arm("wal.write", "torn", arg=5, at=2)
        with open(path, "wb") as f:
            FI.faulty_write("wal.write", f, b"0123456789")
            with pytest.raises(FI.FaultInjected):
                FI.faulty_write("wal.write", f, b"abcdefghij")
            FI.faulty_write("wal.write", f, b"XY")
    finally:
        FI.reset()
    assert path.read_bytes() == b"0123456789abcdeXY"
