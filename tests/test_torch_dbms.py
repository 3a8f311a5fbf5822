"""The port's multi-tenancy (memgraph_tpu_torch/dbms) against the JAX
package's on the CPU.

- Multi-database and tenant-profile scripts run statement by statement
  through a session on each package's ``DbmsHandler`` (the port's with
  ``device="cpu"``), each with an auth store of its own; every outcome
  (rows or error) is compared exactly (``test_torch_cypher.run``).
- The device rule: ``DbmsHandler(device="cpu")`` puts every tenant on the
  CPU; with no card (``torch.cuda.is_available`` patched) and no request
  for the CPU it raises.
- A durability directory: each tenant recovers from its own directory
  under it, as the reference's do; on-disk storage raises
  ``NotPortedException`` naming its slice.
- The reference's tenants run open under auth (ROADMAP Queue 3 item 12):
  the port checks a tenant's statements against the session's store.
"""

import pytest
import torch

from memgraph_tpu.auth.auth import Auth as JAuth
from memgraph_tpu.dbms.dbms import DbmsHandler as JDbms
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu_torch.auth.auth import Auth as TAuth
from memgraph_tpu_torch.dbms.dbms import DbmsHandler as TDbms
from memgraph_tpu_torch.exceptions import (SLICE_HOST_FEATURES,
                                           NotPortedException)
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.storage import StorageConfig as TConfig
from memgraph_tpu_torch.storage.common import StorageMode
from test_torch_cypher import run

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def handlers():
    """A JAX and a port DbmsHandler, each default context with an auth
    store of its own."""
    j, t = JDbms(), TDbms(device="cpu")
    j.default().auth_store = JAuth()
    t.default().auth_store = TAuth()
    return j, t


def play(script):
    """Each step ((user, query) or (user, query, params)) through a session
    per user on each handler's default database."""
    j, t = handlers()
    sessions = {}

    def session(pkg, dbms, user):
        key = (pkg, user)
        if key not in sessions:
            mod = jinterp if pkg == "jax" else tinterp
            sessions[key] = mod.Interpreter(dbms.default())
            sessions[key].username = user
        return sessions[key]

    out = []
    for step in script:
        user, query, params = (*step, None)[:3]
        out.append((step, run(session("jax", j, user), query, params),
                    run(session("port", t, user), query, params)))
    return out, j, t


MULTI_DATABASE = [
    (None, "SHOW DATABASES"),
    (None, "CREATE DATABASE tenant1"),
    (None, "CREATE DATABASE tenant1"),
    (None, "CREATE DATABASE 'bad name'"),
    (None, "CREATE DATABASE bad_name-2"),
    (None, "CREATE (:InDefault {v: 1})"),
    (None, "USE DATABASE tenant1"),
    (None, "SHOW DATABASES"),
    (None, "MATCH (n) RETURN count(n)"),
    (None, "CREATE (:InTenant {v: 2})"),
    (None, "MATCH (n) RETURN labels(n), n.v"),
    (None, "BEGIN"),
    (None, "USE DATABASE memgraph"),
    (None, "ROLLBACK"),
    (None, "USE DATABASE nowhere"),
    (None, "USE DATABASE memgraph"),
    (None, "MATCH (n) RETURN labels(n), n.v"),
    (None, "SUSPEND DATABASE tenant1"),
    (None, "SUSPEND DATABASE memgraph"),
    (None, "SUSPEND DATABASE nowhere"),
    (None, "RESUME DATABASE tenant1"),
    (None, "RESUME DATABASE nowhere"),
    (None, "DROP DATABASE memgraph"),
    (None, "DROP DATABASE nowhere"),
    (None, "DROP DATABASE tenant1"),
    (None, "SHOW DATABASES"),
    (None, "CREATE DATABASE tenant1"),
    (None, "USE DATABASE tenant1"),
    (None, "MATCH (n) RETURN count(n)"),
]

TENANT_PROFILES = [
    (None, "CREATE DATABASE t1"),
    (None, "CREATE DATABASE small_db"),
    (None, "CREATE TENANT PROFILE small LIMIT memory_limit 10MB"),
    (None, "CREATE TENANT PROFILE small LIMIT memory_limit 10MB"),
    (None, "SET TENANT PROFILE ON DATABASE t1 TO small"),
    (None, "SET TENANT PROFILE ON DATABASE nowhere TO small"),
    (None, "SET TENANT PROFILE ON DATABASE t1 TO nope"),
    (None, "SHOW TENANT PROFILE small"),
    (None, "ALTER TENANT PROFILE small SET memory_limit 5MB"),
    (None, "SHOW TENANT PROFILES"),
    (None, "CREATE TENANT PROFILE tiny LIMIT memory_limit 300KB"),
    (None, "SET TENANT PROFILE ON DATABASE small_db TO tiny"),
    (None, "USE DATABASE small_db"),
    (None, "UNWIND range(1, 200000) AS i WITH collect(i) AS xs "
           "RETURN size(xs)"),
    (None, "RETURN 1 QUERY MEMORY LIMIT 100 MB"),
    (None, "USE DATABASE memgraph"),
    (None, "UNWIND range(1, 200000) AS i WITH collect(i) AS xs "
           "RETURN size(xs)"),
    (None, "CLEAR TENANT PROFILE ON DATABASE t1"),
    (None, "SHOW TENANT PROFILES"),
    (None, "DROP DATABASE small_db"),
    (None, "SHOW TENANT PROFILES"),
    (None, "DROP TENANT PROFILE small"),
    (None, "SHOW TENANT PROFILE small"),
    (None, "DROP TENANT PROFILE small"),
]

AUTHED_TENANTS = [
    (None, "CREATE USER admin IDENTIFIED BY 'a'"),
    ("admin", "CREATE USER reader IDENTIFIED BY 'r'"),
    ("admin", "GRANT MATCH TO reader"),
    ("admin", "CREATE DATABASE t2"),
    ("admin", "USE DATABASE t2"),
    ("admin", "CREATE (:AdminMade)"),
    ("admin", "SHOW DATABASES"),
    ("reader", "USE DATABASE t2"),
    ("reader", "MATCH (n) RETURN count(n)"),
    ("reader", "CREATE (:ReaderMade)"),
    ("admin", "MATCH (n) RETURN labels(n)"),
    ("admin", "USE DATABASE memgraph"),
    ("admin", "MATCH (n) RETURN count(n)"),
]


@pytest.mark.parametrize("script", [MULTI_DATABASE, TENANT_PROFILES,
                                    AUTHED_TENANTS],
                         ids=["multi_database", "tenant_profiles",
                              "authed_tenants"])
def test_script(script):
    outcomes, _, _ = play(script)
    for step, want, got in outcomes:
        assert got == want, step
    kinds = {got[0] for _, _, got in outcomes}
    assert kinds == {"ok", "error"}


def test_the_handlers_keep_the_same_databases():
    _, j, t = play(MULTI_DATABASE)
    assert t.names() == j.names() == ["memgraph", "tenant1"]
    assert j.database_states() == [("memgraph", "hot"), ("tenant1", "hot")]
    assert t.get("tenant1").database_name == "tenant1"


def test_every_tenant_runs_on_the_requested_device():
    t = TDbms(device="cpu")
    t.create("a")
    it = tinterp.Interpreter(t.default())
    it.execute("CREATE DATABASE b")
    assert [t.get(n).device for n in t.names()] == \
        [torch.device("cpu")] * 3
    assert all(t.get(n).dbms is t for n in t.names())


def test_without_a_card_and_without_the_cpu_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDbms()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDbms(device="cuda:0")
    assert TDbms(device="cpu").device == torch.device("cpu")


def test_a_durability_directory_names_its_slice(tmp_path):
    """The durability slice has landed: a handler on a durability directory
    keeps the default database at its root and each tenant under
    ``databases/<name>``.  A handler built anew on it recovers the default
    database, and a tenant when it is created again (neither package
    lists its tenants in the directory), as the reference's does on the
    same directory."""
    from memgraph_tpu.storage import StorageConfig as JConfig
    cfg = TConfig(durability_dir=str(tmp_path), wal_enabled=True)
    t = TDbms(cfg, device="cpu")
    it = tinterp.Interpreter(t.default())
    it.execute("CREATE (:Root {v: 1})")
    it.execute("CREATE DATABASE t1")
    it.execute("USE DATABASE t1")
    it.execute("CREATE INDEX ON :T(v)")
    it.execute("UNWIND range(1, 3) AS i CREATE (:T {v: i})")
    assert {"databases", "kvstore.db", "wal"} <= \
        {p.name for p in tmp_path.iterdir()}
    assert (tmp_path / "databases" / "t1" / "wal").is_dir()
    reads = [("memgraph", "MATCH (n) RETURN labels(n), n.v"),
             ("t1", "MATCH (n:T) RETURN sum(n.v)"),
             ("t1", "SHOW INDEX INFO")]
    outs = []
    for dbms in (TDbms(cfg, device="cpu"),
                 JDbms(JConfig(durability_dir=str(tmp_path),
                               wal_enabled=True))):
        assert dbms.names() == ["memgraph"]
        dbms.create("t1")
        outs.append([run(tinterp.Interpreter(dbms.get(db))
                         if isinstance(dbms, TDbms)
                         else jinterp.Interpreter(dbms.get(db)), q)
                     for db, q in reads])
    assert outs[0] == outs[1]
    assert outs[0][1][2] == [(6,)]


def test_on_disk_storage_names_its_slice():
    with pytest.raises(NotPortedException) as e:
        TDbms(TConfig(storage_mode=StorageMode.ON_DISK_TRANSACTIONAL),
              device="cpu")
    assert e.value.slice == SLICE_HOST_FEATURES


def test_a_tenant_checks_privileges_against_the_sessions_store():
    """ROADMAP Queue 3 item 12.  The reference resolves the auth store of
    the database a session uses; a tenant has none of its own, so it
    falls back to the empty process-wide store and anyone who may switch
    to it writes there.  The port checks the session's store."""
    script = [(None, "CREATE USER admin IDENTIFIED BY 'a'"),
              ("admin", "CREATE USER user IDENTIFIED BY 'u'"),
              ("admin", "GRANT MATCH, MULTI_DATABASE_USE, "
                        "MULTI_DATABASE_EDIT TO user"),
              ("admin", "CREATE DATABASE t3"),
              ("user", "USE DATABASE t3"),
              ("user", "CREATE (:Written)"),
              ("user", "MATCH (n) RETURN count(n)")]
    outcomes, j, t = play(script)
    for step, want, got in outcomes[:5]:
        assert got == want and got[0] == "ok", step
    (_, want, got), (_, want_n, got_n) = outcomes[5], outcomes[6]
    assert want[0] == "ok"                      # the reference: written
    assert got[:2] == ("error", "AuthException")
    assert "missing privilege CREATE" in got[2]
    assert want_n[2] == [(1,)] and got_n[2] == [(0,)]
