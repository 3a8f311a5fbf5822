"""The port's composition root (memgraph_tpu_torch/main.py) against the JAX
package's on the CPU.

- ``build_config`` gives equal namespaces on every shared flag (the port
  adds ``--device``), and ``split_statements`` the same split.
- ``build_database`` runs ``--init-file`` / ``--init-data-file`` and the
  license flags through the port's interpreter as the reference does.
- Each flag of a later slice (``main.LATER_FLAGS``) makes ``main`` exit 1
  with the ``NotPortedException`` text naming its slice; without a card
  and without ``--device cpu`` it exits 2.
- ``python -m memgraph_tpu_torch.main --device cpu --bolt-port <free>``
  answers over Bolt and exits on SIGTERM, each step under a timeout.
- ``--timezone`` (ROADMAP Queue 3 item 13): the reference's
  ``build_database`` raises ``UnboundLocalError``; the port sets the zone.
- An init file's users are the server's (ROADMAP Queue 3 item 14).
"""

import logging
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from memgraph_tpu import main as J
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.utils import license as jlicense
from memgraph_tpu_torch import main as T
from memgraph_tpu_torch import exceptions as TE
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.server.client import BoltClient

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: both packages' background threads off, so a test starts none
QUIET = ["--storage-gc-cycle-sec", "0", "--memory-warning-threshold", "0"]

ARGVS = [
    [],
    ["--bolt-port", "7777", "--log-level", "DEBUG", "--bolt-num-workers",
     "3", "--memory-limit", "512"],
    ["--no-storage-wal-enabled", "--license-key", "k", "--organization-name",
     "o", "--isolation-level", "READ_COMMITTED"],
    ["--auth-password-strength-regex", ".{8,}",
     "--no-auth-password-permit-null", "--query-execution-timeout-sec", "3",
     "--storage-property-store-compression-level", "high"],
    ["--no-strict-flag-check", "--not-a-flag", "1"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_build_config_agrees_on_every_shared_flag(argv):
    want = vars(J.build_config(list(argv)))
    got = vars(T.build_config(list(argv)))
    assert got.pop("device") == "cuda"
    assert got == want


def test_an_unknown_flag_is_refused_alike():
    for mod in (J, T):
        with pytest.raises(SystemExit) as e:
            mod.build_config(["--not-a-flag"])
        assert e.value.code == 2


TEXTS = [
    "CREATE (:A);CREATE (:B);",
    "RETURN 'a;b' AS s; RETURN \"c;d\";\n\n  RETURN 1",
    "// a comment; with a semicolon\nCREATE (:C {s: ';'});\n/* block; */"
    "MATCH (n) RETURN n;",
    "   ;;  ; RETURN 2 ;",
    "",
    "UNWIND [1, 2] AS x\nCREATE (:D {x: x});\nMATCH (d:D) RETURN d.x",
]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_split_statements_agrees(text):
    assert T.split_statements(text) == J.split_statements(text)


def test_init_files_run_through_the_interpreter(tmp_path):
    init = tmp_path / "init.cypherl"
    init.write_text("CREATE INDEX ON :P(v);\n"
                    "CREATE CONSTRAINT ON (p:P) ASSERT p.v IS UNIQUE;\n")
    data = tmp_path / "data.cypherl"
    data.write_text("UNWIND range(1, 5) AS i CREATE (:P {v: i});\n"
                    "MATCH (p:P {v: 3}) SET p.s = 'three; or so';\n")
    argv = QUIET + ["--init-file", str(init), "--init-data-file", str(data)]
    out = []
    for mod, interp in ((J, jinterp), (T, tinterp)):
        ictx = mod.build_database(mod.build_config(
            argv + (["--device", "cpu"] if mod is T else [])))
        it = interp.Interpreter(ictx, system=True)
        rows = [it.execute(q)[1] for q in (
            "MATCH (p:P) RETURN p.v, p.s ORDER BY p.v",
            "SHOW CONSTRAINT INFO", "SHOW INDEX INFO")]
        # an index row ends with the wall clock of its last lookup
        out.append(rows[:2] + [[r[:-1] for r in rows[2]]])
    assert out[1] == out[0]
    assert out[1][0][2] == [3, "three; or so"]


def test_an_init_files_users_are_the_servers(tmp_path):
    """ROADMAP Queue 3 item 14: the port wires its auth store before the
    init files, so their users are the ones the server checks.  (The
    reference's init-file users go to its process-wide store there, so
    its side is not run here: it would lock the test process's later
    anonymous sessions.)"""
    init = tmp_path / "init.cypherl"
    init.write_text("CREATE USER admin IDENTIFIED BY 'pw';\n"
                    "CREATE USER reader IDENTIFIED BY 'r';\n"
                    "GRANT MATCH TO reader;\n")
    ictx = T.build_database(T.build_config(
        QUIET + ["--device", "cpu", "--init-file", str(init)]))
    assert ictx.auth_store.users() == ["admin", "reader"]
    assert ictx.auth_store.authenticate("reader", "r")
    from memgraph_tpu_torch.auth.auth import global_auth
    assert global_auth().users() == []


def test_license_flags_configure_the_settings():
    key = jlicense.generate_key("Acme", "enterprise")
    argv = QUIET + ["--license-key", key, "--organization-name", "Acme"]
    out = []
    for mod, interp in ((J, jinterp), (T, tinterp)):
        ictx = mod.build_database(mod.build_config(
            argv + (["--device", "cpu"] if mod is T else [])))
        out.append(interp.Interpreter(ictx).execute(
            "SHOW LICENSE INFO")[1])
    assert out[1] == out[0]
    assert ["is_valid", True] in out[1]


def test_build_database_puts_the_default_database_on_the_device():
    ictx = T.build_database(T.build_config(QUIET + ["--device", "cpu"]))
    assert ictx.device == torch.device("cpu")
    assert ictx.dbms.default() is ictx
    assert ictx.dbms.device == torch.device("cpu")


#: an argv that sets each flag of a later slice off its default
FLAG_ARGV = {
    "data_directory": ["--data-directory", "mg_data"],
    "storage_wal_enabled": ["--no-storage-wal-enabled"],
    "storage_wal_file_size_kib": ["--storage-wal-file-size-kib", "1"],
    "storage_snapshot_on_exit": ["--storage-snapshot-on-exit"],
    "storage_recover_on_startup": ["--no-storage-recover-on-startup"],
    "data_recovery_on_startup": ["--data-recovery-on-startup"],
    "storage_snapshot_interval_sec": ["--storage-snapshot-interval-sec",
                                      "5"],
    "storage_snapshot_interval": ["--storage-snapshot-interval", "5"],
    "storage_snapshot_retention_count": [
        "--storage-snapshot-retention-count", "5"],
    "storage_snapshot_thread_count": ["--storage-snapshot-thread-count",
                                      "2"],
    "storage_parallel_snapshot_creation": [
        "--no-storage-parallel-snapshot-creation"],
    "storage_parallel_schema_recovery": [
        "--no-storage-parallel-schema-recovery"],
    "storage_allow_recovery_failure": ["--storage-allow-recovery-failure"],
    "aws_access_key": ["--aws-access-key", "k"],
    "aws_secret_key": ["--aws-secret-key", "s"],
    "aws_region": ["--aws-region", "r"],
    "aws_endpoint_url": ["--aws-endpoint-url", "http://s3.invalid"],
    "replication_restore_state_on_startup": [
        "--replication-restore-state-on-startup"],
    "coordinator_id": ["--coordinator-id", "1"],
    "coordinator_port": ["--coordinator-port", "10111"],
    "coordinator_peers": ["--coordinator-peers", "2=127.0.0.1:10112"],
    "coordinator_hostname": ["--coordinator-hostname", "c1"],
    "management_port": ["--management-port", "10113"],
    "cluster_cert_file": ["--cluster-cert-file", "c.pem"],
    "cluster_key_file": ["--cluster-key-file", "c.key"],
    "cluster_ca_file": ["--cluster-ca-file", "ca.pem"],
    "metrics_port": ["--metrics-port", "9091"],
    "metrics_address": ["--metrics-address", "127.0.0.1"],
    "metrics_format": ["--metrics-format", "PROMETHEUS"],
    "monitoring_port": ["--monitoring-port", "7444"],
    "monitoring_address": ["--monitoring-address", "127.0.0.1"],
    "telemetry_enabled": ["--telemetry-enabled"],
    "telemetry_endpoint": ["--telemetry-endpoint", "https://t.invalid/"],
    "audit_enabled": ["--audit-enabled"],
    "kafka_bootstrap_servers": ["--kafka-bootstrap-servers", "k:9092"],
    "pulsar_service_url": ["--pulsar-service-url", "pulsar://p.invalid"],
    "storage_mode": ["--storage-mode", "ON_DISK_TRANSACTIONAL"],
}
SLICE_OF = {**T.LATER_FLAGS, "storage_mode": TE.SLICE_HOST_FEATURES}


def test_every_later_flag_has_a_case():
    assert set(FLAG_ARGV) == set(SLICE_OF)
    assert set(T.LATER_FLAGS) <= set(vars(T.build_config([])))


@pytest.mark.parametrize("flag", sorted(FLAG_ARGV))
def test_a_flag_of_a_later_slice_exits_1_naming_it(flag, caplog, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = FLAG_ARGV[flag] + ["--device", "cpu", "--bolt-port", "0"]
    with pytest.raises(TE.NotPortedException) as e:
        T.build_database(T.build_config(argv))
    assert e.value.slice == SLICE_OF[flag]
    with caplog.at_level(logging.ERROR):
        assert T.main(argv) == 1
    assert SLICE_OF[flag] in caplog.text
    assert list(tmp_path.iterdir()) == []          # nothing was written


def test_without_a_card_main_exits_2_and_says_why(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with caplog.at_level(logging.ERROR):
        assert T.main(["--bolt-port", "0"] + QUIET) == 2
    assert "no CUDA device" in caplog.text
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_database(T.build_config(QUIET))


def test_timezone_sets_the_zone_where_the_reference_raises(monkeypatch):
    """ROADMAP Queue 3 item 13: the reference's ``build_database`` binds
    ``_os`` only later in the function, so ``--timezone`` (and the
    ``--aws-*`` flags) raise ``UnboundLocalError``."""
    monkeypatch.setenv("TZ", "UTC")
    with pytest.raises(UnboundLocalError):
        J.build_database(J.build_config(QUIET + ["--timezone", "UTC"]))
    ictx = T.build_database(T.build_config(QUIET + ["--timezone", "UTC",
                                                    "--device", "cpu"]))
    assert os.environ["TZ"] == "UTC"
    assert tinterp.Interpreter(ictx).execute("RETURN 1")[1] == [[1]]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_server_process_answers_and_exits_on_sigterm(tmp_path):
    port = free_port()
    init = tmp_path / "init.cypherl"
    init.write_text("CREATE (:Seed {v: 41});")
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "memgraph_tpu_torch.main", "--device", "cpu",
         "--bolt-address", "127.0.0.1", "--bolt-port", str(port),
         "--init-file", str(init)] + QUIET,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=log,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        client = None
        while client is None:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            assert time.monotonic() < deadline, "the server never listened"
            try:
                client = BoltClient(port=port, timeout=30)
            except OSError:
                time.sleep(0.2)
        try:
            assert client.execute("RETURN 1 AS one")[1] == [[1]]
            assert client.execute("MATCH (s:Seed) RETURN s.v + 1")[1] == \
                [[42]]
        finally:
            client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    assert "Bolt server listening" in (tmp_path / "server.log").read_text()
