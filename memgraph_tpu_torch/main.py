"""Process entry / composition root.

Counterpart of memgraph/src/memgraph.cpp main(): wires config,
storage, interpreter context, auth, query-module directory, Bolt server,
and ordered shutdown.

Copy of memgraph_tpu/main.py for the port.  What differs:

- ``--device`` (default ``cuda``) is where every database runs:
  ``DbmsHandler(..., device=)`` builds each tenant's interpreter context
  there.  Without a card and without ``--device cpu``, ``main`` exits 2
  and says why; nothing falls back to the CPU.
- A flag whose module a later slice of the port brings (``LATER_FLAGS``:
  the data directory and the storage durability flags, replication and
  coordination, cluster TLS, streams' defaults, the HTTP metrics,
  monitoring, telemetry and audit) refuses with the
  ``NotPortedException`` of its slice when set to anything but its
  default: ``build_database`` raises and ``main`` exits 1.  None is
  ignored silently.
- ``build_database`` always wires an auth store (in memory) before the
  init files run, so a user an init file creates is the server's.  (The
  reference wires one only with a data directory or SSO modules; else
  an init file's users go to the process-wide store, and ``serve``
  gives the server a new, empty one.)
- The reference's JAX platform switch has no counterpart, and the
  trigger store is not wired: triggers are a later slice's.

Run:  python -m memgraph_tpu_torch.main --bolt-port 7687
      (``--device cpu`` for the CPU)
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys

from .auth.auth import Auth
from .exceptions import (SLICE_DURABILITY, SLICE_HOST_FEATURES,
                         SLICE_OBSERVABILITY, SLICE_REPLICATION,
                         NotPortedException)
from .query.interpreter import Interpreter, InterpreterContext
from .server.bolt import BoltServer
from .storage import StorageConfig
from .storage.common import IsolationLevel, StorageMode

#: flag (argparse dest) -> the later slice of the port whose module it needs
LATER_FLAGS = {
    **{name: SLICE_DURABILITY for name in (
        "data_directory", "storage_wal_enabled",
        "storage_wal_file_size_kib", "storage_snapshot_on_exit",
        "storage_recover_on_startup", "data_recovery_on_startup",
        "storage_snapshot_interval_sec", "storage_snapshot_interval",
        "storage_snapshot_retention_count", "storage_snapshot_thread_count",
        "storage_parallel_snapshot_creation",
        "storage_parallel_schema_recovery", "storage_allow_recovery_failure",
        "aws_access_key", "aws_secret_key", "aws_region",
        "aws_endpoint_url")},
    **{name: SLICE_REPLICATION for name in (
        "replication_restore_state_on_startup", "coordinator_id",
        "coordinator_port", "coordinator_peers", "coordinator_hostname",
        "management_port", "cluster_cert_file", "cluster_key_file",
        "cluster_ca_file")},
    **{name: SLICE_OBSERVABILITY for name in (
        "metrics_port", "metrics_address", "metrics_format",
        "monitoring_port", "monitoring_address", "telemetry_enabled",
        "telemetry_endpoint", "audit_enabled")},
    **{name: SLICE_HOST_FEATURES for name in (
        "kafka_bootstrap_servers", "pulsar_service_url")},
}


def build_config(argv=None) -> argparse.Namespace:
    """~Flag surface of the reference's src/flags/ (the subset that exists)."""
    p = argparse.ArgumentParser("memgraph_tpu_torch")
    p.add_argument("--bolt-address", default="0.0.0.0")
    p.add_argument("--bolt-port", type=int, default=7687)
    p.add_argument("--bolt-advertised-address", default=None,
                   help="host:port other machines should dial for this "
                        "server (routing tables, cluster metadata); "
                        "defaults to localhost:<bolt-port>")
    p.add_argument("--memory-limit", type=int, default=0,
                   help="global tracked-memory limit in MiB (0 = off; "
                        "reference: --memory-limit)")
    p.add_argument("--bolt-cert-file", default=None,
                   help="TLS certificate for the Bolt listener (bolt+s)")
    p.add_argument("--bolt-key-file", default=None)
    p.add_argument("--cluster-cert-file", default=None,
                   help="intra-cluster TLS (replication, Raft, mgmt RPC); "
                        "reference analog memgraph.cpp:302-317")
    p.add_argument("--cluster-key-file", default=None)
    p.add_argument("--cluster-ca-file", default=None)
    p.add_argument("--data-directory", default=None,
                   help="durability directory (snapshots + WAL)")
    p.add_argument("--storage-mode", default="IN_MEMORY_TRANSACTIONAL",
                   choices=[m.value for m in StorageMode])
    p.add_argument("--isolation-level", default="SNAPSHOT_ISOLATION",
                   choices=[l.value for l in IsolationLevel])
    p.add_argument("--storage-wal-enabled",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--storage-wal-file-size-kib", type=int, default=65536,
                   help="WAL segment rotation size (KiB); old segments "
                        "are pruned once a snapshot covers them")
    p.add_argument("--storage-snapshot-on-exit",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--storage-recover-on-startup",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--query-modules-directory", default=None)
    p.add_argument("--auth-user-or-role-name-regex", default=".*")
    p.add_argument("--auth-module-mappings", default="",
                   help="external auth modules per Bolt scheme, e.g. "
                        "'saml:/path/to/module.py;oidc:/path/other.py' "
                        "(reference: src/auth/module.hpp)")
    p.add_argument("--monitoring-port", type=int, default=0,
                   help="websocket monitoring port: live log streaming + "
                        "metrics frames, as the reference's Lab channel "
                        "(communication/websocket/listener.cpp); "
                        "0 = disabled (reference default 7444)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="Prometheus/JSON metrics HTTP port "
                        "(0 = disabled; reference default 9091)")
    p.add_argument("--metrics-address", default=None,
                   help="bind address for the metrics HTTP endpoint")
    p.add_argument("--audit-enabled",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--storage-snapshot-interval-sec", type=int, default=0,
                   help="periodic snapshot interval (0 = disabled)")
    p.add_argument("--storage-gc-cycle-sec", type=int, default=30,
                   help="periodic delta-GC interval (0 = disabled)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--init-file", default=None,
                   help="cypherl file executed on startup")
    p.add_argument("--init-data-file", default=None,
                   help="cypherl data file executed after --init-file "
                        "(reference: --init-data-file)")
    p.add_argument("--bolt-server-name-for-init", default=None,
                   help="server name sent in the Bolt HELLO response")
    p.add_argument("--log-failed-queries",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="log the text of failing queries at WARNING")
    p.add_argument("--debug-query-plans",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="log each prepared query's plan at DEBUG")
    p.add_argument("--monitoring-address", default=None,
                   help="bind address for the monitoring endpoint "
                        "(default: --bolt-address)")
    p.add_argument("--aws-access-key", default=None)
    p.add_argument("--aws-secret-key", default=None)
    p.add_argument("--aws-region", default=None)
    p.add_argument("--aws-endpoint-url", default=None,
                   help="S3-compatible endpoint for s3:// snapshot loads")
    p.add_argument("--storage-delta-on-identical-property-update",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="write a delta even when SET stores an identical "
                        "value (disable to skip no-op writes)")
    p.add_argument("--storage-automatic-label-index-creation-enabled",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--storage-automatic-edge-type-index-creation-enabled",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--storage-parallel-snapshot-creation",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="encode/decode snapshot chunks on a worker pool")
    p.add_argument("--replication-restore-state-on-startup",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="restore MAIN/REPLICA role and registered "
                        "replicas from the durable state")
    p.add_argument("--hops-limit-partial-results",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="USING HOPS LIMIT returns partial results when "
                        "the budget is spent (false: error)")
    p.add_argument("--execution-timeout-sec", type=float, default=600.0)
    # HA coordination (reference: --coordinator-id/--coordinator-port etc.)
    p.add_argument("--coordinator-id", default=None,
                   help="run as a coordinator with this raft node id")
    p.add_argument("--coordinator-port", type=int, default=0,
                   help="raft port for this coordinator")
    p.add_argument("--coordinator-peers", default="",
                   help="comma list of id=host:port raft peers")
    p.add_argument("--management-port", type=int, default=0,
                   help="data-instance management server port (HA)")
    # --- wider reference flag surface ------------------------------------
    p.add_argument("--storage-snapshot-retention-count", type=int,
                   default=3, help="how many snapshots to keep")
    p.add_argument("--storage-snapshot-thread-count", type=int, default=0,
                   help="snapshot encode/decode worker threads "
                        "(0 = cpu count)")
    p.add_argument("--storage-properties-on-edges",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--bolt-num-workers", type=int, default=0,
                   help="bolt worker threads (0 = auto)")
    p.add_argument("--query-execution-timeout-sec", type=float,
                   default=None,
                   help="reference-named alias of --execution-timeout-sec")
    p.add_argument("--log-file", default=None)
    p.add_argument("--telemetry-enabled", action="store_true",
                   help="send anonymous usage telemetry (object counts, "
                        "uptime; never query text or data) — reference: "
                        "--telemetry-enabled, src/telemetry/")
    p.add_argument("--telemetry-endpoint",
                   default="https://telemetry.invalid/v1/beat")
    p.add_argument("--also-log-to-stderr",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--allow-load-csv",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--memory-warning-threshold", type=int, default=1024,
                   help="log a warning when free system memory drops "
                        "below this many MB (0 disables)")
    p.add_argument("--kafka-bootstrap-servers", default="",
                   help="default brokers for CREATE KAFKA STREAM")
    p.add_argument("--pulsar-service-url", default="",
                   help="default service url for CREATE PULSAR STREAM")
    p.add_argument("--auth-password-strength-regex", default=".+",
                   help="regex newly set passwords must match")
    p.add_argument("--auth-password-permit-null",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="allow users without a password")
    # --- more of the reference's flags (src/flags/*.cpp) --------------------
    p.add_argument("--storage-property-store-compression-enabled",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="zlib-compress large property blobs (reference: "
                        "storage/v2/property_store.hpp:38)")
    p.add_argument("--storage-property-store-compression-level",
                   choices=["low", "mid", "high"], default="mid",
                   help="zlib level: low=1 mid=6 high=9")
    p.add_argument("--license-key", default="",
                   help="enterprise license key (utils/license.py)")
    p.add_argument("--organization-name", default="",
                   help="organization the license key was issued for")
    p.add_argument("--data-recovery-on-startup", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="recover snapshot+WAL on startup (newer alias of "
                        "--storage-recover-on-startup; wins when both set)")
    p.add_argument("--log-query-plan",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="log every prepared query's plan at INFO")
    p.add_argument("--log-min-duration-ms", type=int, default=0,
                   help="log queries slower than this (0 = off)")
    p.add_argument("--metrics-format", choices=["JSON", "PROMETHEUS"],
                   default="JSON",
                   help="default metrics HTTP payload format")
    p.add_argument("--schema-info-enabled",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="collect + serve SHOW SCHEMA INFO")
    p.add_argument("--storage-gc-aggressive",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="run GC after every commit, not just the timer")
    p.add_argument("--timezone", default=None,
                   help="IANA timezone for temporal functions "
                        "(sets TZ process-wide)")
    p.add_argument("--strict-flag-check",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="unknown flags abort startup (off: warn + ignore, "
                        "for config files shared across versions)")
    p.add_argument("--storage-enable-schema-metadata",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="alias of --schema-info-enabled (reference name)")
    p.add_argument("--storage-enable-edges-metadata",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="include per-edge-type counts in STORAGE INFO")
    p.add_argument("--storage-parallel-schema-recovery",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="decode snapshot chunks on the worker pool")
    p.add_argument("--storage-allow-recovery-failure",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="start with partial/empty data when durability "
                        "files are damaged instead of refusing to boot")
    p.add_argument("--storage-snapshot-interval", default=None,
                   help="snapshot cadence in seconds (reference also "
                        "accepts cron syntax; numeric-only here, alias "
                        "of --storage-snapshot-interval-sec)")
    p.add_argument("--coordinator-hostname", default=None,
                   help="hostname this coordinator advertises to peers "
                        "and in ROUTE responses")
    p.add_argument("--experimental-enabled", default="",
                   help="comma-separated experimental feature gates "
                        "(recorded in runtime settings; all features in "
                        "this build are stable, so gates are advisory)")
    p.add_argument("--experimental-config", default="",
                   help="JSON config for experimental features")
    p.add_argument("--query-callable-mappings-path", default=None,
                   help="JSON {alias: procedure} mapping file so "
                        "Neo4j-style CALL names resolve locally")
    p.add_argument("--device", default="cuda",
                   help="the device every database runs on: the card by "
                        "default, 'cpu' only when asked for")
    if argv is None:
        import sys as _sys
        argv = _sys.argv[1:]
    known, unknown = p.parse_known_args(argv)
    if unknown:
        if known.strict_flag_check:
            p.error(f"unrecognized arguments: {' '.join(unknown)} "
                    "(use --no-strict-flag-check to ignore)")
        import logging as _logging
        _logging.getLogger(__name__).warning(
            "ignoring unknown flags (--no-strict-flag-check): %s", unknown)
    return known


def refuse_later_flags(args) -> None:
    """Raise the ``NotPortedException`` of the first flag of
    ``LATER_FLAGS`` set to anything but its default (and of
    ``--storage-mode ON_DISK_TRANSACTIONAL``)."""
    defaults = build_config([])
    for name, slice_ in LATER_FLAGS.items():
        if getattr(args, name) != getattr(defaults, name):
            raise NotPortedException(
                "--" + name.replace("_", "-"), slice_)
    if StorageMode(args.storage_mode) is StorageMode.ON_DISK_TRANSACTIONAL:
        raise NotPortedException("--storage-mode ON_DISK_TRANSACTIONAL",
                                 SLICE_HOST_FEATURES)


def build_database(args) -> InterpreterContext:
    refuse_later_flags(args)
    if args.timezone:
        # process-wide, as the reference's --timezone configures the
        # server-side zone used by temporal functions
        os.environ["TZ"] = args.timezone
        import time as _time
        if hasattr(_time, "tzset"):
            _time.tzset()
    if args.storage_property_store_compression_enabled:
        from .storage.property_store import COMPRESSION
        COMPRESSION["enabled"] = True
        COMPRESSION["level"] = {"low": 1, "mid": 6, "high": 9}[
            args.storage_property_store_compression_level]
    storage_config = StorageConfig(
        storage_mode=StorageMode(args.storage_mode),
        isolation_level=IsolationLevel(args.isolation_level),
        properties_on_edges=args.storage_properties_on_edges,
        delta_on_identical_property_update=(
            args.storage_delta_on_identical_property_update),
        automatic_label_index=(
            args.storage_automatic_label_index_creation_enabled),
        automatic_edge_type_index=(
            args.storage_automatic_edge_type_index_creation_enabled),
        gc_aggressive=args.storage_gc_aggressive,
    )
    timeout_sec = (args.query_execution_timeout_sec
                   if args.query_execution_timeout_sec is not None
                   else args.execution_timeout_sec)
    interp_config = {
        "execution_timeout_sec": timeout_sec,
        "allow_load_csv": args.allow_load_csv,
        "kafka_bootstrap_servers": args.kafka_bootstrap_servers,
        "pulsar_service_url": args.pulsar_service_url,
        "auth_password_strength_regex": args.auth_password_strength_regex,
        "auth_password_permit_null": args.auth_password_permit_null,
        "advertised_address": (args.bolt_advertised_address
                               or f"localhost:{args.bolt_port}"),
        "log_failed_queries": args.log_failed_queries,
        "debug_query_plans": args.debug_query_plans,
        "bolt_server_name": args.bolt_server_name_for_init,
        "hops_limit_partial_results": args.hops_limit_partial_results,
        "log_query_plan": args.log_query_plan,
        "log_min_duration_ms": args.log_min_duration_ms,
        "schema_info_enabled": (args.schema_info_enabled
                                and args.storage_enable_schema_metadata),
        "storage_enable_edges_metadata":
            args.storage_enable_edges_metadata,
        "metrics_format": args.metrics_format,
        "experimental_enabled": args.experimental_enabled,
        "experimental_config": args.experimental_config,
        "coordinator_hostname": args.coordinator_hostname,
    }
    # multi-tenancy: every server runs behind a DbmsHandler, on one device
    from .dbms.dbms import DbmsHandler
    dbms = DbmsHandler(storage_config, interp_config, device=args.device)
    ictx = dbms.default()
    storage = ictx.storage

    if args.memory_limit:
        from .utils.memory_tracker import GLOBAL
        GLOBAL.limit = args.memory_limit * 1024 * 1024

    # warm the native CSR builder at startup so the first analytics query
    # doesn't pay the compile
    from .ops.native import get_csr_builder
    get_csr_builder()

    # background maintenance (reference: GC cycle flags)
    import threading

    def _periodic(interval, fn, name):
        def loop():
            import time as _t
            while True:
                _t.sleep(interval)
                try:
                    fn()
                except Exception:
                    logging.exception("%s failed", name)
        t = threading.Thread(target=loop, daemon=True, name=name)
        t.start()

    if args.memory_warning_threshold:
        def _warn_low_memory():
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemAvailable:"):
                            avail_mb = int(line.split()[1]) // 1024
                            if avail_mb < args.memory_warning_threshold:
                                logging.warning(
                                    "available system memory low: %d MB "
                                    "(threshold %d MB)", avail_mb,
                                    args.memory_warning_threshold)
                            break
            except OSError:
                pass
        _periodic(60, _warn_low_memory, "memory watcher")
    if args.storage_gc_cycle_sec:
        _periodic(args.storage_gc_cycle_sec, storage.collect_garbage,
                  "periodic-gc")

    if args.license_key or args.organization_name:
        from .utils.license import LICENSE_SETTING, ORGANIZATION_SETTING
        from .query.interpreter import ensure_settings
        settings = ensure_settings(ictx)
        if args.license_key:
            settings.set(LICENSE_SETTING, args.license_key)
        if args.organization_name:
            settings.set(ORGANIZATION_SETTING, args.organization_name)
        logging.info("license configured from flags")

    if args.query_callable_mappings_path:
        from .query.procedures.registry import global_registry as _greg
        try:
            n_aliases = _greg.load_callable_mappings(
                args.query_callable_mappings_path)
            logging.info("loaded %d callable mappings", n_aliases)
        except (OSError, ValueError) as e:
            logging.error("callable mappings failed to load: %s", e)

    if args.query_modules_directory:
        from .query.procedures.registry import global_registry
        loaded = global_registry.load_directory(args.query_modules_directory)
        logging.info("loaded query modules: %s", loaded)

    # auth store wired BEFORE the init file runs (single source of truth):
    # in memory until durability is ported, with the SSO modules
    from .auth.module import parse_module_mappings
    ictx.auth_store = Auth(
        module_mappings=parse_module_mappings(args.auth_module_mappings))

    for path in (args.init_file, args.init_data_file):
        if path:
            interp = Interpreter(ictx, system=True)
            with open(path) as f:
                for statement in split_statements(f.read()):
                    interp.execute(statement)
    return ictx


def split_statements(text: str) -> list[str]:
    """Split a cypherl stream on top-level ';' (string/comment-aware)."""
    from .query.frontend.lexer import tokenize
    out = []
    start = 0
    for tok in tokenize(text):
        if tok.type == ";":
            stmt = text[start:tok.pos].strip()
            if stmt:
                out.append(stmt)
            start = tok.pos + 1
    tail = text[start:].strip()
    if tail:
        out.append(tail)
    return out


async def serve(args, ictx) -> None:
    auth = getattr(ictx, "auth_store", None)
    if auth is None:
        auth = Auth(None)
        ictx.auth_store = auth

    ssl_ctx = None
    if args.bolt_cert_file and args.bolt_key_file:
        from .utils.tls import server_context
        ssl_ctx = server_context(args.bolt_cert_file, args.bolt_key_file)
    server = BoltServer(ictx, args.bolt_address, args.bolt_port, auth,
                        ssl_context=ssl_ctx,
                        workers=args.bolt_num_workers or None)
    await server.start()
    logging.info("Bolt server listening on %s:%d%s (device %s)",
                 args.bolt_address, args.bolt_port,
                 " (TLS)" if ssl_ctx else "", ictx.device)

    stop = asyncio.Event()

    def shutdown(*_):
        stop.set()

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, shutdown)
    await stop.wait()

    logging.info("shutting down ...")
    server.stop()


def main(argv=None) -> int:
    args = build_config(argv)
    handlers = None
    if args.log_file:
        handlers = [logging.FileHandler(args.log_file)]
        if args.also_log_to_stderr:
            handlers.append(logging.StreamHandler())
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers)
    try:
        refuse_later_flags(args)
    except NotPortedException as e:
        logging.error("%s", e)
        return 1
    if bool(args.bolt_cert_file) != bool(args.bolt_key_file):
        logging.error("--bolt-cert-file and --bolt-key-file must be "
                      "given together")
        return 1
    from .device import resolve_device
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        logging.error("--device %s: %s", args.device, e)
        return 2
    ictx = build_database(args)
    try:
        asyncio.run(serve(args, ictx))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
