"""Query interpreter: Prepare/Pull lifecycle over the storage engine.

Counterpart of the reference's Interpreter
(memgraph/src/query/interpreter.cpp — Prepare at :9802, PullPlan
streaming at :3240): parses (with an AST/plan cache keyed by query text),
dispatches across query classes (Cypher, DDL, transactions, admin), plans,
and streams results batch-by-batch so Bolt's PULL n maps directly onto
`Interpreter.pull`.

Port of memgraph_tpu/query/interpreter.py.  What differs:

- ``InterpreterContext(storage, config=None, *, device=None)`` resolves
  its device through ``device.resolve_device``: the card unless the
  caller passes ``device="cpu"``; without a card and without that request
  it raises.  Procedures (their snapshots) and the compiled read lane run
  on that device.
- The families whose modules a later slice of the port brings raise
  ``NotPortedException`` naming that slice: snapshots and recovery
  (durability); replication and coordinators (replication); streams,
  triggers, TTL, ``DUMP DATABASE``, the enum DDL and
  ``ON_DISK_TRANSACTIONAL`` (the host features' slice).
- Auth, user and tenant profiles, multi-database and the license run on
  the port's ``auth/``, ``dbms/`` and ``utils/license.py``.  Their
  mutations publish no system transaction: that comes with replication,
  and no port context has a replication state.  The auth store is the
  session's root context's, also after ``USE DATABASE``: the reference
  resolves the tenant's, which has none of its own, so its tenants fall
  back to the empty process-wide store and run open.
- Settings (``SET DATABASE SETTING``) live in memory: the kvstore that
  makes them durable comes with durability.
"""

from __future__ import annotations

import sys
import threading
import time

# a query plan is a linked chain of operators (one per clause element) and
# execution is a chain of generators — both need Python stack depth
# proportional to query size. 1000-clause CREATE queries (TCK
# LargeCreateQuery) blow the 1000-frame default. Raised when an
# Interpreter is constructed (not at import: embedders using only the
# parser/client keep their own limit). Frames are heap-allocated on
# CPython 3.11+, so this does not risk native stack exhaustion.
_MIN_RECURSION_LIMIT = 20_000


def _ensure_recursion_limit() -> None:
    if sys.getrecursionlimit() < _MIN_RECURSION_LIMIT:
        sys.setrecursionlimit(_MIN_RECURSION_LIMIT)
from dataclasses import dataclass, field
from typing import Iterator, Optional

from ..device import resolve_device
from ..exceptions import (SLICE_DURABILITY as _DURABILITY,
                          SLICE_HOST_FEATURES as _HOST_FEATURES,
                          SLICE_REPLICATION as _REPLICATION,
                          HintedAbortError, NotPortedException,
                          QueryException, SemanticException,
                          TransactionException)
from ..observability import trace as mgtrace
from ..storage.common import IsolationLevel, StorageMode, View
from ..storage.ordering import order_key
from ..storage.storage import InMemoryStorage
from .frontend import ast as A
from .frontend.parser import parse_with_source
from .plan.operators import ExecutionContext, LogicalOperator, Produce
from .plan.planner import Planner
from .plan.profile import attach_profiling, profile_rows
from .plan.pretty_print import plan_to_rows




class _SessionTrace:
    """Per-session event timeline (reference: SESSION TRACE ON,
    interpreter.cpp:8530 EmitSessionTraceEvent); a copy of
    memgraph_tpu/observability/audit.py's ``SessionTrace``."""

    def __init__(self) -> None:
        self.enabled = False
        self.events: list[dict] = []

    def emit(self, event: str, **data) -> None:
        if self.enabled:
            self.events.append({"ts": time.time(), "event": event, **data})

    def drain(self) -> list[dict]:
        out = self.events
        self.events = []
        return out


class _Settings:
    """Runtime settings (reference: utils/settings.hpp), in memory: a copy
    of memgraph_tpu/storage/kvstore.py's ``Settings`` without its kvstore,
    which comes with durability."""

    def __init__(self) -> None:
        self._cache: dict[str, str] = {}
        self._observers: dict[str, list] = {}

    def set(self, name: str, value: str) -> None:
        self._cache[name] = value
        for fn in self._observers.get(name, []):
            fn(value)

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._cache.get(name, default)

    def all(self) -> dict[str, str]:
        return dict(self._cache)

    def observe(self, name: str, fn) -> None:
        self._observers.setdefault(name, []).append(fn)


def ensure_settings(ictx) -> _Settings:
    """The one place that lazily attaches the runtime settings to an
    interpreter context (shared by SET DATABASE SETTING and main's
    license flags)."""
    settings = getattr(ictx, "settings", None)
    if settings is None:
        settings = ictx.settings = _Settings()
    return settings


class InterpreterContext:
    """Shared, process-wide interpreter state (reference:
    InterpreterContext, interpreter.hpp).  ``device`` is where procedures
    and the compiled read lane run: the card unless ``device="cpu"``."""

    def __init__(self, storage: InMemoryStorage, config: Optional[dict] = None,
                 *, device=None):
        from ..utils.locks import tracked_lock
        from ..utils.sanitize import shared_field
        self.storage = storage
        self.config = config or {}
        self.device = resolve_device(device)
        self._plan_cache_lock = tracked_lock(
            "InterpreterContext._plan_cache_lock")
        self._plan_cache: dict[str, tuple] = {}
        self._ast_cache: dict[str, object] = {}
        self.running_queries: dict[int, dict] = {}
        # SHOW/TERMINATE TRANSACTIONS iterate this dict from other
        # sessions' threads while queries register/unregister — the old
        # unguarded list(items()) could see a mid-resize dict
        self._rq_lock = tracked_lock("InterpreterContext._rq_lock")
        self._next_query_id = 0
        self._query_id_lock = threading.Lock()
        shared_field(self, "_plan_cache", "_ast_cache",
                     "running_queries")
        self.triggers = None       # wired by trigger store
        self.auth = None           # wired by auth subsystem
        self.metrics = None

    def next_query_id(self) -> int:
        with self._query_id_lock:
            self._next_query_id += 1
            return self._next_query_id

    def cached_parse(self, text: str):
        from ..utils.sanitize import shared_read, shared_write
        key = text.strip()
        with self._plan_cache_lock:
            shared_read(self, "_ast_cache")
            hit = self._ast_cache.get(key)
        if hit is not None:
            return hit
        node = parse_with_source(text)
        # only cache cacheable query classes (parameters keep text stable).
        # Parse happens OUTSIDE the lock: duplicated work on a cache miss
        # is benign, serializing parsing is not.
        with self._plan_cache_lock:
            shared_write(self, "_ast_cache")
            if len(self._ast_cache) < 1024:
                self._ast_cache[key] = node
        return node

    def cached_plan(self, text: str, query: A.CypherQuery):
        """Returns (plan, columns, cache_hit) — the hit flag feeds the
        per-fingerprint plan-cache hit-rate in SHOW QUERY STATS."""
        from ..utils.sanitize import shared_read, shared_write
        key = text.strip()
        with self._plan_cache_lock:
            shared_read(self, "_plan_cache")
            hit = self._plan_cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True
        planner = Planner(self.storage, self.config)
        import copy
        plan, columns = planner.plan_query(copy.deepcopy(query))
        with self._plan_cache_lock:
            shared_write(self, "_plan_cache")
            if len(self._plan_cache) < 256:
                self._plan_cache[key] = (plan, columns)
        return plan, columns, False

    def invalidate_plans(self) -> None:
        with self._plan_cache_lock:
            self._plan_cache.clear()
        # schema changes invalidate compiled lanes too: a lane program
        # compiled under dropped DDL / stale statistics must never
        # serve again (query/plan/lane.py; regression: tests/test_lane)
        from .plan.lane import invalidate_lanes
        invalidate_lanes()


@dataclass
class PreparedQuery:
    columns: list[str]
    qid: int
    summary_type: str = "r"   # 'r' read, 'w' write, 'rw', 's' schema
    # Cypher-only precise classification (plan-derived): True when the
    # plan contains any updating operator. Read-only dispatchers (the
    # multiprocess read executor) key on this instead of summary_type,
    # which stays 'rw' for every Cypher query for Bolt compatibility.
    is_write: bool = False


class Interpreter:
    """One per client session (reference: one per Bolt session)."""

    def __init__(self, context: InterpreterContext,
                 system: bool = False) -> None:
        _ensure_recursion_limit()
        # system interpreters (triggers, streams, init-file, replication
        # internals) bypass RBAC — they act on behalf of the server
        self.system = system
        self.ctx = context
        # instance-level anchor: USE DATABASE rebinds self.ctx, but the
        # active-session registry is instance-wide (reference:
        # GetActiveUsersInfo), so it always reads/writes through this
        self.root_ctx = context
        self.session_isolation: Optional[IsolationLevel] = None
        self.next_isolation: Optional[IsolationLevel] = None
        self._explicit_accessor = None
        self._in_explicit_txn = False
        self._stream: Optional[Iterator] = None
        self._stream_accessor = None
        self._stream_owns_txn = False
        self._prepared: Optional[PreparedQuery] = None
        self._exec_ctx: Optional[ExecutionContext] = None
        self._profile_plan = None
        self._profile_start = None
        self._abort_flag = threading.Event()
        self._current_query_info = None
        self.session_trace = _SessionTrace()
        self.username = ""
        # mgtrace: the query-root trace handle (None unless tracing is
        # armed) + per-phase durations for the slow-query log
        self._trace_root = None
        self._phase_s: dict[str, float] = {}
        self._prepare_finished: tuple[float, float] | None = None
        # mgstat: per-query fingerprint accounting state
        self._query_fingerprint: str | None = None
        self._plan_cache_hit = False
        self._rows_emitted = 0

    # --- public API ---------------------------------------------------------

    def prepare(self, text: str, parameters: Optional[dict] = None
                ) -> PreparedQuery:
        handle = None
        if mgtrace.armed():
            if self._trace_root is not None:
                # the client abandoned the previous prepare (never
                # pulled): close its trace out instead of leaking it
                self._trace_root.finish(status="abandoned")
            # inherits the ambient context (the Bolt session span) as
            # parent when one is active on this thread
            self._trace_root = handle = mgtrace.begin_trace("query")
        try:
            with mgtrace.activate(handle.ctx if handle else None):
                prepared = self._prepare_inner(text, parameters)
            self._prepare_finished = (time.time(), time.monotonic())
            return prepared
        except Exception as e:
            if handle is not None:
                handle.finish(status="error",
                              error=f"{type(e).__name__}: {e}")
                self._trace_root = None
            if self.ctx.config.get("log_failed_queries"):
                import logging
                logging.getLogger(__name__).warning(
                    "query failed: %s", text.strip())
            raise

    def _prepare_inner(self, text: str, parameters: Optional[dict] = None
                       ) -> PreparedQuery:
        parameters = parameters or {}
        audit = getattr(self.ctx, "audit", None)
        if audit is not None:
            audit.record(getattr(self, "username", ""), text, parameters)
        from ..utils.metrics import global_metrics
        global_metrics.increment("query.prepared")
        self._query_started = time.monotonic()
        self._query_text = text
        self._pending_op_counts = None   # drop any abandoned prepare's
        self._query_priv_auth = False    # AUTH queries skip the slow log
        self._phase_s = {}
        self._prepare_finished = None
        self.session_trace.emit("prepare", query=text)
        t0 = time.perf_counter()
        with mgtrace.span("query.parse"):
            node = self.ctx.cached_parse(text)
        self._phase_s["parse"] = time.perf_counter() - t0
        if isinstance(node, A.SessionTraceQuery):
            if node.enabled:
                self.session_trace.enabled = True
                self.session_trace.events = []
                return self._prepare_generator(
                    iter([["session trace enabled"]]), ["status"], "s")
            self.session_trace.enabled = False
            rows = [[e.pop("ts"), e.pop("event"), str(e)]
                    for e in self.session_trace.drain()]
            return self._prepare_generator(
                iter(rows), ["timestamp", "event", "data"], "r")

        priv = self._NODE_PRIVILEGES.get(type(node).__name__)
        # AUTH statements carry plaintext credentials (CREATE USER ...
        # IDENTIFIED BY, SET PASSWORD): never echo them into the slow-query
        # log / monitoring-websocket broadcast
        self._query_priv_auth = priv == "AUTH"
        if priv is not None:
            self._check_privilege(priv)

        if isinstance(node, A.TransactionQuery):
            return self._prepare_transaction(node)
        if isinstance(node, A.CypherQuery):
            return self._prepare_cypher(text, node, parameters)
        if isinstance(node, (A.IndexQuery, A.ConstraintQuery,
                             A.TriggerQuery, A.StorageModeQuery,
                             A.AuthQuery)) and not (
                isinstance(node, A.TriggerQuery) and node.action == "show"):
            self._ensure_writable(type(node).__name__)
        if isinstance(node, A.IndexQuery):
            return self._prepare_generator(self._run_index_query(node),
                                           ["status"], "s")
        if isinstance(node, A.ConstraintQuery):
            return self._prepare_generator(self._run_constraint_query(node),
                                           ["status"], "s")
        if isinstance(node, A.InfoQuery):
            return self._prepare_info(node)
        if isinstance(node, A.ShowTransactionsQuery):
            rows = self._show_transactions()
            return self._prepare_generator(
                iter(rows), ["transaction_id", "query", "username"], "r")
        if isinstance(node, A.TerminateTransactionsQuery):
            return self._prepare_terminate(node, parameters)
        if isinstance(node, A.SnapshotQuery):
            return self._prepare_snapshot(node)
        if isinstance(node, A.DumpQuery):
            raise NotPortedException("DUMP DATABASE", _HOST_FEATURES)
        if isinstance(node, A.AnalyzeGraphQuery):
            return self._prepare_analyze_graph(node)
        if isinstance(node, A.IsolationLevelQuery):
            return self._prepare_isolation(node)
        if isinstance(node, A.StorageModeQuery):
            return self._prepare_storage_mode(node)
        if isinstance(node, A.TriggerQuery):
            return self._prepare_trigger(node)
        if isinstance(node, A.AuthQuery):
            return self._prepare_auth(node, parameters)
        if isinstance(node, A.ReplicationQuery):
            return self._prepare_replication(node)
        if isinstance(node, A.StreamQuery):
            return self._prepare_stream(node)
        if isinstance(node, A.CoordinatorQuery):
            return self._prepare_coordinator(node)
        if isinstance(node, A.MultiDatabaseQuery):
            return self._prepare_multidb(node)
        if isinstance(node, A.TenantProfileQuery):
            return self._prepare_tenant_profile(node)
        if isinstance(node, A.UserProfileQuery):
            return self._prepare_user_profile(node)
        if isinstance(node, A.SettingQuery):
            return self._prepare_setting(node)
        if isinstance(node, A.EnumQuery):
            return self._prepare_enum(node)
        if isinstance(node, A.TtlQuery):
            return self._prepare_ttl(node)
        raise SemanticException(
            f"unsupported query type {type(node).__name__}")

    def _prepare_stream(self, node: A.StreamQuery) -> PreparedQuery:
        raise NotPortedException("streams", _HOST_FEATURES)

    def _settings(self):
        return ensure_settings(self.ctx)

    def _prepare_enum(self, node: A.EnumQuery) -> PreparedQuery:
        raise NotPortedException("enum DDL", _HOST_FEATURES)

    def _prepare_analyze_graph(self, node) -> PreparedQuery:
        """ANALYZE GRAPH [ON LABELS ...] [DELETE STATISTICS].

        Computes the same per-index statistics the reference stores for its
        cost model (interpreter.cpp HandleAnalyzeGraphQuery: num estimation
        nodes, num groups, avg group size, chi-squared, avg degree; degrees
        count both directions, and composite indexes get a row per property
        prefix). The planner here reads live approx_count() from the
        indexes, so the rows are a reporting surface; stats live in
        indices.analyze_stats (dropped with their index) and are cleared by
        DELETE STATISTICS."""
        if self._in_explicit_txn:
            raise TransactionException(
                "ANALYZE GRAPH cannot run inside a transaction")
        storage = self.ctx.storage
        indices = storage.indices
        label_filter = None
        if node.labels:
            label_filter = {storage.label_mapper.maybe_name_to_id(name)
                            for name in node.labels}
            label_filter.discard(None)

        def wanted(lid):
            return label_filter is None or lid in label_filter

        if node.action == "delete":
            rows = []
            for (lid, pids) in sorted(indices.analyze_stats):
                if not wanted(lid):
                    continue
                rows.append([
                    storage.label_mapper.id_to_name(lid),
                    [storage.property_mapper.id_to_name(p) for p in pids]
                    if pids else None,
                ])
            indices.analyze_stats = {
                k: v for k, v in indices.analyze_stats.items()
                if not wanted(k[0])}
            # cached plans were chosen under the dropped statistics
            self.ctx.invalidate_plans()
            return self._prepare_generator(
                iter(rows), ["label", "property"], "r")

        acc = storage.access()
        try:
            stats = {}
            rows = []
            for lid in sorted(indices.label.labels()):
                if not wanted(lid):
                    continue
                count = 0
                degree_sum = 0
                for va in acc.vertices_by_label(lid, View.OLD):
                    count += 1
                    degree_sum += (va.out_degree(View.OLD)
                                   + va.in_degree(View.OLD))
                avg_degree = degree_sum / count if count else 0.0
                stats[(lid, ())] = {"count": count,
                                    "avg_degree": avg_degree}
                rows.append([storage.label_mapper.id_to_name(lid), None,
                             count, None, None, None, avg_degree])
            # one scan per indexed label covers the full key and every
            # property prefix (the reference emits a row per prefix so
            # prefix lookups on composite indexes get costed)
            for (lid, pids) in sorted(indices.label_property.keys()):
                if not wanted(lid):
                    continue
                prefixes = [pids[:k] for k in range(1, len(pids) + 1)]
                acc_stats = {pref: {"groups": {}, "count": 0, "deg": 0}
                             for pref in prefixes}
                for va in acc.vertices_by_label(lid, View.OLD):
                    values = tuple(va.get_property(p, View.OLD)
                                   for p in pids)
                    degree = (va.out_degree(View.OLD)
                              + va.in_degree(View.OLD))
                    for pref in prefixes:
                        pvals = values[:len(pref)]
                        if all(v is None for v in pvals):
                            continue
                        st = acc_stats[pref]
                        st["count"] += 1
                        st["deg"] += degree
                        key = order_key(list(pvals))
                        st["groups"][key] = st["groups"].get(key, 0) + 1
                for pref in prefixes:
                    st = acc_stats[pref]
                    count, n_groups = st["count"], len(st["groups"])
                    avg_group = count / n_groups if n_groups else 0.0
                    chi2 = sum((c - avg_group) ** 2 / avg_group
                               for c in st["groups"].values()) \
                        if avg_group else 0.0
                    avg_degree = st["deg"] / count if count else 0.0
                    stats[(lid, pref)] = {
                        "count": count, "num_groups": n_groups,
                        "avg_group_size": avg_group, "chi_squared": chi2,
                        "avg_degree": avg_degree}
                    rows.append([
                        storage.label_mapper.id_to_name(lid),
                        [storage.property_mapper.id_to_name(p)
                         for p in pref],
                        count, n_groups, avg_group, chi2, avg_degree])
        finally:
            acc.abort()
        indices.analyze_stats.update(stats)
        # fresh statistics change index selection: cached plans must
        # re-plan (reference re-plans through its stats-keyed cache)
        self.ctx.invalidate_plans()
        return self._prepare_generator(
            iter(rows),
            ["label", "property", "num estimation nodes", "num groups",
             "avg group size", "chi-squared value", "avg degree"], "r")

    def _prepare_setting(self, node: A.SettingQuery) -> PreparedQuery:
        settings = self._settings()
        if node.action == "set":
            self._ensure_writable("SET DATABASE SETTING")
            settings.set(node.name, node.value)
            return self._prepare_generator(iter([]), [], "s")
        if node.action == "show_one":
            value = settings.get(node.name)
            rows = [[node.name, value]] if value is not None else []
            return self._prepare_generator(iter(rows),
                                           ["setting_name", "setting_value"],
                                           "r")
        rows = sorted([k, v] for k, v in settings.all().items())
        return self._prepare_generator(iter(rows),
                                       ["setting_name", "setting_value"],
                                       "r")

    def _prepare_user_profile(self, node) -> PreparedQuery:
        """Per-user profiles (reference: auth/profiles/user_profiles.cpp,
        grammar MemgraphCypher.g4:974-991)."""
        from ..auth.profiles import ensure_user_profiles
        profiles = ensure_user_profiles(self.ctx)
        if node.action == "create":
            profiles.create(node.name, node.limits or {})
        elif node.action == "update":
            profiles.update(node.name, node.limits or {})
        elif node.action == "drop":
            profiles.drop(node.name)
        elif node.action == "assign":
            profiles.assign(node.user, node.name)
        elif node.action == "clear":
            profiles.clear(node.user)
        elif node.action == "users_for":
            rows = [[u] for u in profiles.users_for(node.name)]
            return self._prepare_generator(iter(rows), ["username"], "r")
        elif node.action == "show_for":
            pname = profiles.profile_for(node.user)
            rows = ([[pname, limits] for _n, limits
                     in profiles.show(pname)] if pname else [])
            return self._prepare_generator(iter(rows),
                                           ["profile", "limits"], "r")
        elif node.action == "show":
            rows = [[n, limits] for n, limits in profiles.show(node.name)]
            return self._prepare_generator(iter(rows),
                                           ["profile", "limits"], "r")
        else:
            raise SemanticException(
                f"unknown profile action {node.action}")
        return self._prepare_generator(iter([]), [], "w")

    def _prepare_tenant_profile(self, node) -> PreparedQuery:
        """Tenant profiles (reference: dbms/tenant_profiles.cpp)."""
        dbms = getattr(self.ctx, "dbms", None)
        if dbms is None:
            raise QueryException(
                "tenant profiles require a DbmsHandler (enabled "
                "automatically by the server entry point)")
        profiles = dbms.tenant_profiles
        if node.action == "create":
            profiles.create(node.name, node.limits or {})
        elif node.action == "alter":
            profiles.alter(node.name, node.limits or {})
        elif node.action == "drop":
            profiles.drop(node.name)
        elif node.action == "assign":
            if node.database not in dbms.names():
                raise QueryException(
                    f"database {node.database!r} does not exist")
            profiles.assign(node.database, node.name)
        elif node.action == "clear":
            profiles.clear(node.database)
        elif node.action == "show":
            import json as _json
            rows = [[name, _json.dumps(limits), dbs]
                    for name, limits, dbs in profiles.show(node.name)]
            return self._prepare_generator(
                iter(rows), ["profile", "limits", "databases"], "r")
        else:
            raise SemanticException(
                f"unknown tenant profile action {node.action}")
        return self._prepare_generator(iter([]), [], "s")

    def _prepare_multidb(self, node: A.MultiDatabaseQuery) -> PreparedQuery:
        dbms = getattr(self.ctx, "dbms", None)
        if dbms is None:
            raise QueryException(
                "multi-database support requires a DbmsHandler (enabled "
                "automatically by the server entry point)")
        if node.action == "create":
            dbms.create(node.name)
            return self._prepare_generator(
                iter([[f"Database {node.name} created."]]), ["status"], "s")
        if node.action == "drop":
            dbms.drop(node.name)
            return self._prepare_generator(
                iter([[f"Database {node.name} dropped."]]), ["status"], "s")
        if node.action == "use":
            if self._in_explicit_txn:
                raise TransactionException(
                    "cannot switch databases inside a transaction")
            target = dbms.get(node.name)
            # the session keeps this Interpreter object; rebind it
            self.ctx = target
            return self._prepare_generator(
                iter([[f"Using database {node.name}."]]), ["status"], "s")
        if node.action == "suspend":
            dbms.suspend(node.name)
            return self._prepare_generator(
                iter([[f"Database {node.name} suspended."]]),
                ["status"], "s")
        if node.action == "resume":
            dbms.resume(node.name)
            return self._prepare_generator(
                iter([[f"Database {node.name} resumed."]]),
                ["status"], "s")
        if node.action == "show":
            current = getattr(self.ctx, "database_name", "memgraph")
            rows = [[name, name == current] for name in dbms.names()]
            return self._prepare_generator(iter(rows),
                                           ["Name", "Current"], "r")
        raise SemanticException(f"unknown database action {node.action}")

    def _prepare_coordinator(self, node: A.CoordinatorQuery) -> PreparedQuery:
        raise NotPortedException("coordinators", _REPLICATION)

    def _prepare_ttl(self, node: A.TtlQuery) -> PreparedQuery:
        raise NotPortedException("TTL", _HOST_FEATURES)

    def _fine_grained_view(self):
        """Storage-level fine-grained filter for this session's user, or
        None when unrestricted (reference: glue/auth_checker.cpp building a
        FineGrainedAuthChecker per execution)."""
        auth = self._auth_store()
        if not auth.users():
            return None
        checker = auth.fine_grained_checker(self.username or "")
        if not checker.restricted:
            return None
        from ..auth.fine_grained import FgStorageView
        return FgStorageView(checker, self.ctx.storage)

    def _auth_store(self):
        """The session's auth store: its root context's, also after USE
        DATABASE.  (The reference resolves the current database's
        context, whose tenants carry no store of their own, so a tenant
        falls back to the empty process-wide store and runs open.)"""
        from ..auth.auth import resolve_auth
        return resolve_auth(self.root_ctx)

    @staticmethod
    def _password_value(expr, parameters):
        """Password expression -> value: literal or $parameter only — a
        silently-ignored expression would null the password and open the
        account."""
        if expr is None:
            return None
        if isinstance(expr, A.Literal):
            return expr.value
        if isinstance(expr, A.Parameter):
            params = parameters or {}
            if expr.name not in params:
                raise QueryException(
                    f"password parameter ${expr.name} not provided")
            return params[expr.name]
        raise QueryException(
            "passwords must be a string literal or a $parameter")

    def _check_password_policy(self, password) -> None:
        """--auth-password-strength-regex / --auth-password-permit-null
        (reference: flags/general.cpp password policy)."""
        import re as _re
        cfg = getattr(self.ctx, "config", {}) or {}
        if password is None:
            if not cfg.get("auth_password_permit_null", True):
                raise QueryException(
                    "null passwords are forbidden "
                    "(--no-auth-password-permit-null)")
            return
        pattern = cfg.get("auth_password_strength_regex", ".+")
        if not _re.fullmatch(pattern, str(password)):
            raise QueryException(
                "the new password does not satisfy the password "
                "strength policy (--auth-password-strength-regex)")

    def _check_privilege(self, privilege: str) -> None:
        """Enforce RBAC when users are defined (reference: AuthChecker,
        glue/auth_checker.cpp). Sessions without users run open."""
        if self.system:
            return
        auth = self._auth_store()
        if not auth.users():
            return
        from ..exceptions import AuthException
        if not auth.has_privilege(self.username or "", privilege):
            raise AuthException(
                f"user {self.username or '<anonymous>'!r} is not allowed "
                f"to execute this query (missing privilege {privilege})")

    _NODE_PRIVILEGES = {
        "IndexQuery": "INDEX", "ConstraintQuery": "CONSTRAINT",
        "TriggerQuery": "TRIGGER", "StorageModeQuery": "STORAGE_MODE",
        "AuthQuery": "AUTH", "ReplicationQuery": "REPLICATION",
        "StreamQuery": "STREAM", "SnapshotQuery": "DURABILITY",
        "DumpQuery": "DUMP", "MultiDatabaseQuery": "MULTI_DATABASE_EDIT",
        "TenantProfileQuery": "MULTI_DATABASE_EDIT",
        "UserProfileQuery": "AUTH",
        "TtlQuery": "CONFIG", "SettingQuery": "CONFIG",
        "CoordinatorQuery": "COORDINATOR",
        "TerminateTransactionsQuery": "TRANSACTION_MANAGEMENT",
        "ShowTransactionsQuery": "TRANSACTION_MANAGEMENT",
        "AnalyzeGraphQuery": "STATS",
    }

    def _ensure_writable(self, what: str) -> None:
        replication = getattr(self.ctx, "replication", None)
        if replication is not None and replication.role == "replica":
            raise QueryException(
                f"{what} is forbidden on a REPLICA instance")
        if replication is not None and replication.role == "main" \
                and replication.is_fenced():
            # deposed MAIN (a newer fencing epoch exists): refuse loudly
            # at query admission, before the commit path even starts
            from ..exceptions import FencedException
            raise FencedException(
                f"{what} is forbidden: this MAIN was deposed (fenced); "
                "reconnect via the coordinator routing table")

    def _prepare_replication(self, node: A.ReplicationQuery) -> PreparedQuery:
        raise NotPortedException("replication", _REPLICATION)

    def pull(self, n: int = -1) -> tuple[list[list], bool, dict]:
        """Pull up to n rows (n<0 = all). Returns (rows, has_more, summary)."""
        if self._stream is None:
            raise QueryException("no query prepared")
        # re-activate the query root on THIS thread (Bolt pulls may run
        # on a different worker thread than the prepare): device/kernel
        # spans opened during execution join the query's trace
        root = self._trace_root
        with mgtrace.activate(root.ctx if root is not None else None):
            return self._pull_inner(n)

    def _pull_inner(self, n: int) -> tuple[list[list], bool, dict]:
        rows: list[list] = []
        has_more = False
        try:
            while n < 0 or len(rows) < n:
                try:
                    rows.append(next(self._stream))
                except StopIteration:
                    break
            else:
                # check if exhausted
                try:
                    rows.append(next(self._stream))
                    has_more = True
                except StopIteration:
                    has_more = False
            if has_more and n >= 0 and len(rows) > n:
                # put back overflow row
                overflow = rows.pop()
                self._stream = _chain_front(overflow, self._stream)
        except Exception:
            self._cleanup_stream(error=True)
            raise
        summary = {}
        if not has_more:
            summary = self._finish_stream()
        return rows, has_more, summary

    def abort(self) -> None:
        """Kill the current query/transaction (TERMINATE/reset)."""
        self._abort_flag.set()
        self._cleanup_stream(error=True)
        if self._explicit_accessor is not None:
            self._explicit_accessor.abort()
            self._explicit_accessor = None
            self._in_explicit_txn = False

    # --- transactions -------------------------------------------------------

    def stage_stream_offset(self, name: str, position) -> None:
        """Stage a stream source position into the OPEN explicit
        transaction: the offset becomes a WAL record in the same commit
        frame as the batch's data (the exactly-once boundary the stream
        consumer relies on)."""
        if not self._in_explicit_txn or self._explicit_accessor is None:
            raise TransactionException(
                "stream offsets can only be staged inside an explicit "
                "transaction")
        self._explicit_accessor.stage_stream_offset(name, position)

    def _prepare_transaction(self, node: A.TransactionQuery) -> PreparedQuery:
        if node.action == "begin":
            if self._in_explicit_txn:
                raise TransactionException(
                    "nested transactions are not supported")
            self._explicit_accessor = self._fg_access(
                self._pick_isolation())
            self._in_explicit_txn = True
            return self._prepare_generator(iter([]), [], "w")
        if node.action == "commit":
            if not self._in_explicit_txn:
                raise TransactionException("no transaction to commit")
            try:
                self._explicit_accessor.commit()
            finally:
                self._explicit_accessor = None
                self._in_explicit_txn = False
            return self._prepare_generator(iter([]), [], "w")
        if node.action == "rollback":
            if not self._in_explicit_txn:
                raise TransactionException("no transaction to rollback")
            self._explicit_accessor.abort()
            self._explicit_accessor = None
            self._in_explicit_txn = False
            return self._prepare_generator(iter([]), [], "w")
        raise SemanticException(f"unknown transaction action {node.action}")

    def _fg_access(self, isolation=None):
        acc = self.ctx.storage.access(isolation)
        acc.fine_grained = self._fine_grained_view()
        return acc

    def _pick_isolation(self) -> IsolationLevel:
        if self.next_isolation is not None:
            level = self.next_isolation
            self.next_isolation = None
            return level
        if self.session_isolation is not None:
            return self.session_isolation
        return self.ctx.storage.config.isolation_level

    # --- cypher -------------------------------------------------------------

    def _prepare_cypher(self, text: str, query: A.CypherQuery,
                        parameters: dict) -> PreparedQuery:
        strip = text.strip()
        if query.explain or query.profile:
            # strip the EXPLAIN/PROFILE keyword for plan-cache keying
            strip = strip.split(None, 1)[1] if " " in strip else strip
        t0 = time.perf_counter()
        with mgtrace.span("query.plan"):
            plan, columns, cache_hit = self.ctx.cached_plan(strip, query)
        self._phase_s["plan"] = time.perf_counter() - t0
        # mgstat: the fingerprint is keyed off the same stripped text as
        # the plan cache, so repeat queries pay one memo-dict lookup
        from ..observability.stats import global_query_stats
        if global_query_stats.enabled():
            self._query_fingerprint = global_query_stats.fingerprint(strip)
        else:
            self._query_fingerprint = None
        if getattr(plan, "_has_lane", False):
            # compiled read lane: the mgstat fingerprint is the lane's
            # compile-cache key and stats bucket (query/plan/lane.py)
            from .plan.lane import bind_fingerprints
            from ..observability.stats import fingerprint_text
            bind_fingerprints(plan, self._query_fingerprint
                              or fingerprint_text(strip))
        self._plan_cache_hit = cache_hit
        self._rows_emitted = 0

        if self.ctx.config.get("debug_query_plans"):
            import logging
            logging.getLogger(__name__).debug(
                "plan for %s:\n%s", strip, "\n".join(plan_to_rows(plan)))
        if self.ctx.config.get("log_query_plan"):
            import logging
            logging.getLogger(__name__).info(
                "plan for %s:\n%s", strip, "\n".join(plan_to_rows(plan)))

        if self._in_explicit_txn and _plan_has_batched_apply(plan):
            raise TransactionException(
                "CALL { } IN TRANSACTIONS is not allowed inside an "
                "explicit transaction")
        needed = _plan_privileges(plan)
        for privilege in sorted(needed):
            self._check_privilege(privilege)
        is_write = bool(needed - _READ_ONLY_PRIVILEGES)

        replication = getattr(self.ctx, "replication", None)
        if replication is not None and replication.role == "replica" \
                and is_write:
            raise QueryException(
                "write queries are forbidden on a REPLICA instance")

        if query.explain:
            rows = [[line] for line in plan_to_rows(plan)]
            return self._prepare_generator(iter(rows), ["QUERY PLAN"], "r")

        # per-operator execution counters (reference:
        # prometheus_metrics.hpp:108-157 via interpreter.cpp:3320):
        # counted at successful COMPLETION (_finish_stream), not prepare,
        # so failed/aborted queries don't inflate them. The counts are
        # derived once per (cached) plan, not walked per query.
        counts = getattr(plan, "_op_counts", None)
        if counts is None:
            counts = _plan_operator_counts(plan)
            try:
                plan._op_counts = counts
            except (AttributeError, TypeError):
                pass  # frozen/slotted root: recompute next time
        self._pending_op_counts = counts

        if self._in_explicit_txn:
            accessor = self._explicit_accessor
            owns = False
        else:
            accessor = self._fg_access(self._pick_isolation())
            owns = True

        self._abort_flag = threading.Event()
        timeout = self.ctx.config.get("execution_timeout_sec", 600.0)
        deadline = time.monotonic() + timeout if timeout else None
        abort_flag = self._abort_flag

        def timeout_checker():
            if abort_flag.is_set():
                raise HintedAbortError("transaction was asked to abort")
            if deadline is not None and time.monotonic() > deadline:
                raise HintedAbortError(
                    f"query exceeded timeout of {timeout}s")

        from ..utils.memory_tracker import QueryMemoryTracker
        mem_limit = query.memory_limit
        if mem_limit is None:
            # defaults layer: the tenant profile caps the database, the
            # USER profile caps the session's user — smaller wins
            # (reference: tenant_profiles.cpp memory_limit +
            # user_profiles.cpp transactions_memory)
            caps = []
            dbms = getattr(self.ctx, "dbms", None)
            if dbms is not None:
                cap = dbms.tenant_profiles.limit_for_database(
                    getattr(self.ctx, "database_name", ""),
                    "memory_limit")
                if cap is not None:
                    caps.append(cap)
            up = getattr(self.ctx, "user_profiles", None)
            if up is not None and self.username:
                cap = up.limit_for_user(self.username,
                                        "transactions_memory")
                if cap is not None:
                    caps.append(cap)
            mem_limit = min(caps) if caps else None
        exec_ctx = ExecutionContext(accessor, parameters,
                                    View.NEW, self.ctx, timeout_checker,
                                    memory=QueryMemoryTracker(mem_limit))
        exec_ctx.eval_ctx.username = self.username
        # flag default, overridable per-instance at runtime via
        # SET DATABASE SETTING 'hops_limit_partial_results'
        exec_ctx.hops_partial = bool(self.ctx.config.get(
            "hops_limit_partial_results", True))
        hp = self._settings().get("hops_limit_partial_results")
        if hp is not None:
            exec_ctx.hops_partial = hp.strip().lower() != "false"
        if owns:
            exec_ctx._txn_owner = _TxnOwner(self, exec_ctx)
        self._exec_ctx = exec_ctx

        if query.profile:
            from .plan.profile import PROFILE_COLUMNS
            plan, collector = attach_profiling(plan)
            self._profile_plan = (plan, collector)
            self._profile_start = time.perf_counter()
            rows_iter = self._profile_rows_iter(plan, exec_ctx, columns)
            self._install_stream(rows_iter, accessor, owns)
            return self._finish_prepare(list(PROFILE_COLUMNS), "r",
                                        is_write)

        qinfo = {"query": text, "start": time.time(),
                 "interpreter": self}
        qid = self.ctx.next_query_id()
        with self.ctx._rq_lock:
            self.ctx.running_queries[qid] = qinfo
        self._current_query_info = qid

        def rows_iter():
            try:
                if not columns:
                    # write-only query (no RETURN / YIELD): drain for the
                    # side effects but emit NO records — the reference
                    # streams zero records for such queries (EmptyResult
                    # operator, query/plan/operator.hpp)
                    for _ in plan.cursor(exec_ctx):
                        pass
                    return
                for frame in plan.cursor(exec_ctx):
                    row = frame.get("__row__", {})
                    self._rows_emitted += 1
                    yield [row.get(c) for c in columns]
            finally:
                with self.ctx._rq_lock:
                    self.ctx.running_queries.pop(qid, None)

        self._install_stream(rows_iter(), accessor, owns)
        return self._finish_prepare(columns, "rw", is_write)

    def _profile_rows_iter(self, plan, exec_ctx, columns):
        # drain fully under an active stage accumulator (device work —
        # in-process mesh kernels OR kernel-server dispatches whose
        # replies ship their stage splits home — attributes to it),
        # then emit the profile tree
        from ..observability import stats as mgstats
        acc = mgstats.StageAccumulator()
        with mgstats.collecting_stages(acc):
            for _ in plan.cursor(exec_ctx):
                self._rows_emitted += 1
        total = time.perf_counter() - self._profile_start
        plan_obj, collector = self._profile_plan
        yield from profile_rows(plan_obj, collector, total,
                                stages=acc.snapshot())

    def _install_stream(self, iterator, accessor, owns_txn):
        self._stream = iterator
        self._stream_accessor = accessor
        self._stream_owns_txn = owns_txn

    def _finish_prepare(self, columns, summary_type,
                        is_write: bool = False) -> PreparedQuery:
        self._prepared = PreparedQuery(columns, 0, summary_type, is_write)
        return self._prepared

    def _finish_stream(self) -> dict:
        summary = {}
        self.session_trace.emit("finish")
        from ..utils.metrics import global_metrics
        pending_ops = getattr(self, "_pending_op_counts", None)
        self._pending_op_counts = None
        started = getattr(self, "_query_started", None)
        self._query_started = None
        if self._exec_ctx is not None:
            summary["stats"] = dict(self._exec_ctx.stats)
            self._exec_ctx.memory.release_all()
        # execute phase = end of prepare -> stream exhaustion (measured
        # BEFORE the commit below so the phases stay disjoint)
        pf = self._prepare_finished
        if pf is not None:
            self._phase_s["execute"] = time.monotonic() - pf[1]
            mgtrace.record_span("query.execute", pf[0],
                                self._phase_s["execute"])
        # the commit can still fail (constraint violations surface here):
        # counters are recorded only after it succeeds
        if self._stream_owns_txn and self._stream_accessor is not None:
            t0 = time.perf_counter()
            with mgtrace.span("query.commit"):
                self._stream_accessor.commit()
            self._phase_s["commit"] = time.perf_counter() - t0
        global_metrics.increment("query.finished")
        if pending_ops:
            for op_name, count in pending_ops.items():
                global_metrics.increment(f"operator.{op_name}", count)
        if started is not None:
            elapsed = time.monotonic() - started
            global_metrics.observe("query.execution_latency_sec", elapsed)
            # mgstat: per-fingerprint accounting (Cypher queries only —
            # admin statements never set a fingerprint). Recorded after
            # the commit so a constraint-violating query lands in the
            # error path below instead.
            fp = getattr(self, "_query_fingerprint", None)
            if fp is not None:
                from ..observability.stats import global_query_stats
                global_query_stats.record(
                    fp, elapsed, rows=getattr(self, "_rows_emitted", 0),
                    error=False,
                    plan_cache_hit=getattr(self, "_plan_cache_hit",
                                           False),
                    trace_id=self._trace_root.trace_id
                    if self._trace_root is not None else None)
                self._query_fingerprint = None
            min_ms = self.ctx.config.get("log_min_duration_ms") or 0
            slow = min_ms and elapsed * 1000.0 >= min_ms and \
                not getattr(self, "_query_priv_auth", False)
            if slow:
                # the logged entry names its trace_id so a slow query
                # links directly to the retained trace in /traces; the
                # per-phase breakdown says WHERE the time went
                import logging
                phases = " ".join(
                    f"{k}={v * 1000.0:.1f}ms"
                    for k, v in sorted(self._phase_s.items()))
                trace_id = self._trace_root.trace_id \
                    if self._trace_root is not None else "-"
                logging.getLogger(__name__).info(
                    "slow query (%.1f ms, trace_id=%s, %s): %s",
                    elapsed * 1000.0, trace_id, phases or "-",
                    _redact_literals(
                        (getattr(self, "_query_text", "") or "").strip()))
            if self._trace_root is not None:
                self._trace_root.finish(
                    status="ok", force_keep=bool(slow),
                    query=_redact_literals(
                        (getattr(self, "_query_text", "") or "").strip()),
                    **{f"{k}_ms": round(v * 1000.0, 3)
                       for k, v in self._phase_s.items()})
                self._trace_root = None
        elif self._trace_root is not None:
            self._trace_root.finish(status="ok")
            self._trace_root = None
        for key, value in summary.get("stats", {}).items():
            if value:
                global_metrics.increment(f"storage.{key}", value)
        self._stream = None
        self._stream_accessor = None
        self._stream_owns_txn = False
        self._exec_ctx = None
        return summary

    def _cleanup_stream(self, error: bool = False) -> None:
        started = getattr(self, "_query_started", None)
        fp = getattr(self, "_query_fingerprint", None)
        if fp is not None and started is not None and error:
            # errored/aborted queries count against their fingerprint
            # too — an error-heavy hot shape is exactly what SHOW QUERY
            # STATS exists to surface
            from ..observability.stats import global_query_stats
            global_query_stats.record(
                fp, time.monotonic() - started,
                rows=getattr(self, "_rows_emitted", 0), error=True,
                plan_cache_hit=getattr(self, "_plan_cache_hit", False),
                trace_id=self._trace_root.trace_id
                if self._trace_root is not None else None)
        self._query_fingerprint = None
        self._query_started = None
        self._pending_op_counts = None
        if self._exec_ctx is not None:
            self._exec_ctx.memory.release_all()
        if self._stream_owns_txn and self._stream_accessor is not None:
            self._stream_accessor.abort()
        if self._trace_root is not None:
            # errored/aborted queries are always retained
            self._trace_root.finish(
                status="error" if error else "aborted",
                error="query aborted or failed mid-stream" if error
                else None, force_keep=error)
            self._trace_root = None
        self._stream = None
        self._stream_accessor = None
        self._stream_owns_txn = False
        self._exec_ctx = None

    # --- convenience (tests, embedded use) ----------------------------------

    def execute(self, text: str, parameters: Optional[dict] = None):
        """Prepare + pull everything. Returns (columns, rows, summary)."""
        prepared = self.prepare(text, parameters)
        rows, _, summary = self.pull(-1)
        return prepared.columns, rows, summary

    # --- DDL ----------------------------------------------------------------

    def _persist_ddl(self, kind: str, key: str, create: bool,
                     value: str = "1") -> None:
        """Record index/constraint DDL in the kvstore — the authoritative
        DDL set at startup (snapshots carry DDL too, but drops after the
        last snapshot must win)."""
        kv = getattr(self.ctx, "kvstore", None)
        if kv is None:
            return
        kv.put("ddl:enabled", "1")  # marker: kvstore is DDL-authoritative
        if create:
            kv.put(f"ddl:{kind}:{key}", value or "1")
        else:
            kv.delete(f"ddl:{kind}:{key}")

    def _run_index_query(self, node: A.IndexQuery):
        storage = self.ctx.storage
        if self._in_explicit_txn:
            raise TransactionException(
                "index operations are not allowed in explicit transactions")
        import json as _json
        if node.kind == "label":
            lid = storage.label_mapper.name_to_id(node.label)
            if node.action == "create":
                storage.create_label_index(lid)
            else:
                storage.indices.label.drop(lid)
                storage.indices.drop_stats(lid)
            self._persist_ddl("index", _json.dumps(["label", node.label]),
                              node.action == "create")
        elif node.kind == "label_property":
            lid = storage.label_mapper.name_to_id(node.label)
            pids = tuple(storage.property_mapper.name_to_id(p)
                         for p in node.properties)
            if node.action == "create":
                storage.create_label_property_index(lid, pids)
            else:
                storage.indices.label_property.drop(lid, pids)
                storage.indices.drop_stats(lid, pids)
            self._persist_ddl(
                "index",
                _json.dumps(["label_property", node.label,
                             list(node.properties)]),
                node.action == "create")
        elif node.kind == "edge_type":
            tid = storage.edge_type_mapper.name_to_id(node.edge_type)
            if node.action == "create":
                storage.create_edge_type_index(tid)
            else:
                storage.indices.edge_type.drop(tid)
            self._persist_ddl("index",
                              _json.dumps(["edge_type", node.edge_type]),
                              node.action == "create")
        self.ctx.invalidate_plans()
        yield [f"Index {node.action}d."]

    def _run_constraint_query(self, node: A.ConstraintQuery):
        storage = self.ctx.storage
        if self._in_explicit_txn:
            raise TransactionException(
                "constraint operations are not allowed in explicit "
                "transactions")
        import json as _json
        lid = storage.label_mapper.name_to_id(node.label)
        pids = [storage.property_mapper.name_to_id(p)
                for p in node.properties]
        if node.kind == "exists":
            if node.action == "create":
                storage.create_existence_constraint(lid, pids[0])
            else:
                storage.constraints.existence.drop(lid, pids[0])
        elif node.kind == "unique":
            if node.action == "create":
                storage.create_unique_constraint(lid, tuple(pids))
            else:
                storage.constraints.unique.drop(lid, tuple(pids))
        elif node.kind == "type":
            if node.action == "create":
                storage.create_type_constraint(lid, pids[0], node.data_type)
            else:
                storage.constraints.type.drop(lid, pids[0])
        # data_type stays OUT of the key (drop matches on (label, props));
        # normalize it into the stored value instead
        self._persist_ddl(
            "constraint",
            _json.dumps([node.kind, node.label, list(node.properties)]),
            node.action == "create",
            value=(node.data_type or "").upper())
        # constraint DDL must drop cached plans AND compiled lanes, same
        # as index DDL: a unique constraint is also an index the planner
        # keys scans on, and a lane compiled before the drop would keep
        # serving a schema that no longer exists
        self.ctx.invalidate_plans()
        yield [f"Constraint {node.action}d."]

    # --- info / admin -------------------------------------------------------

    def _prepare_info(self, node: A.InfoQuery) -> PreparedQuery:
        storage = self.ctx.storage
        if node.kind == "storage":
            info = storage.info()
            if self.ctx.config.get("storage_enable_edges_metadata"):
                # per-edge-type counts (reference:
                # --storage-enable-edges-metadata)
                counts: dict = {}
                for e in list(storage._edges.values()):
                    if not e.deleted:
                        counts[e.edge_type] = counts.get(e.edge_type, 0) + 1
                for et_id, cnt in sorted(counts.items()):
                    name = storage.edge_type_mapper.id_to_name(et_id)
                    info[f"edge_count[{name}]"] = cnt
            rows = [[k, v] for k, v in sorted(info.items())]
            return self._prepare_generator(iter(rows),
                                           ["storage info", "value"], "r")
        if node.kind == "index":
            # usage columns: lookups served, rows returned,
            # last-used timestamp — an index with writes but no lookups
            # is silent write overhead, now visible
            rows = []
            lm, pm = storage.label_mapper, storage.property_mapper

            def usage_cols(usage):
                if usage is None:
                    return [0, 0, None]
                return [usage.lookups, usage.rows,
                        _iso_utc(usage.last_used)]

            for lid in storage.indices.label.labels():
                rows.append(["label", lm.id_to_name(lid), None,
                             storage.indices.label.approx_count(lid)]
                            + usage_cols(storage.indices.label.usage(lid)))
            for (lid, pids) in storage.indices.label_property.keys():
                rows.append(["label+property", lm.id_to_name(lid),
                             [pm.id_to_name(p) for p in pids],
                             storage.indices.label_property.approx_count(
                                 lid, pids)]
                            + usage_cols(
                                storage.indices.label_property.usage(
                                    lid, pids)))
            for tid in storage.indices.edge_type.types():
                rows.append(["edge-type",
                             storage.edge_type_mapper.id_to_name(tid), None,
                             storage.indices.edge_type.approx_count(tid)]
                            + usage_cols(
                                storage.indices.edge_type.usage(tid)))
            return self._prepare_generator(
                iter(rows),
                ["index type", "label", "property", "count", "lookups",
                 "rows_returned", "last_used"], "r")
        if node.kind == "query_stats":
            from ..observability.stats import (QUERY_STATS_COLUMNS,
                                               global_query_stats)
            return self._prepare_generator(
                iter(global_query_stats.rows()),
                list(QUERY_STATS_COLUMNS), "r")
        if node.kind == "constraint":
            rows = []
            lm, pm = storage.label_mapper, storage.property_mapper
            for (lid, pid) in storage.constraints.existence.all():
                rows.append(["exists", lm.id_to_name(lid),
                             pm.id_to_name(pid)])
            for (lid, pids) in storage.constraints.unique.all():
                rows.append(["unique", lm.id_to_name(lid),
                             [pm.id_to_name(p) for p in pids]])
            for (lid, pid, tname) in storage.constraints.type.all():
                rows.append([f"data_type({tname})", lm.id_to_name(lid),
                             pm.id_to_name(pid)])
            return self._prepare_generator(
                iter(rows), ["constraint type", "label", "properties"], "r")
        if node.kind == "version":
            from .. import __version__
            return self._prepare_generator(iter([[__version__]]),
                                           ["version"], "r")
        if node.kind == "build":
            from .. import __version__
            rows = [["version", __version__], ["build_type", "Release"],
                    ["backend", "torch/CUDA"]]
            return self._prepare_generator(iter(rows),
                                           ["build info", "value"], "r")
        if node.kind == "license":
            from ..utils.license import LicenseChecker
            info = LicenseChecker(self._settings()).info()
            rows = [[k, v] for k, v in info.items()]
            return self._prepare_generator(iter(rows),
                                           ["license info", "value"], "r")
        if node.kind == "active_users":
            sessions = getattr(self.root_ctx, "active_sessions", {})
            # snapshot: the event-loop thread mutates this dict while
            # queries run on the worker pool
            rows = [[username, sid, login_ts]
                    for sid, (username, login_ts)
                    in sorted(list(sessions.items()),
                              key=lambda kv: kv[1][1])]
            return self._prepare_generator(
                iter(rows), ["username", "session uuid",
                             "login timestamp"], "r")
        if node.kind == "metrics":
            from ..utils.metrics import global_metrics
            rows = [[name, str(kind), value]
                    for name, kind, value in global_metrics.snapshot()]
            return self._prepare_generator(iter(rows),
                                           ["name", "type", "value"], "r")
        if node.kind == "schema":
            # full live-schema JSON document (reference:
            # storage/v2/schema_info.cpp, returned as one `schema` row;
            # gated by --schema-info-enabled as the reference gates it
            # behind --storage-enable-schema-metadata)
            if self.ctx.config.get("schema_info_enabled", True) is False:
                raise QueryException(
                    "SHOW SCHEMA INFO is disabled "
                    "(--schema-info-enabled=false)")
            from ..storage.schema_info import schema_info_json
            acc = storage.access()
            try:
                doc = schema_info_json(acc, View.OLD)
            finally:
                acc.abort()
            return self._prepare_generator(iter([[doc]]), ["schema"], "r")
        if node.kind == "database":
            name = getattr(self.ctx, "database_name", "memgraph")
            return self._prepare_generator(iter([[name]]), ["Name"], "r")
        if node.kind == "free_memory":
            # reference requires FREE_MEMORY for FREE MEMORY (declared in
            # auth.PRIVILEGES; enforce it here, not just declare it).
            self._check_privilege("FREE_MEMORY")
            import gc
            stats = storage.collect_garbage()
            gc.collect()
            from ..ops.csr import GLOBAL_GRAPH_CACHE
            GLOBAL_GRAPH_CACHE.clear()
            rows = [[k, v] for k, v in sorted(stats.items())]
            return self._prepare_generator(iter(rows),
                                           ["freed", "count"], "s")
        raise SemanticException(f"unknown info query {node.kind}")

    def _show_transactions(self):
        rows = []
        with self.ctx._rq_lock:
            snapshot = list(self.ctx.running_queries.items())
        for qid, info in snapshot:
            rows.append([str(qid), info.get("query", ""),
                         info.get("username", "")])
        return rows

    def _prepare_terminate(self, node: A.TerminateTransactionsQuery,
                           parameters) -> PreparedQuery:
        from .plan.operators import ExecutionContext
        acc = self.ctx.storage.access()
        ctx = ExecutionContext(acc, parameters)
        results = []
        try:
            for expr in node.ids:
                tid = ctx.evaluator.eval(expr, {})
                killed = False
                with self.ctx._rq_lock:
                    info = self.ctx.running_queries.get(
                        int(tid) if str(tid).isdigit() else -1)
                if info is not None:
                    interp = info.get("interpreter")
                    if interp is not None and interp is not self:
                        interp._abort_flag.set()
                        killed = True
                results.append([str(tid), killed])
        finally:
            acc.abort()
        return self._prepare_generator(iter(results),
                                       ["transaction_id", "killed"], "w")

    def _prepare_snapshot(self, node: A.SnapshotQuery) -> PreparedQuery:
        raise NotPortedException("snapshots and recovery", _DURABILITY)

    def _prepare_isolation(self, node: A.IsolationLevelQuery) -> PreparedQuery:
        level = IsolationLevel(node.level)
        if node.scope == "global":
            self.ctx.storage.config.isolation_level = level
        elif node.scope == "session":
            self.session_isolation = level
        else:
            self.next_isolation = level
        return self._prepare_generator(iter([]), [], "s")

    def _prepare_storage_mode(self, node: A.StorageModeQuery) -> PreparedQuery:
        target = StorageMode(node.mode)
        if target is StorageMode.ON_DISK_TRANSACTIONAL:
            raise NotPortedException("ON_DISK_TRANSACTIONAL storage",
                                     _HOST_FEATURES)
        self.ctx.storage.config.storage_mode = target
        return self._prepare_generator(iter([]), [], "s")

    def _prepare_trigger(self, node: A.TriggerQuery) -> PreparedQuery:
        raise NotPortedException("triggers", _HOST_FEATURES)

    def _prepare_auth(self, node: A.AuthQuery,
                  parameters=None) -> PreparedQuery:
        auth = self._auth_store()
        if node.action == "create_user":
            pw = self._password_value(node.password, parameters)
            self._check_password_policy(pw)
            auth.create_user(node.user, pw)
        elif node.action == "drop_user":
            auth.drop_user(node.user)
        elif node.action == "create_role":
            auth.create_role(node.role)
        elif node.action == "drop_role":
            auth.drop_role(node.role)
        elif node.action == "set_role":
            auth.set_role(node.user, node.role)
        elif node.action == "grant":
            auth.grant(node.user, node.privileges)
        elif node.action == "deny":
            auth.deny(node.user, node.privileges)
        elif node.action == "revoke":
            auth.revoke(node.user, node.privileges)
        elif node.action == "grant_fine_grained":
            auth.grant_fine_grained(node.user, node.fg_kind, node.fg_items,
                                    node.fg_level)
        elif node.action == "revoke_fine_grained":
            auth.revoke_fine_grained(node.user, node.fg_kind, node.fg_items)
        elif node.action == "show_users":
            return self._prepare_generator(
                iter([[u] for u in auth.users()]), ["user"], "r")
        elif node.action == "show_current_user":
            return self._prepare_generator(
                iter([[self.username or None]]), ["user"], "r")
        elif node.action == "show_roles":
            return self._prepare_generator(
                iter([[r] for r in auth.roles()]), ["role"], "r")
        elif node.action == "set_password":
            pw = self._password_value(node.password, parameters)
            self._check_password_policy(pw)
            if not self.username:
                raise QueryException(
                    "SET PASSWORD requires an authenticated user")
            auth.set_password(self.username, pw)
        elif node.action == "show_privileges":
            rows = [[p, eff] for p, eff
                    in auth.effective_privileges(node.user)]
            checker = auth.fine_grained_checker(node.user, allow_role=True)
            if checker.restricted:
                from ..auth.auth import FG_LEVELS
                inv = {v: k for k, v in FG_LEVELS.items()}
                for lbl, lv in sorted(checker._labels.items()):
                    rows.append([f"LABEL :{lbl}" if lbl != "*"
                                 else "LABEL *", inv[lv]])
                for et, lv in sorted(checker._edge_types.items()):
                    rows.append([f"EDGE_TYPE :{et}" if et != "*"
                                 else "EDGE_TYPE *", inv[lv]])
            return self._prepare_generator(
                iter(rows), ["privilege", "effective"], "r")
        else:
            raise SemanticException(f"unknown auth action {node.action}")
        return self._prepare_generator(iter([]), [], "s")

    # --- helpers ------------------------------------------------------------

    def _prepare_generator(self, iterator, columns, summary_type
                           ) -> PreparedQuery:
        self._install_stream(iterator, None, False)
        self._prepared = PreparedQuery(columns, 0, summary_type)
        return self._prepared


class _TxnOwner:
    """Lets CALL { } IN TRANSACTIONS batch-commit an autocommit query:
    commits the current accessor and swaps in a fresh one mid-stream."""

    def __init__(self, interp: "Interpreter", exec_ctx) -> None:
        self._interp = interp
        self._exec_ctx = exec_ctx

    def renew(self) -> None:
        # in-place: the SAME accessor object re-begins, so graph handles
        # held in frames and in-flight scan iterators keep working and
        # post-boundary writes land in the fresh transaction (a swapped-in
        # accessor would leave them bound to the finished one)
        self._exec_ctx.accessor.periodic_commit()


def _redact_literals(text: str) -> str:
    """Mask quoted string literals before a query reaches logs or the
    monitoring broadcast — secrets may hide in any literal, not only in
    AUTH statements (which are skipped entirely)."""
    import re
    return re.sub(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"", "'***'", text)


def _iso_utc(ts: float | None) -> str | None:
    """Unix seconds -> ISO-8601 UTC string (SHOW INDEX INFO last_used)."""
    if not ts:
        return None
    import datetime
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).isoformat()


def _chain_front(first_row, rest):
    yield first_row
    yield from rest


def _plan_operator_counts(plan) -> dict:
    """{operator class name: occurrences} over a plan tree."""
    counts: dict = {}

    def walk(op):
        if op is None:
            return
        counts[type(op).__name__] = counts.get(type(op).__name__, 0) + 1
        for child in op.children():
            walk(child)

    walk(plan)
    return counts


def _plan_has_batched_apply(plan) -> bool:
    from .plan import operators as Op
    found = False

    def walk(op):
        nonlocal found
        if op is None or found:
            return
        if isinstance(op, Op.Apply) and op.batch_rows:
            found = True
            return
        for child in op.children():
            walk(child)

    walk(plan)
    return found


def _plan_privileges(plan) -> set:
    """Privileges a plan requires (reference: per-clause privilege map)."""
    from .plan import operators as Op
    needed: set = set()

    def walk(op):
        if op is None:
            return
        if isinstance(op, (Op.ScanAll, Op.ScanAllByLabel,
                           Op.ScanAllByLabelPropertyValue,
                           Op.ScanAllByLabelPropertyRange, Op.ScanAllById,
                           Op.Expand, Op.ExpandVariable, Op.ExpandShortest,
                           Op.ExpandKShortest)):
            needed.add("MATCH")
        elif isinstance(op, (Op.CreateNode, Op.CreateExpand,
                             Op.BatchCreateGraph)):
            needed.add("CREATE")
        elif isinstance(op, Op.Merge):
            needed.update(("MERGE", "MATCH", "CREATE"))
        elif isinstance(op, Op.Delete):
            needed.add("DELETE")
        elif isinstance(op, (Op.SetProperty, Op.SetProperties,
                             Op.SetLabels)):
            needed.add("SET")
        elif isinstance(op, (Op.RemoveProperty, Op.RemoveLabels)):
            needed.add("REMOVE")
        elif isinstance(op, (Op.LoadCsvOp, Op.LoadJsonlOp,
                             Op.LoadParquetOp)):
            # reference: required_privileges.cpp:283-293 (READ_FILE for
            # LOAD CSV); file-reading operators must not run unprivileged.
            needed.add("READ_FILE")
        elif isinstance(op, Op.CallProcedureOp):
            from .procedures.registry import global_registry
            proc = global_registry.find(op.proc_name)
            needed.add("MODULE_WRITE" if proc is not None and proc.is_write
                       else "MODULE_READ")
        for child in op.children():
            walk(child)

    walk(plan)
    return needed


# privileges whose presence does NOT make a plan a write
_READ_ONLY_PRIVILEGES = frozenset({"MATCH", "MODULE_READ", "READ_FILE"})
