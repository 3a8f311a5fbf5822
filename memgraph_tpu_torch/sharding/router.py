"""ShardedClient: the routed query path over a ShardPlane.

Three request shapes, the same trio the reference's distributed
execution layer distinguishes:

* **single-shard** (a routing key is known): point reads and writes go
  straight to the owner; write acks must carry the grant epoch of the
  map the client routed with, and a stale-map bounce (typed
  ``StaleShardEpoch``) refreshes the map — EPOCH-MONOTONICALLY — and
  retries against the new owner under the shared RetryPolicy.
* **scatter-gather** (no key): the query fans out to every shard and
  the gather side merges — partial-aggregate combination for
  count/sum/min/max (grouped or global), ORDER BY re-sort and global
  LIMIT re-application for plain row results. Unsupported shapes
  (DISTINCT aggregates, avg, SKIP, aggregate arithmetic) raise a loud
  typed ``MergeError`` instead of quietly returning wrong answers.
* **cross-shard writes**: grouped per shard and run through 2PC —
  prepare (held transaction + durable journal) on every touched shard,
  then commit; any prepare failure or worker death aborts every
  prepared participant (presumed abort), while a worker death AFTER
  the commit decision re-drives the decision against the respawned
  worker (its journal replays the vote — no half-committed txn).

Copy of memgraph_tpu/sharding/router.py for the port.  One difference:
a scatter-gather whose shards refuse device work re-raises the typed
``DeviceWorkRefused`` (the reference wraps every shard error in a
``MemgraphTpuError``).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid

from ..exceptions import (DeviceWorkRefused, MemgraphTpuError,
                          ShardError, StaleShardEpoch,
                          WorkerCrashedError, WriteInDoubtError)
from ..utils.metrics import global_metrics
from ..query.frontend import ast as A
from ..query.frontend.parser import parse
from ..utils.retry import RetryPolicy

__all__ = ["MergeError", "MergePlan", "ShardedClient", "plan_merge"]

#: aggregate combiners the gather side knows how to merge from
#: per-shard partials (avg/collect/percentiles need a rewrite the
#: router does not do — they fail loudly instead)
_MERGEABLE = {"count": lambda vals: sum(v for v in vals if v is not None),
              "sum": lambda vals: _sum_sparse(vals),
              "min": lambda vals: _pick(vals, min),
              "max": lambda vals: _pick(vals, max)}


def _sum_sparse(vals):
    vals = [v for v in vals if v is not None]
    return sum(vals) if vals else None


def _pick(vals, fn):
    vals = [v for v in vals if v is not None]
    return fn(vals) if vals else None


class MergeError(ShardError):
    """The query's result shape cannot be merged on the gather side;
    the caller must route it single-shard or rewrite it."""


class MergePlan:
    """How to combine per-shard result sets into one."""

    __slots__ = ("aggregate", "columns", "group_idx", "agg_specs",
                 "order", "limit", "distinct")

    def __init__(self, aggregate, columns, group_idx, agg_specs, order,
                 limit, distinct) -> None:
        self.aggregate = aggregate      # bool
        self.columns = columns          # output column names
        self.group_idx = group_idx      # indexes of group-key columns
        self.agg_specs = agg_specs      # {col_idx: combiner-name}
        self.order = order              # [(col_idx, ascending)]
        self.limit = limit              # int | None (global)
        self.distinct = distinct


def _expr_text(expr) -> str | None:
    """Tiny unparse for the sort-key shapes the merge supports."""
    if isinstance(expr, A.Identifier):
        return expr.name
    if isinstance(expr, A.PropertyLookup) and \
            isinstance(expr.expr, A.Identifier):
        return f"{expr.expr.name}.{expr.prop}"
    return None


def _agg_name(expr) -> str | None:
    """The combiner name when ``expr`` IS a bare mergeable aggregate."""
    if isinstance(expr, A.CountStar):
        return "count"
    if isinstance(expr, A.FunctionCall) and expr.name in _MERGEABLE \
            and not expr.distinct:
        return expr.name
    return None


def _contains_aggregate(expr) -> bool:
    if isinstance(expr, (A.CountStar,)):
        return True
    if isinstance(expr, A.FunctionCall):
        if expr.name in ("count", "sum", "min", "max", "avg",
                         "collect", "stdev", "percentilecont",
                         "percentiledisc"):
            return True
        return any(_contains_aggregate(a) for a in expr.args)
    for attr in ("expr", "left", "right", "index", "lo", "hi"):
        sub = getattr(expr, attr, None)
        if isinstance(sub, A.Expr) and _contains_aggregate(sub):
            return True
    items = getattr(expr, "items", None)
    if isinstance(items, list) and \
            any(isinstance(i, A.Expr) and _contains_aggregate(i)
                for i in items):
        return True
    return False


def _const_int(expr, params) -> int:
    if isinstance(expr, A.Literal) and isinstance(expr.value, int):
        return int(expr.value)
    if isinstance(expr, A.Parameter):
        value = (params or {}).get(expr.name)
        if isinstance(value, int):
            return value
    raise MergeError("scatter-gather LIMIT/SKIP must be an integer "
                     "literal or parameter")


def plan_merge(query: str, params: dict | None = None) -> MergePlan:
    """Derive the gather-side merge plan from the query's RETURN shape.

    Raises MergeError for shapes the merge cannot reproduce exactly —
    the loud-refusal contract: a scatter-gather must never return an
    answer a single store would not have."""
    node = parse(query)
    if not isinstance(node, A.CypherQuery):
        raise MergeError("only Cypher queries scatter-gather")
    if node.unions:
        raise MergeError("UNION queries do not scatter-gather")
    clauses = node.query.clauses
    for cl in clauses:
        if isinstance(cl, A.With) and any(
                _contains_aggregate(it[0]) for it in cl.body.items):
            raise MergeError("aggregating WITH inside a scatter-gather "
                             "would combine per-shard partials wrongly")
    ret = clauses[-1] if clauses and isinstance(clauses[-1], A.Return) \
        else None
    if ret is None:
        raise MergeError("scatter-gather needs a final RETURN")
    body = ret.body
    if body.star:
        raise MergeError("RETURN * does not scatter-gather (column "
                         "set is shard-dependent)")
    if body.skip is not None:
        raise MergeError("SKIP does not scatter-gather (per-shard SKIP "
                         "drops globally-needed rows); paginate on the "
                         "gather side")

    columns, agg_specs, group_idx = [], {}, []
    any_agg = False
    for idx, (expr, alias, text) in enumerate(body.items):
        columns.append(alias or text or f"col{idx}")
        name = _agg_name(expr)
        if name is not None:
            agg_specs[idx] = name
            any_agg = True
            continue
        if _contains_aggregate(expr):
            raise MergeError(
                "only bare count/sum/min/max aggregates merge across "
                "shards (avg, DISTINCT aggregates and aggregate "
                "arithmetic need a rewrite)")
        group_idx.append(idx)

    order = []
    for item in body.order_by:
        text = _expr_text(item.expr)
        if text is None or text not in columns:
            raise MergeError("ORDER BY keys must reference returned "
                            "columns for a scatter-gather merge")
        order.append((columns.index(text), item.ascending))
    limit = _const_int(body.limit, params) \
        if body.limit is not None else None
    if any_agg and limit is not None:
        raise MergeError("LIMIT over a grouped scatter-gather "
                         "aggregate would truncate per-shard partial "
                         "groups; drop the LIMIT or route single-shard")
    return MergePlan(any_agg, columns, group_idx, agg_specs, order,
                     limit, body.distinct)


def merge_rows(plan: MergePlan, shard_rows: list[list]) -> list:
    """Combine per-shard row sets per the plan."""
    if plan.aggregate:
        groups: dict = {}
        order_keys = []
        for rows in shard_rows:
            for row in rows:
                key = tuple(_hashable(row[i]) for i in plan.group_idx)
                if key not in groups:
                    order_keys.append(key)
                    groups[key] = {i: [] for i in plan.agg_specs}
                    groups[key]["_row"] = list(row)
                for i in plan.agg_specs:
                    groups[key][i].append(row[i])
        merged = []
        for key in order_keys:
            bucket = groups[key]
            row = bucket["_row"]
            for i, name in plan.agg_specs.items():
                row[i] = _MERGEABLE[name](bucket[i])
            merged.append(row)
    else:
        merged = [row for rows in shard_rows for row in rows]
        if plan.distinct:
            seen, unique = set(), []
            for row in merged:
                key = tuple(_hashable(v) for v in row)
                if key not in seen:
                    seen.add(key)
                    unique.append(row)
            merged = unique
    for idx, ascending in reversed(plan.order):
        merged.sort(key=lambda r: _sort_key(r[idx]),
                    reverse=not ascending)
    if plan.limit is not None:
        merged = merged[:plan.limit]
    return merged


def _hashable(value):
    if isinstance(value, list):
        return tuple(_hashable(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in value.items()))
    return value


def _sort_key(value):
    """Total order mirroring Cypher orderability: NULL sorts last
    ascending, and mixed-type columns group by a type rank (maps <
    lists < strings < booleans < numbers) instead of letting list.sort
    raise TypeError on a cross-shard heterogeneous column."""
    if value is None:
        return (1, 0, 0)
    if isinstance(value, bool):            # before int: bool IS an int
        return (0, 3, value)
    if isinstance(value, (int, float)):
        return (0, 4, value)
    if isinstance(value, str):
        return (0, 2, value)
    if isinstance(value, list):
        return (0, 1, tuple(_sort_key(v) for v in value))
    if isinstance(value, dict):
        return (0, 0, tuple(sorted((k, _sort_key(v))
                                   for k, v in value.items())))
    return (0, 5, str(value))


class ShardedClient:
    """The routed client over one ShardPlane (the in-process
    counterpart of RoutedClient's coordinator-driven routing)."""

    def __init__(self, plane, retry: RetryPolicy | None = None) -> None:
        self.plane = plane
        self.retry = retry or RetryPolicy(base_delay=0.05,
                                          max_delay=1.0, max_retries=8)
        self.map = plane.map
        self._txn_seq = itertools.count()

    # -- shard map -----------------------------------------------------------

    def refresh_map(self) -> bool:
        """Adopt the placement authority's current map — only if it is
        at least as new as what we hold (epoch-monotonic: a stale
        authority read can never steer writes backwards)."""
        fresh = self.plane.placement.current()
        if fresh.epoch < self.map.epoch:
            return False
        self.map = fresh
        return True

    def shard_for(self, key) -> int:
        return self.map.shard_for(key)

    # -- single-shard --------------------------------------------------------

    def read(self, query: str, params: dict | None = None, key=None):
        """Point read (key given) or scatter-gather read (key=None).
        Returns (columns, rows)."""
        if key is None:
            return self.scatter_read(query, params)
        last: Exception | None = None
        t0 = time.perf_counter()
        for _attempt in self.retry.attempts():
            shard = self.map.shard_for(key)
            try:
                _status, body = self.plane.request(
                    shard, "read", {"query": query,
                                    "params": params or {},
                                    "epoch": self.map.epoch})
                self._account(query, t0, rows=len(body["rows"]))
                return body["columns"], body["rows"]
            except StaleShardEpoch as e:
                last = e
                global_metrics.increment(
                    "shard.stale_epoch_bounces_total")
                self.refresh_map()
            except WorkerCrashedError as e:
                last = e
                self.refresh_map()
        self._account(query, t0, rows=0, error=True)
        raise MemgraphTpuError(
            f"sharded read failed after "
            f"{self.retry.max_retries + 1} attempts: {last}") from last

    def _account(self, query: str, t0: float, rows: int,
                 error: bool = False) -> None:
        """Fork-side stats die with the worker process; the PARENT
        registry is the authoritative fingerprint table (the same
        contract as mp_executor), so routed queries account here."""
        from ..observability import trace as mgtrace
        from ..observability.stats import global_query_stats
        global_query_stats.record_text(
            query, time.perf_counter() - t0, rows=rows, error=error,
            trace_id=mgtrace.current_trace_id())

    def write(self, query: str, params: dict | None = None, *, key):
        """Single-shard write routed by key. The ack is only accepted
        at the routing epoch (the worker enforces equality), and a
        stale-map bounce refreshes + retries — the fencing contract
        under live shard moves. Returns (columns, rows, ack)."""
        last: Exception | None = None
        t0 = time.perf_counter()
        for _attempt in self.retry.attempts():
            shard = self.map.shard_for(key)
            epoch = self.map.epoch
            try:
                _status, body = self.plane.request(
                    shard, "write", {"query": query,
                                     "params": params or {},
                                     "epoch": epoch})
                self._account(query, t0, rows=len(body["rows"]))
                return body["columns"], body["rows"], \
                    {"shard": body["shard"], "epoch": body["epoch"],
                     "owner": body.get("owner")}
            except StaleShardEpoch as e:
                last = e
                global_metrics.increment(
                    "shard.stale_epoch_bounces_total")
                self.refresh_map()
            except WorkerCrashedError as e:
                if e.in_doubt:
                    # the owner died AFTER the write was on the wire:
                    # it may be in the shard's WAL already, so a blind
                    # re-send can double-apply a non-idempotent write.
                    # Surface the doubt typed instead of retrying.
                    self._account(query, t0, rows=0, error=True)
                    global_metrics.increment(
                        "shard.write_in_doubt_total")
                    raise WriteInDoubtError(
                        f"sharded write to shard {shard} is in doubt "
                        f"(owner died mid-request): {e}") from e
                last = e
                self.refresh_map()
        self._account(query, t0, rows=0, error=True)
        raise MemgraphTpuError(
            f"sharded write failed after "
            f"{self.retry.max_retries + 1} attempts: {last}") from last

    def ddl(self, query: str) -> None:
        """Broadcast schema DDL (CREATE INDEX / constraints) to EVERY
        shard — the schema is global even though the data is not."""
        for shard in range(self.map.n_shards):
            last: Exception | None = None
            for _attempt in self.retry.attempts():
                try:
                    self.plane.request(
                        shard, "write", {"query": query, "params": {},
                                         "epoch": self.map.epoch})
                    last = None
                    break
                except (StaleShardEpoch, WorkerCrashedError) as e:
                    last = e
                    self.refresh_map()
            if last is not None:
                raise MemgraphTpuError(
                    f"DDL broadcast to shard {shard} failed: "
                    f"{last}") from last

    # -- scatter-gather ------------------------------------------------------

    def scatter_read(self, query: str, params: dict | None = None):
        """Fan the read out to every shard and merge per the plan."""
        plan = plan_merge(query, params)
        global_metrics.increment("shard.scatter_gather_total")
        results: dict[int, list] = {}
        errors: dict[int, Exception] = {}

        def one(shard: int) -> None:
            try:
                for _attempt in self.retry.attempts():
                    try:
                        _status, body = self.plane.request(
                            shard, "read", {"query": query,
                                            "params": params or {},
                                            "epoch": self.map.epoch})
                        results[shard] = body["rows"]
                        return
                    except (StaleShardEpoch, WorkerCrashedError):
                        self.refresh_map()
                raise MemgraphTpuError(
                    f"shard {shard} kept bouncing the scatter read")
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors[shard] = e

        threads = [threading.Thread(target=one, args=(sid,))
                   for sid in range(self.map.n_shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            shard, err = sorted(errors.items())[0]
            if isinstance(err, DeviceWorkRefused):
                raise err
            raise MemgraphTpuError(
                f"scatter-gather failed on shard {shard}: "
                f"{err}") from err
        rows = merge_rows(plan, [results[s]
                                 for s in sorted(results)])
        return plan.columns, rows

    # -- cross-shard 2PC -----------------------------------------------------

    def write_multi(self, statements) -> dict:
        """Atomic cross-shard write: ``statements`` is a list of
        (key, query, params). Statements group per owning shard and run
        through 2PC. Returns {"shards": [...], "epoch": e}.

        Presumed abort: any prepare failure (vote no, fencing bounce,
        worker death) aborts every prepared participant. After the
        commit decision, a dead participant is re-driven — its durable
        pending journal replays the vote on the recovered store."""
        global_metrics.increment("shard.twopc_total")
        by_shard: dict[int, list] = {}
        for key, query, params in statements:
            by_shard.setdefault(self.map.shard_for(key), []).append(
                {"query": query, "params": params or {}})
        txn_id = f"xs-{uuid.uuid4().hex[:12]}-{next(self._txn_seq)}"
        shards = sorted(by_shard)
        prepared: list[int] = []
        try:
            for shard in shards:
                self._prepare_one(shard, txn_id, by_shard[shard])
                prepared.append(shard)
        except Exception:
            global_metrics.increment("shard.twopc_aborts_total")
            # abort every touched shard INCLUDING the one whose prepare
            # failed: it journals before voting, so a crash mid-prepare
            # can leave a pending entry that the abort must prune (else
            # it accumulates, and a late commit for this txn_id would
            # replay writes the client was told aborted)
            for shard in shards[:len(prepared) + 1]:
                self._decide_one(shard, txn_id, "abort",
                                 best_effort=True)
            raise
        for shard in prepared:
            self._decide_one(shard, txn_id, "commit")
        return {"shards": prepared, "epoch": self.map.epoch,
                "txn_id": txn_id}

    def _prepare_one(self, shard: int, txn_id: str,
                     stmts: list) -> None:
        last: Exception | None = None
        for _attempt in self.retry.attempts():
            try:
                status, body = self.plane.request(
                    shard, "prepare", {"txn_id": txn_id,
                                       "statements": stmts,
                                       "epoch": self.map.epoch})
                if body.get("vote") == "yes":
                    return
                raise MemgraphTpuError(
                    f"shard {shard} voted {body!r} on {txn_id}")
            except StaleShardEpoch as e:
                last = e
                global_metrics.increment(
                    "shard.stale_epoch_bounces_total")
                self.refresh_map()
            except WorkerCrashedError as e:
                # nothing was committed: a fresh prepare on the
                # respawned (recovered) worker is safe
                last = e
                self.refresh_map()
        raise MemgraphTpuError(
            f"2PC prepare on shard {shard} failed: {last}") from last

    def _decide_one(self, shard: int, txn_id: str, decision: str,
                    best_effort: bool = False) -> None:
        last: Exception | None = None
        for _attempt in self.retry.attempts():
            try:
                status, body = self.plane.request(
                    shard, "decide", {"txn_id": txn_id,
                                      "decision": decision},
                    raise_typed=False)
                if status == "unknown_txn" and decision == "commit":
                    raise MemgraphTpuError(
                        f"shard {shard} lost prepared txn {txn_id} "
                        "AND its journal — in-doubt")
                return
            except WorkerCrashedError as e:
                # the journal survives the crash: re-drive the decision
                last = e
                self.refresh_map()
                time.sleep(0)   # yield; retry loop backs off
            except MemgraphTpuError as e:
                last = e
                if best_effort:
                    return      # presumed abort needs no ack
                raise
        if best_effort:
            return
        raise MemgraphTpuError(
            f"2PC {decision} on shard {shard} undeliverable: "
            f"{last}") from last
