"""mglane: compile hot Cypher read pipelines onto the semiring core.

Plan-lowering pass that runs AFTER the columnar rewrite
(query/plan/parallel.py). Eligible read-pipeline tails —

    label/property filter -> [1-2 hop expand] -> count/sum/min/max
    label/property filter -> ORDER BY <int key> LIMIT k

— are lowered onto the compiled-lane operators below, whose cursors
dispatch ONE device program (ops/pipeline.py) per recognized shape:
predicate masks become columnar int32 compares, expansion becomes a
masked ``plus_first`` SpMV chain over the semiring core (GraphBLAST),
and the aggregate/top-k epilogue fuses into the same program.

Layering (each stage is the exact degeneracy of the one above):

    compiled device program          (this module + ops/pipeline.py)
      -> host columnar kernels       (ParallelScanAggregate et al.)
        -> row-at-a-time Volcano     (the original subplan)

Every step down is LOUD: a typed reason is counted per plan-cache
fingerprint (``lane.fallback_total.<reason>``; per-fingerprint table in
``GET /stats`` -> ``lane``) — and CORRECT: the host paths own the exact
semantics, so a refused shape never changes results.

Fallback taxonomy (docs/architecture.md §Compiled read lane):
  shape-level   group_by, agg_avg/agg_<kind>, remember, multi_key,
                edge_prop, dynamic_predicate, direction, edge_type_mix
  data-level    float_column, float_rhs, big_int, column_kind,
                str_order, vocab_miss, null_rhs, type_mismatch,
                topk_precision, precision_overflow
  state-level   mvcc_private, small_input, small_frontier,
                columnar_unsupported, remote_error

Compilation is keyed by the mgstat plan-cache fingerprint:
``InterpreterContext.cached_plan`` stamps it onto every lane operator
(``bind_fingerprints``), each distinct shape compiles ONCE (the witness
is the per-fingerprint compile counter plus ``jit.compile_total``), and
schema changes (index/constraint DDL, ANALYZE) drop every compiled lane
through the same ``invalidate_plans`` hook that drops cached plans.

Port of memgraph_tpu/query/plan/lane.py onto the port's ops/pipeline.py
(masked aggregates and top-k in torch, hop counts on K1 with K2's mass
shadows).  What differs:

- The programs run on the interpreter context's device
  (``InterpreterContext(..., device=)``; ``cuda`` when an execution has
  no context).
- ``LANE_MIN_ROWS`` lives here: the port's ops/pipeline.py has no query
  layer and dropped it.
- The staged edge set is the port's ``StagedEdges``.
- The typed refusals are the reference's, and only they fall back to the
  host path.  A CUDA build or launch error is not a refusal: it
  propagates.  ``remote_error`` covers only the kernel server's socket
  (a connection or an OS error); an error the daemon reports propagates.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np

from ...device import resolve_device
from ..frontend import ast as A
from . import operators as Op
from .parallel import (COLUMNAR, ParallelExpandAggregate, ParallelOrderedScan,
                       ParallelScanAggregate, _as_predicate, _gid_rows,
                       _pred_mask, _split_and, _Unsupported)

log = logging.getLogger(__name__)

DISABLE_ENV = "MEMGRAPH_TPU_DISABLE_LANE"
REMOTE_ENV = "MEMGRAPH_TPU_LANE_REMOTE"

#: below this many rows a scan stays on the host (the reference's
#: ops/pipeline.py LANE_MIN_ROWS)
LANE_MIN_ROWS = int(os.environ.get("MEMGRAPH_TPU_LANE_MIN_ROWS", 4096))

_DEVICE_AGGS = ("count", "sum", "min", "max")


def _lane_min_rows() -> int:
    """Read per-call so tests/benches can tune without re-imports."""
    try:
        return int(os.environ.get("MEMGRAPH_TPU_LANE_MIN_ROWS",
                                  LANE_MIN_ROWS))
    except ValueError:
        return LANE_MIN_ROWS


def _device(ctx):
    """The device an execution's lane programs run on: its interpreter
    context's, else the card."""
    ictx = getattr(ctx, "interpreter_context", None)
    return resolve_device(getattr(ictx, "device", None))


def _registry():
    from ...ops import pipeline
    return pipeline.LANE_REGISTRY


def _note_fallback(fingerprint, reason: str, detail: str = "") -> None:
    """LOUD, typed: counted per fingerprint + debug-logged."""
    _registry().note_fallback(fingerprint, reason)
    log.debug("lane fallback (%s) fp=%s %s", reason, fingerprint, detail)


# --------------------------------------------------------------------------
# predicate admission (host semantics -> device spec)
# --------------------------------------------------------------------------


def _device_pred(col, op: str, rhs):
    """Mirror of parallel._pred_mask admission: returns the int32 rhs
    for a device compare, or raises LaneRefused with the typed reason
    routing this query to the host path (which owns the exact
    semantics for every refused case)."""
    from ...ops import pipeline as pl
    if rhs is None:
        raise pl.LaneRefused("null_rhs")
    if col.kind == "other":
        if not col.present.any():
            # vacuous column (property absent everywhere): the fused
            # presence mask alone excludes every row, any rhs works
            return 0
        raise pl.LaneRefused("column_kind")
    if isinstance(rhs, bool):
        if col.kind != "bool":
            raise pl.LaneRefused("type_mismatch")
        return 1 if rhs else 0
    if isinstance(rhs, int):
        if col.kind != "int":
            raise pl.LaneRefused("type_mismatch" if col.kind != "float"
                                 else "float_column")
        if not -(2**31) < rhs < 2**31 or col.big \
                or pl.i32_column(col) is None:
            raise pl.LaneRefused("big_int")
        return rhs
    if isinstance(rhs, float):
        raise pl.LaneRefused("float_rhs")
    if isinstance(rhs, str):
        if col.kind != "str":
            raise pl.LaneRefused("type_mismatch")
        if op not in ("=", "<>"):
            raise pl.LaneRefused("str_order")
        code = col.vocab.get(rhs)
        if code is None:
            raise pl.LaneRefused("vocab_miss")
        return int(code)
    raise pl.LaneRefused("rhs_kind")


def _stack_columns(snap, needed: list):
    """Stack the needed columns as (C, n) int32 values + bool presence;
    ``needed`` maps prop name -> column. Count-only columns ("other"
    kinds) contribute presence with zero values."""
    from ...ops import pipeline as pl
    n = snap.n
    vals = np.zeros((len(needed), n), dtype=np.int32)
    present = np.zeros((len(needed), n), dtype=bool)
    index: dict[str, int] = {}
    for i, (prop, need_values) in enumerate(needed):
        col = snap.columns[prop]
        index[prop] = i
        present[i] = col.present
        if need_values:
            v = pl.i32_column(col)
            if v is None:
                raise pl.LaneRefused(
                    "float_column" if col.kind == "float" else
                    ("big_int" if col.kind == "int" else "column_kind"))
            vals[i] = v
        elif col.values is not None:
            v = pl.i32_column(col)
            if v is not None:
                vals[i] = v
    return vals, present, index


# --------------------------------------------------------------------------
# compiled scan / expand aggregate
# --------------------------------------------------------------------------


class _LaneAggMixin:
    """Device-first cursor shared by the scan and expand aggregates."""

    def cursor(self, ctx):
        from ...ops import pipeline as pl
        row = None
        ok = False
        try:
            row = self._device_row(ctx)
            ok = True
        except pl.LaneRefused as e:
            _note_fallback(self.fingerprint, e.reason, str(e))
        except _Unsupported:
            _note_fallback(self.fingerprint, "columnar_unsupported")
        if ok:
            _registry().note_hit(self.fingerprint)
            yield row
            return
        yield from super().cursor(ctx)

    def _device_row(self, ctx) -> dict:
        from ...ops import pipeline as pl
        if self.group_by:
            raise pl.LaneRefused("group_by")
        for kind, _prop, _name in self.aggregations:
            if kind not in _DEVICE_AGGS:
                raise pl.LaneRefused(f"agg_{kind}")
        if not COLUMNAR._cacheable(ctx.accessor):
            raise pl.LaneRefused("mvcc_private")
        snap, base = self._snapshot_base(ctx)
        if snap.n < _lane_min_rows() and not self.hinted:
            raise pl.LaneRefused("small_input")

        # admission first (host semantics decide the typed reason),
        # then one fused device program over the stacked columns
        rhs_values = []
        for prop, op, rhs_expr in self.predicates:
            rhs = ctx.evaluator.eval(rhs_expr, {})
            rhs_values.append(_device_pred(snap.columns[prop], op, rhs))

        needed: list = []
        order: dict[str, int] = {}

        def need(prop, values_needed):
            if prop in order:
                if values_needed and not needed[order[prop]][1]:
                    needed[order[prop]] = (prop, True)
                return
            order[prop] = len(needed)
            needed.append((prop, values_needed))

        for prop, _op, _rhs in self.predicates:
            need(prop, snap.columns[prop].kind != "other")
        for kind, prop, _name in self.aggregations:
            if prop is None:
                continue
            if kind != "count":
                # sum/min/max: the row path aggregates NUMERICS only
                # (min over strings etc. is the row fallback's job) —
                # and the device lane's exactness discipline admits
                # int32 of those; floats go to the host columnar path
                ckind = snap.columns[prop].kind
                if ckind != "int":
                    raise pl.LaneRefused(
                        "float_column" if ckind == "float"
                        else "column_kind")
            need(prop, kind != "count")
        vals, present, index = _stack_columns(snap, needed)

        preds = tuple((index[prop], op)
                      for prop, op, _ in self.predicates)
        aggs = tuple((kind, index[prop] if prop is not None else None)
                     for kind, prop, _ in self.aggregations)
        if base is None:
            base = np.ones(snap.n, dtype=bool)
        out = pl.masked_aggregate(preds, aggs, vals, present, base,
                                  rhs_values,
                                  fingerprint=self.fingerprint,
                                  device=_device(ctx))
        row = {}
        for (kind, _prop, name), value in zip(self.aggregations, out):
            if kind == "sum" and value is None:
                value = 0
            row[name] = value
        return row


@dataclass
class ParallelScanAggregateLane(_LaneAggMixin, ParallelScanAggregate):
    """Device-first ParallelScanAggregate (class name extends the base
    so EXPLAIN/operator counters keep their established vocabulary)."""
    fingerprint: Optional[str] = None


@dataclass
class ParallelExpandAggregateLane(_LaneAggMixin, ParallelExpandAggregate):
    fingerprint: Optional[str] = None


# --------------------------------------------------------------------------
# compiled 1-2 hop counts (masked plus_first SpMV chain)
# --------------------------------------------------------------------------


@dataclass
class LaneHopCount(Op.LogicalOperator):
    """Aggregate <- [Filter] <- 1-2 hop expand <- [Filter] <- Scan,
    where every aggregation is a path/row count — lowered to a masked
    frontier SpMV chain with the self-loop edge-uniqueness correction
    (count(DISTINCT target) is the reachability popcount epilogue)."""
    input: Op.LogicalOperator            # Once
    fallback: Op.LogicalOperator         # the original Aggregate subplan
    source: tuple                        # ("label", l) | ("all",) |
    #                                      ("label_prop_eq", l, p, expr)
    src_label: Optional[str]
    src_preds: list
    mid_label: Optional[str]
    mid_preds: list
    dst_label: Optional[str]
    dst_preds: list
    direction: str                       # out | in
    edge_types: Optional[list]
    hops: int
    include_lower: bool
    edge_unique: bool
    row_aggs: list                       # output names: plain counts
    distinct_aggs: list                  # output names: count(DISTINCT m)
    hinted: bool = False
    fingerprint: Optional[str] = None

    def cursor(self, ctx):
        from ...ops import pipeline as pl
        row = None
        ok = False
        try:
            row = self._device_row(ctx)
            ok = True
        except pl.LaneRefused as e:
            _note_fallback(self.fingerprint, e.reason, str(e))
        except _Unsupported:
            _note_fallback(self.fingerprint, "columnar_unsupported")
        if ok:
            _registry().note_hit(self.fingerprint)
            yield row
            return
        yield from self.fallback.cursor(ctx)

    # -- device path -------------------------------------------------------

    def _role_mask(self, ctx, full, f_sorted, f_order, label, preds,
                   as_float: bool):
        """Predicate/label mask for one pattern role, lifted into the
        full-vertex index space (host _pred_mask semantics: exact)."""
        n = full.n
        if label is None and not preds:
            return (np.ones(n, dtype=np.float32) if as_float
                    else np.ones(n, dtype=bool))
        props = tuple(sorted({p for p, _, _ in preds}))
        snap = COLUMNAR.get(ctx.accessor, label, props, ctx.view,
                                  abort_check=ctx.check_abort)
        mask = np.ones(snap.n, dtype=bool)
        for prop, op, rhs_expr in preds:
            mask &= _pred_mask(ctx, snap, prop, op, rhs_expr)
        rows = _gid_rows(f_sorted, f_order, snap.gids)
        sel = mask & (rows >= 0)
        out = np.zeros(n, dtype=np.float32 if as_float else bool)
        out[rows[sel]] = 1.0 if as_float else True
        return out

    def _device_row(self, ctx) -> dict:
        from ...ops import pipeline as pl
        if not COLUMNAR._cacheable(ctx.accessor):
            raise pl.LaneRefused("mvcc_private")
        if self.source[0] == "label_prop_eq" and not self.hinted:
            # a point source expands O(degree^2) rows; the device sweep
            # is O(E) — the row path IS the fast path here
            raise pl.LaneRefused("small_frontier")
        acc = ctx.accessor
        edges = COLUMNAR.get_edges(acc, (), ctx.view,
                                         abort_check=ctx.check_abort)
        ctx.check_abort()
        if edges.n < _lane_min_rows() and not self.hinted:
            raise pl.LaneRefused("small_input")
        full = COLUMNAR.get(acc, None, (), ctx.view,
                                  abort_check=ctx.check_abort)
        ctx.check_abort()

        # per-version staging, cached on the snapshots themselves
        f_order = getattr(full, "_lane_order", None)
        if f_order is None:
            f_order = np.argsort(full.gids, kind="stable")
            full._lane_order = f_order
            full._lane_sorted = full.gids[f_order]
        f_sorted = full._lane_sorted
        endpoints = getattr(edges, "_lane_endpoints", None)
        if endpoints is None:
            s_idx = _gid_rows(f_sorted, f_order, edges.src)
            d_idx = _gid_rows(f_sorted, f_order, edges.dst)
            endpoints = (s_idx.astype(np.int32), d_idx.astype(np.int32),
                         (s_idx >= 0) & (d_idx >= 0))
            edges._lane_endpoints = endpoints
        s_idx, d_idx, ep_ok = endpoints

        emask = ep_ok
        tkey = tuple(sorted(self.edge_types or ()))
        if self.edge_types:
            cache = getattr(edges, "_lane_typemask", None)
            if cache is None:
                cache = edges._lane_typemask = {}
            tmask_e = cache.get(tkey)
            if tmask_e is None:
                ids = [tid for tid in
                       (ctx.storage.edge_type_mapper.maybe_name_to_id(t)
                        for t in self.edge_types) if tid is not None]
                tmask_e = np.isin(edges.type_ids,
                                  np.asarray(ids, dtype=np.int32))
                cache[tkey] = tmask_e
            emask = emask & tmask_e

        src_preds = list(self.src_preds)
        if self.source[0] == "label_prop_eq":
            src_preds.append((self.source[2], "=", self.source[3]))
        smask = self._role_mask(ctx, full, f_sorted, f_order,
                                self.src_label, src_preds, False)
        midmask = self._role_mask(ctx, full, f_sorted, f_order,
                                  self.mid_label, self.mid_preds, True)
        tmask = self._role_mask(ctx, full, f_sorted, f_order,
                                self.dst_label, self.dst_preds, True)
        if self.direction == "in":
            s_idx, d_idx = d_idx, s_idx

        kwargs = dict(hops=self.hops, include_lower=self.include_lower,
                      edge_unique=self.edge_unique,
                      need_rows=bool(self.row_aggs),
                      need_distinct=bool(self.distinct_aggs))
        if os.environ.get(REMOTE_ENV):
            totals = self._remote(s_idx, d_idx, emask, smask, midmask,
                                  tmask, full.n, kwargs, _device(ctx))
        else:
            # edge arrays stay device-resident per (version, types,
            # direction): repeat queries move only the O(n) masks
            staged_cache = getattr(edges, "_lane_staged", None)
            if staged_cache is None:
                staged_cache = edges._lane_staged = {}
            dev = _device(ctx)
            skey = (tkey, self.direction, dev)
            staged = staged_cache.get(skey)
            if staged is None:
                staged = pl.stage_edges(s_idx, d_idx, emask, device=dev)
                staged_cache[skey] = staged
            totals = pl.hop_counts(staged, None, None,
                                   smask, midmask, tmask, full.n,
                                   fingerprint=self.fingerprint,
                                   **kwargs)
        row = {}
        for name in self.row_aggs:
            row[name] = totals["rows"]
        for name in self.distinct_aggs:
            row[name] = totals["distinct"]
        return row

    def _remote(self, s_idx, d_idx, emask, smask, midmask, tmask,
                n_nodes, kwargs, device) -> dict:
        """Dispatch the hop-count program through the kernel server
        (the same resident device plane every analytics op rides).  Only
        a failure of its socket is the typed ``remote_error``."""
        from ...ops import pipeline as pl
        from ...server import kernel_server as ks
        try:
            client = ks.shared_client(spawn=True, device=str(device))
            return client.lane_hops(
                s_idx, d_idx, emask, smask, midmask, tmask,
                n_nodes=n_nodes, **kwargs)
        except (ConnectionError, EOFError, OSError) as e:
            raise pl.LaneRefused("remote_error",
                                 f"{type(e).__name__}: {e}")


# --------------------------------------------------------------------------
# compiled top-k ORDER BY
# --------------------------------------------------------------------------


@dataclass
class ParallelOrderedScanLane(ParallelOrderedScan):
    """ParallelOrderedScan whose order is computed by one fused
    mask+stable-argsort device program (only instantiated under LIMIT,
    where lazy pulling makes the sort a top-k)."""
    fingerprint: Optional[str] = None

    def _columnar_order(self, ctx):
        from ...ops import pipeline as pl
        try:
            return self._device_order(ctx)
        except pl.LaneRefused as e:
            _note_fallback(self.fingerprint, e.reason, str(e))
            return super()._columnar_order(ctx)

    def _device_order(self, ctx):
        from ...ops import pipeline as pl
        if len(self.keys) != 1:
            raise pl.LaneRefused("multi_key")
        if not COLUMNAR._cacheable(ctx.accessor):
            raise pl.LaneRefused("mvcc_private")
        props = tuple(sorted({p for p, _, _ in self.predicates}
                             | {p for p, _ in self.keys}))
        snap = COLUMNAR.get(ctx.accessor, self.label, props,
                                  ctx.view, abort_check=ctx.check_abort)
        ctx.check_abort()
        if snap.n < _lane_min_rows() and not self.hinted:
            raise pl.LaneRefused("small_input")
        key_prop, asc = self.keys[0]
        kcol = snap.columns.get(key_prop)
        if kcol is None or kcol.kind != "int":
            raise pl.LaneRefused("topk_precision"
                                 if kcol is not None and
                                 kcol.kind == "float" else "column_kind")
        kv = pl.i32_column(kcol)
        if kv is None:
            raise pl.LaneRefused("big_int")
        f24ok = getattr(kcol, "_lane_f24ok", None)
        if f24ok is None:
            sel = kv[kcol.present]
            f24ok = bool(sel.size == 0
                         or int(np.abs(sel).max()) < (1 << 24))
            kcol._lane_f24ok = f24ok
        if not f24ok:
            raise pl.LaneRefused("topk_precision")

        rhs_values = []
        for prop, op, rhs_expr in self.predicates:
            rhs = ctx.evaluator.eval(rhs_expr, {})
            rhs_values.append(_device_pred(snap.columns[prop], op, rhs))
        needed = []
        order_map: dict = {}
        for prop, _op, _rhs in self.predicates:
            if prop not in order_map:
                order_map[prop] = len(needed)
                needed.append((prop, snap.columns[prop].kind != "other"))
        vals, present, index = _stack_columns(snap, needed)
        preds = tuple((index[prop], op)
                      for prop, op, _ in self.predicates)
        order, count = pl.masked_topk(
            preds, asc, vals, present, kv, kcol.present, rhs_values,
            fingerprint=self.fingerprint, device=_device(ctx))
        _registry().note_hit(self.fingerprint)
        order = order[order < snap.n][:count]
        return order, snap.gids


# --------------------------------------------------------------------------
# plan rewrite
# --------------------------------------------------------------------------


def _clone_as(cls, op, fingerprint=None):
    kw = {f.name: getattr(op, f.name) for f in fields(op)}
    kw["fingerprint"] = fingerprint
    return cls(**kw)


def _scan_source(node):
    """Scan leaf -> (source descriptor, label) or None."""
    if isinstance(node, Op.ScanAllByLabel):
        return ("label", node.label), node.label
    if isinstance(node, Op.ScanAll):
        return ("all",), None
    if isinstance(node, Op.ScanAllByLabelPropertyValue) \
            and len(node.properties) == 1:
        return (("label_prop_eq", node.label, node.properties[0],
                 node.value_exprs[0]), node.label)
    return None


def _match_hops(agg: Op.Aggregate, hinted: bool):
    """Match the 1-2 hop count tails the columnar expand collapse does
    not claim. Returns a LaneHopCount or None; near-misses (shape
    matched, feature refused) are counted as plan-time fallbacks."""
    if agg.remember or agg.group_by:
        return None

    def filters_of(node):
        out = []
        while isinstance(node, Op.Filter):
            out.append(node.expr)
            node = node.input
        return out, node

    upper, node = filters_of(agg.input)
    expands = []
    mid_filters: list = []
    if isinstance(node, Op.ExpandVariable):
        ev = node
        if ev.filter_lambda is not None or ev.prev_edge_symbols:
            return None
        if ev.direction not in ("out", "in"):
            return None
        if ev.from_symbol == ev.to_symbol:
            return None       # (a)-[*..]->(a): dst-bound constraint
        span = (ev.min_hops, ev.max_hops)
        if span not in ((1, 1), (2, 2), (1, 2)):
            return None
        hops = span[1]
        include_lower = span == (1, 2)
        edge_unique = True
        syms = {"src": ev.from_symbol, "mid": None, "dst": ev.to_symbol,
                "edges": {ev.edge_symbol}}
        direction = ev.direction
        edge_types = list(ev.edge_types or [])
        node = ev.input
    elif isinstance(node, Op.Expand) and type(node) is Op.Expand:
        e2 = node
        inner, node = filters_of(e2.input)
        if isinstance(node, Op.Expand) and type(node) is Op.Expand:
            e1 = node
            if e1.direction != e2.direction \
                    or e1.direction not in ("out", "in"):
                return None
            if e2.from_symbol != e1.to_symbol:
                return None
            named = {e1.from_symbol, e1.to_symbol, e2.to_symbol}
            if len(named) != 3 or e1.edge_symbol == e2.edge_symbol:
                return None
            if sorted(e1.edge_types or []) != sorted(e2.edge_types
                                                     or []):
                _registry().note_fallback(None, "edge_type_mix")
                return None
            hops, include_lower = 2, False
            edge_unique = e1.edge_symbol in (e2.prev_edge_symbols or [])
            syms = {"src": e1.from_symbol, "mid": e1.to_symbol,
                    "dst": e2.to_symbol,
                    "edges": {e1.edge_symbol, e2.edge_symbol}}
            direction = e1.direction
            edge_types = list(e1.edge_types or [])
            mid_filters = inner
            node = e1.input
        else:
            # single-hop counts normally ride the columnar expand
            # collapse; claim the leftovers here
            if e2.direction not in ("out", "in"):
                return None
            if e2.prev_edge_symbols or e2.from_symbol == e2.to_symbol:
                return None
            hops, include_lower, edge_unique = 1, False, True
            syms = {"src": e2.from_symbol, "mid": None,
                    "dst": e2.to_symbol, "edges": {e2.edge_symbol}}
            direction = e2.direction
            edge_types = list(e2.edge_types or [])
            upper = upper + inner
    else:
        return None

    lower, node = filters_of(node)
    src = _scan_source(node)
    if src is None or not isinstance(node.input, Op.Once) \
            or node.symbol != syms["src"]:
        return None
    source, src_label = src

    chain_syms = {syms["src"], syms["dst"]} | syms["edges"]
    if syms["mid"]:
        chain_syms.add(syms["mid"])
    row_aggs, distinct_aggs = [], []
    for spec in agg.aggregations:
        kind, expr, distinct, name = spec[0], spec[1], spec[2], spec[3]
        if len(spec) > 4 and spec[4] is not None:
            return None
        if kind != "count":
            _registry().note_fallback(None, f"agg_{kind}")
            return None
        if distinct:
            if isinstance(expr, A.Identifier) \
                    and expr.name == syms["dst"]:
                distinct_aggs.append(name)
                continue
            _registry().note_fallback(None, "agg_distinct")
            return None
        if expr is None:
            row_aggs.append(name)
            continue
        if isinstance(expr, A.Identifier) and expr.name in chain_syms:
            # count over a chain symbol: never null in an expand row
            row_aggs.append(name)
            continue
        _registry().note_fallback(None, "agg_unsupported")
        return None

    role_preds = {"src": [], "mid": [], "dst": []}
    role_labels = {"src": src_label, "mid": None, "dst": None}
    sym_role = {syms["src"]: "src", syms["dst"]: "dst"}
    if syms["mid"]:
        sym_role[syms["mid"]] = "mid"
    for cond_src in (upper, mid_filters, lower):
        for f in cond_src:
            for cond in _split_and(f):
                if isinstance(cond, A.LabelsTest) and \
                        isinstance(cond.expr, A.Identifier) and \
                        cond.expr.name in sym_role and \
                        len(cond.labels) == 1:
                    role = sym_role[cond.expr.name]
                    if role == "src" and src_label == cond.labels[0]:
                        continue
                    if role_labels[role] is None:
                        role_labels[role] = cond.labels[0]
                        continue
                    return None
                matched = False
                for sym, role in sym_role.items():
                    pred = _as_predicate(cond, sym, None)
                    if pred is not None and pred != ():
                        role_preds[role].append(pred)
                        matched = True
                        break
                if not matched:
                    for esym in syms["edges"]:
                        if _as_predicate(cond, esym, None):
                            _registry().note_fallback(None, "edge_prop")
                            return None
                    _registry().note_fallback(None, "dynamic_predicate")
                    return None

    return LaneHopCount(
        input=Op.Once(), fallback=agg, source=source,
        src_label=role_labels["src"], src_preds=role_preds["src"],
        mid_label=role_labels["mid"], mid_preds=role_preds["mid"],
        dst_label=role_labels["dst"], dst_preds=role_preds["dst"],
        direction=direction, edge_types=edge_types, hops=hops,
        include_lower=include_lower, edge_unique=edge_unique,
        row_aggs=row_aggs, distinct_aggs=distinct_aggs, hinted=hinted)


def lane_rewrite(plan, hinted: bool = False):
    """Lower lane-eligible operators in place (runs after
    parallel_rewrite; disabled alongside it — the lane is the device
    extension of the columnar rewrite, not an independent strategy)."""
    if os.environ.get(DISABLE_ENV) \
            or os.environ.get("MEMGRAPH_TPU_DISABLE_PARALLEL"):
        return plan

    changed = [False]

    def walk(op):
        if isinstance(op, ParallelExpandAggregate) \
                and not isinstance(op, ParallelExpandAggregateLane):
            changed[0] = True
            op = _clone_as(ParallelExpandAggregateLane, op)
        elif isinstance(op, ParallelScanAggregate) \
                and not isinstance(op, (ParallelExpandAggregate,
                                        ParallelScanAggregateLane)):
            changed[0] = True
            op = _clone_as(ParallelScanAggregateLane, op)
        elif isinstance(op, Op.Aggregate):
            repl = _match_hops(op, hinted)
            if repl is not None:
                changed[0] = True
                return repl             # fallback subplan stays pristine
        elif isinstance(op, (Op.Limit, Op.Skip)):
            inner = op.input
            produce = inner if isinstance(inner, Op.Produce) else None
            if produce is not None and isinstance(
                    produce.input, ParallelOrderedScan) and not \
                    isinstance(produce.input, ParallelOrderedScanLane):
                changed[0] = True
                produce.input = _clone_as(ParallelOrderedScanLane,
                                          produce.input)
        if not hasattr(op, "__dataclass_fields__"):
            return op
        for f in fields(op):
            if f.name == "fallback":
                continue            # row-path subplans stay pristine
            v = getattr(op, f.name)
            if isinstance(v, Op.LogicalOperator):
                setattr(op, f.name, walk(v))
        return op

    plan = walk(plan)
    if changed[0]:
        try:
            plan._has_lane = True
        except (AttributeError, TypeError):
            pass
    return plan


def bind_fingerprints(plan, fingerprint: str) -> None:
    """Stamp the mgstat plan-cache fingerprint onto every lane operator
    (the compile-cache key + the per-fingerprint stats bucket)."""
    if not getattr(plan, "_has_lane", False):
        return

    def walk(op):
        if hasattr(op, "fingerprint"):
            op.fingerprint = fingerprint
        if not hasattr(op, "__dataclass_fields__"):
            return
        for f in fields(op):
            v = getattr(op, f.name)
            if isinstance(v, Op.LogicalOperator):
                walk(v)

    walk(plan)


def invalidate_lanes() -> None:
    """Drop every compiled lane program. Wired into
    InterpreterContext.invalidate_plans, so every schema change that
    drops cached plans (index/constraint DDL, ANALYZE GRAPH,
    statistics) also drops the lanes compiled under them."""
    from ...ops import pipeline
    pipeline.drop_programs()
