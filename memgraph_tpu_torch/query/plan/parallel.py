"""Intra-query parallel execution: columnar scan+filter+aggregate.

TPU-first analog of the reference's parallel operators
(memgraph/src/query/plan/operator.hpp:1925-2273 — ScanAllParallel,
AggregateParallelBase, ParallelMerge — and the plan rewriter in
plan/rewrite/parallel_rewrite.hpp). Instead of sharding the Volcano
iterator across a thread pool, an eligible
    Produce <- Aggregate <- Filter* <- ScanAll[ByLabel] <- Once
tail is collapsed into ONE operator that evaluates the filters and
aggregates as whole-column vectorized kernels over a cached columnar
snapshot (ops/columnar.py). Anything the columnar engine cannot express
falls back to the original row-at-a-time subplan at runtime — semantics
are identical by construction, the rewrite is purely an execution
strategy.

Eligibility (matched at plan time):
  - Aggregate with no GROUP BY keys, aggregations in
    count(*)/count/sum/min/max/avg, non-DISTINCT, over a property of the
    scanned symbol;
  - filters that AND-decompose into `sym.prop <op> literal/parameter`
    (op in =, <>, <, <=, >, >=) or a redundant label test on the scan's
    own label.

Cypher three-valued logic is preserved: a predicate over an absent
property is NULL -> row excluded; cross-type equality is false; ordering
comparisons across types are NULL (both exclude); count/sum over zero
rows are 0, min/max/avg are NULL.

Copy of memgraph_tpu/query/plan/parallel.py for the port (its imports the port's own).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np

from ...ops.columnar import COLUMNAR_CACHE, export_columns
from ...storage.source import ScanSource
from ..frontend import ast as A
from . import operators as Op

_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}
_AGG_KINDS = {"count", "sum", "min", "max", "avg"}

# below this row count the row-at-a-time path is cheaper than a column
# sweep (and than a device dispatch, once offloaded); hints force through
MIN_ROWS = int(os.environ.get("MEMGRAPH_TPU_PARALLEL_MIN_ROWS", 1024))


class _Unsupported(Exception):
    pass


class _NoVertices:
    """The source of a label the storage has never seen: no vertex."""

    def vertices(self, label_filter=None):
        return []

    def vertex_property(self, name, gids):
        return None


class AccessorColumns:
    """The reference's ``ColumnarCache`` calls (an accessor, a label name,
    a view) over the port's ``ops.columnar.COLUMNAR_CACHE``, which reads a
    source and keys on label ids: a ``ScanSource`` of the accessor at the
    view, its ``cacheable`` deciding whether the snapshot is shared."""

    def get(self, accessor, label, props, view, abort_check=None):
        lid = None
        if label is not None:
            lid = accessor.storage.label_mapper.maybe_name_to_id(label)
            if lid is None:
                return export_columns(_NoVertices(), None, tuple(props))
        return COLUMNAR_CACHE.get(ScanSource(accessor, view), lid,
                                  tuple(props), abort_check)

    def get_edges(self, accessor, props, view, abort_check=None):
        return COLUMNAR_CACHE.get_edges(ScanSource(accessor, view),
                                        tuple(props), abort_check)

    def _cacheable(self, accessor) -> bool:
        return ScanSource(accessor).cacheable


COLUMNAR = AccessorColumns()


@dataclass
class ParallelScanAggregate(Op.LogicalOperator):
    """Single-operator columnar scan+filter+aggregate with row fallback."""
    input: Op.LogicalOperator          # Once
    fallback: Op.LogicalOperator       # the original Aggregate subplan
    symbol: str
    label: Optional[str]
    predicates: list                   # [(prop, op, rhs A.Expr), ...]
    aggregations: list                 # [(kind, prop|None, out name), ...]
    group_by: list = None              # [(prop, out name), ...] | None
    hinted: bool = False

    def cursor(self, ctx):
        try:
            if self.group_by:
                rows = self._columnar_groups(ctx)
            else:
                rows = [self._columnar_row(ctx)]
        except _Unsupported:
            yield from self.fallback.cursor(ctx)
            return
        yield from rows

    # -- columnar path ----------------------------------------------------

    def _snapshot_base(self, ctx, extra_props=()):
        """Columnar snapshot + base validity mask (None = every row),
        BEFORE predicates — the compiled lane (query/plan/lane.py)
        shares this and fuses the predicate masks into its device
        program instead of applying them host-side."""
        props = tuple(sorted(
            {p for p, _, _ in self.predicates}
            | {p for _, p, _ in self.aggregations if p is not None}
            | set(extra_props)))
        snap = COLUMNAR.get(ctx.accessor, self.label, props,
                                  ctx.view, abort_check=ctx.check_abort)
        ctx.check_abort()
        if snap.n < MIN_ROWS and not self.hinted:
            raise _Unsupported
        return snap, None

    def _snapshot_and_mask(self, ctx, extra_props=()):
        """Shared preamble: columnar snapshot + predicate mask."""
        snap, base = self._snapshot_base(ctx, extra_props)
        mask = np.ones(snap.n, dtype=bool) if base is None \
            else base.copy()
        for prop, op, rhs_expr in self.predicates:
            mask &= _pred_mask(ctx, snap, prop, op, rhs_expr)
        return snap, mask

    def _columnar_row(self, ctx) -> dict:
        snap, mask = self._snapshot_and_mask(ctx)
        out: dict = {}
        for kind, prop, name in self.aggregations:
            out[name] = self._aggregate(snap, mask, kind, prop)
        return out

    def _columnar_groups(self, ctx) -> list:
        """Grouped aggregation: np.unique-keyed groups in FIRST-SEEN
        order (matching the hash aggregation's emission order)."""
        snap, mask = self._snapshot_and_mask(
            ctx, extra_props=[p for p, _ in self.group_by])
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return []                   # grouped agg over 0 rows: no rows

        # composite group key: per-key (presence, value) columns. Mixed
        # or exotic columns fall back; big ints would merge under the
        # composite's float64 promotion; mixed numerics lose the
        # original per-row value type the row path emits.
        key_cols = []
        decoders = []
        for prop, _name in self.group_by:
            col = snap.columns.get(prop)
            if col is None or col.kind == "other":
                if col is not None and not col.present.any():
                    key_cols.append(np.zeros(idx.size, dtype=np.int8))
                    decoders.append(("null", None))
                    continue
                raise _Unsupported
            if (col.kind == "int" and col.big) or                     (col.kind == "float" and col.mixed):
                raise _Unsupported
            present = col.present[idx]
            vals = np.where(present, col.values[idx], 0)
            key_cols.append(np.where(present, 1, 0).astype(np.int8))
            key_cols.append(vals)
            decoders.append((col.kind, col))
        combo = np.stack(key_cols, axis=1)
        _, first_pos, inverse = np.unique(
            combo, axis=0, return_index=True, return_inverse=True)
        n_groups = first_pos.size
        # emission order = first appearance of each group
        emit_order = np.argsort(first_pos, kind="stable")

        out_rows = [dict() for _ in range(n_groups)]
        # group key values (decoded back to engine values)
        ki = 0
        for (kind, col), (prop, name) in zip(decoders, self.group_by):
            if kind == "null":
                for g in range(n_groups):
                    out_rows[g][name] = None
                ki += 1
                continue
            pres_col = key_cols[ki]
            val_col = key_cols[ki + 1]
            ki += 2
            decode = _vocab_decode(col) if kind == "str" else None
            for g in range(n_groups):
                row0 = first_pos[g]
                if not pres_col[row0]:
                    out_rows[g][name] = None
                elif kind == "str":
                    out_rows[g][name] = decode[val_col[row0]]
                elif kind == "bool":
                    out_rows[g][name] = bool(val_col[row0])
                elif kind == "int":
                    out_rows[g][name] = int(val_col[row0])
                else:
                    out_rows[g][name] = float(val_col[row0])

        for kind, prop, name in self.aggregations:
            if kind == "count" and prop is None:
                counts = np.bincount(inverse, minlength=n_groups)
                for g in range(n_groups):
                    out_rows[g][name] = int(counts[g])
                continue
            col = snap.columns[prop]
            present = col.present[idx]
            if kind == "count":
                # needs only presence: works for EVERY column kind
                counts = np.bincount(inverse[present],
                                     minlength=n_groups)
                for g in range(n_groups):
                    out_rows[g][name] = int(counts[g])
                continue
            if col.kind not in ("int", "float"):
                raise _Unsupported
            if col.kind == "int" and col.big:
                raise _Unsupported
            vals = col.values[idx]
            sel = present
            counts = np.bincount(inverse[sel], minlength=n_groups)
            if kind in ("min", "max"):
                fvals = vals.astype(np.float64)
                fill = np.inf if kind == "min" else -np.inf
                acc = np.full(n_groups, fill)
                ufn = np.minimum if kind == "min" else np.maximum
                ufn.at(acc, inverse[sel], fvals[sel])
                for g in range(n_groups):
                    if counts[g] == 0:
                        out_rows[g][name] = None
                    elif col.kind == "int":
                        out_rows[g][name] = int(acc[g])
                    else:
                        out_rows[g][name] = float(acc[g])
                continue
            if col.kind == "int":
                # EXACT int accumulation (np.add.at on int64); the row
                # path sums arbitrary-precision python ints, so guard
                # potential int64 wrap the same way the ungrouped path
                # guards float drift
                sel_vals = vals[sel]
                if sel_vals.size and int(np.abs(sel_vals).max()) >                         (2**62) // max(int(counts.max()), 1):
                    sums = [0] * n_groups
                    for gi, v in zip(inverse[sel], sel_vals):
                        sums[gi] += int(v)
                else:
                    acc = np.zeros(n_groups, dtype=np.int64)
                    np.add.at(acc, inverse[sel], sel_vals)
                    sums = acc
            else:
                sums = np.bincount(inverse[sel],
                                   weights=vals[sel].astype(np.float64),
                                   minlength=n_groups)
            for g in range(n_groups):
                if kind == "sum":
                    out_rows[g][name] = (int(sums[g])
                                         if col.kind == "int"
                                         else float(sums[g]))
                else:                   # avg
                    out_rows[g][name] = (float(sums[g] / counts[g])
                                         if counts[g] else None)
        return [out_rows[g] for g in emit_order]

    def _aggregate(self, snap, mask, kind, prop):
        if kind == "count" and prop is None:
            return int(mask.sum())
        col = snap.columns[prop]
        sel = mask & col.present
        if kind == "count":
            return int(sel.sum())
        if col.kind not in ("int", "float"):
            raise _Unsupported      # sum/min/max/avg over non-numerics
        vals = col.values[sel]
        if kind == "sum":
            if vals.size == 0:
                return 0
            if col.kind == "int":
                # int64 accumulation can wrap; the row path sums exact
                # Python ints. Guard: re-sum exactly when magnitudes
                # could overflow.
                if int(np.abs(vals).max()) > (2**62) // max(vals.size, 1):
                    return sum(int(v) for v in vals)
                return int(vals.sum())
            return float(vals.sum())
        if vals.size == 0:
            return None             # min/max/avg over no rows
        if kind == "min":
            m = vals.min()
        elif kind == "max":
            m = vals.max()
        else:
            return float(vals.mean())
        return int(m) if col.kind == "int" else float(m)



def _gid_rows(sorted_gids: np.ndarray, order: np.ndarray,
              query: np.ndarray) -> np.ndarray:
    """Vectorized gid -> row lookup: returns row indices into the
    original (unsorted) gid array, -1 where absent."""
    if len(sorted_gids) == 0:   # empty endpoint snapshot: nothing matches
        return np.full(len(query), -1, dtype=np.int64)
    pos = np.searchsorted(sorted_gids, query)
    pos_c = np.clip(pos, 0, len(sorted_gids) - 1)
    hit = sorted_gids[pos_c] == query
    return np.where(hit, order[pos_c], -1)


def _gather_column(col, rows: np.ndarray, valid: np.ndarray):
    """Column indexed at `rows` (edge-aligned): rows<0 or ~valid are
    absent. Shares vocab and exactness flags with the source column."""
    from ...ops.columnar import Column
    ok = valid & (rows >= 0)
    rows_c = np.clip(rows, 0, max(len(col.present) - 1, 0))
    if len(col.present) == 0:
        return Column(col.kind, None if col.values is None
                      else col.values[:0], np.zeros(len(rows), dtype=bool),
                      col.vocab, col.big, col.mixed)
    present = ok & col.present[rows_c]
    values = None if col.values is None else col.values[rows_c]
    return Column(col.kind, values, present, col.vocab, col.big, col.mixed)


@dataclass
class ParallelExpandAggregate(ParallelScanAggregate):
    """Columnar collapse of a single-hop expand+aggregate tail:

        Aggregate <- Filter* <- Expand <- Filter* <- ScanAll[ByLabel] <- Once

    One row per visible edge (oriented by `direction`); endpoint
    properties are gathered from the label-restricted vertex snapshots
    via vectorized gid lookups, so predicates/aggregations/group-keys
    run as the same whole-column kernels as ParallelScanAggregate —
    property keys are role-qualified: "n0.x" (scan node), "n1.x"
    (expanded node), "e.x" (edge). Inherits the grouped/ungrouped
    aggregation kernels unchanged.

    Reference analog: the parallel Expand+Aggregate pipelines the
    enterprise rewriter builds (plan/rewrite/parallel_rewrite.hpp); here
    the edge table IS the parallel axis, matching how the MXU kernels
    treat edges (ops/spmv_mxu.py).
    """
    b_label: Optional[str] = None      # LabelsTest on the expanded node
    direction: str = "out"
    edge_types: Optional[list] = None

    def _snapshot_and_mask(self, ctx, extra_props=()):
        snap, valid = self._snapshot_base(ctx, extra_props)
        mask = valid.copy()
        for key, op, rhs_expr in self.predicates:
            mask &= _pred_mask(ctx, snap, key, op, rhs_expr)
        return snap, mask

    def _snapshot_base(self, ctx, extra_props=()):
        """Edge-aligned columnar snapshot + orientation validity mask,
        BEFORE predicates (shared with the compiled lane)."""
        from ...ops.columnar import ColumnarSnapshot
        role_props: dict = {"n0": set(), "n1": set(), "e": set()}
        for key, _, _ in self.predicates:
            role, _, prop = key.partition(".")
            role_props[role].add(prop)
        for _, key, _ in self.aggregations:
            if key is not None:
                role, _, prop = key.partition(".")
                role_props[role].add(prop)
        for key in extra_props:
            role, _, prop = key.partition(".")
            role_props[role].add(prop)

        acc = ctx.accessor
        edges = COLUMNAR.get_edges(
            acc, tuple(sorted(role_props["e"])), ctx.view,
            abort_check=ctx.check_abort)
        ctx.check_abort()
        if edges.n < MIN_ROWS and not self.hinted:
            raise _Unsupported
        a_snap = COLUMNAR.get(acc, self.label,
                                    tuple(sorted(role_props["n0"])),
                                    ctx.view, abort_check=ctx.check_abort)
        b_snap = COLUMNAR.get(acc, self.b_label,
                                    tuple(sorted(role_props["n1"])),
                                    ctx.view, abort_check=ctx.check_abort)
        ctx.check_abort()

        type_mask = np.ones(edges.n, dtype=bool)
        if self.edge_types:
            ids = [tid for tid in
                   (ctx.storage.edge_type_mapper.maybe_name_to_id(t)
                    for t in self.edge_types) if tid is not None]
            type_mask = np.isin(edges.type_ids,
                                np.asarray(ids, dtype=np.int32))

        # orient rows: n0 = the scanned side, n1 = the expanded side
        if self.direction == "out":
            orientations = [(edges.src, edges.dst, None)]
        elif self.direction == "in":
            orientations = [(edges.dst, edges.src, None)]
        else:   # both: each edge row twice (u->v and v->u), a self-loop
            # only once — matching the row path's expand-both semantics
            not_loop = edges.src != edges.dst
            orientations = [(edges.src, edges.dst, None),
                            (edges.dst, edges.src, not_loop)]

        a_order = np.argsort(a_snap.gids, kind="stable")
        a_sorted = a_snap.gids[a_order]
        b_order = np.argsort(b_snap.gids, kind="stable")
        b_sorted = b_snap.gids[b_order]

        parts = []       # (edge_row_idx, a_rows, b_rows, valid)
        for n0_gids, n1_gids, extra_mask in orientations:
            a_rows = _gid_rows(a_sorted, a_order, n0_gids)
            b_rows = _gid_rows(b_sorted, b_order, n1_gids)
            valid = type_mask & (a_rows >= 0) & (b_rows >= 0)
            if extra_mask is not None:
                valid = valid & extra_mask
            parts.append((np.arange(edges.n), a_rows, b_rows, valid))
        erow = np.concatenate([p[0] for p in parts])
        a_rows = np.concatenate([p[1] for p in parts])
        b_rows = np.concatenate([p[2] for p in parts])
        valid = np.concatenate([p[3] for p in parts])

        snap = ColumnarSnapshot(n=len(erow), gids=edges.gids[erow])
        for prop in role_props["n0"]:
            snap.columns[f"n0.{prop}"] = _gather_column(
                a_snap.columns[prop], a_rows, valid)
        for prop in role_props["n1"]:
            snap.columns[f"n1.{prop}"] = _gather_column(
                b_snap.columns[prop], b_rows, valid)
        for prop in role_props["e"]:
            snap.columns[f"e.{prop}"] = _gather_column(
                edges.columns[prop], erow, valid)
        return snap, valid


def _pred_mask(ctx, snap, prop, op, rhs_expr) -> np.ndarray:
    rhs = ctx.evaluator.eval(rhs_expr, {})
    col = snap.columns[prop]
    n = snap.n
    if rhs is None:
        return np.zeros(n, dtype=bool)       # NULL comparison -> NULL
    if col.kind == "other":
        if not col.present.any():
            # vacuous column: no present value, every row excluded
            return np.zeros(n, dtype=bool)
        raise _Unsupported
    if isinstance(rhs, bool):
        if col.kind != "bool":
            return _type_mismatch(col, op, n)
        rhs_v: object = 1 if rhs else 0
    elif isinstance(rhs, (int, float)):
        if col.kind not in ("int", "float"):
            return _type_mismatch(col, op, n)
        # cross-dtype compare happens in float64; beyond 2^53 that
        # diverges from the row path's exact int-vs-float compare
        if col.kind == "int" and isinstance(rhs, float) and col.big:
            raise _Unsupported
        if col.kind == "float" and isinstance(rhs, int) \
                and not -2**53 <= rhs <= 2**53:
            raise _Unsupported
        rhs_v = rhs
    elif isinstance(rhs, str):
        if col.kind != "str":
            return _type_mismatch(col, op, n)
        if op not in ("=", "<>"):
            raise _Unsupported  # lexicographic order not dict-coded
        code = col.vocab.get(rhs)
        if code is None:
            return (np.zeros(n, dtype=bool) if op == "=" else
                    col.present.copy())
        eq = (col.values == code) & col.present
        return eq if op == "=" else (~eq & col.present)
    else:
        raise _Unsupported                   # list/map/temporal rhs
    v = col.values
    if op == "=":
        m = v == rhs_v
    elif op == "<>":
        m = v != rhs_v
    elif op == "<":
        m = v < rhs_v
    elif op == "<=":
        m = v <= rhs_v
    elif op == ">":
        m = v > rhs_v
    else:
        m = v >= rhs_v
    return m & col.present

def _vocab_decode(col):
    """code -> string array for a dict-coded str column."""
    decode = np.empty(len(col.vocab), dtype=object)
    for s, code in col.vocab.items():
        decode[code] = s
    return decode


def _type_mismatch(col, op, n) -> np.ndarray:
    # Cypher: cross-type equality is false, <> is true (for non-null
    # values); ordering across types is NULL. All exclude on =/</...;
    # <> keeps every present row.
    if op == "<>":
        return col.present.copy()
    return np.zeros(n, dtype=bool)
# -------------------------------------------------------------------------
# plan rewrite
# -------------------------------------------------------------------------

def _split_and(expr):
    if isinstance(expr, A.Binary) and expr.op == "AND":
        return _split_and(expr.left) + _split_and(expr.right)
    return [expr]


def _as_predicate(cond, sym: str, label: Optional[str]):
    """Return (prop, op, rhs_expr) if `cond` is columnar-expressible on
    `sym`, None otherwise."""
    if isinstance(cond, A.LabelsTest) and \
            isinstance(cond.expr, A.Identifier) and cond.expr.name == sym \
            and label is not None and cond.labels == [label]:
        return ()  # redundant with the label scan: drop
    if not isinstance(cond, A.Binary) or cond.op not in _CMP_OPS:
        return None
    lhs, rhs, op = cond.left, cond.right, cond.op
    if not _is_prop_of(lhs, sym):
        if not _is_prop_of(rhs, sym):
            return None
        lhs, rhs = rhs, lhs
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    if not _is_const(rhs):
        return None
    return (lhs.prop, op, rhs)


def _is_const(e) -> bool:
    if isinstance(e, (A.Literal, A.Parameter)):
        return True
    return (isinstance(e, A.Unary) and e.op in ("-", "+")
            and isinstance(e.expr, A.Literal))


def _is_prop_of(e, sym: str) -> bool:
    return (isinstance(e, A.PropertyLookup)
            and isinstance(e.expr, A.Identifier) and e.expr.name == sym)


def _match_tail(agg: Op.Aggregate, hinted: bool):
    """Match Aggregate <- Filter* <- ScanAll[ByLabel] <- Once (with or
    without sym.prop GROUP BY keys)."""
    if agg.remember:
        return None
    aggregations = []
    for spec in agg.aggregations:
        kind, expr, distinct = spec[0], spec[1], spec[2]
        name = spec[3]
        if kind not in _AGG_KINDS or distinct:
            return None
        if len(spec) > 4 and spec[4] is not None:
            return None
        if expr is None:
            if kind != "count":
                return None
            aggregations.append((kind, None, name))
            continue
        if kind == "count" and isinstance(expr, A.Identifier):
            # count(n) over a scanned symbol == count(*): n is never null
            aggregations.append((kind, None, name))
            continue
        if not isinstance(expr, A.PropertyLookup) or \
                not isinstance(expr.expr, A.Identifier):
            return None
        aggregations.append((kind, expr.prop, name))

    filters = []
    node = agg.input
    while isinstance(node, Op.Filter):
        filters.append(node.expr)
        node = node.input
    if isinstance(node, Op.ScanAllByLabel):
        sym, label = node.symbol, node.label
    elif isinstance(node, Op.ScanAll):
        sym, label = node.symbol, None
    else:
        return None
    if not isinstance(node.input, Op.Once):
        return None
    # every aggregated expression must target the scanned symbol
    for spec in agg.aggregations:
        expr = spec[1]
        if expr is None:
            continue
        if isinstance(expr, A.Identifier):
            if expr.name != sym:
                return None
        elif expr.expr.name != sym:
            return None

    group_by = []
    for expr, name in agg.group_by:
        if not (isinstance(expr, A.PropertyLookup)
                and isinstance(expr.expr, A.Identifier)
                and expr.expr.name == sym):
            return None
        group_by.append((expr.prop, name))

    predicates = []
    for f in filters:
        for cond in _split_and(f):
            pred = _as_predicate(cond, sym, label)
            if pred is None:
                return None
            if pred == ():
                continue
            predicates.append(pred)
    return ParallelScanAggregate(
        input=Op.Once(), fallback=agg, symbol=sym, label=label,
        predicates=predicates, aggregations=aggregations,
        group_by=group_by, hinted=hinted)


def _match_expand_tail(agg: Op.Aggregate, hinted: bool):
    """Match Aggregate <- Filter* <- Expand <- Filter* <-
    ScanAll[ByLabel] <- Once (single hop, fresh to-symbol) and rewrite
    to ParallelExpandAggregate with role-qualified property keys."""
    if agg.remember:
        return None

    # walk the tail first so symbols are known for predicate targeting
    upper_filters = []
    node = agg.input
    while isinstance(node, Op.Filter):
        upper_filters.append(node.expr)
        node = node.input
    if not isinstance(node, Op.Expand) or type(node) is not Op.Expand:
        return None
    expand = node
    if expand.direction not in ("out", "in", "both"):
        return None
    if expand.from_symbol == expand.to_symbol:
        return None       # (a)-[]->(a): src==dst constraint not expressed
    if expand.prev_edge_symbols:
        return None
    lower_filters = []
    node = expand.input
    while isinstance(node, Op.Filter):
        lower_filters.append(node.expr)
        node = node.input
    if isinstance(node, Op.ScanAllByLabel):
        a_label = node.label
    elif isinstance(node, Op.ScanAll):
        a_label = None
    else:
        return None
    if node.symbol != expand.from_symbol or \
            not isinstance(node.input, Op.Once):
        return None
    roles = {expand.from_symbol: "n0", expand.to_symbol: "n1",
             expand.edge_symbol: "e"}

    def qualify(sym, prop):
        return f"{roles[sym]}.{prop}"

    aggregations = []
    for spec in agg.aggregations:
        kind, expr, distinct, name = spec[0], spec[1], spec[2], spec[3]
        if kind not in _AGG_KINDS or distinct:
            return None
        if len(spec) > 4 and spec[4] is not None:
            return None
        if expr is None:
            if kind != "count":
                return None
            aggregations.append((kind, None, name))
        elif kind == "count" and isinstance(expr, A.Identifier) \
                and expr.name in roles:
            # count(a)/count(r)/count(b): none can be null in an expand row
            aggregations.append((kind, None, name))
        elif isinstance(expr, A.PropertyLookup) and \
                isinstance(expr.expr, A.Identifier) and \
                expr.expr.name in roles:
            aggregations.append((kind, qualify(expr.expr.name, expr.prop),
                                 name))
        else:
            return None

    group_by = []
    for expr, name in agg.group_by:
        if not (isinstance(expr, A.PropertyLookup)
                and isinstance(expr.expr, A.Identifier)
                and expr.expr.name in roles):
            return None
        group_by.append((qualify(expr.expr.name, expr.prop), name))

    b_label = None
    predicates = []
    for f in upper_filters + lower_filters:
        for cond in _split_and(f):
            # label tests: scan label redundant; ONE single-label test on
            # the expanded node becomes the b-side snapshot restriction
            if isinstance(cond, A.LabelsTest) and \
                    isinstance(cond.expr, A.Identifier):
                sym = cond.expr.name
                if sym == expand.from_symbol and a_label is not None \
                        and cond.labels == [a_label]:
                    continue
                if sym == expand.to_symbol and len(cond.labels) == 1 \
                        and b_label is None:
                    b_label = cond.labels[0]
                    continue
                return None
            matched = False
            for sym in roles:
                pred = _as_predicate(cond, sym, None)
                if pred is not None and pred != ():
                    predicates.append((qualify(sym, pred[0]), pred[1],
                                       pred[2]))
                    matched = True
                    break
            if not matched:
                return None
    return ParallelExpandAggregate(
        input=Op.Once(), fallback=agg, symbol=expand.from_symbol,
        label=a_label, predicates=predicates, aggregations=aggregations,
        group_by=group_by, hinted=hinted, b_label=b_label,
        direction=expand.direction, edge_types=list(expand.edge_types))


@dataclass
class ParallelOrderedScan(Op.LogicalOperator):
    """Columnar ORDER BY over a scan tail: filters + sort keys evaluated
    as whole-column numpy kernels (argsort/lexsort) instead of per-row
    python comparisons — the OrderBy analog of ParallelScanAggregate
    (reference: operator.hpp:1925-2273 parallel operators). Yields SCAN
    frames in final order; the original Produce sits above unchanged.
    Falls back to the row-at-a-time OrderBy on anything the columnar
    engine cannot express (mixed-type columns, temporal keys, ...)."""
    input: Op.LogicalOperator          # Once
    fallback: Op.LogicalOperator       # OrderBy over the original tail
    symbol: str
    label: Optional[str]
    predicates: list
    keys: list                         # [(prop name, ascending)]
    hinted: bool = False

    def cursor(self, ctx):
        try:
            order, gids = self._columnar_order(ctx)
        except _Unsupported:
            yield from self.fallback.cursor(ctx)
            return
        find = ctx.accessor.find_vertex
        for i in order:
            ctx.check_abort()
            va = find(int(gids[i]), ctx.view)
            if va is not None:
                yield {self.symbol: va}

    def _columnar_order(self, ctx):
        props = tuple(sorted({p for p, _, _ in self.predicates}
                             | {p for p, _ in self.keys}))
        snap = COLUMNAR.get(ctx.accessor, self.label, props,
                                  ctx.view, abort_check=ctx.check_abort)
        ctx.check_abort()
        if snap.n < MIN_ROWS and not self.hinted:
            raise _Unsupported
        mask = np.ones(snap.n, dtype=bool)
        for prop, op, rhs_expr in self.predicates:
            mask &= _pred_mask(ctx, snap, prop, op, rhs_expr)
        idx = np.flatnonzero(mask)
        # np.lexsort: LAST key is primary -> feed reversed; each sort
        # item contributes (value_key, null_rank) with null_rank primary
        # within the item (openCypher: nulls last ascending, so first
        # under DESC reversal). Stable — tie order matches the row path.
        lex_keys = []
        for prop, asc in reversed(self.keys):
            col = snap.columns.get(prop)
            if col is None or (col.kind == "other"
                               and col.present.any()):
                raise _Unsupported
            if col.kind == "other":        # all-null column: constant key
                continue
            present = col.present[idx]
            nan_rank = np.zeros(len(idx), dtype=np.int8)
            if col.kind == "str":
                decode = np.concatenate([_vocab_decode(col),
                                         np.asarray([""], dtype=object)])
                codes = np.where(present, col.values[idx],
                                 len(col.vocab))
                strings = decode[codes].astype(str)
                uniq, ranks = np.unique(strings, return_inverse=True)
                vals = ranks.astype(np.int64)
            else:
                if col.kind == "int" and col.big:
                    # |v| > 2^53: float64 would merge distinct keys (the
                    # predicate path opts out for the same reason)
                    raise _Unsupported
                vals = col.values[idx].astype(np.float64)
                # openCypher orderability ranks NaN after +inf; negation
                # alone cannot move NaN, so rank it explicitly
                nan = np.isnan(vals)
                if nan.any():
                    vals = np.where(nan, 0.0, vals)
                    nan_rank = (np.where(nan, 1, 0) if asc
                                else np.where(nan, 0, 1)).astype(np.int8)
            if not asc:
                vals = -vals
            null_rank = (np.where(present, 0, 1) if asc
                         else np.where(present, 1, 0))
            lex_keys.append(vals)
            lex_keys.append(nan_rank)
            lex_keys.append(null_rank)     # primary within this item
        if not lex_keys:
            return np.arange(len(idx)), snap.gids[idx]
        order = np.lexsort(lex_keys)
        return order, snap.gids[idx]


def _match_orderby(ob: "Op.OrderBy", hinted: bool):
    """Match OrderBy <- Produce <- Filter* <- ScanAll[ByLabel] <- Once
    with every sort key a property of the scanned symbol."""
    produce = ob.input
    if not isinstance(produce, Op.Produce):
        return None
    filters = []
    node = produce.input
    while isinstance(node, Op.Filter):
        filters.append(node.expr)
        node = node.input
    if isinstance(node, Op.ScanAllByLabel):
        sym, label = node.symbol, node.label
    elif isinstance(node, Op.ScanAll):
        sym, label = node.symbol, None
    else:
        return None
    if not isinstance(node.input, Op.Once):
        return None
    # sort keys arrive either as sym.prop lookups or as projected ALIASES
    # of such lookups (plan_projection rewrites ORDER BY p.age -> age)
    alias_to_prop = {}
    for expr, name in produce.items:
        if isinstance(expr, A.PropertyLookup) and \
                isinstance(expr.expr, A.Identifier) and \
                expr.expr.name == sym:
            alias_to_prop[name] = expr.prop
    keys = []
    fallback_items = []
    for expr, asc in ob.items:
        if isinstance(expr, A.PropertyLookup) and \
                isinstance(expr.expr, A.Identifier) and \
                expr.expr.name == sym:
            prop = expr.prop
        elif isinstance(expr, A.Identifier) and expr.name in alias_to_prop:
            prop = alias_to_prop[expr.name]
        else:
            return None
        keys.append((prop, asc))
        # the fallback sorts PRE-projection frames: keys as sym.prop
        fallback_items.append(
            (A.PropertyLookup(A.Identifier(sym), prop), asc))
    predicates = []
    for f in filters:
        for cond in _split_and(f):
            pred = _as_predicate(cond, sym, label)
            if pred is None:
                return None
            if pred == ():
                continue
            predicates.append(pred)
    # fallback: row OrderBy over the ORIGINAL (unprojected) tail — the
    # Produce above re-projects either way
    fallback = Op.OrderBy(input=produce.input, items=fallback_items)
    scan = ParallelOrderedScan(
        input=Op.Once(), fallback=fallback, symbol=sym, label=label,
        predicates=predicates, keys=keys, hinted=hinted)
    return Op.Produce(input=scan, items=produce.items)


def parallel_rewrite(plan, hinted: bool = False):
    """Walk the plan, replacing eligible Aggregate and OrderBy tails in
    place. Reference analog: plan/rewrite/parallel_rewrite.hpp."""
    if os.environ.get("MEMGRAPH_TPU_DISABLE_PARALLEL"):
        return plan
    if isinstance(plan, Op.Aggregate):
        repl = _match_tail(plan, hinted)
        if repl is None:
            repl = _match_expand_tail(plan, hinted)
        if repl is not None:
            return repl
    if isinstance(plan, Op.OrderBy):
        repl = _match_orderby(plan, hinted)
        if repl is not None:
            return repl
    if not hasattr(plan, "__dataclass_fields__"):
        return plan
    for f in fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, Op.LogicalOperator):
            setattr(plan, f.name, parallel_rewrite(v, hinted))
    return plan
