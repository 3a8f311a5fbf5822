"""Rule-based query planner: clause chain → operator tree.

Counterpart of the reference's RuleBasedPlanner + rewrite passes
(memgraph/src/query/plan/rule_based_planner.cpp,
plan/rewrite/index_lookup.hpp): pattern matching compiles to
Scan→Expand→Filter chains, with index-backed scan selection driven by
pattern property maps, WHERE equality/range predicates, and index
statistics (approx counts) for choosing the cheapest start.

Copy of memgraph_tpu/query/plan/planner.py for the port (its imports the port's own).
"""

from __future__ import annotations

import itertools
from typing import Optional

from ...exceptions import SemanticException
from ..frontend import ast as A
from ..frontend.semantic import (check_expr_scope,
                                  check_no_aggregates,
                                  check_static_types)
from . import operators as Op

_ANON = itertools.count()


def _anon(prefix="anon"):
    return f"__{prefix}{next(_ANON)}__"


def collect_aggregations(expr: A.Expr, out: list) -> None:
    """Find aggregate FunctionCall/CountStar nodes within an expression."""
    if isinstance(expr, A.CountStar):
        out.append(expr)
        return
    if isinstance(expr, A.FunctionCall) and \
            expr.name in Op.AGGREGATE_FUNCTIONS:
        out.append(expr)
        return
    for child in _children_exprs(expr):
        collect_aggregations(child, out)


def _children_exprs(expr):
    if isinstance(expr, A.Unary):
        return [expr.expr]
    if isinstance(expr, A.Binary):
        return [expr.left, expr.right]
    if isinstance(expr, (A.PropertyLookup, A.LabelsTest, A.IsNull)):
        return [expr.expr]
    if isinstance(expr, A.Subscript):
        return [expr.expr, expr.index]
    if isinstance(expr, A.Slice):
        return [e for e in (expr.expr, expr.lo, expr.hi) if e is not None]
    if isinstance(expr, A.ListLiteral):
        return expr.items
    if isinstance(expr, A.MapLiteral):
        return list(expr.items.values())
    if isinstance(expr, A.FunctionCall):
        return expr.args
    if isinstance(expr, A.CaseExpr):
        out = [e for e in (expr.test, expr.default) if e is not None]
        for c, r in expr.whens:
            out.extend((c, r))
        return out
    if isinstance(expr, A.ListComprehension):
        return [e for e in (expr.list_expr, expr.where, expr.projection)
                if e is not None]
    if isinstance(expr, A.Quantifier):
        return [expr.list_expr, expr.where]
    if isinstance(expr, A.Reduce):
        return [expr.init, expr.list_expr, expr.expr]
    return []


def expr_symbols(expr: A.Expr, out: set) -> set:
    """Free identifiers referenced by an expression (over-approximate)."""
    if isinstance(expr, A.Identifier):
        out.add(expr.name)
    if isinstance(expr, (A.PatternExpr, A.PatternComprehension)):
        # pattern variables anchor on outer bindings when those exist, so
        # a predicate mentioning them must not be applied before they are
        # bound (over-approximation: fresh existential vars are included
        # too — harmless, leftover predicates apply at end of MATCH)
        for el in expr.pattern.elements:
            v = getattr(el, "variable", None)
            if v:
                out.add(v)
            props = getattr(el, "properties", None)
            if isinstance(props, dict):
                for p in props.values():
                    expr_symbols(p, out)
        if isinstance(expr, A.PatternComprehension):
            if expr.where is not None:
                expr_symbols(expr.where, out)
            expr_symbols(expr.projection, out)
    for child in _children_exprs(expr):
        expr_symbols(child, out)
    return out


def _check_storable_literal(expr) -> None:
    """SET n.p = <literal> with a statically-invalid property type —
    a list containing maps — is a compile-time TypeError (TCK
    MiscellaneousErrorAcceptance: InvalidPropertyType)."""
    if isinstance(expr, A.ListLiteral):
        for item in expr.items:
            if isinstance(item, A.MapLiteral):
                from ...exceptions import TypeException
                raise TypeException(
                    "InvalidPropertyType: a list of maps cannot be "
                    "stored as a property")
            _check_storable_literal(item)


def _split_and(expr: Optional[A.Expr]) -> list:
    if expr is None:
        return []
    if isinstance(expr, A.Binary) and expr.op == "AND":
        return _split_and(expr.left) + _split_and(expr.right)
    return [expr]


class Planner:
    """Plans one SingleQuery clause chain."""

    def __init__(self, storage, config=None) -> None:
        self.storage = storage
        self.config = config

    # --- public -------------------------------------------------------------

    def plan_query(self, query: A.CypherQuery):
        plan, columns = self.plan_single(query.query)
        if query.unions and len({ua for ua, _ in query.unions}) > 1:
            raise SemanticException(
                "InvalidClauseComposition: mixing UNION and UNION ALL "
                "in one query is not allowed")
        for union_all, sub in query.unions:
            sub_plan, sub_cols = self.plan_single(sub)
            if [c for c in sub_cols] != [c for c in columns]:
                raise SemanticException(
                    "UNION queries must return the same column names")
            plan = Op.Union(plan, sub_plan, columns, distinct=not union_all)
        if query.commit_frequency is not None:
            # root PeriodicCommit wraps the whole plan (reference:
            # rule_based_planner.hpp:504); combining it with CALL {} IN
            # TRANSACTIONS — at any subquery nesting depth — is the
            # reference's "only once" semantic error
            # (symbol_generator.cpp:177)
            def _has_batched_apply(op):
                if op is None:
                    return False
                if isinstance(op, Op.Apply) and op.batch_rows:
                    return True
                return any(_has_batched_apply(c) for c in op.children())
            if _has_batched_apply(plan):
                raise SemanticException(
                    "You can specify periodic commit only once during "
                    "a query!")
            plan = Op.PeriodicCommit(plan, query.commit_frequency)
        elif not query.unions and not columns:
            # bulk-write fast lane: write-only root-level create chains
            # route through storage.batch_insert (query/plan/bulk.py)
            from .bulk import bulk_rewrite
            plan = bulk_rewrite(plan, self.storage, self.config)
        return plan, columns

    def plan_single(self, single: A.SingleQuery, leaf=None,
                    initial_bound=None):
        plan: Op.LogicalOperator = leaf if leaf is not None else Op.Once()
        bound: set[str] = set(initial_bound or ())
        columns: list[str] = []
        clauses = single.clauses
        has_update = False
        produced = False
        parallel_hint = False   # USING PARALLEL EXECUTION, this query only

        # clause-at-a-time visibility: a reading clause after an updating
        # one (and vice versa) gets an Eager barrier so scans never
        # interleave with mutations (TCK CreateAcceptance "Combine MATCH,
        # WITH and CREATE"; reference: Accumulate + advance_command)
        read_seen = False
        write_seen = False
        _READING = (A.Match,)
        _WRITING = (A.Create, A.Merge, A.SetClause, A.Remove, A.Delete,
                    A.Foreach)
        kinds: dict[str, str] = {}   # variable -> node|edge|path|value
        prev_optional = False

        for ci, clause in enumerate(clauses):
            if isinstance(clause, A.Match):
                if prev_optional and not clause.optional:
                    raise SemanticException(
                        "InvalidClauseComposition: MATCH cannot follow "
                        "OPTIONAL MATCH (use a WITH between them)")
                prev_optional = clause.optional
                if clause.parallel:
                    parallel_hint = True
                self._validate_match(clause, bound, kinds)
            write_seen_before = write_seen   # for MERGE's read-side barrier
            if isinstance(clause, _READING) and write_seen:
                plan = Op.Eager(plan)
                write_seen = False  # barrier absorbs prior writes
            elif isinstance(clause, _WRITING) and read_seen:
                plan = Op.Eager(plan)
                read_seen = False   # consecutive writes share one barrier
            if isinstance(clause, _READING):
                read_seen = True
            if isinstance(clause, _WRITING):
                write_seen = True
            if isinstance(clause, A.Match):
                plan = self.plan_match(clause, plan, bound)
            elif isinstance(clause, A.Create):
                has_update = True
                plan = self.plan_create(clause, plan, bound)
            elif isinstance(clause, A.Merge):
                has_update = True
                if write_seen_before:
                    # MERGE READS its match side: PRIOR writes (e.g. a
                    # DELETE) must be fully applied first, or the match
                    # subplan sees not-yet-deleted entities (TCK
                    # MergeNodeAcceptance "not able to match on deleted")
                    plan = Op.Eager(plan)
                plan = self.plan_merge(clause, plan, bound)
            elif isinstance(clause, A.SetClause):
                has_update = True
                for item in clause.items:
                    check_expr_scope(item.target, bound, "SET")
                    if isinstance(item.value, A.Expr):
                        check_expr_scope(item.value, bound, "SET")
                        check_static_types(item.value, kinds)
                        _check_storable_literal(item.value)
                plan = self.plan_set_items(clause.items, plan, bound)
            elif isinstance(clause, A.Remove):
                has_update = True
                for item in clause.items:
                    check_expr_scope(item.target, bound, "REMOVE")
                plan = self.plan_remove(clause, plan)
            elif isinstance(clause, A.Delete):
                has_update = True
                for expr in clause.exprs:
                    if isinstance(expr, A.LabelsTest):
                        raise SemanticException(
                            "InvalidDelete: DELETE takes an entity, not a "
                            "label expression — use REMOVE for labels")
                    if isinstance(expr, (A.Literal, A.Binary, A.Unary,
                                         A.MapLiteral)):
                        raise SemanticException(
                            "InvalidArgumentType: DELETE requires a node, "
                            "relationship or path expression")
                    check_expr_scope(expr, bound, "DELETE")
                plan = Op.Delete(plan, clause.exprs, clause.detach)
            elif isinstance(clause, A.Unwind):
                check_expr_scope(clause.expr, bound, "UNWIND")
                plan = Op.Unwind(plan, clause.expr, clause.variable)
                bound.add(clause.variable)
            elif isinstance(clause, A.CallSubquery):
                sub_plan, sub_cols = self.plan_single(
                    clause.query, leaf=Op.Argument(), initial_bound=bound)
                if _single_has_update(clause.query):
                    has_update = True
                plan = Op.Apply(plan, sub_plan, sub_cols,
                                clause.batch_rows)
                bound.update(sub_cols)
            elif isinstance(clause, A.CallProcedure):
                standalone = len(clauses) == 1
                plan = self.plan_call(clause, plan, bound,
                                      standalone=standalone)
                if ci == len(clauses) - 1 and not clause.yield_dash and (
                        clause.yields or clause.yield_star or standalone):
                    # terminal CALL: surface the yielded columns (standalone
                    # CALL without YIELD surfaces every result field —
                    # TCK ProcedureCallAcceptance "Standalone call ...")
                    names = [a or f for f, a in clause.yields] \
                        if clause.yields else self._call_fields(clause)
                    items = [(A.Identifier(n), n) for n in names]
                    if names:
                        plan = Op.Produce(plan, items)
                        columns = names
                    produced = True
            elif isinstance(clause, A.With):
                # items see the PRE-projection scope; WHERE and ORDER BY
                # see the POST-projection scope (an alias may shadow a
                # node variable with e.g. a list)
                self._check_body_types(clause.body, kinds)
                new_kinds = self._project_kinds(clause.body, kinds)
                check_static_types(clause.where, new_kinds)
                for si in clause.body.order_by:
                    check_static_types(getattr(si, "expr", None),
                                       new_kinds)
                plan, columns = self.plan_projection(
                    clause.body, plan, bound, has_update, is_with=True,
                    where=clause.where)
                has_update = False
                prev_optional = False
                kinds = new_kinds
                bound = set(columns)
            elif isinstance(clause, A.Return):
                self._check_body_types(clause.body, kinds)
                post_kinds = self._project_kinds(clause.body, kinds)
                for si in clause.body.order_by:
                    check_static_types(getattr(si, "expr", None),
                                       post_kinds)
                plan, columns = self.plan_projection(
                    clause.body, plan, bound, has_update, is_with=False)
                produced = True
            elif isinstance(clause, A.Foreach):
                has_update = True
                plan = self.plan_foreach(clause, plan, bound)
            elif isinstance(clause, A.LoadCsv):
                plan = Op.LoadCsvOp(plan, clause.file, clause.variable,
                                    clause.with_header, clause.ignore_bad,
                                    clause.delimiter, clause.quote)
                bound.add(clause.variable)
            elif isinstance(clause, A.LoadJsonl):
                plan = Op.LoadJsonlOp(plan, clause.file, clause.variable)
                bound.add(clause.variable)
            elif isinstance(clause, A.LoadParquet):
                plan = Op.LoadParquetOp(plan, clause.file, clause.variable)
                bound.add(clause.variable)
            else:
                raise SemanticException(
                    f"unsupported clause {type(clause).__name__}")

        if not produced and not has_update and not any(
                isinstance(c, A.CallProcedure) for c in clauses):
            raise SemanticException("query must end with RETURN or an update")
        if not produced:
            # write-only query: WITH projections along the way must not
            # leak as result columns — such queries stream zero records
            columns = []
        from .parallel import parallel_rewrite
        plan = parallel_rewrite(plan, hinted=parallel_hint)
        # compiled read lane: lower the columnar tails (and the 1-2 hop
        # count shapes the columnar collapse does not claim) onto the
        # device programs in ops/pipeline.py (query/plan/lane.py)
        from .lane import lane_rewrite
        plan = lane_rewrite(plan, hinted=parallel_hint)
        return plan, columns

    def _call_fields(self, clause: A.CallProcedure) -> list[str]:
        from ..procedures.registry import global_registry
        proc = global_registry.find(clause.name)
        if proc is None:
            raise SemanticException(f"unknown procedure: {clause.name}")
        return [f for f, _ in proc.results]

    # --- MATCH --------------------------------------------------------------

    def _check_body_types(self, body: A.ReturnBody, kinds: dict) -> None:
        for expr, _alias, _verbatim in body.items:
            check_static_types(expr, kinds)

    @staticmethod
    def _project_kinds(body: A.ReturnBody, kinds: dict) -> dict:
        """Variable kinds AFTER a WITH/RETURN projection: a passed-through
        identifier keeps its kind, a statically-known non-entity expression
        becomes 'value' (so `WITH [n] AS users MATCH (users)` is a
        VariableTypeConflict), anything else is unknown (unchecked)."""
        new_kinds: dict[str, str] = {}
        for expr, alias, _verbatim in body.items:
            name = alias or (_verbatim if _verbatim else _expr_name(expr))
            if isinstance(expr, A.Identifier):
                k = kinds.get(expr.name)
                if k:
                    new_kinds[name] = k
            elif isinstance(expr, (A.ListLiteral, A.MapLiteral,
                                   A.ListComprehension,
                                   A.PatternComprehension)) or (
                    isinstance(expr, A.Literal)
                    and expr.value is not None) or (
                    isinstance(expr, A.FunctionCall)
                    and expr.name in ("collect", "count", "sum",
                                      "avg", "stdev", "stdevp",
                                      "percentiledisc",
                                      "percentilecont")):
                new_kinds[name] = "value"
        if body.star:
            # every currently-visible variable stays visible under `*`
            # (kinds only ever holds in-scope variables)
            for sym, k in kinds.items():
                new_kinds.setdefault(sym, k)
        return new_kinds

    def _validate_match(self, match: A.Match, bound: set,
                        kinds: dict) -> None:
        """Compile-time MATCH validity (TCK SemanticErrorAcceptance /
        MiscellaneousErrorAcceptance): variable kind conflicts, relationship
        uniqueness within a clause, parameter property maps, WHERE scope."""
        clause_vars: set = set()
        clause_edge_vars: set = set()
        for pattern in match.patterns:
            if pattern.variable:
                if pattern.variable in bound or pattern.variable \
                        in clause_vars:
                    raise SemanticException(
                        f"VariableAlreadyBound: path variable "
                        f"{pattern.variable} cannot be rebound")
                kinds[pattern.variable] = "path"
                clause_vars.add(pattern.variable)
            nodes = pattern.elements[0::2]
            edges = pattern.elements[1::2]
            for node in nodes:
                v = node.variable
                if v:
                    if kinds.get(v) in ("edge", "path", "value"):
                        raise SemanticException(
                            f"VariableTypeConflict: {v} is a "
                            f"{kinds[v]}, used here as a node")
                    kinds.setdefault(v, "node")
                    clause_vars.add(v)
                if isinstance(node.properties, A.Parameter):
                    raise SemanticException(
                        "InvalidParameterUse: a parameter property map "
                        "is not allowed in MATCH")
            for edge in edges:
                v = edge.variable
                if v:
                    if v in clause_edge_vars:
                        raise SemanticException(
                            f"RelationshipUniquenessViolation: "
                            f"relationship variable {v} is used more than "
                            f"once in this MATCH")
                    # a var-length slot legally binds a LIST of
                    # relationships (`MATCH ()-[rs*]->()` with rs
                    # projected from collect/[r1, r2]) — only fixed-length
                    # slots conflict with non-edge kinds
                    if not edge.var_length and \
                            kinds.get(v) in ("node", "path", "value"):
                        raise SemanticException(
                            f"VariableTypeConflict: {v} is a "
                            f"{kinds[v]}, used here as a relationship")
                    if not edge.var_length:
                        kinds.setdefault(v, "edge")
                    else:
                        # binds a LIST of relationships: single-rel use
                        # (r.prop) is a compile-time InvalidArgumentType
                        kinds.setdefault(v, "edge_list")
                    clause_edge_vars.add(v)
                    clause_vars.add(v)
                if isinstance(edge.properties, A.Parameter):
                    raise SemanticException(
                        "InvalidParameterUse: a parameter property map "
                        "is not allowed in MATCH")
        scope = bound | clause_vars
        for pattern in match.patterns:
            for item in pattern.elements:
                props = getattr(item, "properties", None)
                if isinstance(props, dict):
                    for p in props.values():
                        check_expr_scope(p, scope, "pattern properties")
                        check_no_aggregates(p, "pattern properties")
        if match.where is not None:
            check_expr_scope(match.where, scope, "WHERE")
            check_no_aggregates(match.where, "WHERE")
            check_static_types(match.where, kinds)

    def plan_match(self, match: A.Match, plan, bound: set):
        where_parts = _split_and(match.where)
        self._index_hints = {h.variable: h for h in
                             getattr(match, "index_hints", [])}
        if getattr(match, "hops_limit", None):
            plan = Op.SetHopsLimit(plan, match.hops_limit)
        if match.optional:
            sub_bound = set(bound)
            subplan = self.plan_pattern_chain(
                match.patterns, Op.Argument(), sub_bound, where_parts,
                outer_bound=bound)
            new_syms = sorted(sub_bound - bound)
            plan = Op.Optional_(plan, subplan, new_syms)
            bound.update(sub_bound)
            return plan
        plan = self.plan_pattern_chain(match.patterns, plan, bound,
                                       where_parts, outer_bound=None)
        return plan

    def plan_pattern_chain(self, patterns, plan, bound: set, where_parts,
                           outer_bound):
        pending = list(where_parts)
        edge_syms_in_match: list[str] = []
        for pattern in patterns:
            plan = self.plan_pattern(pattern, plan, bound, pending,
                                     edge_syms_in_match)
        # leftover predicates apply once everything is bound
        for pred in pending:
            plan = Op.Filter(plan, pred)
        return plan

    def plan_pattern(self, pattern: A.Pattern, plan, bound: set, pending,
                     edge_syms_in_match):
        elements = pattern.elements
        nodes = elements[0::2]
        edges = elements[1::2]
        # name anonymous symbols
        node_syms = []
        for node in nodes:
            sym = node.variable or _anon("node")
            node.variable = sym
            node_syms.append(sym)
        edge_syms = []
        for edge in edges:
            sym = edge.variable or _anon("edge")
            edge.variable = sym
            edge_syms.append(sym)

        # choose a start node among unbound ones (index-driven)
        start_idx = self._choose_start(nodes, bound, pending)
        plan = self._plan_node_scan(nodes[start_idx], plan, bound, pending)

        # expand left and right from the start
        # process edges in order: right side first (start→end), then left
        for i in range(start_idx, len(edges)):
            plan = self._plan_expand(edges[i], nodes[i], nodes[i + 1],
                                     "fwd", plan, bound, pending,
                                     edge_syms_in_match)
        for i in range(start_idx - 1, -1, -1):
            plan = self._plan_expand(edges[i], nodes[i], nodes[i + 1],
                                     "bwd", plan, bound, pending,
                                     edge_syms_in_match)

        if pattern.variable:
            syms = []
            for i, node in enumerate(nodes):
                syms.append(node.variable)
                if i < len(edges):
                    syms.append(edges[i].variable)
            # interleave properly: node, edge, node, ...
            interleaved = []
            for i in range(len(edges)):
                interleaved.append(nodes[i].variable)
                interleaved.append(edges[i].variable)
            interleaved.append(nodes[-1].variable)
            plan = Op.ConstructNamedPath(plan, pattern.variable, interleaved)
            bound.add(pattern.variable)
        return plan

    def _choose_start(self, nodes, bound: set, pending) -> int:
        # already-bound node → cheapest start (no scan at all)
        for i, node in enumerate(nodes):
            if node.variable in bound:
                return i
        best = (float("inf"), 0)
        for i, node in enumerate(nodes):
            cost = self._scan_cost(node, pending)
            if cost < best[0]:
                best = (cost, i)
        return best[1]

    def _scan_cost(self, node: A.NodePattern, pending) -> float:
        indices = self.storage.indices
        mapper = self.storage.label_mapper
        pmapper = self.storage.property_mapper
        total = max(len(self.storage._vertices), 1)
        best = float(total) * 2  # ScanAll penalty
        for label in node.labels:
            lid = mapper.maybe_name_to_id(label)
            if lid is None:
                return 0.0  # label unknown → zero results
            eq_props = self._equality_props(node, pending)
            for (ilabel, iprops) in indices.label_property.relevant_to(lid):
                if all(pmapper.id_to_name(p) in eq_props for p in iprops):
                    # ANALYZE GRAPH statistics predict an equality
                    # lookup's result size exactly: the average group
                    # size per distinct key (reference:
                    # cost_estimator.hpp using
                    # label_property_index_stats avg_group_size);
                    # without stats, fall back to the count heuristic
                    stats = indices.analyze_stats.get((ilabel, iprops))
                    if stats and stats.get("num_groups"):
                        best = min(best, float(stats["avg_group_size"]))
                    else:
                        best = min(best,
                                   indices.label_property.approx_count(
                                       ilabel, iprops)
                                   / max(len(iprops), 1))
            if indices.label.has(lid):
                best = min(best, float(indices.label.approx_count(lid)))
            else:
                best = min(best, float(total))
        return best

    def _equality_props(self, node: A.NodePattern, pending) -> set:
        """Property names fixed by the pattern map or WHERE n.p = <expr>."""
        out = set()
        if isinstance(node.properties, dict):
            out.update(node.properties.keys())
        for pred in pending:
            if isinstance(pred, A.Binary) and pred.op == "=":
                for lhs, rhs in ((pred.left, pred.right),
                                 (pred.right, pred.left)):
                    if (isinstance(lhs, A.PropertyLookup)
                            and isinstance(lhs.expr, A.Identifier)
                            and lhs.expr.name == node.variable):
                        out.add(lhs.prop)
        return out

    def _plan_node_scan(self, node: A.NodePattern, plan, bound: set, pending):
        sym = node.variable
        if sym in bound:
            return self._apply_node_filters(node, plan, bound, pending,
                                            skip_scan_filters=False)
        indices = self.storage.indices
        mapper = self.storage.label_mapper
        pmapper = self.storage.property_mapper
        scan = None
        used_label = None
        used_props: set = set()
        hint = getattr(self, "_index_hints", {}).get(sym)

        eq_map = {}  # prop name -> value expr
        if isinstance(node.properties, dict):
            eq_map.update(node.properties)
        where_eq = {}
        range_preds = {}
        for pred in pending:
            if isinstance(pred, A.Binary) and pred.op in (
                    "=", "<", ">", "<=", ">="):
                for lhs, rhs, op in ((pred.left, pred.right, pred.op),
                                     (pred.right, pred.left,
                                      _flip(pred.op))):
                    if (isinstance(lhs, A.PropertyLookup)
                            and isinstance(lhs.expr, A.Identifier)
                            and lhs.expr.name == sym
                            and not (expr_symbols(rhs, set()) - bound)):
                        if op == "=":
                            where_eq.setdefault(lhs.prop, (rhs, pred))
                        else:
                            range_preds.setdefault(lhs.prop, []).append(
                                (op, rhs, pred))

        label_order = list(node.labels)
        if hint is not None and hint.label in label_order:
            label_order.remove(hint.label)
            label_order.insert(0, hint.label)
        for label in label_order:
            lid = mapper.maybe_name_to_id(label)
            if lid is None:
                continue
            # equality composite index: most selective first — by
            # ANALYZE GRAPH avg_group_size when stats exist, else by
            # specificity (longest prefix)
            def _expected_rows(key):
                stats = indices.analyze_stats.get(key)
                if stats and stats.get("num_groups"):
                    return float(stats["avg_group_size"])
                # no stats (e.g. index created after ANALYZE): fall back
                # to the live count heuristic so a fresh selective index
                # still competes with stale-analyzed ones
                return (indices.label_property.approx_count(*key)
                        / max(len(key[1]), 1))
            keys = sorted(indices.label_property.relevant_to(lid),
                          key=lambda k: (_expected_rows(k), -len(k[1])))
            if hint is not None and hint.label == label and hint.properties:
                hint_pids = tuple(pmapper.maybe_name_to_id(pr)
                                  for pr in hint.properties)
                keys.sort(key=lambda k: 0 if k[1] == hint_pids else 1)
            for (ilabel, iprops) in keys:
                names = [pmapper.id_to_name(p) for p in iprops]
                if all(n in eq_map or n in where_eq for n in names):
                    exprs = []
                    consumed = []
                    for n in names:
                        if n in eq_map:
                            exprs.append(eq_map[n])
                        else:
                            rhs, pred = where_eq[n]
                            exprs.append(rhs)
                            consumed.append(pred)
                    scan = Op.ScanAllByLabelPropertyValue(
                        plan, sym, label, names, exprs)
                    for pred in consumed:
                        if pred in pending:
                            pending.remove(pred)
                    used_label = label
                    used_props = set(names) & set(eq_map)
                    break
                if len(iprops) == 1 and names[0] in range_preds:
                    lo = hi = None
                    lo_inc = hi_inc = True
                    consumed = []
                    for op, rhs, pred in range_preds[names[0]]:
                        if op in (">", ">="):
                            lo, lo_inc = rhs, op == ">="
                        else:
                            hi, hi_inc = rhs, op == "<="
                        consumed.append(pred)
                    scan = Op.ScanAllByLabelPropertyRange(
                        plan, sym, label, names[0], lo, hi, lo_inc, hi_inc)
                    for pred in consumed:
                        if pred in pending:
                            pending.remove(pred)
                    used_label = label
                    break
            if scan is not None:
                break
            if indices.label.has(lid):
                scan = Op.ScanAllByLabel(plan, sym, label)
                used_label = label
                break
        if scan is None:
            if node.labels:
                scan = Op.ScanAllByLabel(plan, sym, node.labels[0])
                used_label = node.labels[0]
            else:
                scan = Op.ScanAll(plan, sym)
        bound.add(sym)
        return self._apply_node_filters(node, scan, bound, pending,
                                        used_label=used_label,
                                        used_props=used_props)

    def _apply_node_filters(self, node: A.NodePattern, plan, bound: set,
                            pending, used_label=None, used_props=(),
                            skip_scan_filters=True):
        sym = node.variable
        ident = A.Identifier(sym)
        remaining_labels = [l for l in node.labels if l != used_label]
        if remaining_labels:
            plan = Op.Filter(plan, A.LabelsTest(ident, remaining_labels))
        if isinstance(node.properties, dict):
            for key, expr in node.properties.items():
                if key in used_props:
                    continue
                plan = Op.Filter(plan, A.Binary(
                    "=", A.PropertyLookup(ident, key), expr))
        elif isinstance(node.properties, A.Parameter):
            plan = Op.Filter(plan, _param_props_predicate(sym,
                                                          node.properties))
        # apply any pending predicate that is now fully bound
        plan = self._apply_ready_predicates(plan, bound, pending)
        return plan

    def _apply_ready_predicates(self, plan, bound: set, pending):
        ready = []
        for pred in pending:
            syms = expr_symbols(pred, set())
            if syms and syms <= bound:
                ready.append(pred)
        for pred in ready:
            pending.remove(pred)
            plan = Op.Filter(plan, pred)
        return plan

    def _plan_expand(self, edge: A.EdgePattern, left_node, right_node,
                     chain_dir, plan, bound: set, pending,
                     edge_syms_in_match):
        if chain_dir == "fwd":
            from_node, to_node = left_node, right_node
            direction = edge.direction
        else:
            from_node, to_node = right_node, left_node
            direction = {"out": "in", "in": "out",
                         "both": "both"}[edge.direction]
        from_sym = from_node.variable
        to_sym = to_node.variable
        edge_sym = edge.variable

        if edge.algo == "kshortest":
            if to_sym not in bound:
                # Yen's needs a bound target: scan it first
                plan = self._plan_node_scan(to_node, plan, bound, pending)
            k = edge.max_hops.value if edge.max_hops else 1
            plan = Op.ExpandKShortest(plan, from_sym, edge_sym, to_sym,
                                      direction, edge.types, k,
                                      edge.weight_lambda,
                                      edge.filter_lambda, edge.total_weight)
            if edge.total_weight:
                bound.add(edge.total_weight)
        elif edge.algo:
            max_h = edge.max_hops.value if edge.max_hops else -1
            plan = Op.ExpandShortest(plan, from_sym, edge_sym, to_sym,
                                     direction, edge.types, edge.algo,
                                     max_h, edge.weight_lambda,
                                     edge.filter_lambda, edge.total_weight)
            if edge.total_weight:
                bound.add(edge.total_weight)
        elif edge.var_length:
            min_h = edge.min_hops.value if edge.min_hops else 1
            max_h = edge.max_hops.value if edge.max_hops else -1
            plan = Op.ExpandVariable(plan, from_sym, edge_sym, to_sym,
                                     direction, edge.types, min_h, max_h,
                                     list(edge_syms_in_match),
                                     edge.filter_lambda)
        else:
            plan = Op.Expand(plan, from_sym, edge_sym, to_sym, direction,
                             edge.types, list(edge_syms_in_match))
        edge_syms_in_match.append(edge_sym)
        bound.add(edge_sym)
        bound.add(to_sym)
        # edge property filters
        if isinstance(edge.properties, dict) and not edge.var_length:
            ident = A.Identifier(edge_sym)
            for key, expr in edge.properties.items():
                plan = Op.Filter(plan, A.Binary(
                    "=", A.PropertyLookup(ident, key), expr))
        elif isinstance(edge.properties, dict) and edge.var_length:
            # a property map on a var-length edge applies to EVERY edge of
            # the path (TCK: `-[:WORKED_WITH* {year: 1988}]->`)
            var = _anon("vlprop")
            for key, expr in edge.properties.items():
                plan = Op.Filter(plan, A.Quantifier(
                    "ALL", var, A.Identifier(edge_sym),
                    A.Binary("=", A.PropertyLookup(A.Identifier(var), key),
                             expr)))
        # labels/properties on the endpoint filter whether it was newly
        # bound here or bound by an earlier clause — in the latter case
        # they are constraints, not binders (TCK: `(a)-[:T]->(b:Label)`
        # with b already bound)
        plan = self._apply_node_filters(to_node, plan, bound, pending)
        return plan

    # --- CREATE / MERGE -----------------------------------------------------

    def _validate_create_pattern(self, pattern: A.Pattern, bound: set,
                                 new_in_clause: set, what: str = "CREATE"):
        """openCypher CREATE/MERGE validity (TCK SemanticErrorAcceptance):
        a bound variable may be reused only as a bare path endpoint — any
        labels or properties on it are VariableAlreadyBound; var-length
        edges cannot be created; whole-pattern property scope is checked
        by the caller."""
        elements = pattern.elements
        nodes = elements[0::2]
        edges = elements[1::2]
        # property expressions may reference vars from earlier patterns of
        # the same clause: CREATE (a {v: 1}), (b {v: a.v})
        clause_vars = {n.variable for n in nodes if n.variable} \
            | {e.variable for e in edges if e.variable} | new_in_clause
        seen = set(new_in_clause)
        for node in nodes:
            v = node.variable
            if v and (v in bound or v in seen) \
                    and (node.labels or node.properties is not None):
                # an EMPTY map `(n {})` also counts as re-declaring
                # (TCK LabelsAcceptance "already bound 5")
                raise SemanticException(
                    f"VariableAlreadyBound: {v} is already declared — "
                    f"{what} may reuse it only as a bare endpoint")
            if what == "CREATE" and len(elements) == 1 and v and v in bound:
                raise SemanticException(
                    f"VariableAlreadyBound: {what} ({v}) — the variable "
                    f"is already declared")
            if v:
                seen.add(v)
            props = node.properties
            if isinstance(props, dict):
                for p in props.values():
                    check_expr_scope(p, bound | clause_vars, what)
        for edge in edges:
            if edge.var_length:
                raise SemanticException(
                    f"CreatingVarLength: variable-length relationships "
                    f"cannot be used in {what}")
            v = edge.variable
            if v and (v in bound or v in seen):
                raise SemanticException(
                    f"VariableAlreadyBound: relationship variable {v} is "
                    f"already declared")
            if isinstance(edge.properties, dict):
                for p in edge.properties.values():
                    check_expr_scope(p, bound | clause_vars, what)
        new_in_clause.update(clause_vars)

    def plan_create(self, create: A.Create, plan, bound: set):
        new_in_clause: set = set()
        for pattern in create.patterns:
            self._validate_create_pattern(pattern, bound, new_in_clause)
        for pattern in create.patterns:
            plan = self._plan_create_pattern(pattern, plan, bound)
        return plan

    def _plan_create_pattern(self, pattern: A.Pattern, plan, bound: set):
        elements = pattern.elements
        nodes = elements[0::2]
        edges = elements[1::2]
        for node in nodes:
            node.variable = node.variable or _anon("node")
        for edge in edges:
            edge.variable = edge.variable or _anon("edge")

        first = nodes[0]
        if first.variable not in bound:
            plan = Op.CreateNode(plan, first.variable, first.labels,
                                 first.properties)
            bound.add(first.variable)
        for i, edge in enumerate(edges):
            if edge.direction == "both":
                raise SemanticException(
                    "CREATE requires a directed relationship")
            if not edge.types or len(edge.types) != 1:
                raise SemanticException(
                    "CREATE requires exactly one relationship type")
            to_node = nodes[i + 1]
            create_to = to_node.variable not in bound
            plan = Op.CreateExpand(
                plan, nodes[i].variable, edge.variable, to_node.variable,
                edge.direction, edge.types[0], edge.properties,
                create_to, to_node.labels, to_node.properties)
            bound.add(edge.variable)
            bound.add(to_node.variable)
        if pattern.variable:
            interleaved = []
            for i in range(len(edges)):
                interleaved.append(nodes[i].variable)
                interleaved.append(edges[i].variable)
            interleaved.append(nodes[-1].variable)
            plan = Op.ConstructNamedPath(plan, pattern.variable, interleaved)
            bound.add(pattern.variable)
        return plan

    def plan_merge(self, merge: A.Merge, plan, bound: set):
        pattern = merge.pattern
        self._validate_create_pattern(pattern, bound, set(), what="MERGE")
        # a LITERAL null property can never match nor be created —
        # compile-time error (TCK MiscellaneousErrorAcceptance
        # "merging node/relationship with null property")
        pat_vars = {el.variable for el in pattern.elements if el.variable}
        for el in pattern.elements:
            props = getattr(el, "properties", None)
            if isinstance(props, dict):
                for key, pexpr in props.items():
                    if isinstance(pexpr, A.Literal) and pexpr.value is None:
                        raise SemanticException(
                            f"MergeReadOwnWrites: cannot merge with null "
                            f"property value for {key!r}")
        # match side
        match_bound = set(bound)
        match_plan = self.plan_pattern(pattern, Op.Argument(), match_bound,
                                       [], [])
        for item in merge.on_match:
            check_expr_scope(item.target, bound | pat_vars, "ON MATCH SET")
            if isinstance(item.value, A.Expr):
                check_expr_scope(item.value, bound | pat_vars,
                                 "ON MATCH SET")
            match_plan = self.plan_set_items([item], match_plan, match_bound)
        # create side — an undirected MERGE relationship matches both
        # orientations but CREATES outgoing (TCK MergeRelationshipAcceptance
        # "Use outgoing direction when unspecified")
        import copy
        create_pattern = copy.deepcopy(pattern)
        for el in create_pattern.elements[1::2]:
            if el.direction == "both":
                el.direction = "out"
        create_bound = set(bound)
        create_plan = self._plan_create_pattern(create_pattern, Op.Argument(),
                                                create_bound)
        for item in merge.on_create:
            check_expr_scope(item.target, bound | pat_vars, "ON CREATE SET")
            if isinstance(item.value, A.Expr):
                check_expr_scope(item.value, bound | pat_vars,
                                 "ON CREATE SET")
            create_plan = self.plan_set_items([item], create_plan,
                                              create_bound)
        bound.update(match_bound | create_bound)
        return Op.Merge(plan, match_plan, create_plan)

    def plan_set_items(self, items, plan, bound: set):
        for item in items:
            if item.kind == "prop":
                plan = Op.SetProperty(plan, item.target, item.value)
            elif item.kind == "var_assign":
                plan = Op.SetProperties(plan, item.target.name, item.value,
                                        update=False)
            elif item.kind == "var_update":
                if not isinstance(item.target, A.Identifier):
                    raise SemanticException("+= requires a variable target")
                plan = Op.SetProperties(plan, item.target.name, item.value,
                                        update=True)
            elif item.kind == "label":
                if not isinstance(item.target, A.Identifier):
                    raise SemanticException("SET label requires a variable")
                plan = Op.SetLabels(plan, item.target.name, item.value)
            else:
                raise SemanticException(f"unknown SET item {item.kind}")
        return plan

    def plan_remove(self, remove: A.Remove, plan):
        for item in remove.items:
            if item.kind == "prop":
                plan = Op.RemoveProperty(plan, item.target)
            else:
                if not isinstance(item.target, A.Identifier):
                    raise SemanticException("REMOVE label requires a variable")
                plan = Op.RemoveLabels(plan, item.target.name, item.labels)
        return plan

    def plan_foreach(self, clause: A.Foreach, plan, bound: set):
        sub_bound = set(bound) | {clause.variable}
        update_plan: Op.LogicalOperator = Op.Argument()
        for upd in clause.updates:
            if isinstance(upd, A.Create):
                update_plan = self.plan_create(upd, update_plan, sub_bound)
            elif isinstance(upd, A.Merge):
                update_plan = self.plan_merge(upd, update_plan, sub_bound)
            elif isinstance(upd, A.SetClause):
                update_plan = self.plan_set_items(upd.items, update_plan,
                                                  sub_bound)
            elif isinstance(upd, A.Remove):
                update_plan = self.plan_remove(upd, update_plan)
            elif isinstance(upd, A.Delete):
                update_plan = Op.Delete(update_plan, upd.exprs, upd.detach)
            elif isinstance(upd, A.Foreach):
                update_plan = self.plan_foreach(upd, update_plan, sub_bound)
            else:
                raise SemanticException(
                    "FOREACH allows only update clauses")
        return Op.Foreach(plan, clause.variable, clause.expr, update_plan)

    # --- CALL ---------------------------------------------------------------

    def plan_call(self, clause: A.CallProcedure, plan, bound: set,
                  standalone: bool = False):
        from ..procedures.registry import global_registry
        proc = global_registry.find(clause.name)
        if proc is None:
            raise SemanticException(f"unknown procedure: {clause.name}")
        args = clause.args
        if args is None:
            # no parens: standalone CALL binds declared args from query
            # parameters by name; in-query CALL must pass them explicitly
            # (reference: InvalidArgumentPassingMode)
            if proc.args and not standalone:
                raise SemanticException(
                    f"in-query CALL to {clause.name} requires explicit "
                    f"arguments — implicit (parameter) passing is only "
                    f"allowed for standalone CALL")
            args = [A.Parameter(name) for name, _ in proc.args]
        else:
            n_req, n_max = len(proc.args), len(proc.args) + len(proc.opt_args)
            if not (n_req <= len(args) <= n_max):
                raise SemanticException(
                    f"procedure {clause.name} expects "
                    f"{n_req if n_req == n_max else f'{n_req}..{n_max}'} "
                    f"arguments, got {len(args)}")
            for expr, (aname, atype) in zip(args, proc.args):
                if isinstance(expr, A.Literal) and not _literal_matches_type(
                        expr.value, atype):
                    raise SemanticException(
                        f"procedure {clause.name} argument {aname!r} "
                        f"expects {atype}, got literal {expr.value!r}")
        for expr in args:
            aggs: list = []
            collect_aggregations(expr, aggs)
            if aggs:
                raise SemanticException(
                    f"CALL {clause.name}: aggregation functions are not "
                    f"allowed in procedure arguments")
        known_fields = {f for f, _ in proc.results}
        if clause.yields:
            for f, _ in clause.yields:
                if f not in known_fields:
                    raise SemanticException(
                        f"procedure {clause.name} does not yield {f!r}")
            yields = clause.yields
        elif clause.yield_dash:
            yields = []
        else:
            if not standalone and proc.results:
                raise SemanticException(
                    f"in-query CALL to {clause.name} must YIELD its output "
                    f"(or YIELD - to discard it)")
            yields = [(f, None) for f, _ in proc.results]
        result_fields = [f for f, _ in yields]
        output_symbols = [a or f for f, a in yields]
        for sym in output_symbols:
            if sym in bound:
                raise SemanticException(
                    f"variable {sym!r} is already bound — YIELD must not "
                    f"shadow an existing variable")
        plan = Op.CallProcedureOp(plan, clause.name, args,
                                  result_fields, output_symbols,
                                  memory_limit=clause.memory_limit)
        bound.update(output_symbols)
        if clause.where is not None:
            plan = Op.Filter(plan, clause.where)
        return plan

    # --- RETURN / WITH ------------------------------------------------------

    def plan_projection(self, body: A.ReturnBody, plan, bound: set,
                        has_update: bool, is_with: bool,
                        where: Optional[A.Expr] = None):
        items: list[tuple[A.Expr, str]] = []
        if body.star:
            visible = [s for s in bound if not s.startswith("__")]
            if not visible and not body.items and not is_with:
                raise SemanticException(
                    "NoVariablesInScope: RETURN * with no variables in "
                    "scope")
            for sym in sorted(visible):
                items.append((A.Identifier(sym), sym))
        for expr, alias, verbatim in body.items:
            if is_with and alias is None and not isinstance(expr,
                                                            A.Identifier):
                raise SemanticException(
                    "NoExpressionAlias: expressions in WITH must be "
                    "aliased (use AS)")
            name = alias or verbatim or _expr_name(expr)
            items.append((expr, name))
        for expr, _ in items:
            check_expr_scope(expr, bound, "projection")
        columns = [name for _, name in items]
        if len(set(columns)) != len(columns):
            raise SemanticException("duplicate column names in projection")

        # aggregation split
        agg_specs = []
        group_items: list[tuple[A.Expr, str]] = []
        final_items: list[tuple[A.Expr, str]] = []
        any_agg = False
        for expr, name in items:
            aggs: list = []
            collect_aggregations(expr, aggs)
            if aggs:
                any_agg = True
        if any_agg:
            rewritten = []
            for expr, name in items:
                aggs = []
                collect_aggregations(expr, aggs)
                if not aggs:
                    group_items.append((expr, name))
                    rewritten.append((A.Identifier(name), name))
                else:
                    new_expr = self._rewrite_aggs(expr, agg_specs,
                                                  group_items,
                                                  outer=frozenset(bound))
                    rewritten.append((new_expr, name))
            final_items = rewritten
        if has_update:
            plan = Op.Accumulate(plan)

        if any_agg:
            group_named = [(e, n) for (e, n) in group_items]
            remember = sorted(bound)
            plan = Op.Aggregate(plan, group_named, agg_specs, remember=[])
            inner_items = final_items
        else:
            inner_items = items

        if body.order_by or body.skip is not None or body.limit is not None \
                or body.distinct or is_with or where is not None or True:
            plan = Op.Produce(plan, inner_items)
        if body.distinct:
            plan = Op.Distinct(plan, columns)
        if body.order_by:
            # scope: projected columns, plus the pre-projection variables
            # unless DISTINCT/aggregation made them unavailable
            # (TCK ReturnAcceptance: "ORDER BY of a column introduced in
            # RETURN" vs UndefinedVariable after DISTINCT)
            # ORDER BY may reference projection/grouping expressions that no
            # longer exist as symbols post-aggregation: rewrite any sort
            # subexpression structurally equal to a projected item to its
            # column name (dataclass equality compares AST structure)
            def rewrite_sort(expr):
                for item_expr, name in items:
                    if expr == item_expr:
                        return A.Identifier(name)
                import copy
                clone = copy.copy(expr)
                if isinstance(expr, A.Unary):
                    clone.expr = rewrite_sort(expr.expr)
                elif isinstance(expr, A.Binary):
                    clone.left = rewrite_sort(expr.left)
                    clone.right = rewrite_sort(expr.right)
                elif isinstance(expr, A.PropertyLookup):
                    clone.expr = rewrite_sort(expr.expr)
                elif isinstance(expr, A.FunctionCall):
                    clone.args = [rewrite_sort(a) for a in expr.args]
                elif isinstance(expr, A.ListLiteral):
                    clone.items = [rewrite_sort(a) for a in expr.items]
                elif isinstance(expr, A.MapLiteral):
                    clone.items = {k: rewrite_sort(v)
                                   for k, v in expr.items.items()}
                return clone

            sort_items = [(rewrite_sort(s.expr), s.ascending)
                          for s in body.order_by]
            # scope: projected columns, plus the pre-projection variables
            # unless DISTINCT/aggregation consumed them (TCK: ORDER BY
            # a.age after RETURN DISTINCT a.name is UndefinedVariable)
            sort_scope = set(columns)
            if not body.distinct and not any_agg:
                sort_scope |= bound
            for (sexpr, _), s in zip(sort_items, body.order_by):
                if not any_agg:
                    aggs = []
                    collect_aggregations(s.expr, aggs)
                    if aggs:
                        raise SemanticException(
                            "InvalidAggregation: aggregation in ORDER BY "
                            "requires an aggregating projection")
                check_expr_scope(sexpr, sort_scope, "ORDER BY")
            plan = Op.OrderBy(plan, sort_items)
        if body.skip is not None:
            plan = Op.Skip(plan, body.skip)
        if body.limit is not None:
            # negative LITERAL fails at compile; a negative PARAMETER is
            # clamped at runtime (TCK OrderByAcceptance pair)
            lim = body.limit
            if (isinstance(lim, A.Unary) and lim.op == "-"
                    and isinstance(lim.expr, A.Literal)) or (
                    isinstance(lim, A.Literal)
                    and isinstance(lim.value, int) and lim.value < 0):
                raise SemanticException(
                    "NegativeIntegerArgument: LIMIT must be a "
                    "non-negative integer")
            plan = Op.Limit(plan, body.limit)
        if where is not None:
            plan = Op.Filter(plan, where)
        if is_with:
            # WITH closes the variable scope: only projected columns may
            # leak downstream — stale frame keys from before the WITH must
            # not make later pattern variables look bound (TCK
            # WithAcceptance "A simple pattern with one bound endpoint")
            plan = Op.ScopeBarrier(plan, columns)
        return plan, columns

    def _rewrite_aggs(self, expr: A.Expr, agg_specs: list,
                      group_items: list | None = None,
                      locals_: frozenset = frozenset(),
                      outer: frozenset = frozenset()) -> A.Expr:
        """Replace aggregate calls with references to Aggregate outputs and
        non-aggregate identifiers with implicit grouping keys.

        `locals_` carries comprehension/reduce-bound variables: references
        to them are NOT grouping keys — they are bound at evaluation time
        (TCK ListComprehension: `[x IN collect(p) | head(nodes(x))]`)."""
        if isinstance(expr, A.CountStar):
            name = _anon("agg")
            agg_specs.append(("count", None, False, name))
            return A.Identifier(name)
        if isinstance(expr, A.FunctionCall) and \
                expr.name in Op.AGGREGATE_FUNCTIONS:
            name = _anon("agg")
            arg = expr.args[0] if expr.args else None
            if len(expr.args) > 1:
                # e.g. percentileDisc(x, p): extra args ride in slot 4
                agg_specs.append((expr.name, arg, expr.distinct, name,
                                  expr.args[1]))
            else:
                agg_specs.append((expr.name, arg, expr.distinct, name))
            return A.Identifier(name)
        if group_items is not None and isinstance(
                expr, (A.Identifier, A.PropertyLookup)) \
                and not (expr_symbols(expr, set()) & locals_):
            # a non-aggregate variable reference inside an aggregating
            # item becomes an implicit grouping key (`RETURN {foo: a.name,
            # kids: collect(...)}` groups by a.name — TCK
            # AggregationAcceptance "aggregates inside non-aggregate
            # expressions")
            for g_expr, g_name in group_items:
                if g_expr == expr:
                    return A.Identifier(g_name)
            name = _anon("group")
            group_items.append((expr, name))
            return A.Identifier(name)
        # rebuild children
        import copy

        def rw(e, extra_locals=()):
            return self._rewrite_aggs(e, agg_specs, group_items,
                                      locals_ | frozenset(extra_locals),
                                      outer)

        clone = copy.copy(expr)
        if isinstance(expr, A.Unary):
            clone.expr = rw(expr.expr)
        elif isinstance(expr, A.IsNull):
            clone.expr = rw(expr.expr)
        elif isinstance(expr, (A.PatternExpr, A.PatternComprehension)):
            # pattern-introduced variables are locals; variables bound
            # OUTSIDE the pattern (anchors) must become grouping keys so
            # the pattern can re-anchor post-aggregation (`RETURN
            # size([(a)-->(b) | b]) + count(*)` groups by a)
            pat_vars = set()
            for el in expr.pattern.elements:
                if getattr(el, "variable", None):
                    pat_vars.add(el.variable)
            if expr.pattern.variable:        # named path: [p = (a)--() | p]
                pat_vars.add(expr.pattern.variable)
            if group_items is not None:
                # only pattern vars bound OUTSIDE the pattern are anchors;
                # the rest are fresh per-match locals
                for var in sorted((pat_vars & outer) - locals_):
                    ident = A.Identifier(var)
                    if not any(g_expr == ident for g_expr, _ in group_items):
                        group_items.append((ident, var))
            # property-map expressions inside the pattern may reference
            # outer variables — those must become grouping keys too
            clone.pattern = copy.deepcopy(expr.pattern)
            for el in clone.pattern.elements:
                props = getattr(el, "properties", None)
                if isinstance(props, dict):
                    for key in list(props):
                        props[key] = rw(props[key], tuple(pat_vars))
            if isinstance(expr, A.PatternComprehension):
                if expr.where is not None:
                    clone.where = rw(expr.where, tuple(pat_vars))
                clone.projection = rw(expr.projection, tuple(pat_vars))
        elif isinstance(expr, A.Binary):
            clone.left = rw(expr.left)
            clone.right = rw(expr.right)
        elif isinstance(expr, A.FunctionCall):
            clone.args = [rw(a) for a in expr.args]
        elif isinstance(expr, A.PropertyLookup):
            clone.expr = rw(expr.expr)
        elif isinstance(expr, A.ListLiteral):
            clone.items = [rw(a) for a in expr.items]
        elif isinstance(expr, A.MapLiteral):
            clone.items = {k: rw(v) for k, v in expr.items.items()}
        elif isinstance(expr, A.Subscript):
            clone.expr = rw(expr.expr)
            clone.index = rw(expr.index)
        elif isinstance(expr, A.Slice):
            clone.expr = rw(expr.expr)
            clone.lo = rw(expr.lo) if expr.lo is not None else None
            clone.hi = rw(expr.hi) if expr.hi is not None else None
        elif isinstance(expr, A.CaseExpr):
            clone.test = rw(expr.test) if expr.test is not None else None
            clone.whens = [(rw(c), rw(r)) for c, r in expr.whens]
            clone.default = (rw(expr.default)
                             if expr.default is not None else None)
        elif isinstance(expr, A.ListComprehension):
            clone.list_expr = rw(expr.list_expr)
            # aggregates may only feed the source list; aggregating inside
            # the filter/projection is invalid (TCK SemanticErrorAcceptance
            # "Failing when using aggregation in list comprehension")
            for part in (expr.where, expr.projection):
                if part is not None:
                    aggs: list = []
                    collect_aggregations(part, aggs)
                    if aggs:
                        raise SemanticException(
                            "InvalidAggregation: aggregation inside a list "
                            "comprehension is not allowed")
            if expr.where is not None:
                clone.where = rw(expr.where, (expr.var,))
            if expr.projection is not None:
                clone.projection = rw(expr.projection, (expr.var,))
        elif isinstance(expr, A.Quantifier):
            clone.list_expr = rw(expr.list_expr)
            clone.where = rw(expr.where, (expr.var,))
        elif isinstance(expr, A.Reduce):
            clone.init = rw(expr.init)
            clone.list_expr = rw(expr.list_expr)
            clone.expr = rw(expr.expr, (expr.acc, expr.var))
        return clone


def _literal_matches_type(value, type_decl: str) -> bool:
    """Compile-time literal-vs-declared-type check for procedure args.

    Type syntax follows the reference's mgp type names (mg_procedure.h
    mgp_type): INTEGER, FLOAT, NUMBER, STRING, BOOLEAN, MAP, LIST OF T,
    ANY, NODE, RELATIONSHIP, PATH; a '?' suffix means nullable.
    """
    t = type_decl.strip().upper()
    nullable = t.endswith("?")
    if nullable:
        t = t[:-1]
    if value is None:
        return nullable
    if t.startswith("LIST"):
        return isinstance(value, (list, tuple))
    def _numeric(v):
        # INTEGER/FLOAT/NUMBER coerce freely between int and float
        # (TCK: "argument of type INTEGER accepts value of type FLOAT")
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    checkers = {
        "INTEGER": _numeric,
        "FLOAT": _numeric,
        "NUMBER": _numeric,
        "STRING": lambda v: isinstance(v, str),
        "BOOLEAN": lambda v: isinstance(v, bool),
        "MAP": lambda v: isinstance(v, dict),
    }
    check = checkers.get(t)
    return True if check is None else check(value)


def _single_has_update(single: A.SingleQuery) -> bool:
    return any(isinstance(c, (A.Create, A.Merge, A.SetClause, A.Remove,
                              A.Delete, A.Foreach)) for c in single.clauses)


def _flip(op: str) -> str:
    return {"=": "=", "<": ">", ">": "<", "<=": ">=", ">=": "<="}[op]


def _expr_name(expr: A.Expr) -> str:
    if isinstance(expr, A.Identifier):
        return expr.name
    if isinstance(expr, A.PropertyLookup):
        return f"{_expr_name(expr.expr)}.{expr.prop}"
    if isinstance(expr, A.CountStar):
        return "count(*)"
    if isinstance(expr, A.FunctionCall):
        return f"{expr.name}({', '.join(_expr_name(a) for a in expr.args)})"
    if isinstance(expr, A.Literal):
        return repr(expr.value)
    if isinstance(expr, A.Parameter):
        return f"${expr.name}"
    if isinstance(expr, A.Subscript):
        return f"{_expr_name(expr.expr)}[{_expr_name(expr.index)}]"
    if isinstance(expr, A.Binary):
        return f"{_expr_name(expr.left)} {expr.op} {_expr_name(expr.right)}"
    if isinstance(expr, A.Unary):
        return f"{expr.op} {_expr_name(expr.expr)}"
    if isinstance(expr, A.Slice):
        lo = _expr_name(expr.lo) if expr.lo is not None else ""
        hi = _expr_name(expr.hi) if expr.hi is not None else ""
        return f"{_expr_name(expr.expr)}[{lo}..{hi}]"
    if isinstance(expr, A.LabelsTest):
        return f"{_expr_name(expr.expr)}:{':'.join(expr.labels)}"
    if isinstance(expr, A.IsNull):
        return (f"{_expr_name(expr.expr)} IS "
                f"{'NOT ' if expr.negated else ''}NULL")
    if isinstance(expr, A.ListLiteral):
        return "[" + ", ".join(_expr_name(i) for i in expr.items) + "]"
    if isinstance(expr, A.MapLiteral):
        return "{" + ", ".join(f"{k}: {_expr_name(v)}"
                               for k, v in expr.items.items()) + "}"
    return "expression"


def _param_props_predicate(sym: str, param: A.Parameter) -> A.Expr:
    # n matches {k: v, ...} parameter map: all entries equal
    # implemented as a function-less AND chain at eval time via a custom
    # expression — reuse quantifier over keys is overkill; build Binary AND
    # over map items is impossible without knowing keys, so compare maps:
    # properties(n) "contains" param — evaluate as subset via ALL quantifier.
    return A.Quantifier(
        "ALL", "__k__",
        A.FunctionCall("keys", [param]),
        A.Binary("=",
                 A.Subscript(A.Identifier(sym), A.Identifier("__k__")),
                 A.Subscript(param, A.Identifier("__k__"))))
