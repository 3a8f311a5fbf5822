"""Volcano-style pull operators (generator cursors).

Counterpart of the reference's ~80 pull operators
(memgraph/src/query/plan/operator.hpp:331-3189). Each logical
operator exposes `cursor(ctx)` returning an iterator of frames (dicts);
the chain streams row-by-row so LIMIT short-circuits and Bolt can pull
incrementally — the same contract as the reference's Cursor::Pull
(operator.hpp:79). PROFILE wraps cursors with counters (profile.py).

Copy of memgraph_tpu/query/plan/operators.py for the port (its imports the port's own).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from ...exceptions import (HintedAbortError, QueryException, SemanticException,
                           TypeException)
from ...storage.common import View
from ...storage.objects import Vertex
from ...storage.ordering import order_key
from ...storage.storage import EdgeAccessor, VertexAccessor
from ..eval import EvalContext, Evaluator
from ..frontend import ast as A
from .. import values as V
from ..values import Path


class ExecutionContext:
    """Per-execution state shared by all cursors."""

    def __init__(self, accessor, parameters=None, view=View.NEW,
                 interpreter_context=None, timeout_checker=None,
                 memory=None):
        from ...utils.memory_tracker import QueryMemoryTracker
        self.accessor = accessor
        self.parameters = parameters or {}
        self.view = view
        self.eval_ctx = EvalContext(accessor, self.parameters, view)
        self.eval_ctx.exec_ctx = self  # functions needing execution state
        self.evaluator = Evaluator(self.eval_ctx)
        self.interpreter_context = interpreter_context
        self.timeout_checker = timeout_checker
        # per-query materialized-state accounting (QUERY MEMORY LIMIT);
        # reference: memory/query_memory_control.cpp
        self.memory = memory if memory is not None else QueryMemoryTracker()
        self.stats = {"nodes_created": 0, "nodes_deleted": 0,
                      "relationships_created": 0, "relationships_deleted": 0,
                      "properties_set": 0, "labels_added": 0,
                      "labels_removed": 0}
        self.hops_budget = None  # USING HOPS LIMIT (query/hops_limit.hpp)
        # when the budget runs out: True -> stop expanding (partial
        # results), False -> raise. Reference default true
        # (run_time_configurable.cpp:77 hops_limit_partial_results)
        self.hops_partial = True

    def check_abort(self):
        if self.timeout_checker is not None:
            self.timeout_checker()

    def consume_hop(self) -> bool:
        """False = budget exhausted in partial-results mode (caller stops
        expanding); raises when partial results are disabled."""
        if self.hops_budget is not None:
            self.hops_budget -= 1
            if self.hops_budget < 0:
                if self.hops_partial:
                    return False
                raise QueryException(
                    "hops limit exceeded (USING HOPS LIMIT)")
        return True

    @property
    def storage(self):
        return self.accessor.storage


class LogicalOperator:
    """Base: single-input operators hold `input` (no default here — a base
    class attribute would leak a dataclass default into every subclass)."""

    def cursor(self, ctx: ExecutionContext):
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    def children(self) -> list:
        child = getattr(self, "input", None)
        return [child] if child is not None else []


class Once(LogicalOperator):
    input = None

    def cursor(self, ctx):
        yield {}


@dataclass
class Eager(LogicalOperator):
    """Pipeline barrier: drain the input fully before yielding anything.

    Gives Cypher its clause-at-a-time visibility semantics — a reading
    clause must observe the graph state AFTER a preceding updating clause
    processed every row, and an updating clause must not mutate the graph
    while an upstream scan is still iterating. The planner inserts this on
    read->write and write->read clause transitions (reference: Accumulate
    with advance_command, query/plan/operator.hpp; neo4j's Eager)."""
    input: LogicalOperator

    def cursor(self, ctx):
        rows = []
        for frame in self.input.cursor(ctx):
            ctx.memory.add_value(frame)
            rows.append(frame)
        for frame in rows:
            ctx.check_abort()
            yield frame


@dataclass
class ScanAll(LogicalOperator):
    input: LogicalOperator
    symbol: str

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            for va in ctx.accessor.vertices(ctx.view):
                new = dict(frame)
                new[self.symbol] = va
                yield new


@dataclass
class ScanAllByLabel(LogicalOperator):
    input: LogicalOperator
    symbol: str
    label: str

    def cursor(self, ctx):
        lid = ctx.storage.label_mapper.maybe_name_to_id(self.label)
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if lid is None:
                continue
            for va in ctx.accessor.vertices_by_label(lid, ctx.view):
                new = dict(frame)
                new[self.symbol] = va
                yield new


@dataclass
class ScanAllByLabelPropertyValue(LogicalOperator):
    input: LogicalOperator
    symbol: str
    label: str
    properties: list[str]
    value_exprs: list[A.Expr]

    def cursor(self, ctx):
        storage = ctx.storage
        lid = storage.label_mapper.maybe_name_to_id(self.label)
        pids = [storage.property_mapper.maybe_name_to_id(p)
                for p in self.properties]
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if lid is None or any(p is None for p in pids):
                continue
            values = [ctx.evaluator.eval(e, frame) for e in self.value_exprs]
            if any(v is None for v in values):
                continue  # = null never matches
            for va in ctx.accessor.vertices_by_label_property_value(
                    lid, tuple(pids), values, ctx.view):
                new = dict(frame)
                new[self.symbol] = va
                yield new


@dataclass
class ScanAllByLabelPropertyRange(LogicalOperator):
    input: LogicalOperator
    symbol: str
    label: str
    prop: str
    lower: Optional[A.Expr]
    upper: Optional[A.Expr]
    lower_inclusive: bool = True
    upper_inclusive: bool = True

    def cursor(self, ctx):
        storage = ctx.storage
        lid = storage.label_mapper.maybe_name_to_id(self.label)
        pid = storage.property_mapper.maybe_name_to_id(self.prop)
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if lid is None or pid is None:
                continue
            lo = ctx.evaluator.eval(self.lower, frame) \
                if self.lower is not None else None
            hi = ctx.evaluator.eval(self.upper, frame) \
                if self.upper is not None else None
            if (self.lower is not None and lo is None) or \
                    (self.upper is not None and hi is None):
                continue
            for va in ctx.accessor.vertices_by_label_property_range(
                    lid, (pid,), lo, hi, self.lower_inclusive,
                    self.upper_inclusive, ctx.view):
                new = dict(frame)
                new[self.symbol] = va
                yield new


@dataclass
class ScanAllById(LogicalOperator):
    input: LogicalOperator
    symbol: str
    id_expr: A.Expr

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            gid = ctx.evaluator.eval(self.id_expr, frame)
            if not isinstance(gid, int) or isinstance(gid, bool):
                continue
            va = ctx.accessor.find_vertex(gid, ctx.view)
            if va is not None:
                new = dict(frame)
                new[self.symbol] = va
                yield new


def _used_edge_gids(frame, prev_edge_symbols) -> set:
    """Edge gids already consumed by earlier pattern elements of the same
    MATCH — single edges AND var-length edge lists (relationship
    isomorphism; reference: EdgeUniquenessFilter, plan/operator.hpp)."""
    used = set()
    for s in prev_edge_symbols:
        v = frame.get(s)
        if isinstance(v, EdgeAccessor):
            used.add(v.gid)
        elif isinstance(v, (list, tuple)):
            for e in v:
                if isinstance(e, EdgeAccessor):
                    used.add(e.gid)
    return used


@dataclass
class Expand(LogicalOperator):
    """Expand one hop from `from_symbol`; binds edge_symbol/to_symbol.

    direction: 'out' | 'in' | 'both'. If to_symbol is already bound, acts
    as an edge test between the two bound nodes. `prev_edge_symbols` holds
    edge symbols of the same MATCH for relationship-uniqueness filtering
    (reference: EdgeUniquenessFilter, plan/operator.hpp).
    """
    input: LogicalOperator
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str
    edge_types: list[str]
    prev_edge_symbols: list[str] = field(default_factory=list)

    def _type_ids(self, ctx):
        if not self.edge_types:
            return None
        ids = set()
        for t in self.edge_types:
            tid = ctx.storage.edge_type_mapper.maybe_name_to_id(t)
            if tid is not None:
                ids.add(tid)
        return ids

    def cursor(self, ctx):
        type_ids = self._type_ids(ctx)
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if self.edge_types and not type_ids:
                continue
            from_v = frame.get(self.from_symbol)
            if from_v is None:
                continue
            to_bound = self.to_symbol in frame
            # an edge variable bound by an earlier clause constrains the
            # match to that exact edge (TCK MatchAcceptance2 "Matching
            # using a relationship that is already bound"; reference:
            # existing-symbol handling in rule_based_planner). A PRESENT
            # key bound to null (OPTIONAL MATCH miss) matches nothing.
            if self.edge_symbol in frame:
                prebound = frame[self.edge_symbol]
                if not isinstance(prebound, EdgeAccessor):
                    continue
            else:
                prebound = None
            used = _used_edge_gids(frame, self.prev_edge_symbols)
            bound_other = None
            if to_bound:
                bound_other = frame[self.to_symbol]
                if not isinstance(bound_other, VertexAccessor):
                    continue
            for ea, other in self._edges(ctx, from_v, type_ids,
                                         bound_other):
                if not ctx.consume_hop():
                    break
                if ea.gid in used:
                    continue
                if prebound is not None and ea.gid != prebound.gid:
                    continue
                if to_bound:
                    if bound_other.gid != other.gid:
                        continue
                    new = dict(frame)
                    new[self.edge_symbol] = ea
                    yield new
                else:
                    new = dict(frame)
                    new[self.edge_symbol] = ea
                    new[self.to_symbol] = other
                    yield new

    def _edges(self, ctx, from_v, type_ids, bound_other=None):
        # a bound destination is pushed down into the adjacency read: on
        # supernode hubs the accessor serves it from the per-vertex
        # adjacency map instead of scanning all O(degree) entries — this is
        # what takes hub MERGE's existence probe from O(degree) to O(1)
        view = ctx.view
        if self.direction in ("out", "both"):
            for ea in from_v.out_edges(view, type_ids,
                                       to_vertex=bound_other):
                yield ea, ea.to_vertex()
        if self.direction in ("in", "both"):
            for ea in from_v.in_edges(view, type_ids,
                                      from_vertex=bound_other):
                if self.direction == "both" and \
                        ea.from_vertex().gid == from_v.gid and \
                        ea.to_vertex().gid == from_v.gid:
                    continue  # self-loop already produced by the out pass
                yield ea, ea.from_vertex()


@dataclass
class ExpandVariable(LogicalOperator):
    """Variable-length expansion (DFS enumeration with hop bounds).

    Binds edge_symbol to the list of edges. Counterpart of the reference's
    ExpandVariable (plan/operator.hpp:1140).
    """
    input: LogicalOperator
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str
    edge_types: list[str]
    min_hops: int = 1
    max_hops: int = -1          # -1 = unbounded
    prev_edge_symbols: list[str] = field(default_factory=list)
    filter_lambda: object = None    # A.Lambda — per-step (e, n | pred)

    def _step_ok(self, ctx, frame, edge, node) -> bool:
        lam = self.filter_lambda
        if lam is None:
            return True
        inner = dict(frame)
        inner[lam.edge_var] = edge
        inner[lam.node_var] = node
        return ctx.evaluator.eval(lam.expr, inner) is True

    def cursor(self, ctx):
        type_ids = Expand._type_ids(self, ctx)
        max_hops = self.max_hops if self.max_hops >= 0 else 1 << 30
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if self.edge_types and not type_ids:
                continue
            from_v = frame.get(self.from_symbol)
            if from_v is None:
                continue
            to_bound = self.to_symbol in frame
            used = _used_edge_gids(frame, self.prev_edge_symbols)

            def dfs(node, path_edges, used_gids):
                depth = len(path_edges)
                if depth >= self.min_hops:
                    if to_bound:
                        bound = frame[self.to_symbol]
                        if isinstance(bound, VertexAccessor) and \
                                bound.gid == node.gid:
                            yield path_edges, node
                    else:
                        yield path_edges, node
                if depth >= max_hops:
                    return
                for ea, other in Expand._edges(self, ctx, node, type_ids):
                    if not ctx.consume_hop():
                        break
                    if ea.gid in used_gids:
                        continue
                    if prebound is not None and (
                            depth >= len(prebound)
                            or ea.gid != prebound[depth].gid):
                        continue
                    if not self._step_ok(ctx, frame, ea, other):
                        continue
                    yield from dfs(other, path_edges + [ea],
                                   used_gids | {ea.gid})

            # a pre-bound edge-list variable constrains the path to exactly
            # that relationship sequence (TCK MatchAcceptance2 "Matching
            # relationships into a list and matching variable length using
            # the list"); a null binding (OPTIONAL MATCH miss) matches
            # nothing. The dfs prefix check below keeps this O(len(list))
            # instead of enumerating every path and filtering after.
            if self.edge_symbol in frame:
                prebound = frame[self.edge_symbol]
                if not isinstance(prebound, (list, tuple)) or not all(
                        isinstance(p, EdgeAccessor) for p in prebound):
                    continue
            else:
                prebound = None

            def seq_ok(path_edges):
                return prebound is None or len(path_edges) == len(prebound)

            if self.min_hops == 0:
                # zero-length: from == to
                if seq_ok([]):
                    if to_bound:
                        bound = frame[self.to_symbol]
                        if isinstance(bound, VertexAccessor) and \
                                bound.gid == from_v.gid:
                            new = dict(frame)
                            new[self.edge_symbol] = []
                            yield new
                    else:
                        new = dict(frame)
                        new[self.edge_symbol] = []
                        new[self.to_symbol] = from_v
                        yield new
            start = max(self.min_hops, 1)
            for path_edges, end in dfs(from_v, [], set(used)):
                if len(path_edges) < start:
                    continue
                if not seq_ok(path_edges):
                    continue
                new = dict(frame)
                new[self.edge_symbol] = list(path_edges)
                if not to_bound:
                    new[self.to_symbol] = end
                yield new


@dataclass
class ExpandShortest(LogicalOperator):
    """BFS / weighted-shortest / all-shortest expansion.

    Counterpart of the traversal modes the reference embeds in
    ExpandVariable (plan/operator.hpp:1140 — *BFS, *WSHORTEST,
    *ALLSHORTEST with filter/weight lambdas). Host-side graph walk (the
    point-query regime); whole-graph distances run on device via
    ops/traversal.py.
    """
    input: LogicalOperator
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str
    edge_types: list[str]
    algo: str                          # 'bfs' | 'wshortest' | 'allshortest'
    max_hops: int = -1
    weight_lambda: object = None       # A.Lambda
    filter_lambda: object = None       # A.Lambda
    total_weight_symbol: Optional[str] = None

    def cursor(self, ctx):
        type_ids = Expand._type_ids(self, ctx)
        max_hops = self.max_hops if self.max_hops >= 0 else 1 << 30
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if self.edge_types and not type_ids:
                continue
            source = frame.get(self.from_symbol)
            if not isinstance(source, VertexAccessor):
                continue
            to_bound = self.to_symbol in frame
            target_gid = None
            if to_bound:
                bound = frame[self.to_symbol]
                if not isinstance(bound, VertexAccessor):
                    continue
                target_gid = bound.gid
            if self.algo == "bfs":
                results = self._bfs(ctx, frame, source, target_gid, max_hops,
                                    type_ids)
            else:
                results = self._dijkstra(
                    ctx, frame, source, target_gid, max_hops, type_ids,
                    all_shortest=(self.algo == "allshortest"))
            for (end_vertex, edges, weight) in results:
                new = dict(frame)
                new[self.edge_symbol] = edges
                if not to_bound:
                    new[self.to_symbol] = end_vertex
                if self.total_weight_symbol:
                    new[self.total_weight_symbol] = weight
                yield new

    def _neighbors(self, ctx, va, type_ids):
        yield from Expand._edges(self, ctx, va, type_ids)

    def _passes_filter(self, ctx, frame, edge, node) -> bool:
        lam = self.filter_lambda
        if lam is None:
            return True
        inner = dict(frame)
        inner[lam.edge_var] = edge
        inner[lam.node_var] = node
        return ctx.evaluator.eval(lam.expr, inner) is True

    def _edge_weight(self, ctx, frame, edge, node) -> float:
        lam = self.weight_lambda
        if lam is None:
            return 1.0
        inner = dict(frame)
        inner[lam.edge_var] = edge
        inner[lam.node_var] = node
        w = ctx.evaluator.eval(lam.expr, inner)
        if not V.is_numeric(w):
            raise TypeException("weight lambda must return a number")
        if w < 0:
            raise TypeException("weight lambda must be non-negative")
        return w

    def _bfs(self, ctx, frame, source, target_gid, max_hops, type_ids):
        from collections import deque
        parent = {source.gid: None}   # gid -> (prev_gid, edge)
        node_of = {source.gid: source}
        queue = deque([(source, 0)])
        while queue:
            ctx.check_abort()
            va, depth = queue.popleft()
            if depth >= max_hops:
                continue
            for ea, other in self._neighbors(ctx, va, type_ids):
                if other.gid in parent:
                    continue
                if not self._passes_filter(ctx, frame, ea, other):
                    continue
                parent[other.gid] = (va.gid, ea)
                node_of[other.gid] = other
                if target_gid is not None and other.gid == target_gid:
                    yield (other, self._path(parent, other.gid),
                           float(depth + 1))
                    return
                if target_gid is None:
                    yield (other, self._path(parent, other.gid),
                           float(depth + 1))
                queue.append((other, depth + 1))

    @staticmethod
    def _path(parent, gid):
        edges = []
        while parent[gid] is not None:
            prev_gid, edge = parent[gid]
            edges.append(edge)
            gid = prev_gid
        edges.reverse()
        return edges

    def _dijkstra(self, ctx, frame, source, target_gid, max_hops, type_ids,
                  all_shortest, banned_edges=frozenset(),
                  banned_nodes=frozenset()):
        import heapq
        import itertools as it
        dist = {source.gid: 0.0}
        hops = {source.gid: 0}
        parents: dict = {source.gid: []}  # gid -> [(prev_gid, edge)]
        node_of = {source.gid: source}
        tie = it.count()
        heap = [(0.0, next(tie), source)]
        settled = set()
        while heap:
            ctx.check_abort()
            d, _, va = heapq.heappop(heap)
            if va.gid in settled:
                continue
            settled.add(va.gid)
            if target_gid is not None and va.gid == target_gid:
                break
            if hops[va.gid] >= max_hops:
                continue
            for ea, other in self._neighbors(ctx, va, type_ids):
                if ea.gid in banned_edges or other.gid in banned_nodes:
                    continue
                if not self._passes_filter(ctx, frame, ea, other):
                    continue
                w = self._edge_weight(ctx, frame, ea, other)
                nd = d + w
                old = dist.get(other.gid)
                if old is None or nd < old - 1e-12:
                    dist[other.gid] = nd
                    hops[other.gid] = hops[va.gid] + 1
                    parents[other.gid] = [(va.gid, ea)]
                    node_of[other.gid] = other
                    heapq.heappush(heap, (nd, next(tie), other))
                elif all_shortest and abs(nd - old) <= 1e-12:
                    parents[other.gid].append((va.gid, ea))

        def all_paths(gid):
            if not parents[gid]:
                yield []
                return
            for (prev_gid, edge) in parents[gid]:
                for prefix in all_paths(prev_gid):
                    yield prefix + [edge]

        targets = ([target_gid] if target_gid is not None
                   else [g for g in dist if g != source.gid])
        for gid in targets:
            if gid not in dist:
                continue
            if all_shortest:
                for path in all_paths(gid):
                    yield (node_of[gid], path, dist[gid])
            else:
                yield (node_of[gid], all_paths(gid).__next__(), dist[gid])


@dataclass
class ExpandKShortest(LogicalOperator):
    """*KSHORTEST: Yen's algorithm over the Dijkstra base (reference:
    the KSHORTEST mode of ExpandVariable). Requires a bound target."""
    input: LogicalOperator
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str
    edge_types: list[str]
    k: int
    weight_lambda: object = None
    filter_lambda: object = None
    total_weight_symbol: Optional[str] = None

    def cursor(self, ctx):
        type_ids = Expand._type_ids(self, ctx)
        helper = ExpandShortest(
            self.input, self.from_symbol, self.edge_symbol, self.to_symbol,
            self.direction, self.edge_types, "wshortest", -1,
            self.weight_lambda, self.filter_lambda, None)
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            source = frame.get(self.from_symbol)
            target = frame.get(self.to_symbol)
            if not isinstance(source, VertexAccessor) or \
                    not isinstance(target, VertexAccessor):
                continue
            for (edges, weight) in self._yen(ctx, frame, helper, source,
                                             target, type_ids):
                new = dict(frame)
                new[self.edge_symbol] = edges
                if self.total_weight_symbol:
                    new[self.total_weight_symbol] = weight
                yield new

    def _shortest(self, ctx, frame, helper, source, target, banned_edges,
                  banned_nodes, type_ids):
        """One Dijkstra run honoring Yen's removals."""
        results = list(helper._dijkstra(
            ctx, frame, source, target.gid, 1 << 30, type_ids,
            all_shortest=False, banned_edges=frozenset(banned_edges),
            banned_nodes=frozenset(banned_nodes)))
        return results[0] if results else None

    def _yen(self, ctx, frame, helper, source, target, type_ids):
        first = self._shortest(ctx, frame, helper, source, target,
                               set(), set(), type_ids)
        if first is None:
            return
        paths = [(first[1], first[2])]   # (edges, weight)
        yield paths[0]
        candidates: list = []
        import heapq
        while len(paths) < self.k:
            prev_edges, _ = paths[-1]
            prev_nodes = self._node_seq(source, prev_edges)
            for i in range(len(prev_edges)):
                spur_node = prev_nodes[i]
                root_edges = prev_edges[:i]
                root_weight = sum(
                    helper._edge_weight(ctx, frame, e,
                                        self._other(e, prev_nodes[j]))
                    for j, e in enumerate(root_edges))
                banned_edges = set()
                for (p_edges, _w) in paths:
                    if [e.gid for e in p_edges[:i]] == \
                            [e.gid for e in root_edges] and len(p_edges) > i:
                        banned_edges.add(p_edges[i].gid)
                banned_nodes = {n.gid for n in prev_nodes[:i]}
                spur = self._shortest(ctx, frame, helper, spur_node, target,
                                      banned_edges, banned_nodes, type_ids)
                if spur is None:
                    continue
                total = root_edges + spur[1]
                weight = root_weight + spur[2]
                key = tuple(e.gid for e in total)
                if not any(tuple(e.gid for e in c[2]) == key
                           for c in candidates) and \
                        not any(tuple(e.gid for e in p[0]) == key
                                for p in paths):
                    heapq.heappush(candidates,
                                   (weight, id(total), total))
            if not candidates:
                return
            weight, _, best = heapq.heappop(candidates)
            paths.append((best, weight))
            yield paths[-1]

    def _node_seq(self, source, edges):
        nodes = [source]
        for e in edges:
            cur = nodes[-1]
            nxt = e.to_vertex() if e.from_vertex().gid == cur.gid \
                else e.from_vertex()
            nodes.append(nxt)
        return nodes

    @staticmethod
    def _other(edge, from_node):
        return edge.to_vertex() if edge.from_vertex().gid == from_node.gid \
            else edge.from_vertex()


def _chain_edges(edge_list, start_node):
    """Walk edge_list in the GIVEN order from start_node; returns the
    interleaved [edge, node, edge, node, ...] tail, or None if some edge
    is not incident to the walk front (wrong orientation)."""
    out = []
    last = start_node
    for ea in edge_list:
        if ea.from_vertex().gid == last.gid:
            nxt = ea.to_vertex()
        elif ea.to_vertex().gid == last.gid:
            nxt = ea.from_vertex()
        else:
            return None
        out.append(ea)
        out.append(nxt)
        last = nxt
    return out


@dataclass
class ConstructNamedPath(LogicalOperator):
    """Bind a path variable from matched pattern symbols."""
    input: LogicalOperator
    path_symbol: str
    element_symbols: list[str]   # node, edge, node, edge, ...

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            items = []
            ok = True
            for i, sym in enumerate(self.element_symbols):
                v = frame.get(sym)
                if v is None:
                    ok = False
                    break
                if isinstance(v, list):      # variable-length edge list
                    if items:
                        # the matcher stores the list in TRAVERSAL order,
                        # which is REVERSED when the planner expanded from
                        # the far end — chain whichever orientation walks
                        # from the declared start, so relationships(p)
                        # comes out in pattern order (TCK MatchAcceptance
                        # "starting from the end"). Trying both exact
                        # orders (not greedy incidence picking) stays
                        # correct on cycles and parallel edges.
                        chained = _chain_edges(v, items[-1]) or \
                            _chain_edges(list(reversed(v)), items[-1])
                        if chained is None:
                            ok = False
                            break
                        items.extend(chained)
                    continue
                if items and isinstance(v, VertexAccessor) and \
                        isinstance(items[-1], VertexAccessor):
                    if items[-1].gid == v.gid:
                        continue  # var-length already appended the end node
                items.append(v)
            new = dict(frame)
            new[self.path_symbol] = Path(items) if ok else None
            yield new


@dataclass
class Filter(LogicalOperator):
    input: LogicalOperator
    expr: A.Expr

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if ctx.evaluator.eval(self.expr, frame) is True:
                yield frame


@dataclass
class Produce(LogicalOperator):
    input: LogicalOperator
    items: list[tuple[A.Expr, str]]   # (expr, output name)

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            out = dict(frame)
            row = {}
            for expr, name in self.items:
                value = ctx.evaluator.eval(expr, frame)
                row[name] = value
                out[name] = value
            out["__row__"] = row
            yield out


@dataclass
class CreateNode(LogicalOperator):
    input: LogicalOperator
    symbol: str
    labels: list[str]
    properties: object           # dict[str, Expr] | A.Parameter | None

    def cursor(self, ctx):
        storage = ctx.storage
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            va = ctx.accessor.create_vertex()
            ctx.stats["nodes_created"] += 1
            for label in self.labels:
                va.add_label(storage.label_mapper.name_to_id(label))
                ctx.stats["labels_added"] += 1
            props = _eval_prop_map(ctx, self.properties, frame)
            for key, value in props.items():
                if value is not None:
                    va.set_property(
                        storage.property_mapper.name_to_id(key), value)
                    ctx.stats["properties_set"] += 1
            new = dict(frame)
            new[self.symbol] = va
            yield new


@dataclass
class CreateExpand(LogicalOperator):
    """Create an edge (and possibly the other endpoint node)."""
    input: LogicalOperator
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str               # 'out' | 'in' (creation needs a direction)
    edge_type: str
    edge_properties: object
    create_to_node: bool
    to_labels: list[str] = field(default_factory=list)
    to_properties: object = None

    def cursor(self, ctx):
        storage = ctx.storage
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            from_v = frame[self.from_symbol]
            if not isinstance(from_v, VertexAccessor):
                raise QueryException("CREATE edge endpoint is not a node")
            new = dict(frame)
            if self.create_to_node:
                to_v = ctx.accessor.create_vertex()
                ctx.stats["nodes_created"] += 1
                for label in self.to_labels:
                    to_v.add_label(storage.label_mapper.name_to_id(label))
                    ctx.stats["labels_added"] += 1
                props = _eval_prop_map(ctx, self.to_properties, frame)
                for key, value in props.items():
                    if value is not None:
                        to_v.set_property(
                            storage.property_mapper.name_to_id(key), value)
                        ctx.stats["properties_set"] += 1
                new[self.to_symbol] = to_v
            else:
                to_v = frame[self.to_symbol]
                if not isinstance(to_v, VertexAccessor):
                    raise QueryException("CREATE edge endpoint is not a node")
            tid = storage.edge_type_mapper.name_to_id(self.edge_type)
            if self.direction == "in":
                ea = ctx.accessor.create_edge(to_v, from_v, tid)
            else:
                ea = ctx.accessor.create_edge(from_v, to_v, tid)
            ctx.stats["relationships_created"] += 1
            props = _eval_prop_map(ctx, self.edge_properties, frame)
            for key, value in props.items():
                if value is not None:
                    ea.set_property(storage.property_mapper.name_to_id(key),
                                    value)
                    ctx.stats["properties_set"] += 1
            new[self.edge_symbol] = ea
            yield new


def _eval_prop_map(ctx, properties, frame) -> dict:
    if properties is None:
        return {}
    if isinstance(properties, A.Parameter):
        value = ctx.evaluator.eval(properties, frame)
        if not isinstance(value, dict):
            raise TypeException("property parameter must be a map")
        return value
    return {k: ctx.evaluator.eval(e, frame) for k, e in properties.items()}


@dataclass
class SetProperty(LogicalOperator):
    input: LogicalOperator
    target: A.PropertyLookup
    value: A.Expr

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            obj = ctx.evaluator.eval(self.target.expr, frame)
            value = ctx.evaluator.eval(self.value, frame)
            if obj is None:
                yield frame
                continue
            if not isinstance(obj, (VertexAccessor, EdgeAccessor)):
                raise TypeException("SET property on a non-graph value")
            pid = ctx.storage.property_mapper.name_to_id(self.target.prop)
            obj.set_property(pid, value)
            ctx.stats["properties_set"] += 1
            yield frame


@dataclass
class SetProperties(LogicalOperator):
    """n = {..} (replace) or n += {..} (update)."""
    input: LogicalOperator
    symbol: str
    value: A.Expr
    update: bool

    def cursor(self, ctx):
        storage = ctx.storage
        for frame in self.input.cursor(ctx):
            obj = frame.get(self.symbol)
            if obj is None:
                yield frame
                continue
            if not isinstance(obj, (VertexAccessor, EdgeAccessor)):
                raise TypeException("SET properties on a non-graph value")
            value = ctx.evaluator.eval(self.value, frame)
            if isinstance(value, (VertexAccessor, EdgeAccessor)):
                value = {storage.property_mapper.id_to_name(k): v
                         for k, v in value.properties(ctx.view).items()}
            if not isinstance(value, dict):
                raise TypeException("SET expects a map")
            if not self.update:
                for pid in list(obj.properties(ctx.view)):
                    obj.set_property(pid, None)
            for key, v in value.items():
                obj.set_property(storage.property_mapper.name_to_id(key), v)
                ctx.stats["properties_set"] += 1
            yield frame


@dataclass
class SetLabels(LogicalOperator):
    input: LogicalOperator
    symbol: str
    labels: list[str]

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            obj = frame.get(self.symbol)
            if obj is None:
                yield frame
                continue
            if not isinstance(obj, VertexAccessor):
                raise TypeException("SET label on a non-node value")
            for label in self.labels:
                if obj.add_label(ctx.storage.label_mapper.name_to_id(label)):
                    ctx.stats["labels_added"] += 1
            yield frame


@dataclass
class RemoveProperty(LogicalOperator):
    input: LogicalOperator
    target: A.PropertyLookup

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            obj = ctx.evaluator.eval(self.target.expr, frame)
            if obj is None:
                yield frame
                continue
            if not isinstance(obj, (VertexAccessor, EdgeAccessor)):
                raise TypeException("REMOVE property on a non-graph value")
            pid = ctx.storage.property_mapper.maybe_name_to_id(self.target.prop)
            if pid is not None:
                obj.set_property(pid, None)
                ctx.stats["properties_set"] += 1
            yield frame


@dataclass
class RemoveLabels(LogicalOperator):
    input: LogicalOperator
    symbol: str
    labels: list[str]

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            obj = frame.get(self.symbol)
            if obj is None:
                yield frame
                continue
            if not isinstance(obj, VertexAccessor):
                raise TypeException("REMOVE label on a non-node value")
            for label in self.labels:
                lid = ctx.storage.label_mapper.maybe_name_to_id(label)
                if lid is not None and obj.remove_label(lid):
                    ctx.stats["labels_removed"] += 1
            yield frame


@dataclass
class Delete(LogicalOperator):
    input: LogicalOperator
    exprs: list[A.Expr]
    detach: bool

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            # two-phase per input row: collect every entity from every
            # clause expression, delete relationships FIRST, then nodes —
            # so DELETE p1, p2 over paths sharing endpoints never trips
            # the has-edges check on a node whose edge dies in the same
            # clause (TCK DeleteAcceptance "Delete paths from nested
            # map/list")
            edges: list = []
            vertices: list = []
            for expr in self.exprs:
                value = ctx.evaluator.eval(expr, frame)
                self._collect(value, edges, vertices)
            for ea in edges:
                if ea.is_visible(View.NEW):
                    ctx.accessor.delete_edge(ea)
                    ctx.stats["relationships_deleted"] += 1
            for va in vertices:
                if va.is_visible(View.NEW):
                    _, deleted_edges = ctx.accessor.delete_vertex(
                        va, detach=self.detach)
                    ctx.stats["nodes_deleted"] += 1
                    ctx.stats["relationships_deleted"] += len(deleted_edges)
            yield frame

    def _collect(self, value, edges, vertices):
        if value is None:
            return
        if isinstance(value, VertexAccessor):
            vertices.append(value)
        elif isinstance(value, EdgeAccessor):
            edges.append(value)
        elif isinstance(value, Path):
            edges.extend(value.edges())
            vertices.extend(value.vertices())
        elif isinstance(value, (list, tuple)):
            for item in value:
                self._collect(item, edges, vertices)
        else:
            raise TypeException(
                f"DELETE on {V.type_name(value)} is not supported")


@dataclass
class SetHopsLimit(LogicalOperator):
    input: LogicalOperator
    limit: int

    def cursor(self, ctx):
        ctx.hops_budget = self.limit
        ctx.hops_initial = self.limit
        yield from self.input.cursor(ctx)


class Argument(LogicalOperator):
    """Subplan leaf: yields the frame installed by _run_subplan (the cached
    plan itself stays immutable, so concurrent executions can share it —
    same role as the reference/Neo4j 'Argument' operator)."""

    input = None

    def cursor(self, ctx):
        yield dict(ctx._argument_frame)


def _run_subplan(subplan: LogicalOperator, ctx, frame) -> list:
    """Execute a subplan (leaf: Argument) against one input frame.

    Materializes the result list so ctx._argument_frame is never observed
    by a suspended generator after it changes.
    """
    prev = getattr(ctx, "_argument_frame", None)
    ctx._argument_frame = frame
    try:
        return list(subplan.cursor(ctx))
    finally:
        ctx._argument_frame = prev


@dataclass
class Optional_(LogicalOperator):
    """OPTIONAL MATCH: run subplan per input row; null-fill on no match."""
    input: LogicalOperator
    subplan: LogicalOperator
    optional_symbols: list[str]

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            subs = _run_subplan(self.subplan, ctx, frame)
            if subs:
                yield from subs
            else:
                new = dict(frame)
                for sym in self.optional_symbols:
                    new[sym] = None
                yield new

    def children(self):
        return [self.input, self.subplan]


@dataclass
class Merge(LogicalOperator):
    """MERGE: try match subplan; else run create subplan. ON CREATE/ON MATCH
    handled by Set* operators appended to the respective subplans."""
    input: LogicalOperator
    match_plan: LogicalOperator
    create_plan: LogicalOperator

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            subs = _run_subplan(self.match_plan, ctx, frame)
            if subs:
                yield from subs
            else:
                yield from _run_subplan(self.create_plan, ctx, frame)

    def children(self):
        return [self.input, self.match_plan, self.create_plan]


AGGREGATE_FUNCTIONS = {"count", "sum", "avg", "min", "max", "collect",
                       "stdev", "stdevp", "project",
                       "percentiledisc", "percentilecont"}


@dataclass
class Aggregate(LogicalOperator):
    """Hash aggregation. group_by: (expr, name); aggregations:
    (kind, expr|None, distinct, output name)."""
    input: LogicalOperator
    group_by: list[tuple[A.Expr, str]]
    aggregations: list[tuple[str, Optional[A.Expr], bool, str]]
    remember: list[str] = field(default_factory=list)

    def cursor(self, ctx):
        groups: dict = {}
        order: list = []
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            key_vals = [ctx.evaluator.eval(e, frame) for e, _ in self.group_by]
            key = tuple(V.hashable_key(v) for v in key_vals)
            if key not in groups:
                state = {
                    "key_vals": key_vals,
                    "frame": {s: frame.get(s) for s in self.remember},
                    "aggs": [_AggState(spec[0], spec[2])
                             for spec in self.aggregations],
                }
                ctx.memory.add_value(key_vals)
                ctx.memory.add(256)   # group bookkeeping overhead
                groups[key] = state
                order.append(key)
            state = groups[key]
            for spec, agg in zip(self.aggregations, state["aggs"]):
                kind, expr = spec[0], spec[1]
                if len(spec) > 4 and spec[4] is not None:
                    # extra constant argument (percentileDisc/Cont's p)
                    agg.param = ctx.evaluator.eval(spec[4], frame)
                value = (ctx.evaluator.eval(expr, frame)
                         if expr is not None else "__row__")
                if agg.seen is not None or kind in (
                        "collect", "project", "percentiledisc",
                        "percentilecont"):
                    # collecting/DISTINCT aggregates retain every value
                    ctx.memory.add_value(value)
                agg.update(value)
        if not groups and not self.group_by:
            # aggregation over empty input yields one row of neutral values
            state = {"key_vals": [], "frame": {},
                     "aggs": [_AggState(spec[0], spec[2])
                              for spec in self.aggregations]}
            groups[()] = state
            order.append(())
        for key in order:
            state = groups[key]
            new = dict(state["frame"])
            for (_, name), val in zip(self.group_by, state["key_vals"]):
                new[name] = val
            for spec, agg in zip(self.aggregations, state["aggs"]):
                new[spec[3]] = agg.result()
            yield new


class _AggState:
    __slots__ = ("kind", "distinct", "seen", "count", "total", "minv",
                 "maxv", "items", "m2", "mean", "param")

    def __init__(self, kind, distinct):
        self.kind = kind
        self.distinct = distinct
        self.seen = set() if distinct else None
        self.count = 0
        self.total = 0
        self.minv = None
        self.maxv = None
        self.items = []
        self.mean = 0.0
        self.m2 = 0.0
        self.param = None    # percentileDisc/Cont's p argument

    def update(self, value):
        kind = self.kind
        if kind == "count" and value == "__row__":
            self.count += 1
            return
        if value is None:
            return
        if self.distinct:
            key = V.hashable_key(value)
            if key in self.seen:
                return
            self.seen.add(key)
        self.count += 1
        if kind == "count":
            return
        if kind == "collect":
            self.items.append(value)
            return
        if kind in ("percentiledisc", "percentilecont"):
            if not V.is_numeric(value):
                raise TypeException(f"{kind}() requires numeric input")
            self.items.append(value)
            return
        if kind == "project":
            self.items.append(value)
            return
        if kind in ("sum", "avg"):
            from ...utils.temporal import Duration
            if not (V.is_numeric(value) or isinstance(value, Duration)):
                raise TypeException(f"{kind}() requires numeric input")
            self.total = value if self.count == 1 else self.total + value
            return
        if kind in ("stdev", "stdevp"):
            if not V.is_numeric(value):
                raise TypeException(f"{kind}() requires numeric input")
            delta = value - self.mean
            self.mean += delta / self.count
            self.m2 += delta * (value - self.mean)
            return
        if kind == "min":
            # full orderability, not comparability: over mixed types the
            # TCK expects e.g. lists < strings < numbers (order_key ranks)
            if self.minv is None or order_key(value) < order_key(self.minv):
                self.minv = value
            return
        if kind == "max":
            if self.maxv is None or order_key(self.maxv) < order_key(value):
                self.maxv = value
            return
        raise SemanticException(f"unknown aggregate {kind}")

    def result(self):
        kind = self.kind
        if kind == "count":
            return self.count
        if kind == "collect":
            return self.items
        if kind == "project":
            # graph projection: collect of paths/nodes into a map
            return {"nodes": [x for x in self.items
                              if isinstance(x, VertexAccessor)],
                    "edges": [x for x in self.items
                              if isinstance(x, EdgeAccessor)]}
        if kind == "sum":
            return self.total if self.count else 0
        if kind == "avg":
            return (self.total / self.count) if self.count else None
        if kind == "min":
            return self.minv
        if kind == "max":
            return self.maxv
        if kind == "stdev":
            if self.count < 2:
                return 0.0 if self.count else None
            return (self.m2 / (self.count - 1)) ** 0.5
        if kind == "stdevp":
            if not self.count:
                return None
            return (self.m2 / self.count) ** 0.5
        if kind in ("percentiledisc", "percentilecont"):
            if not self.items:
                return None  # aggregation over zero rows yields null
            p = self.param
            if not V.is_numeric(p) or not (0.0 <= p <= 1.0):
                raise QueryException(
                    f"NumberOutOfRange: {kind}() percentile must be in "
                    f"[0, 1], got {p!r}")
            xs = sorted(self.items)
            if kind == "percentiledisc":
                # smallest value with cumulative frequency >= p
                import math
                idx = max(0, math.ceil(p * len(xs)) - 1)
                return xs[idx]
            if len(xs) == 1:
                return float(xs[0])
            pos = p * (len(xs) - 1)
            lo = int(pos)
            frac = pos - lo
            if lo + 1 >= len(xs):
                return float(xs[-1])
            return xs[lo] + (xs[lo + 1] - xs[lo]) * frac
        raise SemanticException(f"unknown aggregate {kind}")


@dataclass
class OrderBy(LogicalOperator):
    input: LogicalOperator
    items: list[tuple[A.Expr, bool]]   # (expr, ascending)

    def cursor(self, ctx):
        rows = []
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            keys = []
            for expr, asc in self.items:
                k = order_key(ctx.evaluator.eval(expr, frame))
                keys.append((k, asc))
            ctx.memory.add_value(frame)
            rows.append((keys, frame))

        import functools

        def compare(a, b):
            for (ka, asc), (kb, _) in zip(a[0], b[0]):
                if ka < kb:
                    return -1 if asc else 1
                if ka > kb:
                    return 1 if asc else -1
            return 0

        rows.sort(key=functools.cmp_to_key(compare))
        for _, frame in rows:
            yield frame


@dataclass
class Skip(LogicalOperator):
    input: LogicalOperator
    expr: A.Expr

    def cursor(self, ctx):
        n = ctx.evaluator.eval(self.expr, {})
        if not isinstance(n, int) or isinstance(n, bool) or n < 0:
            raise TypeException("SKIP must be a non-negative integer")
        yield from itertools.islice(self.input.cursor(ctx), n, None)


@dataclass
class Limit(LogicalOperator):
    input: LogicalOperator
    expr: A.Expr

    def cursor(self, ctx):
        n = ctx.evaluator.eval(self.expr, {})
        if not isinstance(n, int) or isinstance(n, bool):
            raise TypeException("LIMIT must be a non-negative integer")
        # negative literals fail at compile time; a negative PARAMETER
        # "should not generate errors" (TCK OrderByAcceptance) — clamp
        yield from itertools.islice(self.input.cursor(ctx), max(n, 0))


@dataclass
class ScopeBarrier(LogicalOperator):
    """WITH scope close: prune frames to the projected columns so stale
    pre-WITH bindings never leak into later clauses (reference: symbol
    table scoping in semantic/symbol_generator.cpp)."""
    input: LogicalOperator
    columns: list[str]

    def cursor(self, ctx):
        cols = self.columns
        for frame in self.input.cursor(ctx):
            yield {k: frame[k] for k in cols if k in frame}


@dataclass
class Distinct(LogicalOperator):
    input: LogicalOperator
    symbols: list[str]

    def cursor(self, ctx):
        seen = set()
        for frame in self.input.cursor(ctx):
            key = tuple(V.hashable_key(frame.get(s)) for s in self.symbols)
            if key in seen:
                continue
            ctx.memory.add_value(key)
            seen.add(key)
            yield frame


@dataclass
class Unwind(LogicalOperator):
    input: LogicalOperator
    expr: A.Expr
    symbol: str

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            value = ctx.evaluator.eval(self.expr, frame)
            if value is None:
                continue
            if not isinstance(value, (list, tuple)):
                raise TypeException("UNWIND requires a list")
            for item in value:
                new = dict(frame)
                new[self.symbol] = item
                yield new


@dataclass
class CallProcedureOp(LogicalOperator):
    input: LogicalOperator
    proc_name: str
    args: list[A.Expr]
    result_fields: list[str]
    output_symbols: list[str]
    memory_limit: "Optional[int]" = None   # PROCEDURE MEMORY LIMIT, bytes

    def cursor(self, ctx):
        from ..procedures.registry import global_registry
        from ...utils.memory_tracker import (MemoryLimitException,
                                             approx_size)
        proc = global_registry.find(self.proc_name)
        if proc is None:
            raise SemanticException(f"unknown procedure: {self.proc_name}")
        from .planner import _literal_matches_type
        proc_bytes = 0   # yielded-record accounting vs PROCEDURE limit
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            args = [ctx.evaluator.eval(e, frame) for e in self.args]
            for value, (aname, atype) in zip(args, proc.args):
                if not _literal_matches_type(value, atype):
                    raise TypeException(
                        f"procedure {self.proc_name} argument {aname!r} "
                        f"expects {atype}, got {value!r}")
            if not proc.results:
                # VOID procedure: run for its effects, pass the row through
                # (TCK: "In-query call to VOID procedure does not consume
                # rows"); a ':: ()' procedure instead yields nothing
                for _ in proc.call(ctx, args):
                    pass
                if getattr(proc, "void", False):
                    yield dict(frame)
                continue
            for record in proc.call(ctx, args):
                if self.memory_limit is not None:
                    proc_bytes += approx_size(record)
                    if proc_bytes > self.memory_limit:
                        raise MemoryLimitException(
                            f"procedure {self.proc_name} exceeded its "
                            f"PROCEDURE MEMORY LIMIT of "
                            f"{self.memory_limit} bytes")
                new = dict(frame)
                for fieldname, sym in zip(self.result_fields,
                                          self.output_symbols):
                    if fieldname not in record:
                        raise SemanticException(
                            f"procedure {self.proc_name} did not yield "
                            f"{fieldname!r}")
                    new[sym] = record[fieldname]
                yield new


@dataclass
class PeriodicCommit(LogicalOperator):
    """USING PERIODIC COMMIT n: commit the enclosing autocommit
    transaction and open a fresh one after every n pulled rows, plus once
    more for the remainder when the stream ends (reference:
    plan/operator.cpp PeriodicCommitCursor). Batches already committed
    survive a later failure — the point of the directive for huge loads.

    Graph values in frames stay readable across the boundary: reads
    through a committed accessor see its committed state (round-3
    post-commit visibility semantics), matching the reference where
    accessors outlive PeriodicCommit's internal commits.
    """
    input: LogicalOperator
    frequency: object   # int literal or frontend Parameter

    def cursor(self, ctx):
        freq = self.frequency
        if not isinstance(freq, int):   # $param, resolved at runtime
            freq = ctx.evaluator.eval(freq, {})
            if not isinstance(freq, int) or isinstance(freq, bool) \
                    or freq < 1:
                raise QueryException(
                    "periodic commit frequency must be a positive "
                    f"integer, got {freq!r}")
        owner = getattr(ctx, "_txn_owner", None)
        if owner is None:
            raise QueryException(
                "USING PERIODIC COMMIT requires an implicit (autocommit) "
                "transaction")
        pulled = 0
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            pulled += 1
            if pulled >= freq:
                owner.renew()
                pulled = 0
            yield frame
        if pulled:
            owner.renew()   # remainder batch, mirroring the reference

    def children(self):
        return [self.input]


@dataclass
class Apply(LogicalOperator):
    """CALL { subquery }: run the subplan per input row; merge returned
    columns (or pass rows through for unit subqueries).

    batch_rows (CALL { } IN TRANSACTIONS OF n ROWS): commit the enclosing
    autocommit transaction and open a fresh one every n input rows —
    periodic-commit batching for huge loads (reference: PeriodicCommit,
    plan/operator.hpp). Restriction: frames crossing the batch boundary
    must not carry graph values (their accessors die with the committed
    transaction); the operator enforces this with a clear error.
    """
    input: LogicalOperator
    subplan: LogicalOperator
    columns: list[str]
    batch_rows: Optional[int] = None

    def cursor(self, ctx):
        since_commit = 0
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            if self.batch_rows:
                self._guard_frame(frame, "input row")
                if since_commit >= self.batch_rows:
                    self._renew_transaction(ctx)
                    since_commit = 0
            sub_rows = _run_subplan(self.subplan, ctx, frame)
            since_commit += 1
            if not self.columns:
                yield frame  # unit subquery: cardinality preserved
                continue
            for sub in sub_rows:
                row = sub.get("__row__", {})
                merged = dict(frame)
                for col in self.columns:
                    merged[col] = row.get(col, sub.get(col))
                if self.batch_rows:
                    # subquery outputs may outlive this batch's transaction
                    # downstream — graph values would silently go stale
                    self._guard_frame({c: merged[c] for c in self.columns},
                                      "subquery result")
                yield merged

    @staticmethod
    def _contains_graph_value(value) -> bool:
        if isinstance(value, (VertexAccessor, EdgeAccessor, Path)):
            return True
        if isinstance(value, (list, tuple)):
            return any(Apply._contains_graph_value(v) for v in value)
        if isinstance(value, dict):
            return any(Apply._contains_graph_value(v)
                       for v in value.values())
        return False

    @staticmethod
    def _guard_frame(frame: dict, where: str) -> None:
        for key, value in frame.items():
            if key.startswith("__"):
                continue
            if Apply._contains_graph_value(value):
                raise QueryException(
                    "CALL { } IN TRANSACTIONS cannot carry graph values "
                    f"({key}, in the {where}) across batch boundaries — "
                    "their transaction commits mid-query; project scalar "
                    "values (ids, properties) instead")

    @staticmethod
    def _renew_transaction(ctx) -> None:
        if getattr(ctx, "_txn_owner", None) is None:
            raise QueryException(
                "CALL { } IN TRANSACTIONS requires an implicit "
                "(autocommit) transaction")
        ctx._txn_owner.renew()

    def children(self):
        return [self.input, self.subplan]


@dataclass
class Union(LogicalOperator):
    left: LogicalOperator
    right: LogicalOperator
    symbols: list[str]
    distinct: bool

    input: None = None

    def cursor(self, ctx):
        seen = set()
        for plan in (self.left, self.right):
            for frame in plan.cursor(ctx):
                row = frame.get("__row__", {})
                out = {s: row.get(s) for s in self.symbols}
                if self.distinct:
                    key = tuple(V.hashable_key(out[s]) for s in self.symbols)
                    if key in seen:
                        continue
                    seen.add(key)
                yield {**out, "__row__": out}

    def children(self):
        return [self.left, self.right]


@dataclass
class Foreach(LogicalOperator):
    input: LogicalOperator
    symbol: str
    list_expr: A.Expr
    update_plan: LogicalOperator

    def cursor(self, ctx):
        for frame in self.input.cursor(ctx):
            lst = ctx.evaluator.eval(self.list_expr, frame)
            if lst is not None:
                if not isinstance(lst, (list, tuple)):
                    raise TypeException("FOREACH requires a list")
                for item in lst:
                    inner = dict(frame)
                    inner[self.symbol] = item
                    for _ in _run_subplan(self.update_plan, ctx, inner):
                        pass
            yield frame

    def children(self):
        return [self.input, self.update_plan]


@dataclass
class LoadCsvOp(LogicalOperator):
    """Stream rows from a CSV file (reference: operator.hpp:2883 LoadCsv).
    With header → map rows; without → list rows. Values stay strings
    (explicit casts in the query, matching the reference's LOAD CSV)."""
    input: LogicalOperator
    file: A.Expr
    symbol: str
    with_header: bool
    ignore_bad: bool
    delimiter: Optional[A.Expr]
    quote: Optional[A.Expr]

    def cursor(self, ctx):
        cfg = getattr(ctx.interpreter_context, "config", None) or {}
        if not cfg.get("allow_load_csv", True):
            raise QueryException(
                "LOAD CSV is disabled (--no-allow-load-csv)")
        import csv as csvlib
        for frame in self.input.cursor(ctx):
            path = ctx.evaluator.eval(self.file, frame)
            if not isinstance(path, str):
                raise TypeException("LOAD CSV FROM requires a string path")
            delim = (ctx.evaluator.eval(self.delimiter, frame)
                     if self.delimiter is not None else ",")
            quote = (ctx.evaluator.eval(self.quote, frame)
                     if self.quote is not None else '"')
            try:
                f = open(path, newline="", encoding="utf-8")
            except OSError as e:
                raise QueryException(f"cannot open CSV file: {e}") from e
            with f:
                reader = csvlib.reader(f, delimiter=delim, quotechar=quote)
                header = None
                for lineno, row in enumerate(reader):
                    ctx.check_abort()
                    if self.with_header and header is None:
                        header = row
                        continue
                    if self.with_header:
                        if len(row) != len(header):
                            if self.ignore_bad:
                                continue
                            raise QueryException(
                                f"CSV row {lineno + 1} has {len(row)} "
                                f"fields, header has {len(header)}")
                        value = dict(zip(header, row))
                    else:
                        value = list(row)
                    new = dict(frame)
                    new[self.symbol] = value
                    yield new


@dataclass
class LoadJsonlOp(LogicalOperator):
    """Stream objects from a JSON-lines file (reference: LoadJsonl,
    query/jsonl/reader.cppm)."""
    input: LogicalOperator
    file: A.Expr
    symbol: str

    def cursor(self, ctx):
        import json as jsonlib
        for frame in self.input.cursor(ctx):
            path = ctx.evaluator.eval(self.file, frame)
            if not isinstance(path, str):
                raise TypeException("LOAD JSONL FROM requires a string path")
            try:
                f = open(path, encoding="utf-8")
            except OSError as e:
                raise QueryException(f"cannot open JSONL file: {e}") from e
            with f:
                for line in f:
                    ctx.check_abort()
                    line = line.strip()
                    if not line:
                        continue
                    new = dict(frame)
                    new[self.symbol] = jsonlib.loads(line)
                    yield new


@dataclass
class LoadParquetOp(LogicalOperator):
    """Stream rows from a Parquet file via pyarrow (reference: LoadParquet,
    query/arrow_parquet/reader.cppm)."""
    input: LogicalOperator
    file: A.Expr
    symbol: str

    def cursor(self, ctx):
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover
            raise QueryException("pyarrow is not available") from e
        for frame in self.input.cursor(ctx):
            path = ctx.evaluator.eval(self.file, frame)
            if not isinstance(path, str):
                raise TypeException("LOAD PARQUET FROM requires a string path")
            table = pq.read_table(path)
            for batch in table.to_batches():
                rows = batch.to_pylist()
                for row in rows:
                    ctx.check_abort()
                    new = dict(frame)
                    new[self.symbol] = row
                    yield new


def _expr_references(expr, names) -> bool:
    """Does an expression tree mention any Identifier in `names`?"""
    import dataclasses
    if isinstance(expr, A.Identifier):
        return expr.name in names
    if dataclasses.is_dataclass(expr) and not isinstance(expr, type):
        return any(_expr_references(getattr(expr, f.name), names)
                   for f in dataclasses.fields(expr))
    if isinstance(expr, (list, tuple)):
        return any(_expr_references(e, names) for e in expr)
    if isinstance(expr, dict):
        return any(_expr_references(e, names) for e in expr.values())
    return False


def _compile_value_fn(expr, parameters):
    """Closure for trivially-evaluable expressions (literal / identifier /
    parameter / constant list subscript) on the bulk lane's per-row hot
    path — mirrors the evaluator's semantics for exactly these shapes.
    None = not compilable, caller keeps the generic evaluator."""
    if isinstance(expr, A.Literal):
        value = expr.value
        return lambda frame: value
    if isinstance(expr, A.Identifier):
        name = expr.name
        return lambda frame: frame.get(name)
    if isinstance(expr, A.Parameter):
        if expr.name not in parameters:
            return None     # let the evaluator raise its own error
        value = parameters[expr.name]
        return lambda frame: value
    if isinstance(expr, A.Subscript) and isinstance(expr.expr, A.Identifier) \
            and isinstance(expr.index, A.Literal):
        name = expr.expr.name
        idx = expr.index.value
        if isinstance(idx, int) and not isinstance(idx, bool):
            def list_item(frame):
                obj = frame.get(name)
                if obj is None:
                    return None
                if isinstance(obj, (list, tuple)):
                    if idx < -len(obj) or idx >= len(obj):
                        return None
                    return obj[idx]
                if isinstance(obj, dict):
                    raise TypeException("map key must be a string")
                raise TypeException("subscript on a non-list value")
            return list_item
        # string subscripts can hit maps OR graph entities at runtime —
        # those keep the generic evaluator
    if isinstance(expr, A.Binary):
        op_fn = _COMPILED_BINOPS.get(expr.op)
        if op_fn is not None:
            lf = _compile_value_fn(expr.left, parameters)
            rf = _compile_value_fn(expr.right, parameters)
            if lf is not None and rf is not None:
                # delegates to the evaluator's own arithmetic functions,
                # so null propagation / type rules stay identical
                return lambda frame: op_fn(lf(frame), rf(frame))
    return None


_COMPILED_BINOPS = {
    "+": V.cypher_add, "-": V.cypher_sub, "*": V.cypher_mul,
    "/": V.cypher_div, "%": V.cypher_mod, "^": V.cypher_pow,
}


@dataclass
class BatchNodeStep:
    """One per-row vertex creation inside the bulk-write fast lane."""
    symbol: str
    labels: list[str]
    properties: object           # dict[str, Expr] | A.Parameter | None


@dataclass
class BatchEdgeStep:
    """One per-row edge creation inside the bulk-write fast lane. Endpoints
    resolve to a same-row BatchNodeStep symbol or a frame-bound vertex."""
    from_symbol: str
    edge_symbol: str
    to_symbol: str
    direction: str               # 'out' | 'in'
    edge_type: str
    edge_properties: object


@dataclass
class BatchCreateGraph(LogicalOperator):
    """Bulk-write fast lane: executes a root chain of CreateNode /
    CreateExpand steps over ALL input rows with one storage
    ``batch_insert()`` call instead of per-row operator pulls — one gid
    reservation, one undo delta per object, bulk-merged index maintenance,
    one WAL record, one change-log bump per batch.

    Installed by query/plan/bulk.py only at the root of write-only plans
    (no downstream consumer exists), so it yields no frames. Engines that
    don't support batch_insert fall back to equivalent per-row creates.

    When the row source is a pure point-lookup pipeline (UNWIND /
    equality-index scans over a simple base), bulk.py additionally folds
    it into `pipeline` and the cursor runs the lookups inline against the
    label+property index — skipping per-row generator frames, dict copies,
    and the Eager barrier's bookkeeping (safe: the batch path defers every
    write until the input is fully consumed anyway).
    """
    input: LogicalOperator
    steps: list                  # BatchNodeStep | BatchEdgeStep, row order
    pipeline_base: object = None   # base operator of the folded pipeline
    pipeline: list = None          # [("unwind", expr, sym) |
    #                                 ("scan", sym, label, props, exprs)]

    def cursor(self, ctx):
        storage = ctx.storage
        acc = ctx.accessor
        if not getattr(storage, "supports_batch_insert", False) \
                or not hasattr(acc, "batch_insert"):
            yield from self._row_fallback(ctx)
            return

        # resolve name->id mappings and compile property maps once per
        # batch, not once per row
        name_to_pid = storage.property_mapper.name_to_id

        def compile_props(properties):
            """[(pid, fn_or_None, expr)] for a static map; None when the
            map itself is dynamic (a $parameter)."""
            if properties is None:
                return ()
            if isinstance(properties, A.Parameter):
                return None
            return [(name_to_pid(k), _compile_value_fn(e, ctx.parameters), e)
                    for k, e in properties.items()]

        resolved = []
        for step in self.steps:
            if isinstance(step, BatchNodeStep):
                resolved.append((step, tuple(
                    storage.label_mapper.name_to_id(l)
                    for l in step.labels),
                    compile_props(step.properties)))
            else:
                resolved.append((step, storage.edge_type_mapper.name_to_id(
                    step.edge_type),
                    compile_props(step.edge_properties)))
        pid_cache: dict[str, int] = {}
        evaluator = ctx.evaluator

        def prop_ids(compiled, properties, frame) -> dict:
            out = {}
            if compiled is None:    # $parameter map: dynamic keys
                for key, value in _eval_prop_map(ctx, properties,
                                                 frame).items():
                    if value is None:
                        continue
                    pid = pid_cache.get(key)
                    if pid is None:
                        pid = name_to_pid(key)
                        pid_cache[key] = pid
                    out[pid] = value
                return out
            for pid, fn, expr in compiled:
                value = fn(frame) if fn is not None \
                    else evaluator.eval(expr, frame)
                if value is not None:
                    out[pid] = value
            return out

        vertices: list = []
        edges: list = []
        counters = [0, 0, 0]     # rows, labels_added, props_set
        single = len(resolved) == 1
        first_step, first_ids, first_compiled = resolved[0]
        single_node = single and isinstance(first_step, BatchNodeStep)
        single_edge = single and isinstance(first_step, BatchEdgeStep)

        def process_row(frame):
            counters[0] += 1
            if not counters[0] % 1024:
                ctx.check_abort()
            if single_node:
                # the dominant UNWIND…CREATE-one-node shape, un-dispatched
                props = prop_ids(first_compiled, first_step.properties,
                                 frame)
                vertices.append((first_ids, props))
                counters[1] += len(first_ids)
                counters[2] += len(props)
                return
            if single_edge:
                # the dominant MATCH-endpoints…CREATE-one-edge shape
                from_ref = frame.get(first_step.from_symbol)
                if isinstance(from_ref, VertexAccessor):
                    from_ref = from_ref.vertex
                elif not isinstance(from_ref, Vertex):
                    raise QueryException(
                        "CREATE edge endpoint is not a node")
                to_ref = frame.get(first_step.to_symbol)
                if isinstance(to_ref, VertexAccessor):
                    to_ref = to_ref.vertex
                elif not isinstance(to_ref, Vertex):
                    raise QueryException(
                        "CREATE edge endpoint is not a node")
                if first_compiled == ():
                    props = None     # no property map: share the no-op
                else:
                    props = prop_ids(first_compiled,
                                     first_step.edge_properties, frame)
                    counters[2] += len(props)
                if first_step.direction == "in":
                    from_ref, to_ref = to_ref, from_ref
                edges.append((first_ids, from_ref, to_ref, props))
                return
            refs: dict[str, object] = {}
            for step, ids, compiled in resolved:
                if isinstance(step, BatchNodeStep):
                    props = prop_ids(compiled, step.properties, frame)
                    refs[step.symbol] = len(vertices)
                    vertices.append((ids, props))
                    counters[1] += len(ids)
                    counters[2] += len(props)
                else:
                    from_ref = refs.get(step.from_symbol)
                    if from_ref is None:
                        from_ref = frame.get(step.from_symbol)
                        if isinstance(from_ref, VertexAccessor):
                            from_ref = from_ref.vertex
                        elif not isinstance(from_ref, Vertex):
                            raise QueryException(
                                "CREATE edge endpoint is not a node")
                    to_ref = refs.get(step.to_symbol)
                    if to_ref is None:
                        to_ref = frame.get(step.to_symbol)
                        if isinstance(to_ref, VertexAccessor):
                            to_ref = to_ref.vertex
                        elif not isinstance(to_ref, Vertex):
                            raise QueryException(
                                "CREATE edge endpoint is not a node")
                    props = prop_ids(compiled, step.edge_properties, frame)
                    counters[2] += len(props)
                    if step.direction == "in":
                        from_ref, to_ref = to_ref, from_ref
                    edges.append((ids, from_ref, to_ref, props))

        self._drive_rows(ctx, process_row)
        acc.batch_insert(vertices, edges)
        ctx.stats["nodes_created"] += len(vertices)
        ctx.stats["relationships_created"] += len(edges)
        ctx.stats["labels_added"] += counters[1]
        ctx.stats["properties_set"] += counters[2]
        return
        yield  # pragma: no cover — marks cursor() as a generator

    def _drive_rows(self, ctx, process_row):
        """Feed frames to process_row: the folded point-lookup pipeline
        when usable, else the generic input subtree (minus a redundant top
        Eager barrier — the batch path defers every write past input
        exhaustion, which is exactly the guarantee Eager provides)."""
        if self.pipeline is not None and ctx.accessor.fine_grained is None:
            resolved = self._resolve_pipeline(ctx)
            if resolved == "empty":
                return
            if resolved is not None:
                self._pipeline_run(ctx, resolved, process_row)
                return
        source = self.input
        if isinstance(source, Eager):
            source = source.input
        for frame in source.cursor(ctx):
            process_row(frame)

    def _resolve_pipeline(self, ctx):
        """Map stage names to ids; None = fall back to the generic source
        (an equality scan without its composite index), "empty" = an
        unknown label/property name can match nothing."""
        storage = ctx.storage
        out = []
        for stage in self.pipeline:
            if stage[0] == "unwind":
                out.append(stage)
                continue
            _tag, sym, label, props, exprs = stage
            lid = storage.label_mapper.maybe_name_to_id(label)
            pids = tuple(storage.property_mapper.maybe_name_to_id(p)
                         for p in props)
            if lid is None or any(p is None for p in pids):
                return "empty"
            slot = storage.indices.label_property._index.get((lid, pids))
            if slot is None:
                return None
            out.append(("scan", sym, lid, pids, exprs, slot["eq"]))
        return out

    def _steps_reference(self, names) -> bool:
        """True when any step property expression references one of
        `names` (then frames must carry full accessors, not raw
        vertices)."""
        for step in self.steps:
            props = step.properties if isinstance(step, BatchNodeStep) \
                else step.edge_properties
            if props is None:
                continue
            exprs = props.values() if isinstance(props, dict) else [props]
            for e in exprs:
                if _expr_references(e, names):
                    return True
        return False

    def _pipeline_run(self, ctx, stages, emit):
        from ...storage.mvcc import state_is_current
        evaluator = ctx.evaluator
        view = ctx.view
        acc = ctx.accessor
        txn = acc.txn
        n_stages = len(stages)
        # bind raw Vertex objects for scan symbols no step expression
        # reads back — skips one accessor allocation per matched row
        scan_syms = {s[1] for s in stages if s[0] == "scan"}
        raw_bind = not self._steps_reference(scan_syms)

        def compiled(exprs):
            return [(_compile_value_fn(e, ctx.parameters), e)
                    for e in exprs]

        stages = [
            ("unwind", compiled([stage[1]])[0], stage[2])
            if stage[0] == "unwind" else
            ("scan", stage[1], stage[2], stage[3], compiled(stage[4]),
             stage[5])
            for stage in stages]

        def flat_run():
            """Fully-inlined loop for THE bulk-load shape — one UNWIND
            followed only by equality scans — avoiding a Python frame per
            stage per row. Multi-candidate or composite-key rows fall back
            to the generic expand() from the stage that needs it."""
            from ...storage.common import (TRANSACTION_ID_START,
                                           IsolationLevel)
            _t0, (ufn, uexpr), usym = stages[0]
            scan_stages = stages[1:]
            txn_id = txn.id
            # effective_start_ts is constant during execution under
            # snapshot isolation (the default) — hoist it; other levels
            # keep the per-candidate call
            si_mode = txn.isolation is IsolationLevel.SNAPSHOT_ISOLATION \
                and view is View.NEW
            start_ts = txn.effective_start_ts() if si_mode else 0
            for base_frame in self.pipeline_base.cursor(ctx):
                frame = base_frame
                lst = ufn(frame) if ufn is not None \
                    else evaluator.eval(uexpr, frame)
                if lst is None:
                    continue
                if not isinstance(lst, (list, tuple)):
                    raise TypeException("UNWIND requires a list")
                for item in lst:
                    frame[usym] = item
                    ok = True
                    si = 1
                    for stage in scan_stages:
                        _t, sym, lid, pids, exprs, eq = stage
                        if len(exprs) != 1:
                            ok = None      # composite key: generic path
                            break
                        fn, e = exprs[0]
                        v0 = fn(frame) if fn is not None \
                            else evaluator.eval(e, frame)
                        if v0 is None:
                            ok = False
                            break
                        bucket = eq.get((order_key(v0),))
                        if not bucket:
                            ok = False
                            break
                        if len(bucket) != 1:
                            ok = None      # cartesian: generic path
                            break
                        vertex = bucket[0]
                        lock = vertex.lock
                        lock.acquire()
                        if si_mode:
                            d = vertex.delta
                            current = d is None or \
                                (ts := d.commit_info.timestamp) == txn_id \
                                or (ts < TRANSACTION_ID_START
                                    and ts <= start_ts)
                        else:
                            current = state_is_current(vertex, txn, view)
                        if current:
                            bad = (vertex.deleted
                                   or lid not in vertex.labels
                                   or vertex.properties.get(pids[0]) != v0)
                            lock.release()
                        else:
                            lock.release()
                            st = acc._vertex_state(vertex, view, False)
                            bad = (not st.exists or st.deleted
                                   or lid not in st.labels
                                   or st.properties.get(pids[0]) != v0)
                        if bad:
                            ok = False
                            break
                        frame[sym] = vertex if raw_bind \
                            else VertexAccessor(vertex, acc)
                        si += 1
                    if ok:
                        emit(frame)
                    elif ok is None:
                        expand(frame, si)
                frame.pop(usym, None)

        def expand(frame, si):
            if si == n_stages:
                emit(frame)
                return
            stage = stages[si]
            if stage[0] == "unwind":
                _t, (fn, expr), sym = stage
                value = fn(frame) if fn is not None \
                    else evaluator.eval(expr, frame)
                if value is None:
                    return
                if not isinstance(value, (list, tuple)):
                    raise TypeException("UNWIND requires a list")
                nxt = si + 1
                for item in value:
                    frame[sym] = item
                    expand(frame, nxt)
                frame.pop(sym, None)
                return
            _t, sym, lid, pids, exprs, eq = stage
            if len(exprs) == 1:
                fn, e = exprs[0]
                v0 = fn(frame) if fn is not None \
                    else evaluator.eval(e, frame)
                if v0 is None:
                    return  # = null never matches
                values = (v0,)
                candidates = eq.get((order_key(v0),))
            else:
                values = [fn(frame) if fn is not None
                          else evaluator.eval(e, frame) for fn, e in exprs]
                if None in values:
                    return
                candidates = eq.get(tuple(order_key(v) for v in values))
            if candidates is None:
                return
            nxt = si + 1
            for vertex in candidates:
                # settled fast check: when the reader's view equals the
                # live fields, validate against them directly — no
                # MaterializedState allocation or dict/set copies
                lock = vertex.lock
                lock.acquire()
                if state_is_current(vertex, txn, view):
                    try:
                        if vertex.deleted or lid not in vertex.labels:
                            continue
                        props = vertex.properties
                        skip = False
                        for p, v in zip(pids, values):
                            if props.get(p) != v:
                                skip = True
                                break
                        if skip:
                            continue
                    finally:
                        lock.release()
                else:
                    lock.release()
                    st = acc._vertex_state(vertex, view, False)
                    if not st.exists or st.deleted or lid not in st.labels:
                        continue
                    props = st.properties
                    skip = False
                    for p, v in zip(pids, values):
                        if props.get(p) != v:
                            skip = True
                            break
                    if skip:
                        continue
                frame[sym] = vertex if raw_bind \
                    else VertexAccessor(vertex, acc)
                expand(frame, nxt)
            frame.pop(sym, None)

        if n_stages and stages[0][0] == "unwind" \
                and all(s[0] == "scan" for s in stages[1:]):
            flat_run()
            return
        for base_frame in self.pipeline_base.cursor(ctx):
            expand(base_frame, 0)

    def _row_fallback(self, ctx):
        """Per-row creates with identical semantics, for engines without
        batch_insert (the on-disk engine)."""
        storage = ctx.storage
        for frame in self.input.cursor(ctx):
            ctx.check_abort()
            env = dict(frame)
            for step in self.steps:
                if isinstance(step, BatchNodeStep):
                    va = ctx.accessor.create_vertex()
                    ctx.stats["nodes_created"] += 1
                    for label in step.labels:
                        va.add_label(storage.label_mapper.name_to_id(label))
                        ctx.stats["labels_added"] += 1
                    for key, value in _eval_prop_map(
                            ctx, step.properties, frame).items():
                        if value is not None:
                            va.set_property(
                                storage.property_mapper.name_to_id(key),
                                value)
                            ctx.stats["properties_set"] += 1
                    env[step.symbol] = va
                else:
                    from_v = env.get(step.from_symbol)
                    to_v = env.get(step.to_symbol)
                    if not isinstance(from_v, VertexAccessor) or \
                            not isinstance(to_v, VertexAccessor):
                        raise QueryException(
                            "CREATE edge endpoint is not a node")
                    tid = storage.edge_type_mapper.name_to_id(step.edge_type)
                    if step.direction == "in":
                        ea = ctx.accessor.create_edge(to_v, from_v, tid)
                    else:
                        ea = ctx.accessor.create_edge(from_v, to_v, tid)
                    ctx.stats["relationships_created"] += 1
                    for key, value in _eval_prop_map(
                            ctx, step.edge_properties, frame).items():
                        if value is not None:
                            ea.set_property(
                                storage.property_mapper.name_to_id(key),
                                value)
                            ctx.stats["properties_set"] += 1
                    env[step.edge_symbol] = ea
        return
        yield  # pragma: no cover


@dataclass
class Accumulate(LogicalOperator):
    """Materialize all input rows before streaming (write barrier between
    updating clauses and RETURN — reference: Accumulate operator)."""
    input: LogicalOperator

    def cursor(self, ctx):
        rows = []
        for frame in self.input.cursor(ctx):
            ctx.memory.add_value(frame)
            rows.append(frame)
        yield from rows
