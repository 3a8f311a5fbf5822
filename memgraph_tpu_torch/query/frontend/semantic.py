"""Compile-time semantic validation shared by the planner.

Counterpart of the reference's symbol generator / semantic checks
(memgraph/src/query/frontend/semantic/symbol_generator.cpp):
unbound-variable detection with correct binder scoping, plus the
openCypher error classes the TCK exercises (VariableAlreadyBound,
InvalidArgumentType for IN, aggregation placement, ...).

Copy of memgraph_tpu/query/frontend/semantic.py for the port (its imports the port's own).
"""

from __future__ import annotations

from ...exceptions import SemanticException
from . import ast as A


def check_expr_scope(expr: A.Expr | None, bound: set,
                     where: str = "expression") -> None:
    """Raise SemanticException for identifiers not in scope. `bound` is the
    set of visible variable names; binder expressions (comprehensions,
    reduce, quantifiers, pattern comprehensions) extend it locally."""
    if expr is None:
        return
    if isinstance(expr, A.Identifier):
        if expr.name not in bound:
            raise SemanticException(
                f"UndefinedVariable: {expr.name} is not defined "
                f"(in {where})")
        return
    if isinstance(expr, A.ListComprehension):
        check_expr_scope(expr.list_expr, bound, where)
        inner = bound | {expr.var}
        check_expr_scope(expr.where, inner, where)
        check_expr_scope(expr.projection, inner, where)
        return
    if isinstance(expr, A.Quantifier):
        check_expr_scope(expr.list_expr, bound, where)
        check_expr_scope(expr.where, bound | {expr.var}, where)
        return
    if isinstance(expr, A.Reduce):
        check_expr_scope(expr.init, bound, where)
        check_expr_scope(expr.list_expr, bound, where)
        check_expr_scope(expr.expr, bound | {expr.acc, expr.var}, where)
        return
    if isinstance(expr, (A.PatternExpr, A.PatternComprehension)):
        inner = set(bound)
        if expr.pattern.variable:
            inner.add(expr.pattern.variable)
        for item in expr.pattern.elements:   # [Node, Edge, Node, ...]
            if item.variable:
                inner.add(item.variable)
            props = getattr(item, "properties", None)
            if isinstance(props, dict):
                for v in props.values():
                    check_expr_scope(v, bound, where)
        if isinstance(expr, A.PatternComprehension):
            check_expr_scope(expr.where, inner, where)
            check_expr_scope(expr.projection, inner, where)
        return
    if isinstance(expr, A.Binary) and expr.op == "IN":
        # compile-time: IN with a literal non-list RHS
        # (TCK SemanticErrorAcceptance: InvalidArgumentType)
        rhs = expr.right
        if isinstance(rhs, A.Literal) and rhs.value is not None \
                and not isinstance(rhs.value, (list, tuple)):
            raise SemanticException(
                f"InvalidArgumentType: IN expects a list, "
                f"got {rhs.value!r}")
    for child in _children(expr):
        check_expr_scope(child, bound, where)


def _children(expr):
    from ..plan.planner import _children_exprs
    return _children_exprs(expr)


def _contains_call(expr, name: str) -> bool:
    if isinstance(expr, A.FunctionCall) and expr.name.lower() == name:
        return True
    return any(_contains_call(c, name) for c in _children(expr))


def check_static_types(expr: A.Expr | None, kinds: dict) -> None:
    """Static argument-type errors the TCK requires at COMPILE time
    (SemanticErrorAcceptance / SyntaxErrorAcceptance /
    MiscellaneousErrorAcceptance): functions applied to entity kinds they
    can never accept, property access on a variable-length relationship
    list, unknown function names, and non-deterministic rand() inside
    aggregations. `kinds` is the planner's variable->kind map
    (node|edge|path|edge_list|value)."""
    if expr is None:
        return
    # binders rebind their variable: the outer kind must not leak into
    # the body (e.g. [r IN [{a: 1}] | r.a] where r is a var-length rel)
    if isinstance(expr, (A.ListComprehension, A.Quantifier)):
        check_static_types(expr.list_expr, kinds)
        inner = {k: v for k, v in kinds.items() if k != expr.var}
        check_static_types(getattr(expr, "where", None), inner)
        check_static_types(getattr(expr, "projection", None), inner)
        return
    if isinstance(expr, A.Reduce):
        check_static_types(expr.init, kinds)
        check_static_types(expr.list_expr, kinds)
        inner = {k: v for k, v in kinds.items()
                 if k not in (expr.acc, expr.var)}
        check_static_types(expr.expr, inner)
        return
    if isinstance(expr, A.PatternComprehension):
        # pattern variables are fresh bindings local to the comprehension
        inner = dict(kinds)
        if expr.pattern.variable:
            inner.pop(expr.pattern.variable, None)
        for item in expr.pattern.elements:
            if item.variable:
                inner.pop(item.variable, None)
        check_static_types(expr.where, inner)
        check_static_types(expr.projection, inner)
        return
    if isinstance(expr, A.PropertyLookup) and isinstance(expr.expr,
                                                         A.Identifier):
        if kinds.get(expr.expr.name) == "edge_list":
            raise SemanticException(
                f"InvalidArgumentType: {expr.expr.name} is a variable "
                f"length relationship (a list), not a single relationship")
    if isinstance(expr, A.FunctionCall):
        name = expr.name.lower()
        arg_kind = None
        if expr.args and isinstance(expr.args[0], A.Identifier):
            arg_kind = kinds.get(expr.args[0].name)
        if name == "type" and arg_kind in ("node", "path"):
            raise SemanticException(
                f"InvalidArgumentType: type() expects a relationship, "
                f"got a {arg_kind}")
        if name == "length" and arg_kind in ("node", "edge"):
            raise SemanticException(
                f"InvalidArgumentType: length() expects a path, "
                f"got a {arg_kind}")
        if name == "size" and arg_kind in ("path", "node", "edge"):
            raise SemanticException(
                f"InvalidArgumentType: size() expects a list or string, "
                f"got a {arg_kind}")
        # exists() is intercepted by the parser (never a FunctionCall
        # here); its argument check lives in parser.py
        from ..functions import FUNCTIONS
        from ..plan.operators import AGGREGATE_FUNCTIONS
        if name in AGGREGATE_FUNCTIONS:
            for a in expr.args:
                if _contains_call(a, "rand"):
                    raise SemanticException(
                        "NonConstantExpression: rand() is not allowed "
                        "inside aggregation functions")
        elif name not in FUNCTIONS and "." not in expr.name:
            raise SemanticException(
                f"UnknownFunction: {expr.name}() is not a known function")
    for child in _children(expr):
        check_static_types(child, kinds)


def check_no_aggregates(expr: A.Expr | None, context: str) -> None:
    """Aggregation functions are invalid in WHERE / pattern properties /
    procedure args (TCK: InvalidAggregation)."""
    if expr is None:
        return
    from ..plan.planner import collect_aggregations
    aggs: list = []
    collect_aggregations(expr, aggs)
    if aggs:
        raise SemanticException(
            f"InvalidAggregation: aggregation functions are not allowed "
            f"in {context}")
