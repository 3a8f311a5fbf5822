"""Tree-walking expression evaluator over a frame of bound symbols.

Counterpart of the reference's ExpressionEvaluator
(memgraph/src/query/interpret/eval.hpp): evaluates AST expressions
against a dict frame, with openCypher null propagation, property access on
graph objects, list/map operations, quantifiers, CASE, and the builtin
function library (functions.py).

Copy of memgraph_tpu/query/eval.py for the port (its imports the port's own).
"""

from __future__ import annotations

import re

from ..exceptions import EntityNotFound, SemanticException, TypeException
from ..storage.common import View
from ..storage.storage import EdgeAccessor, VertexAccessor
from .frontend import ast as A
from . import values as V
from .values import Path


class EvalContext:
    """Evaluation environment: storage accessor, parameters, view."""

    def __init__(self, accessor, parameters=None, view: View = View.NEW,
                 functions=None):
        self.accessor = accessor
        self.parameters = parameters or {}
        self.view = view
        if functions is None:
            from .functions import FUNCTIONS
            functions = FUNCTIONS
        self.functions = functions

    @property
    def storage(self):
        return self.accessor.storage


class Evaluator:
    def __init__(self, ctx: EvalContext) -> None:
        self.ctx = ctx

    def eval(self, expr: A.Expr, frame: dict):
        method = getattr(self, "_eval_" + type(expr).__name__, None)
        if method is None:
            raise SemanticException(
                f"unsupported expression: {type(expr).__name__}")
        return method(expr, frame)

    # --- leaves -------------------------------------------------------------

    def _eval_Literal(self, e: A.Literal, frame):
        return e.value

    def _eval_Parameter(self, e: A.Parameter, frame):
        if e.name not in self.ctx.parameters:
            raise SemanticException(f"parameter ${e.name} not provided")
        return self.ctx.parameters[e.name]

    def _eval_Identifier(self, e: A.Identifier, frame):
        if e.name not in frame:
            raise SemanticException(f"unbound variable: {e.name}")
        return frame[e.name]

    # --- structure access ---------------------------------------------------

    def _eval_PropertyLookup(self, e: A.PropertyLookup, frame):
        obj = self.eval(e.expr, frame)
        return self.get_property(obj, e.prop)

    def get_property(self, obj, prop: str):
        if obj is None:
            return None
        if isinstance(obj, dict):
            return obj.get(prop)
        if isinstance(obj, VertexAccessor) or isinstance(obj, EdgeAccessor):
            st = self.checked_state(obj)
            pid = self.ctx.storage.property_mapper.maybe_name_to_id(prop)
            if pid is None:
                return None
            return st.properties.get(pid)
        # temporal/point component access (d.year, p.x, ...)
        attr = getattr(type(obj), prop, None)
        if attr is not None and isinstance(attr, property):
            return getattr(obj, prop)
        if hasattr(obj, prop) and not callable(getattr(obj, prop)):
            return getattr(obj, prop)
        raise TypeException(
            f"property access on {V.type_name(obj)} is not supported")

    def checked_state(self, obj):
        """Materialized accessor state; raises on a deleted entity
        (TCK DeletedEntityAccess; reference: ExpressionEvaluator raises
        on property/label access of deleted objects, eval.hpp)."""
        if isinstance(obj, VertexAccessor):
            # property/label reads: skip the O(degree) adjacency copy
            st = obj._state(self.ctx.view, need_edges=False)
        else:
            st = obj._state(self.ctx.view)
        if not st.exists or st.deleted:
            kind = ("node" if isinstance(obj, VertexAccessor)
                    else "relationship")
            raise EntityNotFound(
                f"cannot access properties of a deleted {kind}")
        return st

    def _eval_LabelsTest(self, e: A.LabelsTest, frame):
        obj = self.eval(e.expr, frame)
        if obj is None:
            return None
        if not isinstance(obj, VertexAccessor):
            raise TypeException("labels test on a non-node value")
        mapper = self.ctx.storage.label_mapper
        for name in e.labels:
            lid = mapper.maybe_name_to_id(name)
            if lid is None or not obj.has_label(lid, self.ctx.view):
                return False
        return True

    def _eval_IsNull(self, e: A.IsNull, frame):
        v = self.eval(e.expr, frame)
        return (v is not None) if e.negated else (v is None)

    def _eval_Subscript(self, e: A.Subscript, frame):
        obj = self.eval(e.expr, frame)
        idx = self.eval(e.index, frame)
        if obj is None or idx is None:
            return None
        if isinstance(obj, (list, tuple)):
            if not isinstance(idx, int) or isinstance(idx, bool):
                raise TypeException("list index must be an integer")
            if idx < -len(obj) or idx >= len(obj):
                return None
            return obj[idx]
        if isinstance(obj, dict):
            if not isinstance(idx, str):
                raise TypeException("map key must be a string")
            return obj.get(idx)
        if isinstance(obj, (VertexAccessor, EdgeAccessor)):
            if not isinstance(idx, str):
                raise TypeException("property key must be a string")
            return self.get_property(obj, idx)
        raise TypeException(f"subscript on {V.type_name(obj)}")

    def _eval_Slice(self, e: A.Slice, frame):
        obj = self.eval(e.expr, frame)
        if obj is None:
            return None
        if not isinstance(obj, (list, tuple)):
            raise TypeException("slice on a non-list value")
        lo = self.eval(e.lo, frame) if e.lo is not None else 0
        hi = self.eval(e.hi, frame) if e.hi is not None else len(obj)
        if lo is None or hi is None:
            return None
        return list(obj[lo:hi])

    def _eval_ListLiteral(self, e: A.ListLiteral, frame):
        return [self.eval(item, frame) for item in e.items]

    def _eval_MapLiteral(self, e: A.MapLiteral, frame):
        return {k: self.eval(v, frame) for k, v in e.items.items()}

    # --- operators ----------------------------------------------------------

    def _eval_Unary(self, e: A.Unary, frame):
        v = self.eval(e.expr, frame)
        if e.op == "NOT":
            return V.ternary_not(v)
        if v is None:
            return None
        if e.op == "-":
            if V.is_numeric(v):
                return -v
            from ..utils.temporal import Duration
            if isinstance(v, Duration):
                return -v
            raise TypeException(f"cannot negate {V.type_name(v)}")
        if e.op == "+":
            if V.is_numeric(v):
                return v
            raise TypeException(f"invalid unary '+' on {V.type_name(v)}")
        raise SemanticException(f"unknown unary op {e.op}")

    def _eval_Binary(self, e: A.Binary, frame):
        op = e.op
        if op == "AND":
            return V.ternary_and(self.eval(e.left, frame),
                                 self.eval(e.right, frame))
        if op == "OR":
            return V.ternary_or(self.eval(e.left, frame),
                                self.eval(e.right, frame))
        if op == "XOR":
            return V.ternary_xor(self.eval(e.left, frame),
                                 self.eval(e.right, frame))
        a = self.eval(e.left, frame)
        b = self.eval(e.right, frame)
        if op == "+":
            return V.cypher_add(a, b)
        if op == "-":
            return V.cypher_sub(a, b)
        if op == "*":
            return V.cypher_mul(a, b)
        if op == "/":
            return V.cypher_div(a, b)
        if op == "%":
            return V.cypher_mod(a, b)
        if op == "^":
            return V.cypher_pow(a, b)
        if op == "=":
            return V.cypher_eq(a, b)
        if op == "<>":
            r = V.cypher_eq(a, b)
            return None if r is None else not r
        if op == "<":
            return V.cypher_lt(a, b)
        if op == ">":
            return V.cypher_lt(b, a)
        if op == "<=":
            lt = V.cypher_lt(a, b)
            if lt is True:
                return True
            eq = V.cypher_eq(a, b)
            if lt is None or eq is None:
                return None
            return bool(eq)
        if op == ">=":
            lt = V.cypher_lt(b, a)
            if lt is True:
                return True
            eq = V.cypher_eq(a, b)
            if lt is None or eq is None:
                return None
            return bool(eq)
        if op == "IN":
            return self._eval_in(a, b)
        if op == "STARTS WITH":
            return self._string_pred(a, b, str.startswith)
        if op == "ENDS WITH":
            return self._string_pred(a, b, str.endswith)
        if op == "CONTAINS":
            return self._string_pred(a, b, str.__contains__)
        if op == "=~":
            if a is None or b is None:
                return None
            if not isinstance(a, str) or not isinstance(b, str):
                raise TypeException("regex match requires strings")
            return re.fullmatch(b, a) is not None
        raise SemanticException(f"unknown operator {op}")

    @staticmethod
    def _string_pred(a, b, fn):
        # non-string operands yield null, not an error (TCK
        # StartsWithAcceptance "Handling non-string operands")
        if not isinstance(a, str) or not isinstance(b, str):
            return None
        return fn(a, b)

    @staticmethod
    def _eval_in(a, b):
        if b is None:
            return None
        if not isinstance(b, (list, tuple)):
            raise TypeException("IN requires a list")
        if a is None:
            return None if b else False
        saw_null = False
        for item in b:
            r = V.cypher_eq(a, item)
            if r is True:
                return True
            if r is None:
                saw_null = True
        return None if saw_null else False

    # --- functions / higher-order -------------------------------------------

    def _eval_FunctionCall(self, e: A.FunctionCall, frame):
        fn = self.ctx.functions.get(e.name)
        if fn is None:
            raise SemanticException(f"unknown function: {e.name}()")
        args = [self.eval(a, frame) for a in e.args]
        return fn(self, args)

    def _eval_CountStar(self, e, frame):
        raise SemanticException("count(*) is only valid in RETURN/WITH")

    def _eval_CaseExpr(self, e: A.CaseExpr, frame):
        if e.test is not None:
            test = self.eval(e.test, frame)
            for cond, result in e.whens:
                if V.cypher_eq(test, self.eval(cond, frame)) is True:
                    return self.eval(result, frame)
        else:
            for cond, result in e.whens:
                if self.eval(cond, frame) is True:
                    return self.eval(result, frame)
        return self.eval(e.default, frame) if e.default is not None else None

    def _eval_ListComprehension(self, e: A.ListComprehension, frame):
        lst = self.eval(e.list_expr, frame)
        if lst is None:
            return None
        if not isinstance(lst, (list, tuple)):
            raise TypeException("list comprehension requires a list")
        out = []
        inner = dict(frame)
        for item in lst:
            inner[e.var] = item
            if e.where is not None and self.eval(e.where, inner) is not True:
                continue
            out.append(self.eval(e.projection, inner)
                       if e.projection is not None else item)
        return out

    def _eval_Quantifier(self, e: A.Quantifier, frame):
        lst = self.eval(e.list_expr, frame)
        if lst is None:
            return None
        if not isinstance(lst, (list, tuple)):
            raise TypeException(f"{e.kind} requires a list")
        inner = dict(frame)
        results = []
        for item in lst:
            inner[e.var] = item
            results.append(self.eval(e.where, inner))
        trues = sum(1 for r in results if r is True)
        nulls = sum(1 for r in results if r is None)
        n = len(results)
        if e.kind == "ALL":
            if trues == n:
                return True
            return None if trues + nulls == n else False
        if e.kind == "ANY":
            if trues > 0:
                return True
            return None if nulls > 0 else False
        if e.kind == "NONE":
            if trues > 0:
                return False
            return None if nulls > 0 else True
        if e.kind == "SINGLE":
            if nulls:
                return None
            return trues == 1
        raise SemanticException(f"unknown quantifier {e.kind}")

    def _eval_Reduce(self, e: A.Reduce, frame):
        lst = self.eval(e.list_expr, frame)
        if lst is None:
            return None
        if not isinstance(lst, (list, tuple)):
            raise TypeException("reduce requires a list")
        acc = self.eval(e.init, frame)
        inner = dict(frame)
        for item in lst:
            inner[e.acc] = acc
            inner[e.var] = item
            acc = self.eval(e.expr, inner)
        return acc

    def _eval_PatternExpr(self, e: A.PatternExpr, frame):
        """exists((n)-[...]->(m)) — run a mini-match anchored on bound vars."""
        from .plan.pattern_match import match_pattern_anchored
        for _ in match_pattern_anchored(self.ctx, e.pattern, frame):
            return True
        return False

    def _eval_EnumLiteral(self, e: A.EnumLiteral, frame):
        # positions are immutable (no redefinition, ALTER only appends), so a
        # literal resolves once per (AST node, storage) and is memoized
        storage = self.ctx.storage
        memo = e.resolved
        if memo is not None and memo[0]() is storage:
            return memo[1]
        import weakref
        from ..storage.enums import enum_registry
        value = enum_registry(storage).value(e.enum_name, e.value_name)
        e.resolved = (weakref.ref(storage), value)
        return value

    def _eval_PatternComprehension(self, e: A.PatternComprehension, frame):
        """[(n)-->(m) WHERE pred | expr] — collect projections per match."""
        from .plan.pattern_match import match_pattern_anchored
        out = []
        for match_frame in match_pattern_anchored(self.ctx, e.pattern, frame):
            inner = dict(frame)
            inner.update(match_frame)
            if e.where is not None and self.eval(e.where, inner) is not True:
                continue
            out.append(self.eval(e.projection, inner))
        return out
