"""Cypher value semantics: ternary logic, equality, comparison, arithmetic.

The runtime value model is native Python (None/bool/int/float/str/list/dict,
temporal types, Point, VertexAccessor/EdgeAccessor/Path) — the counterpart of
the reference's TypedValue (memgraph/src/query/typed_value.cpp) with
openCypher null-propagation rules.

Copy of memgraph_tpu/query/values.py for the port (its imports the port's own).
"""

from __future__ import annotations

import math

from ..exceptions import ArithmeticException, TypeException
from ..storage.ordering import order_key
from ..storage.storage import EdgeAccessor, VertexAccessor
from ..utils.point import Point
from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                              ZonedDateTime)

_TEMPORAL = (Date, Duration, LocalDateTime, LocalTime, ZonedDateTime)


class Path:
    """Alternating vertex/edge sequence produced by path patterns."""

    __slots__ = ("items",)

    def __init__(self, items: list) -> None:
        self.items = items  # [VertexAccessor, EdgeAccessor, Vertex..., ...]

    def vertices(self) -> list:
        return self.items[0::2]

    def edges(self) -> list:
        return self.items[1::2]

    def __len__(self) -> int:
        return len(self.items) // 2  # path length = edge count

    def __eq__(self, other):
        return isinstance(other, Path) and self.items == other.items

    def __hash__(self):
        return hash(tuple(self.items))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Path({self.items})"


def is_numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def cypher_eq(a, b):
    """Ternary equality: None if either side is null (or null inside lists)."""
    if a is None or b is None:
        return None
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return a == b
        return False
    if is_numeric(a) and is_numeric(b):
        return float(a) == float(b) if (isinstance(a, float)
                                        or isinstance(b, float)) else a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        saw_null = False
        for x, y in zip(a, b):
            r = cypher_eq(x, y)
            if r is None:
                saw_null = True
            elif not r:
                return False
        return None if saw_null else True
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        saw_null = False
        for k in a:
            r = cypher_eq(a[k], b[k])
            if r is None:
                saw_null = True
            elif not r:
                return False
        return None if saw_null else True
    if type(a) is type(b):
        return a == b
    if isinstance(a, _TEMPORAL) or isinstance(b, _TEMPORAL):
        return False
    if isinstance(a, (VertexAccessor, EdgeAccessor, Path)) or \
            isinstance(b, (VertexAccessor, EdgeAccessor, Path)):
        return False
    return False


def cypher_lt(a, b):
    """Ternary '<'. None on null or incomparable type mix."""
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        if isinstance(a, float) and math.isnan(a):
            return None
        if isinstance(b, float) and math.isnan(b):
            return None
        return a < b
    if isinstance(a, str) and isinstance(b, str) and not isinstance(a, bool):
        return a < b
    if isinstance(a, bool) and isinstance(b, bool):
        return a < b
    for cls in _TEMPORAL:
        if isinstance(a, cls) and isinstance(b, cls):
            return a < b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return order_key(list(a)) < order_key(list(b))
    from ..storage.enums import EnumValue
    if (isinstance(a, EnumValue) and isinstance(b, EnumValue)
            and a.enum_name == b.enum_name):
        return a.position < b.position
    return None  # incomparable mix → null (openCypher comparability)


def cypher_add(a, b):
    if a is None or b is None:
        return None
    if isinstance(a, str) and isinstance(b, str):
        return a + b
    if isinstance(a, (list, tuple)):
        if isinstance(b, (list, tuple)):
            return list(a) + list(b)
        return list(a) + [b]
    if isinstance(b, (list, tuple)):
        return [a] + list(b)
    if is_numeric(a) and is_numeric(b):
        return a + b
    # temporal arithmetic
    try:
        result = a + b
        if result is not NotImplemented:
            return result
    except TypeError:
        pass
    raise TypeException(f"invalid '+' operands: {_tn(a)} and {_tn(b)}")


def cypher_sub(a, b):
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        return a - b
    try:
        result = a - b
        if result is not NotImplemented:
            return result
    except TypeError:
        pass
    raise TypeException(f"invalid '-' operands: {_tn(a)} and {_tn(b)}")


def cypher_mul(a, b):
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        return a * b
    raise TypeException(f"invalid '*' operands: {_tn(a)} and {_tn(b)}")


def cypher_div(a, b):
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        if isinstance(a, int) and isinstance(b, int):
            if b == 0:
                raise ArithmeticException("division by zero")
            q = abs(a) // abs(b)
            return q if (a >= 0) == (b >= 0) else -q  # truncate toward zero
        if b == 0:
            if a == 0:
                return math.nan
            return math.inf if a > 0 else -math.inf
        return a / b
    raise TypeException(f"invalid '/' operands: {_tn(a)} and {_tn(b)}")


def cypher_mod(a, b):
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        if b == 0:
            if isinstance(a, int) and isinstance(b, int):
                raise ArithmeticException("modulo by zero")
            return math.nan
        r = math.fmod(a, b)
        if isinstance(a, int) and isinstance(b, int):
            return int(r)
        return r
    raise TypeException(f"invalid '%' operands: {_tn(a)} and {_tn(b)}")


def cypher_pow(a, b):
    if a is None or b is None:
        return None
    if is_numeric(a) and is_numeric(b):
        return float(a) ** float(b)
    raise TypeException(f"invalid '^' operands: {_tn(a)} and {_tn(b)}")


def ternary_and(a, b):
    if a is False or b is False:
        return False
    if a is None or b is None:
        return None
    _require_bool(a), _require_bool(b)
    return True


def ternary_or(a, b):
    if a is True or b is True:
        return True
    if a is None or b is None:
        return None
    _require_bool(a), _require_bool(b)
    return False


def ternary_xor(a, b):
    if a is None or b is None:
        return None
    _require_bool(a), _require_bool(b)
    return a != b


def ternary_not(a):
    if a is None:
        return None
    _require_bool(a)
    return not a


def _require_bool(v):
    if not isinstance(v, bool):
        raise TypeException(f"expected boolean, got {_tn(v)}")


def _tn(v) -> str:
    if v is None:
        return "Null"
    return type(v).__name__


def type_name(v) -> str:
    """Cypher type name (for type() / valueType() style functions)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "FLOAT"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, (list, tuple)):
        return "LIST"
    if isinstance(v, dict):
        return "MAP"
    if isinstance(v, VertexAccessor):
        return "NODE"
    if isinstance(v, EdgeAccessor):
        return "RELATIONSHIP"
    if isinstance(v, Path):
        return "PATH"
    if isinstance(v, Date):
        return "DATE"
    if isinstance(v, LocalTime):
        return "LOCAL_TIME"
    if isinstance(v, LocalDateTime):
        return "LOCAL_DATE_TIME"
    if isinstance(v, ZonedDateTime):
        return "ZONED_DATE_TIME"
    if isinstance(v, Duration):
        return "DURATION"
    if isinstance(v, Point):
        return "POINT"
    return type(v).__name__.upper()


def hashable_key(v):
    """Key usable for DISTINCT / grouping (lists→tuples, maps→sorted tuples)."""
    if isinstance(v, list):
        return ("__list__", tuple(hashable_key(x) for x in v))
    if isinstance(v, dict):
        return ("__map__", tuple(sorted((k, hashable_key(x))
                                        for k, x in v.items())))
    if isinstance(v, float) and not isinstance(v, bool) and v.is_integer() \
            and abs(v) < 2 ** 63:
        return int(v)  # 1.0 groups with 1
    return v
