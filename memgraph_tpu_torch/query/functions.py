"""Builtin scalar/list/string/temporal/spatial function library.

Counterpart of the reference's ~190 builtins
(memgraph/src/query/interpret/awesome_memgraph_functions.cpp).
Each function takes (evaluator, args) and follows openCypher null
propagation unless noted. Aggregates live in the executor, not here.

Copy of memgraph_tpu/query/functions.py for the port (its imports the port's own).
"""

from __future__ import annotations

import math
import random as _random
import re
import uuid as _uuid

from ..exceptions import TypeException
from ..storage.common import View
from ..storage.storage import EdgeAccessor, VertexAccessor
from ..utils.point import Point
from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                              ZonedDateTime)
from . import values as V
from .values import Path

FUNCTIONS: dict = {}


def register(name, min_args=None, max_args=None, propagate_null=True):
    def deco(fn):
        def wrapper(ev, args):
            if min_args is not None and len(args) < min_args:
                raise TypeException(f"{name}() requires at least {min_args} argument(s)")
            if max_args is not None and len(args) > max_args:
                raise TypeException(f"{name}() takes at most {max_args} argument(s)")
            if propagate_null and any(a is None for a in args):
                return None
            return fn(ev, args)
        FUNCTIONS[name] = wrapper
        return fn
    return deco


def _num(name, v):
    if not V.is_numeric(v):
        raise TypeException(f"{name}() requires a number, got {V.type_name(v)}")
    return v


def _str(name, v):
    if not isinstance(v, str):
        raise TypeException(f"{name}() requires a string, got {V.type_name(v)}")
    return v


def _list(name, v):
    if not isinstance(v, (list, tuple)):
        raise TypeException(f"{name}() requires a list, got {V.type_name(v)}")
    return v


# --- scalar ------------------------------------------------------------------

@register("coalesce", 1, propagate_null=False)
def fn_coalesce(ev, args):
    for a in args:
        if a is not None:
            return a
    return None


@register("id", 1, 1)
def fn_id(ev, args):
    v = args[0]
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        return v.gid
    raise TypeException("id() requires a node or relationship")


@register("type", 1, 1)
def fn_type(ev, args):
    v = args[0]
    if isinstance(v, EdgeAccessor):
        return ev.ctx.storage.edge_type_mapper.id_to_name(v.edge_type)
    raise TypeException("type() requires a relationship")


@register("labels", 1, 1)
def fn_labels(ev, args):
    v = args[0]
    if not isinstance(v, VertexAccessor):
        raise TypeException("labels() requires a node")
    st = ev.checked_state(v)
    mapper = ev.ctx.storage.label_mapper
    return [mapper.id_to_name(l) for l in sorted(st.labels)]


@register("properties", 1, 1)
def fn_properties(ev, args):
    v = args[0]
    if isinstance(v, dict):
        return dict(v)
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        st = ev.checked_state(v)
        mapper = ev.ctx.storage.property_mapper
        return {mapper.id_to_name(k): val
                for k, val in st.properties.items()}
    raise TypeException("properties() requires a node, relationship or map")


@register("keys", 1, 1)
def fn_keys(ev, args):
    v = args[0]
    if isinstance(v, dict):
        return list(v.keys())
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        st = ev.checked_state(v)
        mapper = ev.ctx.storage.property_mapper
        return [mapper.id_to_name(k) for k in st.properties]
    raise TypeException("keys() requires a node, relationship or map")


@register("startnode", 1, 1)
def fn_startnode(ev, args):
    if not isinstance(args[0], EdgeAccessor):
        raise TypeException("startNode() requires a relationship")
    return args[0].from_vertex()


@register("endnode", 1, 1)
def fn_endnode(ev, args):
    if not isinstance(args[0], EdgeAccessor):
        raise TypeException("endNode() requires a relationship")
    return args[0].to_vertex()


@register("degree", 1, 1)
def fn_degree(ev, args):
    v = args[0]
    if not isinstance(v, VertexAccessor):
        raise TypeException("degree() requires a node")
    return v.in_degree(ev.ctx.view) + v.out_degree(ev.ctx.view)


@register("indegree", 1, 1)
def fn_indegree(ev, args):
    if not isinstance(args[0], VertexAccessor):
        raise TypeException("inDegree() requires a node")
    return args[0].in_degree(ev.ctx.view)


@register("outdegree", 1, 1)
def fn_outdegree(ev, args):
    if not isinstance(args[0], VertexAccessor):
        raise TypeException("outDegree() requires a node")
    return args[0].out_degree(ev.ctx.view)


@register("timestamp", 0, 0, propagate_null=False)
def fn_timestamp(ev, args):
    import time
    return int(time.time() * 1_000_000)


@register("valuetype", 1, 1, propagate_null=False)
def fn_valuetype(ev, args):
    return V.type_name(args[0])


@register("tointeger", 1, 1)
def fn_tointeger(ev, args):
    v = args[0]
    if isinstance(v, bool):
        # InvalidArgumentValue per TCK TypeConversionFunctions (the
        # bool-accepting variant is toIntegerOrNull/toBooleanList)
        raise TypeException("toInteger() can't convert Boolean")
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return int(v)
    if isinstance(v, str):
        try:
            return int(float(v)) if ("." in v or "e" in v.lower()) else int(v, 0)
        except ValueError:
            return None
    raise TypeException(f"toInteger() can't convert {V.type_name(v)}")


@register("tofloat", 1, 1)
def fn_tofloat(ev, args):
    v = args[0]
    if V.is_numeric(v):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    raise TypeException(f"toFloat() can't convert {V.type_name(v)}")


@register("toboolean", 1, 1)
def fn_toboolean(ev, args):
    v = args[0]
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        # InvalidArgumentValue per TCK TypeConversionFunctions
        raise TypeException("toBoolean() can't convert Integer")
    if isinstance(v, str):
        low = v.strip().lower()
        if low == "true":
            return True
        if low == "false":
            return False
        return None
    raise TypeException(f"toBoolean() can't convert {V.type_name(v)}")


@register("tostring", 1, 1)
def fn_tostring(ev, args):
    v = args[0]
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if V.is_numeric(v):
        if isinstance(v, float) and v.is_integer():
            return f"{v:.1f}"
        return str(v)
    if isinstance(v, (Date, Duration, LocalDateTime, LocalTime,
                      ZonedDateTime, Point)):
        return str(v)
    # lists/maps/graph entities are invalid (TCK TypeConversionFunctions
    # InvalidArgumentValue; reference: awesome_memgraph_functions ToString)
    raise TypeException(f"toString() can't convert {V.type_name(v)}")


# --- math --------------------------------------------------------------------

def _math1(name, fn):
    @register(name, 1, 1)
    def f(ev, args, _fn=fn, _name=name):
        return _fn(_num(_name, args[0]))
    return f


_math1("abs", abs)
_math1("ceil", lambda v: float(math.ceil(v)))
_math1("floor", lambda v: float(math.floor(v)))
_math1("sqrt", lambda v: math.sqrt(v) if v >= 0 else math.nan)
_math1("exp", math.exp)
_math1("log", lambda v: math.log(v) if v > 0 else math.nan)
_math1("log10", lambda v: math.log10(v) if v > 0 else math.nan)
_math1("log2", lambda v: math.log2(v) if v > 0 else math.nan)
_math1("sin", math.sin)
_math1("cos", math.cos)
_math1("tan", math.tan)
_math1("cot", lambda v: 1.0 / math.tan(v) if math.tan(v) != 0 else math.inf)
_math1("asin", lambda v: math.asin(v) if -1 <= v <= 1 else math.nan)
_math1("acos", lambda v: math.acos(v) if -1 <= v <= 1 else math.nan)
_math1("atan", math.atan)
_math1("sign", lambda v: (v > 0) - (v < 0))
_math1("degrees", math.degrees)
_math1("radians", math.radians)


@register("round", 1, 2)
def fn_round(ev, args):
    v = _num("round", args[0])
    digits = 0
    if len(args) == 2:
        digits = int(_num("round", args[1]))
    # half away from zero (Cypher), not banker's rounding
    scale = 10 ** digits
    return float(math.floor(abs(v) * scale + 0.5) / scale * ((v > 0) - (v < 0))
                 if v != 0 else 0.0)


@register("atan2", 2, 2)
def fn_atan2(ev, args):
    return math.atan2(_num("atan2", args[0]), _num("atan2", args[1]))


@register("pi", 0, 0, propagate_null=False)
def fn_pi(ev, args):
    return math.pi


@register("e", 0, 0, propagate_null=False)
def fn_e(ev, args):
    return math.e


@register("rand", 0, 0, propagate_null=False)
def fn_rand(ev, args):
    return _random.random()


@register("random", 0, 0, propagate_null=False)
def fn_random(ev, args):
    return _random.random()


# --- strings -----------------------------------------------------------------

@register("tolower", 1, 1)
@register("lower", 1, 1)      # openCypher M09 pre-rename alias
def fn_tolower(ev, args):
    return _str("toLower", args[0]).lower()


@register("toupper", 1, 1)
@register("upper", 1, 1)
def fn_toupper(ev, args):
    return _str("toUpper", args[0]).upper()


@register("trim", 1, 1)
def fn_trim(ev, args):
    return _str("trim", args[0]).strip()


@register("ltrim", 1, 1)
def fn_ltrim(ev, args):
    return _str("lTrim", args[0]).lstrip()


@register("rtrim", 1, 1)
def fn_rtrim(ev, args):
    return _str("rTrim", args[0]).rstrip()


@register("reverse", 1, 1)
def fn_reverse(ev, args):
    v = args[0]
    if isinstance(v, str):
        return v[::-1]
    if isinstance(v, (list, tuple)):
        return list(reversed(v))
    raise TypeException("reverse() requires a string or list")


@register("left", 2, 2)
def fn_left(ev, args):
    s = _str("left", args[0])
    n = int(_num("left", args[1]))
    if n < 0:
        raise TypeException("left() requires a non-negative length")
    return s[:n]


@register("right", 2, 2)
def fn_right(ev, args):
    s = _str("right", args[0])
    n = int(_num("right", args[1]))
    if n < 0:
        raise TypeException("right() requires a non-negative length")
    return s[len(s) - min(n, len(s)):]


@register("substring", 2, 3)
def fn_substring(ev, args):
    s = _str("substring", args[0])
    start = int(_num("substring", args[1]))
    if len(args) == 3:
        length = int(_num("substring", args[2]))
        return s[start:start + length]
    return s[start:]


@register("split", 2, 2)
def fn_split(ev, args):
    return _str("split", args[0]).split(_str("split", args[1]))


@register("replace", 3, 3)
def fn_replace(ev, args):
    return _str("replace", args[0]).replace(_str("replace", args[1]),
                                            _str("replace", args[2]))


@register("size", 1, 1)
def fn_size(ev, args):
    v = args[0]
    if isinstance(v, str) or isinstance(v, (list, tuple)):
        return len(v)
    if isinstance(v, dict):
        return len(v)
    if isinstance(v, Path):
        return len(v)
    raise TypeException(f"size() not supported for {V.type_name(v)}")


@register("length", 1, 1)
def fn_length(ev, args):
    v = args[0]
    if isinstance(v, Path):
        return len(v)
    if isinstance(v, (str, list, tuple)):
        return len(v)
    raise TypeException("length() requires a path, string or list")


@register("chartoascii", 1, 1)
def fn_chartoascii(ev, args):
    s = _str("charToAscii", args[0])
    if not s:
        raise TypeException("charToAscii() requires a non-empty string")
    return ord(s[0])


@register("asciitochar", 1, 1)
def fn_asciitochar(ev, args):
    return chr(int(_num("asciiToChar", args[0])))


# --- lists -------------------------------------------------------------------

@register("range", 2, 3)
def fn_range(ev, args):
    lo = int(_num("range", args[0]))
    hi = int(_num("range", args[1]))
    step = int(_num("range", args[2])) if len(args) == 3 else 1
    if step == 0:
        raise TypeException("range() step must not be zero")
    if step > 0:
        return list(range(lo, hi + 1, step))
    return list(range(lo, hi - 1, step))


@register("head", 1, 1)
def fn_head(ev, args):
    lst = _list("head", args[0])
    return lst[0] if lst else None


@register("last", 1, 1)
def fn_last(ev, args):
    lst = _list("last", args[0])
    return lst[-1] if lst else None


@register("tail", 1, 1)
def fn_tail(ev, args):
    return list(_list("tail", args[0])[1:])


@register("nodes", 1, 1)
def fn_nodes(ev, args):
    if not isinstance(args[0], Path):
        raise TypeException("nodes() requires a path")
    return args[0].vertices()


@register("relationships", 1, 1)
def fn_relationships(ev, args):
    if not isinstance(args[0], Path):
        raise TypeException("relationships() requires a path")
    return args[0].edges()


@register("uniformsample", 2, 2)
def fn_uniformsample(ev, args):
    lst = _list("uniformSample", args[0])
    n = int(_num("uniformSample", args[1]))
    if not lst or n <= 0:
        return []
    return [_random.choice(lst) for _ in range(n)]


# --- temporal ----------------------------------------------------------------

@register("date", 0, 1, propagate_null=False)
def fn_date(ev, args):
    if not args or args[0] is None:
        return Date.today()
    v = args[0]
    if isinstance(v, str):
        return Date.parse(v)
    if isinstance(v, dict):
        return Date.from_parts(int(v.get("year", 1970)),
                               int(v.get("month", 1)), int(v.get("day", 1)))
    if isinstance(v, Date):
        return v
    if isinstance(v, LocalDateTime):
        return v.date()
    raise TypeException("date() argument must be a string or map")


@register("localtime", 0, 1, propagate_null=False)
def fn_localtime(ev, args):
    if not args or args[0] is None:
        import datetime
        return LocalTime(datetime.datetime.now().time())
    v = args[0]
    if isinstance(v, str):
        return LocalTime.parse(v)
    if isinstance(v, dict):
        return LocalTime.from_parts(
            int(v.get("hour", 0)), int(v.get("minute", 0)),
            int(v.get("second", 0)), int(v.get("millisecond", 0)),
            int(v.get("microsecond", 0)))
    if isinstance(v, LocalTime):
        return v
    if isinstance(v, LocalDateTime):
        return v.local_time()
    raise TypeException("localTime() argument must be a string or map")


@register("localdatetime", 0, 1, propagate_null=False)
def fn_localdatetime(ev, args):
    if not args or args[0] is None:
        return LocalDateTime.now()
    v = args[0]
    if isinstance(v, str):
        return LocalDateTime.parse(v)
    if isinstance(v, dict):
        return LocalDateTime.from_parts(
            int(v.get("year", 1970)), int(v.get("month", 1)),
            int(v.get("day", 1)), int(v.get("hour", 0)),
            int(v.get("minute", 0)), int(v.get("second", 0)),
            int(v.get("millisecond", 0)), int(v.get("microsecond", 0)))
    if isinstance(v, LocalDateTime):
        return v
    raise TypeException("localDateTime() argument must be a string or map")


@register("datetime", 0, 1, propagate_null=False)
def fn_datetime(ev, args):
    if not args or args[0] is None:
        return ZonedDateTime.now()
    v = args[0]
    if isinstance(v, str):
        return ZonedDateTime.parse(v)
    if isinstance(v, ZonedDateTime):
        return v
    raise TypeException("datetime() argument must be a string")


@register("duration", 1, 1)
def fn_duration(ev, args):
    v = args[0]
    if isinstance(v, str):
        return Duration.parse(v)
    if isinstance(v, dict):
        return Duration.from_parts(
            days=v.get("day", v.get("days", 0)),
            hours=v.get("hour", v.get("hours", 0)),
            minutes=v.get("minute", v.get("minutes", 0)),
            seconds=v.get("second", v.get("seconds", 0)),
            milliseconds=v.get("millisecond", v.get("milliseconds", 0)),
            microseconds=v.get("microsecond", v.get("microseconds", 0)))
    if isinstance(v, Duration):
        return v
    raise TypeException("duration() argument must be a string or map")


# --- spatial -----------------------------------------------------------------

@register("point", 1, 1)
def fn_point(ev, args):
    if not isinstance(args[0], dict):
        raise TypeException("point() requires a map")
    return Point.from_map(args[0])


@register("point.distance", 2, 2)
def fn_point_distance(ev, args):
    a, b = args
    if not isinstance(a, Point) or not isinstance(b, Point):
        raise TypeException("point.distance() requires two points")
    return a.distance(b)


@register("distance", 2, 2)
def fn_distance(ev, args):
    return fn_point_distance(ev, args)


@register("point.withinbbox", 3, 3)
def fn_point_withinbbox(ev, args):
    p, lo, hi = args
    if not all(isinstance(x, Point) for x in (p, lo, hi)):
        raise TypeException("point.withinbbox() requires three points")
    ok = lo.x <= p.x <= hi.x and lo.y <= p.y <= hi.y
    if p.crs.dims == 3 and lo.z is not None and hi.z is not None:
        ok = ok and lo.z <= p.z <= hi.z
    return ok


# --- assertion / counters (reference: awesome_memgraph_functions) ------------

@register("assert", 1, 2, propagate_null=False)
def fn_assert(ev, args):
    ok = args[0]
    message = args[1] if len(args) > 1 else "Assertion failed"
    if ok is not True:
        raise TypeException(str(message))
    return True


@register("counter", 2, 3)
def fn_counter(ev, args):
    """counter(name, initial, step=1): named counter scoped to the query
    execution (reference: per-EvaluationContext counters, context.hpp),
    returns the current value then advances."""
    name = _str("counter", args[0])
    initial = int(_num("counter", args[1]))
    step = int(_num("counter", args[2])) if len(args) == 3 else 1
    counters = getattr(ev.ctx, "_query_counters", None)
    if counters is None:
        counters = ev.ctx._query_counters = {}
    current = counters.get(name, initial)
    counters[name] = current + step
    return current


@register("propertysize", 2, 2)
def fn_propertysize(ev, args):
    """Approximate encoded byte size of a stored property."""
    from ..storage.property_store import value_key
    obj, prop = args
    if not isinstance(obj, (VertexAccessor, EdgeAccessor)):
        raise TypeException("propertySize() requires a node or relationship")
    value = ev.get_property(obj, _str("propertySize", prop))
    if value is None:
        return 0
    return len(value_key(value))


@register("tocharlist", 1, 1)
def fn_tocharlist(ev, args):
    return list(_str("toCharList", args[0]))


# --- conversions: *OrNull / *List / container helpers ------------------------

@register("isempty", 1, 1)
def fn_isempty(ev, args):
    v = args[0]
    if isinstance(v, (str, list, tuple, dict)):
        return len(v) == 0
    raise TypeException("isEmpty() requires a string, list or map")


def _toboolean_lenient(ev, args):
    """List/OrNull-variant semantics: integers coerce (nonzero -> true),
    unlike the scalar toBoolean() which raises per the TCK."""
    v = args[0]
    if isinstance(v, int) and not isinstance(v, bool):
        return v != 0
    return fn_toboolean(ev, args)


def _tointeger_lenient(ev, args):
    v = args[0]
    if isinstance(v, bool):
        return 1 if v else 0
    return fn_tointeger(ev, args)


def _or_null(conv):
    def inner(ev, args):
        try:
            return conv(ev, args)
        # mglint: disable=MG003 — Cypher toXOrNull() contract: any
        # conversion failure IS the null result, not an error
        except Exception:
            return None
    return inner


register("tointegerornull", 1, 1)(_or_null(_tointeger_lenient))
register("tofloatornull", 1, 1)(_or_null(fn_tofloat))
register("tobooleanornull", 1, 1)(_or_null(_toboolean_lenient))
register("tostringornull", 1, 1)(_or_null(fn_tostring))


def _list_conv(name, elem_fn):
    @register(name, 1, 1)
    def inner(ev, args, _fn=elem_fn):
        lst = _list(name, args[0])
        out = []
        for item in lst:
            if item is None:
                out.append(None)
                continue
            try:
                out.append(_fn(ev, [item]))
            # mglint: disable=MG003 — per-element toX() null-on-failure
            # is the Cypher list-conversion contract
            except Exception:
                out.append(None)
        return out
    return inner


_list_conv("tointegerlist", _tointeger_lenient)
_list_conv("tofloatlist", fn_tofloat)
_list_conv("tobooleanlist", _toboolean_lenient)
_list_conv("tostringlist", fn_tostring)


@register("toset", 1, 1)
def fn_toset(ev, args):
    lst = _list("toSet", args[0])
    seen = set()
    out = []
    for item in lst:
        key = V.hashable_key(item)
        if key not in seen:
            seen.add(key)
            out.append(item)
    return out


@register("values", 1, 1)
def fn_values(ev, args):
    v = args[0]
    if isinstance(v, dict):
        return list(v.values())
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        return list(v.properties(ev.ctx.view).values())
    raise TypeException("values() requires a map, node or relationship")


@register("username", 0, 0, propagate_null=False)
def fn_username(ev, args):
    # bound by the session; null on embedded/anonymous use
    return getattr(ev.ctx, "username", None) or None


@register("roles", 0, 1, propagate_null=False)
def fn_roles(ev, args):
    """Role names of the session user (reference:
    awesome_memgraph_functions.cpp Roles); [] when anonymous. The optional
    db_name argument is accepted for parity (roles are global here)."""
    if args and args[0] is not None and not isinstance(args[0], str):
        raise TypeException("roles() db_name must be a string")
    username = getattr(ev.ctx, "username", None)
    if not username:
        return []
    from ..auth.auth import resolve_auth
    exec_ctx = getattr(ev.ctx, "exec_ctx", None)
    auth = resolve_auth(getattr(exec_ctx, "interpreter_context", None))
    return auth.user_roles(username)


@register("elementid", 1, 1)
def fn_elementid(ev, args):
    """id() as a string, for external-integration compatibility (reference:
    awesome_memgraph_functions.cpp ElementId)."""
    v = args[0]
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        return str(v.gid)
    raise TypeException("elementId() requires a node or relationship")


@register("toenum", 1, 2)
def fn_toenum(ev, args):
    """toEnum("Name::Value") or toEnum("Name", "Value") -> enum value
    (reference: awesome_memgraph_functions.cpp ToEnum)."""
    from ..storage.enums import enum_registry
    if not all(isinstance(a, str) for a in args):
        raise TypeException("toEnum() requires string arguments")
    if len(args) == 1:
        name, sep, value = args[0].partition("::")
        if not sep:
            raise TypeException(
                f"invalid enum literal {args[0]!r} (expected 'Name::Value')")
    else:
        name, value = args
    return enum_registry(ev.ctx.storage).value(name, value)


@register("gethopscounter", 0, 0, propagate_null=False)
def fn_gethopscounter(ev, args):
    """Edge visits consumed so far under USING HOPS LIMIT (reference:
    query/hops_limit.hpp counter surface)."""
    exec_ctx = getattr(ev.ctx, "exec_ctx", None)
    if exec_ctx is not None and exec_ctx.hops_budget is not None:
        return getattr(exec_ctx, "hops_initial", 0) - exec_ctx.hops_budget
    return 0


# --- ids / misc --------------------------------------------------------------

@register("randomuuid", 0, 0, propagate_null=False)
def fn_randomuuid(ev, args):
    return str(_uuid.uuid4())


@register("uuid", 0, 0, propagate_null=False)
def fn_uuid(ev, args):
    return str(_uuid.uuid4())


@register("tobytestring", 1, 1)
def fn_tobytestring(ev, args):
    s = _str("toByteString", args[0])
    if s.startswith("0x") or s.startswith("0X"):
        return bytes.fromhex(s[2:])
    return s.encode("utf-8")


@register("frombytestring", 1, 1)
def fn_frombytestring(ev, args):
    v = args[0]
    if not isinstance(v, bytes):
        raise TypeException("fromByteString() requires bytes")
    return v.decode("utf-8", errors="replace")

# --- convert.* / mgps.* module functions -------------------------------------
# (reference: query_modules/convert.cpp registers these as magic functions;
#  query_modules/mgps.py registers version/validate_predicate)


def _json_path_select(text, path):
    """Parse JSON and walk an optional '$.a.b[0]' path. Returns the selected
    subtree, or None for an unresolved path or a JSON null leaf (reference
    convert.cpp ResolveJsonPath/JsonPathToPointer)."""
    import json
    import re as _re
    try:
        root = json.loads(text)
    except ValueError as exc:
        raise TypeException(f"invalid JSON: {exc}") from None
    if not path:
        return root
    cur = root
    spec = path[1:] if path.startswith("$") else path
    for step in _re.findall(r"\.([^.\[]+)|\[(\d+)\]", spec):
        key, idx = step
        if key:
            if not isinstance(cur, dict) or key not in cur:
                return None
            cur = cur[key]
        else:
            i = int(idx)
            if not isinstance(cur, list) or i >= len(cur):
                return None
            cur = cur[i]
    return cur


def _from_json(args, expected_type, what):
    if not isinstance(args[0], str):
        raise TypeException(f"convert.from_json_{what} expects a JSON "
                            f"string")
    path = args[1] if len(args) > 1 else None
    if path is not None and not isinstance(path, str):
        raise TypeException("the path argument must be a string")
    out = _json_path_select(args[0], path)
    if out is None:
        return None  # unresolved path / JSON null leaf -> null
    if not isinstance(out, expected_type):
        raise TypeException(
            f"convert.from_json_{what} expects a JSON "
            f"{'object' if expected_type is dict else 'array'}")
    return out


@register("convert.from_json_map", 1, 2)
def fn_convert_from_json_map(ev, args):
    return _from_json(args, dict, "map")


@register("convert.from_json_list", 1, 2)
def fn_convert_from_json_list(ev, args):
    return _from_json(args, list, "list")


def _node_json(ev, v):
    mapper = ev.ctx.storage.property_mapper
    obj = {"id": str(v.gid), "type": "node"}
    labels = [ev.ctx.storage.label_mapper.id_to_name(l)
              for l in v.labels(ev.ctx.view)]
    if labels:
        obj["labels"] = labels
    props = {mapper.id_to_name(pid): _jsonable(ev, val)
             for pid, val in v.properties(ev.ctx.view).items()}
    if props:
        obj["properties"] = props
    return obj


def _edge_json(ev, e):
    mapper = ev.ctx.storage.property_mapper
    obj = {"id": str(e.gid), "type": "relationship",
           "label": ev.ctx.storage.edge_type_mapper.id_to_name(e.edge_type),
           "start": _node_json(ev, e.from_vertex()),
           "end": _node_json(ev, e.to_vertex())}
    props = {mapper.id_to_name(pid): _jsonable(ev, val)
             for pid, val in e.properties(ev.ctx.view).items()}
    if props:
        obj["properties"] = props
    return obj


def _jsonable(ev, v):
    """Reference convert.cpp JSON shapes: nodes {id,type,labels,properties},
    relationships with full start/end node objects, paths as interleaved
    arrays; temporal/point/enum values serialize via their string form."""
    from .values import Path as _QPath
    if isinstance(v, VertexAccessor):
        return _node_json(ev, v)
    if isinstance(v, EdgeAccessor):
        return _edge_json(ev, v)
    if isinstance(v, _QPath):
        out = []
        for k, item in enumerate(v.items):
            out.append(_node_json(ev, item) if k % 2 == 0
                       else _edge_json(ev, item))
        return out
    if isinstance(v, (list, tuple)):
        return [_jsonable(ev, x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(ev, val) for k, val in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)  # temporal/point/enum -> string form


@register("convert.to_json", 1, 1, propagate_null=False)
def fn_convert_to_json(ev, args):
    import json
    return json.dumps(_jsonable(ev, args[0]), separators=(",", ":"))


@register("convert.to_map", 1, 1)
def fn_convert_to_map(ev, args):
    # a map passes through; a node/relationship yields its properties;
    # anything else yields null (reference convert.cpp to_map)
    v = args[0]
    if isinstance(v, dict):
        return v
    if isinstance(v, (VertexAccessor, EdgeAccessor)):
        mapper = ev.ctx.storage.property_mapper
        return {mapper.id_to_name(pid): val
                for pid, val in v.properties(ev.ctx.view).items()}
    return None


@register("mgps.version", 0, 0, propagate_null=False)
def fn_mgps_version(ev, args):
    return "5.9.0"


@register("mgps.validate_predicate", 3, 3)
def fn_mgps_validate_predicate(ev, args):
    predicate, message, params = args
    if not isinstance(predicate, bool):
        raise TypeException(
            "mgps.validate_predicate expects a boolean predicate")
    if predicate:
        try:
            rendered = message % tuple(params or [])
        except (TypeError, ValueError) as exc:
            raise TypeException(
                f"invalid validation message format: {exc}") from None
        raise TypeException(rendered)
    return True
