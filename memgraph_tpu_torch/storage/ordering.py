"""Total ordering over heterogeneous property values.

Cypher ORDER BY and range index scans need a total order across mixed types.
The order follows the reference's TypedValue comparison / openCypher
orderability: by type class first (null sorts last ascending), then within
type. Used by both the label+property index (range scans) and the query
executor's OrderBy.

Copy of memgraph_tpu/storage/ordering.py for the port (its imports the port's own).
"""

from __future__ import annotations

import math

from ..utils.point import Point
from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                              ZonedDateTime)

# type-class ranks; numerics share a rank so 1 < 1.5 < 2 interleave
_RANK_MAP = 0
_RANK_NODE = 1
_RANK_EDGE = 2
_RANK_LIST = 3
_RANK_PATH = 4
_RANK_STRING = 5
_RANK_BOOL = 6
_RANK_NUMBER = 7
_RANK_DATE = 8
_RANK_LOCAL_TIME = 9
_RANK_LOCAL_DATETIME = 10
_RANK_ZONED_DATETIME = 11
_RANK_DURATION = 12
_RANK_POINT = 13
_RANK_BYTES = 14
_RANK_ENUM = 15
_RANK_NULL = 16  # null sorts last in ascending order (openCypher)


def order_key(v):
    """Map a value to a tuple that sorts per openCypher orderability."""
    if v is None:
        return (_RANK_NULL,)
    if isinstance(v, bool):  # bool before int check (bool subclasses int)
        return (_RANK_BOOL, v)
    if isinstance(v, int):
        return (_RANK_NUMBER, v)
    if isinstance(v, float):
        if math.isnan(v):
            return (_RANK_NUMBER, math.inf, 1)  # NaN sorts after +inf
        return (_RANK_NUMBER, v)
    if isinstance(v, str):
        return (_RANK_STRING, v)
    if isinstance(v, (list, tuple)):
        return (_RANK_LIST, tuple(order_key(x) for x in v))
    if isinstance(v, dict):
        return (_RANK_MAP,
                tuple(sorted((k, order_key(val)) for k, val in v.items())))
    if isinstance(v, Date):
        return (_RANK_DATE, v.d.toordinal())
    if isinstance(v, LocalTime):
        return (_RANK_LOCAL_TIME, v._micros())
    if isinstance(v, LocalDateTime):
        return (_RANK_LOCAL_DATETIME, v.timestamp_micros())
    if isinstance(v, ZonedDateTime):
        return (_RANK_ZONED_DATETIME, v.timestamp_micros())
    if isinstance(v, Duration):
        return (_RANK_DURATION, v.micros)
    if isinstance(v, Point):
        return (_RANK_POINT, v.crs.value, v.x, v.y, v.z if v.z is not None else 0.0)
    if isinstance(v, bytes):
        return (_RANK_BYTES, v)
    from .enums import EnumValue
    if isinstance(v, EnumValue):
        return (_RANK_ENUM, v.enum_name, v.position)
    # graph objects (VertexAccessor/EdgeAccessor/Path) order by identity ids
    gid = getattr(v, "gid", None)
    if gid is not None:
        return (_RANK_NODE, gid)
    return (_RANK_PATH, id(v))
