"""Compact binary encoding for property values.

Role parity with the reference's PropertyStore
(storage/v2/property_store.cpp — custom little-endian encoding with small
inline buffers): a self-describing, compact, deterministic binary codec for
all supported value types. In this build the in-memory representation stays
native Python dicts (the host hot path), and this codec is the durability and
replication wire format for properties (snapshots, WAL deltas) plus the
content-addressable form used for unique-constraint keys.

Format: each value is [1-byte tag][payload]. Integers use zig-zag varints;
strings/bytes are length-prefixed UTF-8; lists/maps are count-prefixed;
temporal types encode as their microsecond payloads; maps encode string keys.
A property *set* encodes as varint(count) then (varint(prop_id), value)*
sorted by prop_id — deterministic for hashing.

Copy of memgraph_tpu/storage/property_store.py for the port (its imports the port's own).
"""

from __future__ import annotations

import struct
from io import BytesIO

from ..exceptions import StorageError
from ..utils.point import CrsType, Point
from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                              ZonedDateTime)

# value tags
T_NULL = 0x00
T_FALSE = 0x01
T_TRUE = 0x02
T_INT = 0x03
T_DOUBLE = 0x04
T_STRING = 0x05
T_LIST = 0x06
T_MAP = 0x07
T_DATE = 0x08
T_LOCAL_TIME = 0x09
T_LOCAL_DATETIME = 0x0A
T_DURATION = 0x0B
T_ZONED_DATETIME = 0x0C
T_POINT = 0x0D
T_BYTES = 0x0E
T_ENUM = 0x0F


def _write_varint(buf: BytesIO, n: int) -> None:
    if n < 0:
        raise StorageError("varint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes((b | 0x80,)))
        else:
            buf.write(bytes((b,)))
            return


def _read_varint(buf: BytesIO) -> int:
    shift = 0
    result = 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise StorageError("truncated varint")
        b = raw[0]
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result
        shift += 7


def _read_exact(buf: BytesIO, n: int) -> bytes:
    """Short reads mean a torn/corrupt blob — surface StorageError, never
    a silently-shortened value (found by the truncation fuzzer)."""
    raw = buf.read(n)
    if len(raw) != n:
        raise StorageError(
            f"truncated value payload: wanted {n} bytes, got {len(raw)}")
    return raw


def _big_zigzag(n: int) -> int:
    # zig-zag over unbounded Python ints: non-negatives → even, negatives → odd
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


def _unzigzag(n: int) -> int:
    return (n >> 1) if not n & 1 else -((n + 1) >> 1)


def _is_enum(v) -> bool:
    from .enums import EnumValue
    return isinstance(v, EnumValue)


def encode_value(buf: BytesIO, v) -> None:
    if v is None:
        buf.write(bytes((T_NULL,)))
    elif v is True:
        buf.write(bytes((T_TRUE,)))
    elif v is False:
        buf.write(bytes((T_FALSE,)))
    elif isinstance(v, int):
        buf.write(bytes((T_INT,)))
        _write_varint(buf, _big_zigzag(v))
    elif isinstance(v, float):
        buf.write(bytes((T_DOUBLE,)))
        buf.write(struct.pack("<d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        buf.write(bytes((T_STRING,)))
        _write_varint(buf, len(raw))
        buf.write(raw)
    elif isinstance(v, bytes):
        buf.write(bytes((T_BYTES,)))
        _write_varint(buf, len(v))
        buf.write(v)
    elif isinstance(v, (list, tuple)):
        buf.write(bytes((T_LIST,)))
        _write_varint(buf, len(v))
        for item in v:
            encode_value(buf, item)
    elif isinstance(v, dict):
        buf.write(bytes((T_MAP,)))
        _write_varint(buf, len(v))
        for k in sorted(v):
            if not isinstance(k, str):
                raise StorageError("map property keys must be strings")
            raw = k.encode("utf-8")
            _write_varint(buf, len(raw))
            buf.write(raw)
            encode_value(buf, v[k])
    elif isinstance(v, Date):
        buf.write(bytes((T_DATE,)))
        _write_varint(buf, _big_zigzag(v.d.toordinal()))
    elif isinstance(v, LocalTime):
        buf.write(bytes((T_LOCAL_TIME,)))
        _write_varint(buf, v._micros())
    elif isinstance(v, LocalDateTime):
        buf.write(bytes((T_LOCAL_DATETIME,)))
        _write_varint(buf, _big_zigzag(v.timestamp_micros()))
    elif isinstance(v, Duration):
        buf.write(bytes((T_DURATION,)))
        _write_varint(buf, _big_zigzag(v.micros))
    elif isinstance(v, ZonedDateTime):
        buf.write(bytes((T_ZONED_DATETIME,)))
        _write_varint(buf, _big_zigzag(v.timestamp_micros()))
        tz = v.timezone_name().encode("utf-8")
        _write_varint(buf, len(tz))
        buf.write(tz)
    elif _is_enum(v):
        buf.write(bytes((T_ENUM,)))
        for part in (v.enum_name, v.value_name):
            raw = part.encode("utf-8")
            _write_varint(buf, len(raw))
            buf.write(raw)
        _write_varint(buf, v.position)
    elif isinstance(v, Point):
        buf.write(bytes((T_POINT,)))
        _write_varint(buf, v.crs.value)
        buf.write(struct.pack("<d", v.x))
        buf.write(struct.pack("<d", v.y))
        if v.crs.dims == 3:
            buf.write(struct.pack("<d", v.z))
    else:
        raise StorageError(f"unsupported property value type: {type(v)!r}")


def decode_value(buf: BytesIO):
    raw = buf.read(1)
    if not raw:
        raise StorageError("truncated value")
    tag = raw[0]
    if tag == T_NULL:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _unzigzag(_read_varint(buf))
    if tag == T_DOUBLE:
        return struct.unpack("<d", _read_exact(buf, 8))[0]
    if tag == T_STRING:
        n = _read_varint(buf)
        return _read_exact(buf, n).decode("utf-8")
    if tag == T_BYTES:
        n = _read_varint(buf)
        return _read_exact(buf, n)
    if tag == T_LIST:
        n = _read_varint(buf)
        return [decode_value(buf) for _ in range(n)]
    if tag == T_MAP:
        n = _read_varint(buf)
        out = {}
        for _ in range(n):
            klen = _read_varint(buf)
            key = _read_exact(buf, klen).decode("utf-8")
            out[key] = decode_value(buf)
        return out
    if tag == T_DATE:
        import datetime as _dt
        return Date(_dt.date.fromordinal(_unzigzag(_read_varint(buf))))
    if tag == T_LOCAL_TIME:
        from ..utils.temporal import _micros_to_time
        return LocalTime(_micros_to_time(_read_varint(buf)))
    if tag == T_LOCAL_DATETIME:
        import datetime as _dt
        micros = _unzigzag(_read_varint(buf))
        return LocalDateTime(_dt.datetime(1970, 1, 1)
                             + _dt.timedelta(microseconds=micros))
    if tag == T_DURATION:
        return Duration(_unzigzag(_read_varint(buf)))
    if tag == T_ZONED_DATETIME:
        import datetime as _dt
        micros = _unzigzag(_read_varint(buf))
        tzlen = _read_varint(buf)
        tzname = _read_exact(buf, tzlen).decode("utf-8")
        dt = _dt.datetime.fromtimestamp(micros / 1_000_000, _dt.timezone.utc)
        try:
            from zoneinfo import ZoneInfo
            dt = dt.astimezone(ZoneInfo(tzname))
        except (ImportError, KeyError, ValueError, OSError):
            pass  # unknown/unavailable tz db: keep UTC instant
        return ZonedDateTime(dt)
    if tag == T_ENUM:
        from .enums import EnumValue
        enum_name = _read_exact(buf, _read_varint(buf)).decode("utf-8")
        value_name = _read_exact(buf, _read_varint(buf)).decode("utf-8")
        position = _read_varint(buf)
        return EnumValue(enum_name, value_name, position)
    if tag == T_POINT:
        crs = CrsType(_read_varint(buf))
        x = struct.unpack("<d", _read_exact(buf, 8))[0]
        y = struct.unpack("<d", _read_exact(buf, 8))[0]
        z = struct.unpack("<d", _read_exact(buf, 8))[0] \
            if crs.dims == 3 else None
        return Point(x, y, z, crs)
    raise StorageError(f"unknown value tag 0x{tag:02x}")


# Flag-driven blob compression (reference: property_store.hpp:38-40 +
# utils/compressor.cpp — zlib, gated by
# --storage-property-store-compression-enabled). Set by main.py; the
# decoder auto-detects, so mixed-config blobs always read correctly.
COMPRESSION = {"enabled": False, "level": 6, "min_bytes": 64}

# envelope marker: a legacy blob starts with a varint property count, and
# the only legal single-byte blob starting 0x00 is the 1-byte empty set —
# so "0x00 + more bytes" is free to mean "zlib payload follows"
_COMPRESSED_MARK = b"\x00"


def encode_properties(props: dict[int, object]) -> bytes:
    """Deterministically encode a {prop_id: value} set. When compression
    is enabled, blobs over min_bytes are zlib-wrapped (marker 0x00)."""
    buf = BytesIO()
    _write_varint(buf, len(props))
    for pid in sorted(props):
        _write_varint(buf, pid)
        encode_value(buf, props[pid])
    raw = buf.getvalue()
    if COMPRESSION["enabled"] and len(raw) >= COMPRESSION["min_bytes"]:
        import zlib
        packed = _COMPRESSED_MARK + zlib.compress(raw, COMPRESSION["level"])
        if len(packed) < len(raw):
            return packed
    return raw


def decode_properties(data: bytes) -> dict[int, object]:
    if len(data) > 1 and data[:1] == _COMPRESSED_MARK:
        import zlib
        try:
            data = zlib.decompress(data[1:])
        except zlib.error as e:
            raise StorageError(f"corrupt compressed property blob: {e}") \
                from e
    buf = BytesIO(data)
    try:
        n = _read_varint(buf)
        out = {}
        for _ in range(n):
            pid = _read_varint(buf)
            out[pid] = decode_value(buf)
        return out
    except (struct.error, UnicodeDecodeError, ValueError,
            OverflowError) as e:
        # torn/corrupt blob (truncated payload, invalid utf-8, unknown
        # CRS id, out-of-range temporal): surface the domain error, not
        # the codec internals (found by the property fuzzers)
        raise StorageError(f"corrupt property blob: {e}") from e


def value_key(v) -> bytes:
    """Canonical bytes for a single value (unique-constraint keys)."""
    buf = BytesIO()
    encode_value(buf, v)
    return buf.getvalue()
