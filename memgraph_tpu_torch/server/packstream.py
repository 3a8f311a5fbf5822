"""PackStream serialization (Bolt's value format).

Counterpart of the reference's Bolt encoder/decoder
(memgraph/src/communication/bolt/v1/encoder/, decoder/): the
PackStream v2 wire format used by Bolt 4.x/5.x — ints, floats, strings,
lists, maps, structs (Node/Relationship/Path/temporal/point), with the
v5 element-id fields.

Copy of memgraph_tpu/server/packstream.py for the port.
"""

from __future__ import annotations

import struct
from io import BytesIO

from ..exceptions import MemgraphTpuError


class PackStreamError(MemgraphTpuError):
    pass


# struct tags
S_NODE = 0x4E
S_RELATIONSHIP = 0x52
S_UNBOUND_RELATIONSHIP = 0x72
S_PATH = 0x50
S_DATE = 0x44
S_TIME = 0x54
S_LOCAL_TIME = 0x74
S_DATETIME = 0x49          # v5 UTC datetime
S_DATETIME_ZONE_ID = 0x69  # v5 UTC datetime w/ zone name
S_LOCAL_DATETIME = 0x64
S_DURATION = 0x45
S_POINT_2D = 0x58
S_POINT_3D = 0x59


class Structure:
    __slots__ = ("tag", "fields")

    def __init__(self, tag: int, fields: list) -> None:
        self.tag = tag
        self.fields = fields

    def __eq__(self, other):
        return (isinstance(other, Structure) and other.tag == self.tag
                and other.fields == self.fields)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Structure(0x{self.tag:02X}, {self.fields!r})"


def pack(value, buf: BytesIO | None = None) -> bytes:
    out = bytearray()
    _pack(value, out)
    if buf is not None:
        buf.write(bytes(out))
        return b""
    return bytes(out)


_pack_to = struct.pack


def _pack(v, out: bytearray) -> None:
    # bytearray appends, not BytesIO writes: bulk UNWIND parameters are
    # one huge nested list and the encoder runs per element
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, int):
        if -0x10 <= v < 0x80:
            out.append(v & 0xFF)
        elif -0x80 <= v < 0x80:
            out.append(0xC8)
            out.append(v & 0xFF)
        elif -0x8000 <= v < 0x8000:
            out.append(0xC9)
            out += v.to_bytes(2, "big", signed=True)
        elif -0x80000000 <= v < 0x80000000:
            out.append(0xCA)
            out += v.to_bytes(4, "big", signed=True)
        elif -0x8000000000000000 <= v < 0x8000000000000000:
            out.append(0xCB)
            out += v.to_bytes(8, "big", signed=True)
        else:
            raise PackStreamError(f"integer out of 64-bit range: {v}")
    elif isinstance(v, float):
        out.append(0xC1)
        out += _pack_to(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        n = len(raw)
        if n < 0x10:
            out.append(0x80 | n)
        elif n < 0x100:
            out.append(0xD0)
            out.append(n)
        elif n < 0x10000:
            out.append(0xD1)
            out += _pack_to(">H", n)
        else:
            out.append(0xD2)
            out += _pack_to(">I", n)
        out += raw
    elif isinstance(v, bytes):
        n = len(v)
        if n < 0x100:
            out.append(0xCC)
            out.append(n)
        elif n < 0x10000:
            out.append(0xCD)
            out += _pack_to(">H", n)
        else:
            out.append(0xCE)
            out += _pack_to(">I", n)
        out += v
    elif isinstance(v, (list, tuple)):
        n = len(v)
        if n < 0x10:
            out.append(0x90 | n)
        elif n < 0x100:
            out.append(0xD4)
            out.append(n)
        elif n < 0x10000:
            out.append(0xD5)
            out += _pack_to(">H", n)
        else:
            out.append(0xD6)
            out += _pack_to(">I", n)
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        n = len(v)
        if n < 0x10:
            out.append(0xA0 | n)
        elif n < 0x100:
            out.append(0xD8)
            out.append(n)
        elif n < 0x10000:
            out.append(0xD9)
            out += _pack_to(">H", n)
        else:
            out.append(0xDA)
            out += _pack_to(">I", n)
        for key, val in v.items():
            _pack(str(key), out)
            _pack(val, out)
    elif isinstance(v, Structure):
        out.append(0xB0 | len(v.fields))
        out.append(v.tag)
        for f in v.fields:
            _pack(f, out)
    else:
        raise PackStreamError(f"cannot pack {type(v)!r}")


def _pack_int(v: int, out) -> None:
    """Kept for callers that encode bare ints; bytearray-based."""
    if isinstance(out, BytesIO):
        tmp = bytearray()
        _pack(v, tmp)
        out.write(bytes(tmp))
        return
    _pack(v, out)


_unpack_from = struct.unpack_from


def _unpack_at(data: bytes, pos: int):
    """Decode one value at `pos`; returns (value, next_pos). Flat function
    with direct byte indexing — the per-element method-call + slice +
    bounds-check of the old class decoder dominated bulk-parameter
    ingestion (10k-row UNWIND batches are one big nested list)."""
    marker = data[pos]
    pos += 1
    if marker < 0x80:
        return marker, pos
    if marker >= 0xF0:
        return marker - 0x100, pos
    if marker < 0x90:
        n = marker & 0x0F
        if pos + n > len(data):
            raise PackStreamError("unexpected end of data")
        return data[pos:pos + n].decode("utf-8"), pos + n
    if marker < 0xA0:
        out = []
        append = out.append
        for _ in range(marker & 0x0F):
            v, pos = _unpack_at(data, pos)
            append(v)
        return out, pos
    if marker < 0xB0:
        out = {}
        for _ in range(marker & 0x0F):
            k, pos = _unpack_at(data, pos)
            v, pos = _unpack_at(data, pos)
            out[k] = v
        return out, pos
    if marker < 0xC0:
        n = marker & 0x0F
        tag = data[pos]
        pos += 1
        fields = []
        for _ in range(n):
            v, pos = _unpack_at(data, pos)
            fields.append(v)
        return Structure(tag, fields), pos
    if marker == 0xC0:
        return None, pos
    if marker == 0xC1:
        return _unpack_from(">d", data, pos)[0], pos + 8
    if marker == 0xC2:
        return False, pos
    if marker == 0xC3:
        return True, pos
    if marker == 0xC8:
        return _unpack_from(">b", data, pos)[0], pos + 1
    if marker == 0xC9:
        return _unpack_from(">h", data, pos)[0], pos + 2
    if marker == 0xCA:
        return _unpack_from(">i", data, pos)[0], pos + 4
    if marker == 0xCB:
        return _unpack_from(">q", data, pos)[0], pos + 8
    if marker in (0xCC, 0xCD, 0xCE):
        if marker == 0xCC:
            n = data[pos]
            pos += 1
        elif marker == 0xCD:
            n = _unpack_from(">H", data, pos)[0]
            pos += 2
        else:
            n = _unpack_from(">I", data, pos)[0]
            pos += 4
        if pos + n > len(data):
            raise PackStreamError("unexpected end of data")
        return data[pos:pos + n], pos + n
    if marker in (0xD0, 0xD1, 0xD2):
        if marker == 0xD0:
            n = data[pos]
            pos += 1
        elif marker == 0xD1:
            n = _unpack_from(">H", data, pos)[0]
            pos += 2
        else:
            n = _unpack_from(">I", data, pos)[0]
            pos += 4
        if pos + n > len(data):
            raise PackStreamError("unexpected end of data")
        return data[pos:pos + n].decode("utf-8"), pos + n
    if marker in (0xD4, 0xD5, 0xD6):
        if marker == 0xD4:
            n = data[pos]
            pos += 1
        elif marker == 0xD5:
            n = _unpack_from(">H", data, pos)[0]
            pos += 2
        else:
            n = _unpack_from(">I", data, pos)[0]
            pos += 4
        out = []
        append = out.append
        for _ in range(n):
            v, pos = _unpack_at(data, pos)
            append(v)
        return out, pos
    if marker in (0xD8, 0xD9, 0xDA):
        if marker == 0xD8:
            n = data[pos]
            pos += 1
        elif marker == 0xD9:
            n = _unpack_from(">H", data, pos)[0]
            pos += 2
        else:
            n = _unpack_from(">I", data, pos)[0]
            pos += 4
        out = {}
        for _ in range(n):
            k, pos = _unpack_at(data, pos)
            v, pos = _unpack_at(data, pos)
            out[k] = v
        return out, pos
    raise PackStreamError(f"unknown marker 0x{marker:02X}")


class Unpacker:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def unpack(self):
        try:
            value, self.pos = _unpack_at(self.data, self.pos)
        except (IndexError, struct.error) as e:
            raise PackStreamError("unexpected end of data") from e
        return value


def unpack(data: bytes):
    return Unpacker(data).unpack()
