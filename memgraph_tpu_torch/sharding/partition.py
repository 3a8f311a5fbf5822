"""Stable hash partitioner: routing keys -> shard ids.

The partitioner must be a pure function of the VALUE, identical in
every process that ever routes (the parent plane, forked shard workers,
bench clients, a recovering worker) — so Python's salted ``hash()`` is
out. We hash a canonical byte encoding with crc32, which is stable
across processes, platforms and restarts (the reference analog: the
fixed fnv1a the reference uses for its property-sharded indices).

Keys are whatever the workload routes by — in the OLTP bench that is
the ``id`` property value; gids work too (``shard_for_gid``).

Copy of memgraph_tpu/sharding/partition.py for the port: the same
key gives the same shard in either package.
"""

from __future__ import annotations

import struct
import zlib

__all__ = ["N_SHARDS_DEFAULT", "canonical_key_bytes", "shard_for_key",
           "shard_for_gid"]

N_SHARDS_DEFAULT = 4


def canonical_key_bytes(key) -> bytes:
    """One canonical encoding per value so int 7 and float 7.0 and the
    string "7" land deterministically (ints/floats that compare equal
    share an encoding, mirroring Cypher value equality)."""
    if isinstance(key, bool):
        return b"b" + (b"1" if key else b"0")
    if isinstance(key, int):
        return b"i" + struct.pack("<q", key)
    if isinstance(key, float):
        if key.is_integer():
            return b"i" + struct.pack("<q", int(key))
        return b"f" + struct.pack("<d", key)
    if isinstance(key, str):
        return b"s" + key.encode("utf-8")
    if isinstance(key, bytes):
        return b"y" + key
    if key is None:
        return b"n"
    raise TypeError(f"unroutable partition key type {type(key).__name__}")


def shard_for_key(key, n_shards: int) -> int:
    """Map a routing key onto [0, n_shards)."""
    if n_shards <= 0:
        raise ValueError("n_shards must be positive")
    return zlib.crc32(canonical_key_bytes(key)) % n_shards


def shard_for_gid(gid: int, n_shards: int) -> int:
    return shard_for_key(int(gid), n_shards)
