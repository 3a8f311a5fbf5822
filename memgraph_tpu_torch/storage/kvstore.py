"""Durable key-value store for metadata.

Counterpart of the reference's RocksDB-backed kvstore
(memgraph/src/kvstore/kvstore.hpp): durable string->bytes map used
by auth, settings, trigger and stream metadata. Backed by sqlite3 (stdlib;
the RocksDB-class dependency this environment doesn't ship) with WAL mode.

Copy of memgraph_tpu/storage/kvstore.py for the port: the same table and
keys, so each package opens the other's ``kvstore.db``.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Iterator, Optional

from ..utils.locks import tracked_lock


class KVStore:
    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = tracked_lock("KVStore._lock")
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)")
        self._conn.commit()

    def put(self, key: str, value: bytes | str) -> None:
        from ..utils import faultinject as FI
        FI.fire("kvstore.put")
        if isinstance(value, str):
            value = value.encode("utf-8")
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v", (key, value))
            self._conn.commit()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def get_str(self, key: str) -> Optional[str]:
        raw = self.get(key)
        return raw.decode("utf-8") if raw is not None else None

    def delete(self, key: str) -> bool:
        with self._lock:
            cur = self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()
            return cur.rowcount > 0

    def items_with_prefix(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k LIKE ? ORDER BY k",
                (prefix + "%",)).fetchall()
        for k, v in rows:
            yield k, bytes(v)

    def delete_prefix(self, prefix: str) -> int:
        with self._lock:
            cur = self._conn.execute("DELETE FROM kv WHERE k LIKE ?",
                                     (prefix + "%",))
            self._conn.commit()
            return cur.rowcount

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class Settings:
    """Durable runtime settings (reference: utils/settings.hpp +
    flags/run_time_configurable.cpp) with change observers."""

    def __init__(self, kvstore: Optional[KVStore] = None) -> None:
        self._kv = kvstore
        self._cache: dict[str, str] = {}
        self._observers: dict[str, list] = {}
        if kvstore is not None:
            for key, value in kvstore.items_with_prefix("setting:"):
                self._cache[key[len("setting:"):]] = value.decode("utf-8")

    def set(self, name: str, value: str) -> None:
        self._cache[name] = value
        if self._kv is not None:
            self._kv.put(f"setting:{name}", value)
        for fn in self._observers.get(name, []):
            fn(value)

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._cache.get(name, default)

    def all(self) -> dict[str, str]:
        return dict(self._cache)

    def observe(self, name: str, fn) -> None:
        self._observers.setdefault(name, []).append(fn)


def ensure_settings(ictx) -> "Settings":
    """The one place that lazily attaches the runtime Settings store to
    an interpreter context (shared by the interpreter's SET DATABASE
    SETTING path and main.py's license wiring)."""
    settings = getattr(ictx, "settings", None)
    if settings is None:
        settings = ictx.settings = Settings(getattr(ictx, "kvstore", None))
    return settings
