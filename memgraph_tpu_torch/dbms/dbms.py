"""Multi-tenancy: named databases with isolated storage.

Counterpart of the reference's DbmsHandler
(memgraph/src/dbms/dbms_handler.hpp:134 — per-tenant Database with
isolated storage and memory arena; New_/Get/Delete at :916-991). Each
database owns its InMemoryStorage + InterpreterContext; sessions switch
with USE DATABASE. The default database always exists.

Copy of memgraph_tpu/dbms/dbms.py for the port.  What differs:

- ``DbmsHandler(..., device=)`` builds every tenant's
  ``InterpreterContext`` on that device: the card unless the caller asks
  for the CPU.  Without a card and without that request it raises, and
  nothing falls back to the CPU.
- A ``durability_dir`` (recovery, WAL, the kvstore, the DDL restore,
  SUSPEND's snapshot) raises ``NotPortedException`` naming the port's
  durability slice, and ``ON_DISK_TRANSACTIONAL`` names its host
  features' slice.  So no tenant has a durability directory, and
  ``suspend`` refuses as the reference does for such a tenant; no tenant
  is cold, and the handler takes no ``recover_on_startup``.
"""

from __future__ import annotations

import dataclasses

from ..device import resolve_device
from ..exceptions import (SLICE_DURABILITY, SLICE_HOST_FEATURES,
                          NotPortedException, QueryException)
from ..utils.locks import tracked_lock
from ..storage import InMemoryStorage, StorageConfig
from ..storage.common import StorageMode

DEFAULT_DB = "memgraph"


class DbmsHandler:
    def __init__(self, root_config: StorageConfig | None = None,
                 interpreter_config: dict | None = None, *, device=None):
        self._lock = tracked_lock("Dbms._lock")
        self._root_config = root_config or StorageConfig()
        if self._root_config.durability_dir:
            raise NotPortedException("a durability directory",
                                     SLICE_DURABILITY)
        if self._root_config.storage_mode is \
                StorageMode.ON_DISK_TRANSACTIONAL:
            raise NotPortedException("ON_DISK_TRANSACTIONAL storage",
                                     SLICE_HOST_FEATURES)
        self.device = resolve_device(device)
        self._interp_config = interpreter_config or {}
        self._databases: dict[str, "InterpreterContext"] = {}
        from .tenant_profiles import TenantProfiles
        self.tenant_profiles = TenantProfiles()
        self._make(DEFAULT_DB)

    def _make(self, name: str):
        from ..query.interpreter import InterpreterContext
        # copy EVERY field of the root config (replace, not
        # field-by-field: a hand-copied list drops newly added knobs)
        storage = InMemoryStorage(dataclasses.replace(self._root_config))
        ictx = InterpreterContext(storage, dict(self._interp_config),
                                  device=self.device)
        ictx.database_name = name
        # per-DB arena cap: the tenant profile's storage_limit is
        # enforced at write commits (storage._check_db_memory_limit)
        storage.memory_limit_fn = (
            lambda n=name: self.tenant_profiles.limit_for_database(
                n, "storage_limit"))
        ictx.dbms = self
        self._databases[name] = ictx
        return ictx

    # --- API (reference: New_/Get/TryDelete) --------------------------------

    def create(self, name: str):
        if not name.replace("_", "").replace("-", "").isalnum():
            raise QueryException(f"invalid database name {name!r}")
        with self._lock:
            if name in self._databases:
                raise QueryException(f"database {name!r} already exists")
            return self._make(name)

    def get(self, name: str):
        with self._lock:
            ictx = self._databases.get(name)
        if ictx is None:
            raise QueryException(f"database {name!r} does not exist")
        return ictx

    def drop(self, name: str) -> None:
        if name == DEFAULT_DB:
            raise QueryException("cannot drop the default database")
        with self._lock:
            if name not in self._databases:
                raise QueryException(f"database {name!r} does not exist")
            del self._databases[name]
        # a recreated same-name database must not inherit the old limits
        self.tenant_profiles.clear(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._databases)

    # --- hot/cold (reference: specs/hot-cold-databases.md) ------------------

    def suspend(self, name: str) -> None:
        """HOT -> COLD needs the tenant's durability directory for its
        snapshot, which no tenant of the port has yet: it refuses as the
        reference does for a tenant without one."""
        if name == DEFAULT_DB:
            raise QueryException(
                "the default database cannot be suspended")
        with self._lock:
            if name not in self._databases:
                raise QueryException(f"database {name!r} does not exist")
        raise QueryException(
            f"database {name!r} has no durability directory — "
            f"suspending would lose its data")

    def resume(self, name: str) -> None:
        """COLD -> HOT; idempotent on hot databases, and no tenant of the
        port is cold."""
        with self._lock:
            if name not in self._databases:
                raise QueryException(f"database {name!r} does not exist")

    def default(self):
        return self.get(DEFAULT_DB)
