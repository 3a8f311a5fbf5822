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
- ``ON_DISK_TRANSACTIONAL`` raises ``NotPortedException`` naming the
  host features' slice, and so do the enums a recovered kvstore may
  hold: they are neither read nor written until that slice.
- Every recovery (at start, on RESUME) ends in a topology version bump
  with no changed set (``storage/durability/recovery.py``): the port's
  snapshot cache and warm pool then export a recovered storage afresh
  and never serve it a plan placed for the storage before the restart.
"""

from __future__ import annotations

import os
import threading
import time

from ..device import resolve_device
from ..exceptions import (SLICE_HOST_FEATURES, NotPortedException,
                          QueryException)
from ..utils.locks import tracked_lock
from ..storage import InMemoryStorage, StorageConfig

DEFAULT_DB = "memgraph"


class DbmsHandler:
    def __init__(self, root_config: StorageConfig | None = None,
                 interpreter_config: dict | None = None,
                 recover_on_startup: bool = True, *, device=None):
        from ..storage.common import StorageMode
        self._lock = tracked_lock("Dbms._lock")
        self._root_config = root_config or StorageConfig()
        if self._root_config.storage_mode is \
                StorageMode.ON_DISK_TRANSACTIONAL:
            raise NotPortedException("ON_DISK_TRANSACTIONAL storage",
                                     SLICE_HOST_FEATURES)
        self.device = resolve_device(device)
        self._interp_config = interpreter_config or {}
        self._recover = recover_on_startup
        self._databases: dict[str, "InterpreterContext"] = {}
        self._suspended: set[str] = set()
        self._suspending: set[str] = set()   # snapshot in flight
        self._make(DEFAULT_DB)
        # suspended tenants stay cold across restarts (their durable
        # shell is on disk; SUSPENDED markers record the state)
        root = self._root_config.durability_dir
        if root:
            dbdir = os.path.join(root, "databases")
            if os.path.isdir(dbdir):
                for entry in os.listdir(dbdir):
                    if os.path.exists(os.path.join(dbdir, entry,
                                                   "SUSPENDED")):
                        self._suspended.add(entry)
        from .tenant_profiles import TenantProfiles
        self.tenant_profiles = TenantProfiles(
            self._databases[DEFAULT_DB].kvstore
            if getattr(self._databases[DEFAULT_DB], "kvstore", None)
            is not None else None)

    def _db_config(self, name: str) -> StorageConfig:
        import dataclasses
        # copy EVERY field (replace, not field-by-field: a hand-copied
        # list silently drops newly added StorageConfig knobs — it
        # already lost automatic_*_index once); per-db durability_dir is
        # assigned below
        cfg = dataclasses.replace(self._root_config, durability_dir=None)
        if self._root_config.durability_dir:
            if name == DEFAULT_DB:
                # the default database lives at the root (single-tenant
                # layouts stay recoverable when multi-tenancy is enabled)
                cfg.durability_dir = self._root_config.durability_dir
            else:
                cfg.durability_dir = os.path.join(
                    self._root_config.durability_dir, "databases", name)
            os.makedirs(cfg.durability_dir, exist_ok=True)
            marker = os.path.join(cfg.durability_dir, "STORAGE_MODE")
            if os.path.exists(marker):
                from ..storage.common import StorageMode
                with open(marker, encoding="utf-8") as f:
                    cfg.storage_mode = StorageMode(f.read().strip())
        return cfg

    def _make(self, name: str, force_recover: bool = False):
        from ..query.interpreter import InterpreterContext
        from ..storage.common import StorageMode
        recover_now = self._recover or force_recover
        cfg = self._db_config(name)
        if cfg.storage_mode is StorageMode.ON_DISK_TRANSACTIONAL:
            # a data directory may name disk mode (its STORAGE_MODE marker)
            raise NotPortedException("ON_DISK_TRANSACTIONAL storage",
                                     SLICE_HOST_FEATURES)
        storage = InMemoryStorage(cfg)
        if cfg.durability_dir:
            from ..storage.durability.recovery import (recover,
                                                       wire_durability)
            if recover_now:
                if cfg.allow_recovery_failure:
                    try:
                        recover(storage)
                    except Exception as e:  # noqa: BLE001
                        import logging
                        logging.getLogger(__name__).error(
                            "recovery failed (continuing, "
                            "--storage-allow-recovery-failure): %s", e)
                else:
                    recover(storage)
            if cfg.wal_enabled:
                wire_durability(storage)
        ictx = InterpreterContext(storage, dict(self._interp_config),
                                  device=self.device)
        ictx.database_name = name
        # per-DB arena cap: the tenant profile's storage_limit is
        # enforced at write commits (storage._check_db_memory_limit)
        storage.memory_limit_fn = (
            lambda n=name: self.tenant_profiles.limit_for_database(
                n, "storage_limit"))
        ictx.dbms = self
        if cfg.durability_dir:
            from ..storage.kvstore import KVStore, Settings
            ictx.kvstore = KVStore(
                os.path.join(cfg.durability_dir, "kvstore.db"))
            ictx.settings = Settings(ictx.kvstore)
            if recover_now:
                self._restore_ddl(storage, ictx.kvstore)
                if ictx.kvstore.get("enums"):
                    raise NotPortedException("recovering enums",
                                             SLICE_HOST_FEATURES)
        self._databases[name] = ictx
        return ictx

    @staticmethod
    def _restore_ddl(storage, kvstore) -> None:
        """Make the kvstore the authoritative DDL set: re-create persisted
        indexes/constraints AND drop any that the snapshot restored but the
        kvstore no longer lists (a drop after the last snapshot must win)."""
        import json as _json
        index_keys = set()
        for key, _ in kvstore.items_with_prefix("ddl:index:"):
            index_keys.add(tuple(_json.loads(key[len("ddl:index:"):])[:1])
                           + (key,))
        # reconcile drops first (only when DDL persistence has ever run —
        # a directory predating the feature keeps its snapshot DDL)
        has_any = kvstore.get("ddl:enabled") is not None
        if has_any:
            lm, pm, tm = (storage.label_mapper, storage.property_mapper,
                          storage.edge_type_mapper)
            listed = {key[len("ddl:index:"):]
                      for key, _ in kvstore.items_with_prefix("ddl:index:")}
            for lid in list(storage.indices.label.labels()):
                if _json.dumps(["label", lm.id_to_name(lid)]) not in listed:
                    storage.indices.label.drop(lid)
            for (lid, pids) in list(storage.indices.label_property.keys()):
                spec = _json.dumps(["label_property", lm.id_to_name(lid),
                                    [pm.id_to_name(p) for p in pids]])
                if spec not in listed:
                    storage.indices.label_property.drop(lid, pids)
            for tid in list(storage.indices.edge_type.types()):
                if _json.dumps(["edge_type", tm.id_to_name(tid)])                         not in listed:
                    storage.indices.edge_type.drop(tid)
            listed_c = {key[len("ddl:constraint:"):]
                        for key, _ in
                        kvstore.items_with_prefix("ddl:constraint:")}
            for (lid, pid) in list(storage.constraints.existence.all()):
                spec = _json.dumps(["exists", lm.id_to_name(lid),
                                    [pm.id_to_name(pid)]])
                if spec not in listed_c:
                    storage.constraints.existence.drop(lid, pid)
            for (lid, pids) in list(storage.constraints.unique.all()):
                spec = _json.dumps(["unique", lm.id_to_name(lid),
                                    [pm.id_to_name(p) for p in pids]])
                if spec not in listed_c:
                    storage.constraints.unique.drop(lid, tuple(pids))
            for (lid, pid, tname) in list(storage.constraints.type.all()):
                spec = _json.dumps(["type", lm.id_to_name(lid),
                                    [pm.id_to_name(pid)]])
                if spec not in listed_c:
                    storage.constraints.type.drop(lid, pid)
        for key, _ in kvstore.items_with_prefix("ddl:index:"):
            spec = _json.loads(key[len("ddl:index:"):])
            if spec[0] == "label":
                storage.create_label_index(
                    storage.label_mapper.name_to_id(spec[1]))
            elif spec[0] == "label_property":
                storage.create_label_property_index(
                    storage.label_mapper.name_to_id(spec[1]),
                    tuple(storage.property_mapper.name_to_id(p)
                          for p in spec[2]))
            elif spec[0] == "edge_type":
                storage.create_edge_type_index(
                    storage.edge_type_mapper.name_to_id(spec[1]))
        for key, raw in kvstore.items_with_prefix("ddl:constraint:"):
            kind, label, props = _json.loads(key[len("ddl:constraint:"):])
            data_type = raw.decode("utf-8")
            lid = storage.label_mapper.name_to_id(label)
            pids = [storage.property_mapper.name_to_id(p) for p in props]
            try:
                if kind == "exists":
                    storage.create_existence_constraint(lid, pids[0])
                elif kind == "unique":
                    storage.create_unique_constraint(lid, tuple(pids))
                elif kind == "type":
                    storage.create_type_constraint(lid, pids[0], data_type)
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "constraint restore failed: %s", key)

    # --- API (reference: New_/Get/TryDelete) --------------------------------

    def create(self, name: str):
        if not name.replace("_", "").replace("-", "").isalnum():
            raise QueryException(f"invalid database name {name!r}")
        with self._lock:
            if name in self._databases or name in self._suspended:
                raise QueryException(f"database {name!r} already exists")
            return self._make(name)

    def get(self, name: str):
        with self._lock:
            ictx = self._databases.get(name)
            if ictx is None and name in self._suspended:
                raise QueryException(
                    f"database {name!r} is suspended; RESUME DATABASE "
                    f"{name} first")
        if ictx is None:
            raise QueryException(f"database {name!r} does not exist")
        return ictx

    def drop(self, name: str) -> None:
        if name == DEFAULT_DB:
            raise QueryException("cannot drop the default database")
        with self._lock:
            if name in self._suspended:
                self._suspended.discard(name)
                self._clear_suspend_marker(name)
            elif name in self._databases:
                del self._databases[name]
            else:
                raise QueryException(f"database {name!r} does not exist")
        # a recreated same-name database must not inherit the old limits
        profiles = getattr(self, "tenant_profiles", None)
        if profiles is not None:
            profiles.clear(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(set(self._databases) | self._suspended)

    # --- hot/cold (reference: specs/hot-cold-databases.md) ------------------

    def _suspend_marker(self, name: str) -> str:
        return os.path.join(self._db_config(name).durability_dir or "",
                            "SUSPENDED")

    def _clear_suspend_marker(self, name: str) -> None:
        try:
            os.remove(self._suspend_marker(name))
        except OSError:
            pass

    def suspend(self, name: str) -> None:
        """HOT -> COLD: persist a durable shell, drop the in-memory
        storage. Never loses data (spec §2); not queryable until
        resumed."""
        if name == DEFAULT_DB:
            raise QueryException(
                "the default database cannot be suspended")
        with self._lock:
            if name in self._suspended:
                return                  # idempotent (spec §4 SUSPEND|cold)
            ictx = self._databases.get(name)
            if ictx is None:
                raise QueryException(f"database {name!r} does not exist")
            cfg = ictx.storage.config
            if not getattr(cfg, "durability_dir", None):
                raise QueryException(
                    f"database {name!r} has no durability directory — "
                    f"suspending would lose its data")
            # make the db invisible first; the (possibly long) snapshot
            # runs OUTSIDE the handler lock so other tenants never stall
            del self._databases[name]
            self._suspended.add(name)
            self._suspending.add(name)
        # gate BEFORE snapshotting: sessions holding a USE DATABASE
        # reference can no longer open transactions, and in-flight ones
        # must drain — a commit racing the snapshot would be silently
        # lost on resume ("never loses data", spec §2)
        ictx.storage.suspended = True
        try:
            deadline = time.monotonic() + 30.0
            while getattr(ictx.storage, "_active_txns", None):
                if time.monotonic() > deadline:
                    raise QueryException(
                        f"cannot suspend {name!r}: transactions did not "
                        f"drain within 30s")
                time.sleep(0.01)
            from ..storage.durability.snapshot import create_snapshot
            ictx.storage._suspend_internal = True
            try:
                create_snapshot(ictx.storage)
            finally:
                ictx.storage._suspend_internal = False
        except Exception:
            with self._lock:            # undo: the db stays hot
                ictx.storage.suspended = False
                self._suspended.discard(name)
                self._suspending.discard(name)
                self._databases[name] = ictx
            raise
        with self._lock:
            self._suspending.discard(name)
            # a concurrent RESUME may have re-made the db while we
            # snapshotted; its fresh instance wins — no stale marker
            if name not in self._suspended:
                return
            with open(self._suspend_marker(name), "w") as f:
                f.write("cold\n")

    def resume(self, name: str) -> None:
        """COLD -> HOT: rebuild from the durable shell; blocks until the
        database is queryable again. Idempotent on hot databases."""
        # a concurrent SUSPEND may still be writing its snapshot: block
        # until the durable shell is complete, or resuming would recover
        # stale state (spec: RESUME blocks until the database is hot)
        deadline = time.monotonic() + 60.0
        while True:
            with self._lock:
                if name not in self._suspending:
                    break
            if time.monotonic() > deadline:
                raise QueryException(
                    f"database {name!r} is still being suspended")
            time.sleep(0.01)
        with self._lock:
            if name in self._databases:
                return
            if name not in self._suspended:
                raise QueryException(f"database {name!r} does not exist")
            self._suspended.discard(name)
            self._clear_suspend_marker(name)
            # recovery is NON-optional here even when the server skips it
            # at startup: resuming without it would bring up an empty db
            self._make(name, force_recover=True)

    def database_states(self) -> list[tuple[str, str]]:
        with self._lock:
            rows = [(n, "hot") for n in self._databases]
            rows += [(n, "suspended") for n in self._suspended]
        return sorted(rows)

    def default(self):
        return self.get(DEFAULT_DB)
