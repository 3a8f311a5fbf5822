"""Tenant profiles: named resource limits assignable to databases.

Counterpart of the reference's TenantProfiles
(memgraph/src/dbms/tenant_profiles.cpp + the MemgraphCypher.g4
tenant-profile grammar): CREATE/ALTER/DROP TENANT PROFILE with a limit
list, SHOW, and SET ... ON DATABASE assignment, persisted in the root
kvstore so they survive restarts.

Enforced limit: `memory_limit` becomes the DEFAULT per-query memory cap
for every query running against an assigned database (an explicit
QUERY MEMORY LIMIT still wins); the reference additionally meters the
storage arena, which this build tracks globally, not per tenant.

Copy of memgraph_tpu/dbms/tenant_profiles.py for the port.  The port has
no kvstore yet (it comes with durability), so its profiles live in
memory.
"""

from __future__ import annotations

import json
import threading

from ..exceptions import QueryException

_KEY = "tenant_profiles"


class TenantProfiles:
    def __init__(self, kvstore=None) -> None:
        self._lock = threading.Lock()
        self._profiles: dict[str, dict] = {}
        self._assignments: dict[str, str] = {}   # database -> profile
        self._kv = kvstore
        if kvstore is not None:
            raw = kvstore.get_str(_KEY)
            if raw:
                data = json.loads(raw)
                self._profiles = data.get("profiles", {})
                self._assignments = data.get("assignments", {})

    def _save(self) -> None:
        if self._kv is not None:
            self._kv.put(_KEY, json.dumps(
                {"profiles": self._profiles,
                 "assignments": self._assignments}))

    # --- DDL -----------------------------------------------------------------

    def create(self, name: str, limits: dict) -> None:
        with self._lock:
            if name in self._profiles:
                raise QueryException(
                    f"tenant profile {name!r} already exists")
            self._profiles[name] = dict(limits)
            self._save()

    def alter(self, name: str, limits: dict) -> None:
        with self._lock:
            if name not in self._profiles:
                raise QueryException(
                    f"tenant profile {name!r} does not exist")
            self._profiles[name].update(limits)
            self._save()

    def drop(self, name: str) -> None:
        with self._lock:
            if name not in self._profiles:
                raise QueryException(
                    f"tenant profile {name!r} does not exist")
            del self._profiles[name]
            self._assignments = {db: p for db, p
                                 in self._assignments.items() if p != name}
            self._save()

    def assign(self, database: str, profile: str) -> None:
        with self._lock:
            if profile not in self._profiles:
                raise QueryException(
                    f"tenant profile {profile!r} does not exist")
            self._assignments[database] = profile
            self._save()

    def clear(self, database: str) -> None:
        with self._lock:
            self._assignments.pop(database, None)
            self._save()

    # --- reads ---------------------------------------------------------------

    def show(self, name: str | None = None) -> list[list]:
        with self._lock:
            items = (sorted(self._profiles.items()) if name is None
                     else [(name, self._profiles.get(name))])
            out = []
            for pname, limits in items:
                if limits is None:
                    raise QueryException(
                        f"tenant profile {pname!r} does not exist")
                dbs = sorted(db for db, p in self._assignments.items()
                             if p == pname)
                out.append([pname, dict(limits), dbs])
            return out

    def limit_for_database(self, database: str, key: str):
        with self._lock:
            profile = self._assignments.get(database)
            if profile is None:
                return None
            return self._profiles.get(profile, {}).get(key)
