"""Per-user resource profiles.

Counterpart of the reference's UserProfiles
(memgraph/src/auth/profiles/user_profiles.cpp + the
MemgraphCypher.g4:974-991 grammar): named profiles carrying the limits
`sessions` (max concurrent Bolt sessions) and `transactions_memory`
(per-query memory cap), assignable to users, persisted in the kvstore.

Enforcement here:
  - sessions: BoltSession registration counts live sessions per
    username and refuses logins over the limit.
  - transactions_memory: becomes the default per-query memory cap for
    that user (explicit QUERY MEMORY LIMIT still wins; combined with a
    tenant-profile cap the smaller one applies).

Copy of memgraph_tpu/auth/profiles.py for the port: with a data
directory the profiles live in its kvstore (``storage/kvstore.py``),
under the same key as the reference's.
"""

from __future__ import annotations

import json
import threading

from ..exceptions import QueryException

_KEY = "user_profiles"
LIMIT_KEYS = ("sessions", "transactions_memory")


class UserProfiles:
    def __init__(self, kvstore=None) -> None:
        self._lock = threading.Lock()
        self._profiles: dict[str, dict] = {}
        self._assignments: dict[str, str] = {}   # username -> profile
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

    @staticmethod
    def _check_limits(limits: dict) -> dict:
        for key in limits:
            if key not in LIMIT_KEYS:
                raise QueryException(
                    f"unknown profile limit {key!r}; supported: "
                    f"{', '.join(LIMIT_KEYS)}")
        return dict(limits)

    # --- DDL -----------------------------------------------------------------

    def create(self, name: str, limits: dict) -> None:
        with self._lock:
            if name in self._profiles:
                raise QueryException(f"profile {name!r} already exists")
            self._profiles[name] = self._check_limits(limits)
            self._save()

    def update(self, name: str, limits: dict) -> None:
        with self._lock:
            if name not in self._profiles:
                raise QueryException(f"profile {name!r} does not exist")
            self._profiles[name].update(self._check_limits(limits))
            self._save()

    def drop(self, name: str) -> None:
        with self._lock:
            if name not in self._profiles:
                raise QueryException(f"profile {name!r} does not exist")
            del self._profiles[name]
            self._assignments = {u: p for u, p in
                                 self._assignments.items() if p != name}
            self._save()

    def assign(self, username: str, profile: str) -> None:
        with self._lock:
            if profile not in self._profiles:
                raise QueryException(
                    f"profile {profile!r} does not exist")
            self._assignments[username] = profile
            self._save()

    def clear(self, username: str) -> None:
        with self._lock:
            self._assignments.pop(username, None)
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
                        f"profile {pname!r} does not exist")
                shown = {k: ("UNLIMITED" if limits.get(k) is None
                             else limits[k]) for k in LIMIT_KEYS
                         if k in limits}
                out.append([pname, shown])
            return out

    def profile_for(self, username: str):
        with self._lock:
            return self._assignments.get(username)

    def users_for(self, profile: str) -> list[str]:
        with self._lock:
            if profile not in self._profiles:
                raise QueryException(
                    f"profile {profile!r} does not exist")
            return sorted(u for u, p in self._assignments.items()
                          if p == profile)

    def limit_for_user(self, username: str, key: str):
        with self._lock:
            profile = self._assignments.get(username)
            if profile is None:
                return None
            return self._profiles.get(profile, {}).get(key)


def ensure_user_profiles(ictx) -> "UserProfiles":
    profiles = getattr(ictx, "user_profiles", None)
    if profiles is None:
        profiles = ictx.user_profiles = UserProfiles(
            getattr(ictx, "kvstore", None))
    return profiles
