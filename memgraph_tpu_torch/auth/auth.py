"""Users, roles, permissions (AuthN/AuthZ).

Capability map to the reference's auth layer (memgraph/src/auth/):
users with salted-hash passwords (PBKDF2 — the stdlib-available equivalent
of the reference's bcrypt, auth/crypto.cpp), roles, per-privilege
GRANT/DENY, durable via JSON (kvstore analog lands with durability dir).

Copy of memgraph_tpu/auth/auth.py for the port.  Its JSON file has the
same layout: each package's ``Auth`` loads the file the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading
from dataclasses import dataclass, field

from ..exceptions import AuthException

PRIVILEGES = [
    "CREATE", "DELETE", "MATCH", "MERGE", "SET", "REMOVE", "INDEX", "STATS",
    "CONSTRAINT", "DUMP", "REPLICATION", "DURABILITY", "READ_FILE",
    "FREE_MEMORY", "TRIGGER", "CONFIG", "AUTH", "STREAM", "MODULE_READ",
    "MODULE_WRITE", "WEBSOCKET", "TRANSACTION_MANAGEMENT", "STORAGE_MODE",
    "MULTI_DATABASE_EDIT", "MULTI_DATABASE_USE", "COORDINATOR",
]


def _hash_password(password: str, salt: bytes | None = None) -> str:
    if salt is None:
        salt = secrets.token_bytes(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt,
                                 100_000)
    return salt.hex() + "$" + digest.hex()


def _verify_password(password: str, stored: str) -> bool:
    try:
        salt_hex, digest_hex = stored.split("$", 1)
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"),
                                 bytes.fromhex(salt_hex), 100_000)
    return secrets.compare_digest(digest.hex(), digest_hex)


@dataclass
class Role:
    name: str
    granted: set = field(default_factory=set)
    denied: set = field(default_factory=set)
    # fine-grained: label/edge-type name (or "*") -> access level
    fg_labels: dict = field(default_factory=dict)
    fg_edge_types: dict = field(default_factory=dict)


@dataclass
class User:
    name: str
    password_hash: str | None = None
    roles: list[str] = field(default_factory=list)
    granted: set = field(default_factory=set)
    denied: set = field(default_factory=set)
    fg_labels: dict = field(default_factory=dict)
    fg_edge_types: dict = field(default_factory=dict)
    # module-managed (SSO) identity: basic-scheme login is REFUSED for
    # these users (a passwordless external user must not be open)
    external: bool = False


class Auth:
    def __init__(self, storage_path: str | None = None,
                 module_mappings: dict | None = None) -> None:
        self._lock = threading.Lock()
        self._users: dict[str, User] = {}
        self._roles: dict[str, Role] = {}
        self._path = storage_path
        # scheme -> AuthModule (SSO/external auth; auth/module.py)
        self.module_mappings = dict(module_mappings or {})
        if storage_path and os.path.exists(storage_path):
            self._load()

    # --- external (SSO) authentication --------------------------------------

    def authenticate_external(self, scheme: str, principal: str,
                              credentials) -> str | None:
        """Route a non-basic Bolt auth scheme through its external
        module. Returns the authenticated username, or None.

        The module decides identity AND role
        ({"authenticated": true, "username": ..., "role": ...}); the
        user is auto-created on first login and its role assignment
        follows the module on every login (reference: SSO users are
        module-managed, auth/module.cpp)."""
        module = self.module_mappings.get((scheme or "").lower())
        if module is None:
            return None
        reply = module.call({"scheme": scheme, "username": principal,
                             "response": credentials})
        if not reply or reply.get("authenticated") is not True:
            return None
        username = reply.get("username") or principal
        if not isinstance(username, str) or not username:
            return None
        # modules may return a single "role" or a "roles" list (the OIDC
        # flow maps one IdP role to several local roles)
        roles = reply.get("roles")
        if not isinstance(roles, list):
            role = reply.get("role")
            roles = [role] if isinstance(role, str) and role else []
        roles = [r for r in roles if isinstance(r, str) and r]
        with self._lock:
            changed = False
            user = self._users.get(username)
            if user is None:
                user = User(username, None, external=True)
                self._users[username] = user
                changed = True
            if roles:
                for role in roles:
                    if role not in self._roles:
                        self._roles[role] = Role(role)
                        changed = True
                new_roles = list(dict.fromkeys(roles))
            else:
                # the module is authoritative on EVERY login: a reply
                # without a role revokes previous module-granted roles
                new_roles = []
            if user.roles != new_roles:
                user.roles = new_roles
                changed = True
            if changed:   # reconnect storms must not rewrite the store
                self._save()
        return username

    # --- users --------------------------------------------------------------

    def create_user(self, name: str, password: str | None = None) -> None:
        with self._lock:
            if name in self._users:
                raise AuthException(f"user {name!r} already exists")
            user = User(name, _hash_password(password) if password else None)
            if not self._users:
                # the first user becomes the administrator (full grants) —
                # otherwise enabling auth would lock everyone out
                user.granted = set(PRIVILEGES)
            self._users[name] = user
            self._save()

    def drop_user(self, name: str) -> None:
        with self._lock:
            if name not in self._users:
                raise AuthException(f"user {name!r} does not exist")
            del self._users[name]
            self._save()

    def set_password(self, name: str, password: str | None) -> None:
        with self._lock:
            user = self._users.get(name)
            if user is None:
                raise AuthException(f"user {name!r} does not exist")
            user.password_hash = _hash_password(password) if password else None
            self._save()

    def authenticate(self, name: str, password: str) -> bool:
        with self._lock:
            if not self._users:
                return True  # no users defined → open instance (reference behavior)
            user = self._users.get(name)
            if user is None:
                return False
            if user.external:
                # SSO identities authenticate ONLY through their module
                return False
            if user.password_hash is None:
                return True
            return _verify_password(password, user.password_hash)

    def users(self) -> list[str]:
        with self._lock:
            return sorted(self._users)

    def user_roles(self, name: str) -> list[str]:
        with self._lock:
            user = self._users.get(name)
            return sorted(user.roles) if user is not None else []

    def roles(self) -> list[str]:
        with self._lock:
            return sorted(self._roles)

    def _resolve_locked(self, name: str, privilege: str) -> str | None:
        """Single resolution routine shared by enforcement and reporting:
        user deny > user grant > role deny > role grant. Returns 'GRANT',
        'DENY', or None (no opinion). Caller holds self._lock."""
        user = self._users.get(name)
        if user is not None:
            if privilege in user.denied:
                return "DENY"
            if privilege in user.granted:
                return "GRANT"
            role_granted = False
            for role_name in user.roles:
                role = self._roles.get(role_name)
                if role is None:
                    continue
                if privilege in role.denied:
                    return "DENY"
                if privilege in role.granted:
                    role_granted = True
            return "GRANT" if role_granted else None
        role = self._roles.get(name)
        if role is not None:
            if privilege in role.denied:
                return "DENY"
            if privilege in role.granted:
                return "GRANT"
        return None

    def effective_privileges(self, name: str) -> list[tuple[str, str]]:
        """[(privilege, 'GRANT'|'DENY')] for a user or role; raises for
        unknown names. Uses the same resolution order as has_privilege
        so SHOW PRIVILEGES never contradicts enforcement."""
        with self._lock:
            if name not in self._users and name not in self._roles:
                raise AuthException(f"user or role {name!r} does not exist")
            out = []
            for p in PRIVILEGES:
                verdict = self._resolve_locked(name, p)
                if verdict is not None:
                    out.append((p, verdict))
            return out

    # --- roles / privileges -------------------------------------------------

    def create_role(self, name: str) -> None:
        with self._lock:
            if name in self._roles:
                raise AuthException(f"role {name!r} already exists")
            self._roles[name] = Role(name)
            self._save()

    def drop_role(self, name: str) -> None:
        with self._lock:
            self._roles.pop(name, None)
            for user in self._users.values():
                if name in user.roles:
                    user.roles.remove(name)
            self._save()

    def set_role(self, user: str, role: str) -> None:
        with self._lock:
            if user not in self._users:
                raise AuthException(f"user {user!r} does not exist")
            if role not in self._roles:
                raise AuthException(f"role {role!r} does not exist")
            if role not in self._users[user].roles:
                self._users[user].roles.append(role)
            self._save()

    def grant(self, name: str, privileges: list[str]) -> None:
        self._change_privileges(name, privileges, "grant")

    def deny(self, name: str, privileges: list[str]) -> None:
        self._change_privileges(name, privileges, "deny")

    def revoke(self, name: str, privileges: list[str]) -> None:
        self._change_privileges(name, privileges, "revoke")

    def _change_privileges(self, name, privileges, action) -> None:
        privileges = [p.upper() for p in privileges]
        for p in privileges:
            if p != "ALL" and p not in PRIVILEGES:
                raise AuthException(f"unknown privilege {p}")
        with self._lock:
            target = self._users.get(name) or self._roles.get(name)
            if target is None:
                raise AuthException(f"user or role {name!r} does not exist")
            plist = PRIVILEGES if "ALL" in privileges else privileges
            for p in plist:
                if action == "grant":
                    target.granted.add(p)
                    target.denied.discard(p)
                elif action == "deny":
                    target.denied.add(p)
                    target.granted.discard(p)
                else:
                    target.granted.discard(p)
                    target.denied.discard(p)
            self._save()

    def grant_fine_grained(self, name: str, kind: str, items: list[str],
                           level: str) -> None:
        """kind: 'labels' | 'edge_types'; items may be ['*']."""
        if level not in FG_LEVELS:
            raise AuthException(f"unknown access level {level!r}")
        with self._lock:
            p = self._users.get(name) or self._roles.get(name)
            if p is None:
                raise AuthException(f"no such user or role {name!r}")
            target = p.fg_labels if kind == "labels" else p.fg_edge_types
            for item in items:
                target[item] = level
            self._save()

    def revoke_fine_grained(self, name: str, kind: str,
                            items: list[str]) -> None:
        with self._lock:
            p = self._users.get(name) or self._roles.get(name)
            if p is None:
                raise AuthException(f"no such user or role {name!r}")
            target = p.fg_labels if kind == "labels" else p.fg_edge_types
            for item in items:
                target.pop(item, None)
            self._save()

    def fine_grained_checker(self, username: str,
                             allow_role: bool = False
                             ) -> "FineGrainedChecker":
        """allow_role=True additionally resolves a bare role name (for
        SHOW PRIVILEGES inspection); the runtime authorization path must
        keep it False so a dropped user never inherits a same-named
        role's rules."""
        return FineGrainedChecker(self, username, allow_role=allow_role)

    def has_privilege(self, user_name: str, privilege: str) -> bool:
        with self._lock:
            if not self._users:
                return True
            if user_name not in self._users:
                return False
            return self._resolve_locked(user_name, privilege) == "GRANT"

    # --- durability ---------------------------------------------------------

    def to_dict(self) -> dict:
        """Full-state dump for system replication (reference analog: the
        ordered auth system txns of src/system/transaction.cpp; the store
        is small, so full-state transfer is idempotent and order-safe)."""
        with self._lock:
            return self._dump_locked()

    def apply_dict(self, data: dict) -> None:
        """Replace contents with a to_dict() dump (replica apply)."""
        with self._lock:
            self._users.clear()
            self._roles.clear()
            self._load_data(data)
            self._save()

    def _dump_locked(self) -> dict:
        return {
            "users": [{"name": u.name, "password_hash": u.password_hash,
                       "roles": u.roles, "granted": sorted(u.granted),
                       "denied": sorted(u.denied),
                       "fg_labels": u.fg_labels,
                       "fg_edge_types": u.fg_edge_types,
                       "external": u.external}
                      for u in self._users.values()],
            "roles": [{"name": r.name, "granted": sorted(r.granted),
                       "denied": sorted(r.denied),
                       "fg_labels": r.fg_labels,
                       "fg_edge_types": r.fg_edge_types}
                      for r in self._roles.values()],
        }

    def _load_data(self, data: dict) -> None:
        for u in data.get("users", []):
            self._users[u["name"]] = User(
                u["name"], u.get("password_hash"), u.get("roles", []),
                set(u.get("granted", [])), set(u.get("denied", [])),
                dict(u.get("fg_labels", {})),
                dict(u.get("fg_edge_types", {})),
                external=bool(u.get("external", False)))
        for r in data.get("roles", []):
            self._roles[r["name"]] = Role(
                r["name"], set(r.get("granted", [])),
                set(r.get("denied", [])),
                dict(r.get("fg_labels", {})),
                dict(r.get("fg_edge_types", {})))

    def _save(self) -> None:
        if not self._path:
            return
        data = {
            "users": [{"name": u.name, "password_hash": u.password_hash,
                       "roles": u.roles, "granted": sorted(u.granted),
                       "denied": sorted(u.denied),
                       "fg_labels": u.fg_labels,
                       "fg_edge_types": u.fg_edge_types,
                       "external": u.external}
                      for u in self._users.values()],
            "roles": [{"name": r.name, "granted": sorted(r.granted),
                       "denied": sorted(r.denied),
                       "fg_labels": r.fg_labels,
                       "fg_edge_types": r.fg_edge_types}
                      for r in self._roles.values()],
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self._path)

    def _load(self) -> None:
        with open(self._path) as f:
            data = json.load(f)
        self._load_data(data)


# --- fine-grained (label-based) access -------------------------------------
# Reference: src/auth/models.cpp FineGrainedAccessPermissions — per-label /
# per-edge-type levels NOTHING < READ < UPDATE < CREATE_DELETE, with "*"
# as the global fallback rule.

FG_LEVELS = {"NOTHING": 0, "READ": 1, "UPDATE": 2, "CREATE_DELETE": 3}


class FineGrainedChecker:
    """Resolved per-session view of a user's label/edge-type permissions.

    Resolution per item: user-specific rule > user "*" > role-specific >
    role "*". A principal with NO fine-grained rules anywhere is
    unrestricted (fine-grained is opt-in, as in the reference); once any
    rule exists, unmatched items default to NOTHING.
    """

    def __init__(self, auth: "Auth", username: str,
                 allow_role: bool = False) -> None:
        # kept as SEPARATE chains: a user's "*" rule must shadow a role's
        # label-specific rule, which a flat merge cannot express
        self._label_chain: list[dict] = []
        self._etype_chain: list[dict] = []
        with auth._lock:
            user = auth._users.get(username)
            if user is None and allow_role and username in auth._roles:
                # allow inspecting a ROLE's fine-grained rules directly
                role = auth._roles[username]
                self._label_chain.append(
                    {k: FG_LEVELS.get(v, 0)
                     for k, v in role.fg_labels.items()})
                self._etype_chain.append(
                    {k: FG_LEVELS.get(v, 0)
                     for k, v in role.fg_edge_types.items()})
            if user is not None:
                self._label_chain.append(
                    {k: FG_LEVELS.get(v, 0) for k, v in user.fg_labels.items()})
                self._etype_chain.append(
                    {k: FG_LEVELS.get(v, 0)
                     for k, v in user.fg_edge_types.items()})
                for rn in user.roles:
                    role = auth._roles.get(rn)
                    if role is not None:
                        self._label_chain.append(
                            {k: FG_LEVELS.get(v, 0)
                             for k, v in role.fg_labels.items()})
                        self._etype_chain.append(
                            {k: FG_LEVELS.get(v, 0)
                             for k, v in role.fg_edge_types.items()})
        self.restricted = any(self._label_chain) or any(self._etype_chain)
        # flattened views for SHOW PRIVILEGES (resolution order preserved)
        self._labels: dict[str, int] = {}
        self._edge_types: dict[str, int] = {}
        for keys, chain, out in (("l", self._label_chain, self._labels),
                                 ("e", self._etype_chain, self._edge_types)):
            for rules in chain:
                for k in rules:
                    out.setdefault(
                        k, self._resolve(chain, k))

    @staticmethod
    def _resolve(chain: list[dict], name: str) -> int:
        """First chain entry (user, then roles in order) that has either a
        specific rule or a "*" rule decides."""
        for rules in chain:
            if name in rules:
                return rules[name]
            if "*" in rules:
                return rules["*"]
        return 0

    def label_level(self, name: str) -> int:
        if not self.restricted:
            return 3
        return self._resolve(self._label_chain, name)

    def edge_type_level(self, name: str) -> int:
        if not self.restricted:
            return 3
        return self._resolve(self._etype_chain, name)

    # vertex rules: the level of a vertex is the MINIMUM over its labels
    # (an unlabeled vertex is unrestricted), matching the reference's
    # FineGrainedAuthChecker vertex accumulation
    def vertex_level(self, label_names) -> int:
        level = 3
        for name in label_names:
            level = min(level, self.label_level(name))
        return level


_GLOBAL_AUTH: Auth | None = None
_GLOBAL_LOCK = threading.Lock()


def resolve_auth(interpreter_context) -> Auth:
    """The Auth store a session should consult: the context's wired
    auth_store, else the process-global one. Single source for both RBAC
    enforcement (Interpreter._auth_store) and the roles() builtin."""
    auth = getattr(interpreter_context, "auth_store", None)
    return auth if auth is not None else global_auth()


def global_auth() -> Auth:
    global _GLOBAL_AUTH
    with _GLOBAL_LOCK:
        if _GLOBAL_AUTH is None:
            _GLOBAL_AUTH = Auth()
        return _GLOBAL_AUTH
