"""Existence and unique constraints.

Capability map to the reference's storage/v2/constraints/: existence
constraints validated per-write, unique constraints validated at commit time
under the engine lock (reference: inmemory/storage.cpp:1156-1172). Unique
keys use the canonical binary value encoding so composite and nested values
compare correctly.

Copy of memgraph_tpu/storage/constraints.py for the port (its imports the port's own).
"""

from __future__ import annotations

import threading

from ..exceptions import ConstraintViolation
from .property_store import value_key


class ExistenceConstraints:
    """Set of (label_id, prop_id): every vertex with label must have prop."""

    def __init__(self) -> None:
        self._constraints: set[tuple[int, int]] = set()

    def create(self, label_id: int, prop_id: int, vertices, namer=None) -> None:
        for v in vertices:
            if label_id in v.labels and prop_id not in v.properties and not v.deleted:
                raise ConstraintViolation(
                    self._message(label_id, prop_id, namer),
                    constraint=("existence", label_id, (prop_id,)))
        self._constraints.add((label_id, prop_id))

    def drop(self, label_id: int, prop_id: int) -> bool:
        try:
            self._constraints.remove((label_id, prop_id))
            return True
        except KeyError:
            return False

    def has(self, label_id: int, prop_id: int) -> bool:
        return (label_id, prop_id) in self._constraints

    def all(self):
        return sorted(self._constraints)

    @staticmethod
    def _message(label_id, prop_id, namer):
        if namer:
            return (f"Node with label {namer.label(label_id)} is missing "
                    f"required property {namer.prop(prop_id)}")
        return f"Existence constraint violated (label {label_id}, property {prop_id})"

    def validate_vertex(self, labels, properties, namer=None) -> None:
        for (label_id, prop_id) in self._constraints:
            if label_id in labels and prop_id not in properties:
                raise ConstraintViolation(
                    self._message(label_id, prop_id, namer),
                    constraint=("existence", label_id, (prop_id,)))


def _canonical(v):
    """Canonicalize values so key equality matches Cypher value equality:
    1 == 1.0 (but true != 1), applied recursively through containers."""
    if isinstance(v, bool):
        return v
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 63:
        return int(v)
    if isinstance(v, list):
        return [_canonical(x) for x in v]
    if isinstance(v, dict):
        return {k: _canonical(x) for k, x in v.items()}
    return v


class _UniqueSlot:
    """Committed key registry for one unique constraint."""

    __slots__ = ("by_key", "by_gid")

    def __init__(self) -> None:
        self.by_key: dict[bytes, int] = {}
        self.by_gid: dict[int, bytes] = {}

    def register(self, gid: int, new_key: bytes | None) -> None:
        old_key = self.by_gid.get(gid)
        if old_key == new_key:
            return
        if old_key is not None:
            # same-commit handover may have already reassigned the key to
            # another gid — only release it if we still own it
            if self.by_key.get(old_key) == gid:
                self.by_key.pop(old_key)
            del self.by_gid[gid]
        if new_key is not None:
            self.by_key[new_key] = gid
            self.by_gid[gid] = new_key


class UniqueConstraints:
    """Set of (label_id, (prop_ids...)) with committed-value registries.

    Registered values track *committed* state only; commit-time validation
    (under the engine lock, so commits are serialized) checks each touched
    vertex's new values against the registry and against the other vertices
    committing in the same transaction.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._maps: dict[tuple[int, tuple[int, ...]], _UniqueSlot] = {}

    @staticmethod
    def _key(values) -> bytes:
        return b"\x1f".join(value_key(_canonical(v)) for v in values)

    def create(self, label_id: int, prop_ids: tuple[int, ...], vertices,
               namer=None) -> None:
        slot = _UniqueSlot()
        for v in vertices:
            k = self._vertex_key(v, label_id, prop_ids)
            if k is None:
                continue
            if k in slot.by_key:
                raise ConstraintViolation(
                    self._message(label_id, prop_ids, namer),
                    constraint=("unique", label_id, prop_ids))
            slot.register(v.gid, k)
        with self._lock:
            self._maps[(label_id, prop_ids)] = slot

    def drop(self, label_id: int, prop_ids: tuple[int, ...]) -> bool:
        with self._lock:
            return self._maps.pop((label_id, prop_ids), None) is not None

    def has(self, label_id: int, prop_ids: tuple[int, ...]) -> bool:
        return (label_id, prop_ids) in self._maps

    def all(self):
        return sorted(self._maps)

    def _vertex_key(self, v, label_id, prop_ids):
        if label_id not in v.labels or v.deleted:
            return None
        values = []
        for pid in prop_ids:
            if pid not in v.properties:
                return None
            values.append(v.properties[pid])
        return self._key(values)

    @staticmethod
    def _message(label_id, prop_ids, namer):
        if namer:
            props = ", ".join(namer.prop(p) for p in prop_ids)
            return (f"Unique constraint violated on label "
                    f"{namer.label(label_id)} properties ({props})")
        return f"Unique constraint violated (label {label_id}, properties {prop_ids})"

    def validate_commit(self, touched_vertices, namer=None) -> list:
        """Validate touched vertices; return registrations to apply on success.

        Called under the engine lock. Checks both the committed registry and
        collisions *within* this commit's pending set.
        """
        registrations = []
        for (label_id, prop_ids), slot in self._maps.items():
            # first pass: keys this commit releases (old owner loses the key),
            # so a same-transaction handover (delete A, create B with A's
            # value) validates correctly
            new_keys: dict[int, bytes | None] = {}
            released: set[bytes] = set()
            for v in touched_vertices:
                new_key = self._vertex_key(v, label_id, prop_ids)
                new_keys[v.gid] = new_key
                old_key = slot.by_gid.get(v.gid)
                if old_key is not None and old_key != new_key:
                    released.add(old_key)
            pending: dict[bytes, int] = {}
            for v in touched_vertices:
                new_key = new_keys[v.gid]
                if new_key is not None:
                    owner = slot.by_key.get(new_key)
                    if (owner is not None and owner != v.gid
                            and new_key not in released):
                        raise ConstraintViolation(
                            self._message(label_id, prop_ids, namer),
                            constraint=("unique", label_id, prop_ids))
                    other = pending.get(new_key)
                    if other is not None and other != v.gid:
                        raise ConstraintViolation(
                            self._message(label_id, prop_ids, namer),
                            constraint=("unique", label_id, prop_ids))
                    pending[new_key] = v.gid
                if new_key is not None or v.gid in slot.by_gid:
                    registrations.append((slot, v.gid, new_key))
        return registrations

    def apply_registrations(self, registrations) -> None:
        with self._lock:
            for slot, gid, new_key in registrations:
                slot.register(gid, new_key)


class TypeConstraints:
    """(label_id, prop_id) -> required type name (IS TYPED ...)."""

    _CHECKS = {
        "STRING": lambda v: isinstance(v, str),
        "INTEGER": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "FLOAT": lambda v: isinstance(v, float),
        "BOOLEAN": lambda v: isinstance(v, bool),
        "LIST": lambda v: isinstance(v, list),
        "MAP": lambda v: isinstance(v, dict),
    }

    def __init__(self) -> None:
        self._constraints: dict[tuple[int, int], str] = {}

    def create(self, label_id: int, prop_id: int, type_name: str,
               vertices, namer=None) -> None:
        type_name = type_name.upper()
        check = self._CHECKS.get(type_name)
        if check is None:
            raise ConstraintViolation(f"Unsupported type constraint {type_name}")
        for v in vertices:
            if label_id in v.labels and prop_id in v.properties and not v.deleted:
                if not check(v.properties[prop_id]):
                    raise ConstraintViolation(
                        f"Type constraint ({type_name}) violated",
                        constraint=("type", label_id, (prop_id,)))
        self._constraints[(label_id, prop_id)] = type_name

    def drop(self, label_id: int, prop_id: int) -> bool:
        return self._constraints.pop((label_id, prop_id), None) is not None

    def all(self):
        return sorted((k[0], k[1], v) for k, v in self._constraints.items())

    def validate_vertex(self, labels, properties, namer=None) -> None:
        for (label_id, prop_id), type_name in self._constraints.items():
            if label_id in labels and prop_id in properties:
                if not self._CHECKS[type_name](properties[prop_id]):
                    raise ConstraintViolation(
                        f"Type constraint ({type_name}) violated",
                        constraint=("type", label_id, (prop_id,)))


class Constraints:
    def __init__(self) -> None:
        self.existence = ExistenceConstraints()
        self.unique = UniqueConstraints()
        self.type = TypeConstraints()
