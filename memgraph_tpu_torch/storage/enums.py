"""Cypher enum types.

Counterpart of the reference's enum support (storage/v2/enum_store.hpp;
grammar MemgraphCypher.g4 createEnumQuery/alterEnumAddValueQuery —
CREATE ENUM Name VALUES { A, B }, ALTER ENUM Name ADD VALUE C, literals
Name::Value): definitions live on the storage; values are small immutable
(enum, value) pairs ordered by their declaration position.

Copy of memgraph_tpu/storage/enums.py for the port (its imports the port's own).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from functools import total_ordering

from ..exceptions import QueryException


@total_ordering
@dataclass(frozen=True)
class EnumValue:
    enum_name: str
    value_name: str
    position: int = 0

    def __eq__(self, other):
        return (isinstance(other, EnumValue)
                and other.enum_name == self.enum_name
                and other.value_name == self.value_name)

    def __lt__(self, other):
        if not isinstance(other, EnumValue) or \
                other.enum_name != self.enum_name:
            return NotImplemented
        return self.position < other.position

    def __hash__(self):
        return hash((self.enum_name, self.value_name))

    def __str__(self):
        return f"{self.enum_name}::{self.value_name}"


class EnumRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._enums: dict[str, list[str]] = {}

    def create(self, name: str, values: list[str]) -> None:
        with self._lock:
            if name in self._enums:
                raise QueryException(f"enum {name!r} already exists")
            if len(set(values)) != len(values):
                raise QueryException("enum values must be unique")
            self._enums[name] = list(values)

    def add_value(self, name: str, value: str) -> None:
        with self._lock:
            if name not in self._enums:
                raise QueryException(f"enum {name!r} does not exist")
            if value in self._enums[name]:
                raise QueryException(
                    f"enum {name!r} already has value {value!r}")
            self._enums[name].append(value)

    def value(self, name: str, value_name: str) -> EnumValue:
        with self._lock:
            values = self._enums.get(name)
            if values is None:
                raise QueryException(f"enum {name!r} does not exist")
            try:
                pos = values.index(value_name)
            except ValueError:
                raise QueryException(
                    f"enum {name!r} has no value {value_name!r}") from None
            return EnumValue(name, value_name, pos)

    def all(self) -> dict[str, list[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._enums.items()}

    def to_list(self):
        return sorted(self.all().items())

    def load(self, items) -> None:
        with self._lock:
            self._enums = {k: list(v) for k, v in items}


def enum_registry(storage) -> EnumRegistry:
    reg = getattr(storage, "_enum_registry", None)
    if reg is None:
        reg = storage._enum_registry = EnumRegistry()
    return reg
