"""Name <-> id interning for labels, edge types, and property names.

The reference interns all label/property/edge-type strings to small integer
ids (NameIdMapper, memgraph/src/storage/v2/name_id_mapper.hpp) so hot
paths compare ints. The TPU build needs the same ids as the bridge to device
arrays: label ids become rows of label one-hot/segment arrays, property ids
index columnar property exports.

Copy of memgraph_tpu/utils/ids.py for the port (its imports the port's own).
"""

from __future__ import annotations

import threading


class NameIdMapper:
    """Thread-safe bidirectional string<->int interning map.

    Ids are dense, starting at 0, never reused. Safe for concurrent readers
    with occasional writers.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._name_to_id: dict[str, int] = {}
        self._id_to_name: list[str] = []

    def name_to_id(self, name: str) -> int:
        """Intern `name`, returning its id (allocating if unseen)."""
        existing = self._name_to_id.get(name)
        if existing is not None:
            return existing
        with self._lock:
            existing = self._name_to_id.get(name)
            if existing is not None:
                return existing
            new_id = len(self._id_to_name)
            self._id_to_name.append(name)
            self._name_to_id[name] = new_id
            return new_id

    def id_to_name(self, id_: int) -> str:
        return self._id_to_name[id_]

    def has_name(self, name: str) -> bool:
        return name in self._name_to_id

    def maybe_name_to_id(self, name: str) -> int | None:
        return self._name_to_id.get(name)

    def to_dict(self) -> dict[str, int]:
        """Snapshot for persistence (disk mode metadata)."""
        with self._lock:
            return dict(self._name_to_id)

    def load_dict(self, mapping: dict[str, int]) -> None:
        """Restore from a to_dict() snapshot (ids must be dense from 0)."""
        with self._lock:
            items = sorted(mapping.items(), key=lambda kv: kv[1])
            self._id_to_name = [name for name, _ in items]
            self._name_to_id = dict(mapping)

    def __len__(self) -> int:
        return len(self._id_to_name)

    def all_names(self) -> list[str]:
        return list(self._id_to_name)

    # --- durability ---------------------------------------------------------

    def to_list(self) -> list[str]:
        return list(self._id_to_name)

    @classmethod
    def from_list(cls, names: list[str]) -> "NameIdMapper":
        m = cls()
        m._id_to_name = list(names)
        m._name_to_id = {n: i for i, n in enumerate(names)}
        return m
