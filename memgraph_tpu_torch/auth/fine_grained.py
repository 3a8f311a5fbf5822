"""Storage-level fine-grained (label-based) access filtering.

The id-space adapter between the name-keyed FineGrainedChecker
(auth.auth.FineGrainedChecker, reference src/auth/models.cpp) and the
storage accessors, which deal in interned label/edge-type ids. Levels:
NOTHING(0) < READ(1) < UPDATE(2) < CREATE_DELETE(3).

Attached to an Accessor as `accessor.fine_grained`; the accessor consults
it on every read (scan, expansion) and write (label/property mutation,
create/delete) — the single choke point both engines (in-memory and disk)
share, the same role the reference's FineGrainedAuthChecker plays inside
its operators.

Copy of memgraph_tpu/auth/fine_grained.py for the port.
"""

from __future__ import annotations

from ..exceptions import AuthException

READ, UPDATE, CREATE_DELETE = 1, 2, 3


class FgStorageView:
    def __init__(self, checker, storage) -> None:
        self._checker = checker
        self._label_mapper = storage.label_mapper
        self._edge_type_mapper = storage.edge_type_mapper
        self._label_cache: dict[int, int] = {}
        self._etype_cache: dict[int, int] = {}

    def label_level(self, label_id: int) -> int:
        lv = self._label_cache.get(label_id)
        if lv is None:
            lv = self._checker.label_level(
                self._label_mapper.id_to_name(label_id))
            self._label_cache[label_id] = lv
        return lv

    def edge_type_level(self, edge_type_id: int) -> int:
        lv = self._etype_cache.get(edge_type_id)
        if lv is None:
            lv = self._checker.edge_type_level(
                self._edge_type_mapper.id_to_name(edge_type_id))
            self._etype_cache[edge_type_id] = lv
        return lv

    def vertex_level(self, label_ids) -> int:
        level = 3
        for lid in label_ids:
            level = min(level, self.label_level(lid))
        return level

    # --- read filters -------------------------------------------------

    def can_read_vertex(self, label_ids) -> bool:
        return self.vertex_level(label_ids) >= READ

    def can_read_edge(self, edge_type_id: int) -> bool:
        return self.edge_type_level(edge_type_id) >= READ

    # --- write gates (raise on violation) -----------------------------

    def check_label_modify(self, label_id: int) -> None:
        if self.label_level(label_id) < CREATE_DELETE:
            raise AuthException(
                "not allowed to create/delete label "
                f":{self._label_mapper.id_to_name(label_id)}")

    def check_vertex_update(self, label_ids) -> None:
        if self.vertex_level(label_ids) < UPDATE:
            raise AuthException(
                "not allowed to update vertices with these labels")

    def check_vertex_delete(self, label_ids) -> None:
        if self.vertex_level(label_ids) < CREATE_DELETE:
            raise AuthException(
                "not allowed to delete vertices with these labels")

    def check_edge_create_delete(self, edge_type_id: int) -> None:
        if self.edge_type_level(edge_type_id) < CREATE_DELETE:
            raise AuthException(
                "not allowed to create/delete edges of type "
                f":{self._edge_type_mapper.id_to_name(edge_type_id)}")

    def check_edge_update(self, edge_type_id: int) -> None:
        if self.edge_type_level(edge_type_id) < UPDATE:
            raise AuthException(
                "not allowed to update edges of type "
                f":{self._edge_type_mapper.id_to_name(edge_type_id)}")
