"""SHOW SCHEMA INFO — live schema document.

Counterpart of memgraph/src/storage/v2/schema_info.cpp: nodes
grouped by their exact label set with per-property counts/type
histograms/filling factors, edges grouped by (type, start labels, end
labels), plus constraints and enums. The reference tracks this
incrementally under a flag; here the document is computed on demand from
the accessor's visible state (always exact, O(V+E) per call — the right
trade for a Python host layer; the columnar/CSR caches already pay the
same sweep).

Output shape matches the reference's ToJson (schema_info_types.hpp:110-,
schema_info.cpp:419-), returned as one row with a `schema` JSON string.

Copy of memgraph_tpu/storage/schema_info.py for the port (its imports the port's own).
"""

from __future__ import annotations

import json


def _type_name(v, storage) -> str:
    from ..utils.point import Point
    from ..utils.temporal import (Date, Duration, LocalDateTime, LocalTime,
                                  ZonedDateTime)
    from .enums import EnumValue
    if v is None:
        return "Null"
    if isinstance(v, bool):
        return "Boolean"
    if isinstance(v, int):
        return "Integer"
    if isinstance(v, float):
        return "Float"
    if isinstance(v, str):
        return "String"
    if isinstance(v, (list, tuple)):
        return "List"
    if isinstance(v, dict):
        return "Map"
    if isinstance(v, Date):
        return "Date"
    if isinstance(v, LocalTime):
        return "LocalTime"
    if isinstance(v, LocalDateTime):
        return "LocalDateTime"
    if isinstance(v, ZonedDateTime):
        return "ZonedDateTime"
    if isinstance(v, Duration):
        return "Duration"
    if isinstance(v, EnumValue):
        return "Enum::" + v.enum_name
    if isinstance(v, Point):
        return "Point3D" if getattr(v, "z", None) is not None else "Point2D"
    if isinstance(v, (bytes, bytearray)):
        return "Bytes"
    return type(v).__name__


def _prop_stats(prop_maps: list[dict], storage, pm) -> list[dict]:
    """Per-property aggregate over a group of objects' property dicts."""
    by_key: dict[str, dict] = {}
    for props in prop_maps:
        for pid, value in props.items():
            key = pm.id_to_name(pid)
            slot = by_key.setdefault(key, {"count": 0, "types": {}})
            slot["count"] += 1
            t = _type_name(value, storage)
            slot["types"][t] = slot["types"].get(t, 0) + 1
    max_count = len(prop_maps) or 1
    out = []
    for key in sorted(by_key):
        slot = by_key[key]
        out.append({
            "key": key,
            "count": slot["count"],
            "filling_factor": 100.0 * slot["count"] / max_count,
            "types": [{"type": t, "count": c}
                      for t, c in sorted(slot["types"].items())],
        })
    return out


def schema_info_json(accessor, view) -> str:
    """Build the full schema document for the accessor's visible state."""
    storage = accessor.storage
    lm, pm = storage.label_mapper, storage.property_mapper
    em = storage.edge_type_mapper

    node_groups: dict[frozenset, list[dict]] = {}
    labels_of_gid: dict[int, tuple] = {}
    for va in accessor.vertices(view):
        labels = frozenset(va.labels(view))
        node_groups.setdefault(labels, []).append(va.properties(view))
        labels_of_gid[va.gid] = tuple(sorted(
            lm.id_to_name(l) for l in labels))

    edge_groups: dict[tuple, list[dict]] = {}
    for ea in accessor.edges(view):
        key = (em.id_to_name(ea.edge_type),
               labels_of_gid.get(ea.from_vertex().gid, ()),
               labels_of_gid.get(ea.to_vertex().gid, ()))
        edge_groups.setdefault(key, []).append(ea.properties(view))

    doc: dict = {"nodes": [], "edges": [], "node_constraints": [],
                 "enums": []}
    for labels in sorted(node_groups, key=lambda s: sorted(
            lm.id_to_name(l) for l in s)):
        group = node_groups[labels]
        doc["nodes"].append({
            "labels": sorted(lm.id_to_name(l) for l in labels),
            "count": len(group),
            "properties": _prop_stats(group, storage, pm),
        })
    for (etype, start, end) in sorted(edge_groups):
        group = edge_groups[(etype, start, end)]
        doc["edges"].append({
            "type": etype,
            "start_node_labels": list(start),
            "end_node_labels": list(end),
            "count": len(group),
            "properties": _prop_stats(group, storage, pm),
        })

    cons = storage.constraints
    for (lid, pid) in cons.existence.all():
        doc["node_constraints"].append({
            "type": "existence", "label": lm.id_to_name(lid),
            "properties": [pm.id_to_name(pid)]})
    for (lid, pids) in cons.unique.all():
        doc["node_constraints"].append({
            "type": "unique", "label": lm.id_to_name(lid),
            "properties": [pm.id_to_name(p) for p in pids]})
    for (lid, pid, type_decl) in cons.type.all():
        doc["node_constraints"].append({
            "type": "data_type", "label": lm.id_to_name(lid),
            "properties": [pm.id_to_name(pid)], "data_type": type_decl})

    from .enums import enum_registry
    for name, values in enum_registry(storage).all().items():
        doc["enums"].append({"name": name, "values": list(values)})

    return json.dumps(doc, sort_keys=False)
