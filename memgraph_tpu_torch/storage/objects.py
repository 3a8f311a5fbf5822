"""In-memory vertex and edge records.

The reference packs Vertex into 80 bytes with small_vectors and a tagged delta
pointer (storage/v2/vertex.hpp:32-73). In the Python host layer we keep the
same *shape* — gid, labels, properties, adjacency, delta head, per-object
lock — with __slots__ for density. Adjacency entries are
(edge_type_id, other_vertex, edge) triples, mirroring the reference's
(EdgeType, Vertex*, EdgeRef) tuples so edge objects are only touched when
edge properties are needed.

Copy of memgraph_tpu/storage/objects.py for the port (its imports the port's own).
"""

from __future__ import annotations

import threading
from typing import Optional

from .delta import Delta


# in/out degree at which a per-vertex adjacency map (neighbor gid -> entry
# list) is built lazily, making bound-endpoint edge lookups — the MERGE
# existence probe — O(1) instead of O(degree) on supernode hubs
ADJ_INDEX_THRESHOLD = 64


class Vertex:
    __slots__ = ("gid", "labels", "properties", "in_edges", "out_edges",
                 "deleted", "delta", "lock", "adj_in", "adj_out")

    def __init__(self, gid: int, delta: Optional[Delta] = None) -> None:
        self.gid = gid
        self.labels: set[int] = set()
        self.properties: dict[int, object] = {}
        # entries: (edge_type_id, other_vertex, edge)
        self.in_edges: list[tuple] = []
        self.out_edges: list[tuple] = []
        self.deleted = False
        self.delta = delta
        self.lock = threading.Lock()
        # lazy supernode adjacency maps: other_gid -> [entry, ...].
        # None = not built; kept exactly in sync with in_edges/out_edges by
        # every path that mutates those lists (or invalidated back to None).
        self.adj_in: Optional[dict] = None
        self.adj_out: Optional[dict] = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Vertex(gid={self.gid}, labels={self.labels}, deleted={self.deleted})"


def adj_map_add(vertex: "Vertex", side: str, entry: tuple) -> None:
    """Mirror an adjacency-list append into the vertex's lazy adjacency map
    (no-op while the map is unbuilt). Caller holds vertex.lock."""
    adj = vertex.adj_in if side == "in" else vertex.adj_out
    if adj is not None:
        adj.setdefault(entry[1].gid, []).append(entry)


def adj_map_remove(vertex: "Vertex", side: str, entry: tuple) -> None:
    """Mirror an adjacency-list removal. Caller holds vertex.lock."""
    adj = vertex.adj_in if side == "in" else vertex.adj_out
    if adj is None:
        return
    bucket = adj.get(entry[1].gid)
    if bucket is None:
        return
    try:
        bucket.remove(entry)
    except ValueError:
        pass
    if not bucket:
        del adj[entry[1].gid]


def adj_map_build(vertex: "Vertex", side: str) -> dict:
    """Build (and install) the adjacency map from the live adjacency list.
    Caller holds vertex.lock."""
    adj: dict = {}
    entries = vertex.in_edges if side == "in" else vertex.out_edges
    for entry in entries:
        adj.setdefault(entry[1].gid, []).append(entry)
    if side == "in":
        vertex.adj_in = adj
    else:
        vertex.adj_out = adj
    return adj


class Edge:
    __slots__ = ("gid", "edge_type", "from_vertex", "to_vertex", "properties",
                 "deleted", "delta", "lock")

    def __init__(self, gid: int, edge_type: int, from_vertex: Vertex,
                 to_vertex: Vertex, delta: Optional[Delta] = None) -> None:
        self.gid = gid
        self.edge_type = edge_type
        self.from_vertex = from_vertex
        self.to_vertex = to_vertex
        self.properties: dict[int, object] = {}
        self.deleted = False
        self.delta = delta
        self.lock = threading.Lock()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Edge(gid={self.gid}, type={self.edge_type}, "
                f"{self.from_vertex.gid}->{self.to_vertex.gid})")
