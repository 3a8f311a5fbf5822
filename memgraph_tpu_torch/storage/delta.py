"""MVCC delta records: undo operations forming per-object version chains.

Same model as the reference (storage/v2/delta.hpp:244, delta_action.hpp:21-32):
each mutation pushes an *undo* delta at the head of the object's chain, tagged
with the writing transaction's CommitInfo. While the transaction is active the
CommitInfo timestamp is the transaction id (>= TRANSACTION_ID_START); commit
flips it — atomically for every delta of the transaction, since they share the
one CommitInfo object — to the commit timestamp. Readers walk the chain
applying undos until they reach their snapshot.

Copy of memgraph_tpu/storage/delta.py for the port (its imports the port's own).
"""

from __future__ import annotations

import enum
from typing import Any


class CommitInfo:
    """Shared by all deltas of one transaction; timestamp flips on commit."""

    __slots__ = ("timestamp",)

    def __init__(self, txn_or_commit_ts: int) -> None:
        self.timestamp = txn_or_commit_ts


class DeltaAction(enum.Enum):
    # vertex/edge existence (undo directions)
    DELETE_OBJECT = 1      # undo of create: "before this txn, object didn't exist"
    RECREATE_OBJECT = 2    # undo of delete: "before this txn, object existed"
    # vertex state
    ADD_LABEL = 3          # undo of remove_label
    REMOVE_LABEL = 4       # undo of add_label
    SET_PROPERTY = 5       # undo: restore previous value (vertex or edge)
    ADD_IN_EDGE = 6        # undo of remove_in_edge
    ADD_OUT_EDGE = 7       # undo of remove_out_edge
    REMOVE_IN_EDGE = 8     # undo of add_in_edge
    REMOVE_OUT_EDGE = 9    # undo of add_out_edge
    # batch-insert amortization: ONE undo for all adjacency entries a bulk
    # insert appended to a pre-existing vertex (payload: tuple of entries).
    # Keeps hub vertices from growing one delta per spoke during bulk loads.
    REMOVE_IN_EDGES_BULK = 10
    REMOVE_OUT_EDGES_BULK = 11


# actions that only affect the adjacency lists of a materialized state —
# readers that need labels/properties/existence only can skip both copying
# the (possibly huge) adjacency lists and applying these undos
EDGE_ACTIONS = frozenset({
    DeltaAction.ADD_IN_EDGE, DeltaAction.ADD_OUT_EDGE,
    DeltaAction.REMOVE_IN_EDGE, DeltaAction.REMOVE_OUT_EDGE,
    DeltaAction.REMOVE_IN_EDGES_BULK, DeltaAction.REMOVE_OUT_EDGES_BULK,
})


class Delta:
    """One undo record. `payload` depends on action:

    DELETE_OBJECT / RECREATE_OBJECT: None
    ADD_LABEL / REMOVE_LABEL:        label_id (int)
    SET_PROPERTY:                    (property_id, previous_value)
    *_IN_EDGE / *_OUT_EDGE:          (edge_type_id, other_vertex, edge)
    """

    __slots__ = ("action", "payload", "commit_info", "next", "obj")

    def __init__(self, action: DeltaAction, payload: Any,
                 commit_info: CommitInfo, next_delta: "Delta | None",
                 obj: Any) -> None:
        self.action = action
        self.payload = payload
        self.commit_info = commit_info
        self.next = next_delta  # older delta (towards the past)
        self.obj = obj          # owning Vertex/Edge (for abort/GC)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Delta({self.action.name}, ts={self.commit_info.timestamp}, "
                f"payload={self.payload!r})")


def apply_undo(state: "MaterializedState", delta: Delta) -> None:
    """Apply one undo record to a materialized read state."""
    a = delta.action
    if a is DeltaAction.DELETE_OBJECT:
        state.exists = False
    elif a is DeltaAction.RECREATE_OBJECT:
        state.exists = True
        state.deleted = False
    elif a is DeltaAction.ADD_LABEL:
        state.labels.add(delta.payload)
    elif a is DeltaAction.REMOVE_LABEL:
        state.labels.discard(delta.payload)
    elif a is DeltaAction.SET_PROPERTY:
        prop_id, prev = delta.payload
        if prev is None:
            state.properties.pop(prop_id, None)
        else:
            state.properties[prop_id] = prev
    elif a is DeltaAction.ADD_IN_EDGE:
        state.in_edges.append(delta.payload)
    elif a is DeltaAction.REMOVE_IN_EDGE:
        state.in_edges.remove(delta.payload)
    elif a is DeltaAction.ADD_OUT_EDGE:
        state.out_edges.append(delta.payload)
    elif a is DeltaAction.REMOVE_OUT_EDGE:
        state.out_edges.remove(delta.payload)
    elif a is DeltaAction.REMOVE_IN_EDGES_BULK:
        drop = set(delta.payload)
        state.in_edges = [e for e in state.in_edges if e not in drop]
    elif a is DeltaAction.REMOVE_OUT_EDGES_BULK:
        drop = set(delta.payload)
        state.out_edges = [e for e in state.out_edges if e not in drop]
    else:  # pragma: no cover
        raise AssertionError(f"unknown delta action {a}")


class MaterializedState:
    """A reader's reconstructed view of one object at its snapshot."""

    __slots__ = ("exists", "deleted", "labels", "properties", "in_edges",
                 "out_edges")

    def __init__(self, exists=True, deleted=False, labels=None, properties=None,
                 in_edges=None, out_edges=None):
        self.exists = exists
        self.deleted = deleted
        self.labels = labels if labels is not None else set()
        self.properties = properties if properties is not None else {}
        self.in_edges = in_edges if in_edges is not None else []
        self.out_edges = out_edges if out_edges is not None else []
