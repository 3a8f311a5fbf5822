"""MVCC visibility and write-ownership rules.

Semantics follow the reference's ApplyDeltasForRead / PrepareForWrite
(storage/v2/mvcc.hpp:33-140) re-expressed over the Python delta model:

Read at snapshot S (transaction T):
  start from the object's *current* state, then walk the delta (undo) chain
  newest-first, applying each undo whose writer is invisible to T:
    - writer is another still-active transaction (ts >= TRANSACTION_ID_START,
      ts != T.id), or
    - writer committed after S (ts > S), or
    - writer is T itself but the reader asked for View.OLD.
  Stop at the first visible delta (chain is ordered newest→oldest, so
  once a writer is visible all older ones are too).

Write by T:
  the head delta must be either absent, written by T itself, or committed at
  or before T.start_ts; otherwise a concurrent writer owns the object →
  SerializationError (optimistic, first-writer-wins).

Copy of memgraph_tpu/storage/mvcc.py for the port (its imports the port's own).
"""

from __future__ import annotations

from ..exceptions import SerializationError
from .common import TRANSACTION_ID_START, View
from .delta import (EDGE_ACTIONS, CommitInfo, Delta, DeltaAction,
                    MaterializedState, apply_undo)
from .objects import Edge, Vertex


def _writer_invisible(ts: int, txn_id: int, start_ts: int, view: View) -> bool:
    if ts >= TRANSACTION_ID_START:
        if ts == txn_id:
            return view is View.OLD  # own write: visible only under NEW
        return True                  # other active txn: never visible
    return ts > start_ts             # committed after our snapshot


def state_is_current(obj: Vertex | Edge, txn, view: View) -> bool:
    """True when `txn`'s view of `obj` equals its live fields: the undo walk
    stops at the first visible delta, so a visible (or absent) chain head
    means no undo applies. Caller should hold obj.lock for an atomic answer.
    """
    delta = obj.delta
    if delta is None:
        return True
    ts = delta.commit_info.timestamp
    return not _writer_invisible(ts, txn.id, txn.effective_start_ts(), view)


def materialize_vertex(vertex: Vertex, txn, view: View,
                       need_edges: bool = True) -> MaterializedState:
    """Reconstruct `vertex` as seen by `txn` under `view`.

    need_edges=False skips copying the adjacency lists AND applying edge
    undos — labels/properties/existence readers on supernode hubs must not
    pay an O(degree) list copy per property access (round-5 write-path
    profile: this copy dominated hub UNWIND SET).
    """
    with vertex.lock:
        state = MaterializedState(
            exists=True,
            deleted=vertex.deleted,
            labels=set(vertex.labels),
            properties=dict(vertex.properties),
            in_edges=list(vertex.in_edges) if need_edges else [],
            out_edges=list(vertex.out_edges) if need_edges else [],
        )
        delta = vertex.delta
    _walk(delta, state, txn, view, apply_edges=need_edges)
    return state


def materialize_edge(edge: Edge, txn, view: View) -> MaterializedState:
    with edge.lock:
        state = MaterializedState(
            exists=True,
            deleted=edge.deleted,
            properties=dict(edge.properties),
        )
        delta = edge.delta
    _walk(delta, state, txn, view)
    return state


def _walk(delta: Delta | None, state: MaterializedState, txn, view: View,
          apply_edges: bool = True) -> None:
    start_ts = txn.effective_start_ts()
    txn_id = txn.id
    while delta is not None:
        ts = delta.commit_info.timestamp
        if not _writer_invisible(ts, txn_id, start_ts, view):
            break
        if apply_edges or delta.action not in EDGE_ACTIONS:
            apply_undo(state, delta)
        delta = delta.next
    # Callers treat visibility as `state.exists and not state.deleted`;
    # the flags stay separate so accessors can distinguish "never existed at
    # this snapshot" from "deleted" (different client-facing errors).


def prepare_for_write(obj: Vertex | Edge, txn) -> None:
    """Assert `txn` may mutate `obj`; raise SerializationError otherwise.

    Caller must hold obj.lock.
    """
    delta = obj.delta
    if delta is None:
        return
    ts = delta.commit_info.timestamp
    if ts == txn.id:
        return
    if ts >= TRANSACTION_ID_START:
        raise SerializationError(
            "Cannot serialize due to concurrent write (object owned by an "
            "active transaction). Retry the transaction.")
    if ts > txn.start_ts:
        raise SerializationError(
            "Cannot serialize: object modified by a transaction committed "
            "after this transaction started. Retry the transaction.")


def push_delta(obj: Vertex | Edge, txn, action: DeltaAction, payload) -> Delta:
    """Create an undo delta at the head of obj's chain and register it with txn.

    Caller must hold obj.lock and have called prepare_for_write.
    """
    delta = Delta(action, payload, txn.commit_info, obj.delta, obj)
    obj.delta = delta
    txn.deltas.append(delta)
    return delta

