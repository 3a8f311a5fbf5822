"""MVCC in-memory graph storage engine (host side).

Re-design of the reference storage layer (memgraph/src/storage/v2/):
optimistic MVCC with per-object undo-delta chains, snapshot isolation,
label / label+property indexes, existence/unique constraints, snapshot+WAL
durability — built TPU-first: the storage engine's job is fast point
reads/writes plus cheap export of immutable CSR snapshots to device memory
(see memgraph_tpu.ops.csr).

Copy of memgraph_tpu/storage/__init__.py for the port (its imports the port's own).
"""

from .common import Gid, View, IsolationLevel, StorageMode
from .storage import InMemoryStorage, StorageConfig

__all__ = ["Gid", "View", "IsolationLevel", "StorageMode", "InMemoryStorage",
           "StorageConfig"]
