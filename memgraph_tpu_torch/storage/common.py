"""Shared storage enums and id types.

Capability map: View/IsolationLevel/StorageMode mirror the reference's
storage/v2/{view.hpp,isolation_level.hpp,storage_mode.hpp} semantics.

Copy of memgraph_tpu/storage/common.py for the port (its imports the port's own).
"""

from __future__ import annotations

import enum

# Transaction ids live far above commit timestamps so a single integer field
# can say "uncommitted, owned by txn X" vs "committed at T". Same trick as the
# reference's kTransactionInitialId (storage/v2/transaction.hpp).
TRANSACTION_ID_START = 1 << 62

Gid = int  # global ids are dense non-negative ints, assigned per object kind


class View(enum.Enum):
    """Which state a reader wants within a transaction."""
    OLD = 0   # state at transaction start (ignores own uncommitted changes)
    NEW = 1   # state including own uncommitted changes


class IsolationLevel(enum.Enum):
    SNAPSHOT_ISOLATION = "SNAPSHOT_ISOLATION"
    READ_COMMITTED = "READ_COMMITTED"
    READ_UNCOMMITTED = "READ_UNCOMMITTED"


class StorageMode(enum.Enum):
    IN_MEMORY_TRANSACTIONAL = "IN_MEMORY_TRANSACTIONAL"
    IN_MEMORY_ANALYTICAL = "IN_MEMORY_ANALYTICAL"
    ON_DISK_TRANSACTIONAL = "ON_DISK_TRANSACTIONAL"
