"""mgshard: shard-per-process OLTP execution plane.

The Bolt worker pool gives concurrency, not CPU parallelism — the GIL
caps aggregate multi-client OLTP at ~1.2x (OLTP_r05/r06). This package
promotes the mp-executor experiment to the architecture: storage is
hash-sharded across N long-lived worker processes, each owning a full
Storage engine with its own WAL directory and per-shard crash recovery;
a coordinator-minted, epoch-versioned shard map routes every request;
and the client layer does single-shard point routing, scatter-gather
reads with merge, and cross-shard 2PC writes with presumed-abort.

Layout:
    partition.py  stable hash partitioner (key -> shard)
    shard_map.py  epoch-versioned shard_id -> owner map
    worker.py     the shard worker process loop (storage + WAL + 2PC)
    plane.py      ShardPlane: spawn/respawn/kill/move shard workers
    router.py     ShardedClient: routing, scatter-gather merge, 2PC

Copy of memgraph_tpu/sharding/ for the port.  A shard worker runs host
Cypher only: a plan that reaches the device is refused
(``DeviceWorkRefused``, worker.py).
"""

from .partition import shard_for_key, shard_for_gid
from .shard_map import ShardMap
from .plane import ShardPlane, LocalPlacement, CoordinatorPlacement
from .router import ShardedClient, MergeError

__all__ = ["shard_for_key", "shard_for_gid", "ShardMap", "ShardPlane",
           "LocalPlacement", "CoordinatorPlacement", "ShardedClient",
           "MergeError"]
