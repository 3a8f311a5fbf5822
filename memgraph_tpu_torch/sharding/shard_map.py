"""Epoch-versioned shard map: shard_id -> owning worker endpoint.

The map is minted by the placement authority (the coordinator's
replicated apply, or its single-process stand-in) and carries ONE
fencing epoch for the whole table: every reassignment bumps it, every
write ack carries the owner's granted epoch, and a client refuses to go
back to an older table — the same monotonic-epoch contract RoutedClient
already enforces for MAIN failover, applied per shard.

Copy of memgraph_tpu/sharding/shard_map.py for the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .partition import shard_for_key

__all__ = ["ShardMap"]


@dataclass(frozen=True)
class ShardMap:
    """Immutable snapshot of shard placement at one fencing epoch."""

    epoch: int
    n_shards: int
    #: shard_id -> owner endpoint name (e.g. "s2g0"; opaque to the map)
    owners: dict = field(default_factory=dict)

    def owner_of(self, shard_id: int) -> str:
        try:
            return self.owners[shard_id]
        except KeyError:
            raise KeyError(f"shard {shard_id} has no owner in the map "
                           f"at epoch {self.epoch}") from None

    def shard_for(self, key) -> int:
        return shard_for_key(key, self.n_shards)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "n_shards": self.n_shards,
                "owners": {str(k): v for k, v in self.owners.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        return cls(epoch=int(d["epoch"]), n_shards=int(d["n_shards"]),
                   owners={int(k): v
                           for k, v in (d.get("owners") or {}).items()})
