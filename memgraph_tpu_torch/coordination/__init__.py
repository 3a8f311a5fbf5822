"""High-availability coordination: Raft consensus + automatic failover.

Counterpart of the reference's coordinator layer
(memgraph/src/coordination/ — RaftState over NuRaft at
raft_state.cpp:370, health-checked failover at
coordinator_instance.cpp:478-585). The environment has no Raft library, so
raft.py is a from-scratch implementation of the Raft protocol (elections,
log replication, commit on majority) sized for the control plane: the
replicated state machine holds the cluster topology (which data instance is
MAIN), not data — the data plane stays WAL-frame replication.

Copy of memgraph_tpu/coordination/ for the port.
"""

from .raft import RaftNode
from .coordinator import CoordinatorInstance

__all__ = ["RaftNode", "CoordinatorInstance"]
