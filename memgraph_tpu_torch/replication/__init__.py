"""Replication: the MAIN side (main_role.py), the replica side
(replica.py) and their wire (protocol.py).  Copy of
memgraph_tpu/replication/ for the port."""
