"""Host helpers: the serving plane's retry policy, device fault points
and their classification, and a metrics registry (copies of what
memgraph_tpu/utils and memgraph_tpu/observability give the reference's
kernel server); the Cypher engine's value types (ids, points, temporal
values) and query memory accounting; and its lock and shared-state
annotations as plain locks and no-ops (``locks``, ``sanitize``)."""
