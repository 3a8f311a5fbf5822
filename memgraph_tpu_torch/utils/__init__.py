"""Host helpers of the port's serving plane: the retry policy, the
device fault points and their classification, and a metrics registry
(copies of what memgraph_tpu/utils and memgraph_tpu/observability give
the reference's kernel server)."""
