"""Device operators of the port; module names mirror memgraph_tpu/ops."""
