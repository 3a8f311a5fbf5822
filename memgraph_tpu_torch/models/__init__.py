"""Models trained by the port; module names mirror memgraph_tpu/models."""
