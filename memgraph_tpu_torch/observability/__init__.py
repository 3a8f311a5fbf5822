"""Spans (``trace``) and device-stage extents, query statistics and the
saturation plane (``stats``): port of memgraph_tpu/observability's
trace.py and stats.py."""
