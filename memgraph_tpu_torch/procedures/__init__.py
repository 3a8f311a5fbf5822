"""The compute half of the graph-algorithm procedures, on storage
snapshots (``procedures.graph_algorithms``)."""
