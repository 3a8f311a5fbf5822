"""The compute half of the procedures, on storage snapshots: the graph
algorithms (``procedures.graph_algorithms``), the dense paths
(``ml_modules``, ``vector_search``, ``utility_modules``,
``structure_modules``) and node2vec (``node2vec_module``)."""


class ProcedureError(Exception):
    """A procedure's refusal of its call, where the reference raises a
    QueryException or a ProcedureException: the message is the
    reference's."""
