"""The compute half of the procedures, on storage snapshots: the graph
algorithms (``procedures.graph_algorithms``) and the dense paths
(``ml_modules``, ``vector_search``, ``utility_modules``,
``structure_modules``)."""


class ProcedureError(Exception):
    """A procedure's refusal of its call, where the reference raises a
    QueryException or a ProcedureException: the message is the
    reference's."""
