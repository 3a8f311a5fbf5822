"""The compute half of the procedures, on storage snapshots: the graph
algorithms (``procedures.graph_algorithms``), the dense paths
(``ml_modules``, ``vector_search``, ``utility_modules``,
``structure_modules``), node2vec (``node2vec_module``), the temporal
graph network (``tgn_module``) and text embeddings
(``embeddings_module``)."""


class ProcedureError(Exception):
    """A procedure's refusal of its call, where the reference raises a
    QueryException or a ProcedureException: the message is the
    reference's."""
