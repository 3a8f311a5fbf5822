"""The compute half of the procedures, on storage snapshots: the graph
algorithms (``procedures.graph_algorithms``), the dense paths
(``ml_modules``, ``vector_search``, ``utility_modules``,
``structure_modules``), node2vec (``node2vec_module``), the temporal
graph network (``tgn_module``) and text embeddings
(``embeddings_module``).

``load_builtin_modules`` registers the Cypher procedures ported so far
(``CALL module.proc()``, through ``mgp``): the graph algorithms'.  The
other modules' registrations come with a later slice."""

_LOADED = False


def load_builtin_modules() -> None:
    """Register the builtin procedures with the query registry (once)."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import graph_algorithms  # noqa: F401 — registers on import


class ProcedureError(Exception):
    """A procedure's refusal of its call, where the reference raises a
    QueryException or a ProcedureException: the message is the
    reference's."""
