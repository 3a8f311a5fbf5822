"""Module-author API: decorators for registering procedures.

Counterpart of the reference's include/mgp.py decorator surface
(@mgp.read_proc / @mgp.write_proc): a procedure declares its result fields
and receives a ProcedureContext as first argument. Registration happens at
import time into the global registry.

    from memgraph_tpu_torch.procedures import mgp

    @mgp.read_proc("my_module.my_proc",
                   args=[("limit", "INTEGER")],
                   results=[("node", "NODE"), ("score", "FLOAT")])
    def my_proc(ctx, limit=10):
        graph = ctx.device_graph()
        ...
        yield {"node": ctx.vertex_by_index(graph, 0), "score": 1.0}

Copy of memgraph_tpu/procedures/mgp.py for the port (its imports the port's own).
"""

from __future__ import annotations

from ..query.procedures.registry import Procedure, global_registry


def read_proc(name: str, args=None, opt_args=None, results=None):
    def deco(fn):
        global_registry.register(Procedure(
            name=name, func=fn, args=args or [], opt_args=opt_args or [],
            results=results or [], is_write=False))
        return fn
    return deco


def write_proc(name: str, args=None, opt_args=None, results=None):
    def deco(fn):
        global_registry.register(Procedure(
            name=name, func=fn, args=args or [], opt_args=opt_args or [],
            results=results or [], is_write=True))
        return fn
    return deco
