"""Query-module procedure registry (the mgp-equivalent boundary).

Counterpart of the reference's ModuleRegistry + mgp API
(memgraph/src/query/procedure/module.cpp:61,811 and include/mgp.py):
procedures are registered under dotted names ("pagerank.get"), declare
result fields, and stream result records. Python modules register with the
@read_proc / @write_proc decorators (memgraph_tpu_torch.procedures.mgp);
the builtin analytics modules live in memgraph_tpu_torch.procedures.*.

The ProcedureContext handed to implementations exposes the storage accessor
AND the device graph cache — the mgp_graph → CSR snapshot seam.

Port of memgraph_tpu/query/procedures/registry.py.  What differs: a
snapshot is ``ops.csr.GLOBAL_GRAPH_CACHE`` over a ``StorageSource`` of
the accessor (storage/source.py), placed on the interpreter context's
device (``device``; the card when the execution has no context), and
``load_directory`` loads ``.py`` modules only: the loader of native
``.so`` modules comes with a later slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ...utils.locks import fork_safe


@dataclass
class Procedure:
    name: str                              # full dotted name
    func: Callable                         # (ProcedureContext, *args) -> iter
    args: list[tuple[str, str]]            # (name, type hint)
    opt_args: list[tuple[str, str, object]]
    results: list[tuple[str, str]]         # (field, type hint)
    is_write: bool = False
    # VOID procs run for their side effects and pass the input row through;
    # a proc declared ':: ()' instead yields an empty record stream
    # (openCypher TCK distinction, ProcedureCallAcceptance)
    void: bool = False

    def call(self, exec_ctx, args: list) -> Iterable[dict]:
        pctx = ProcedureContext(exec_ctx)
        return self.func(pctx, *args)


class ProcedureContext:
    """What a procedure sees: graph access + device snapshot export."""

    def __init__(self, exec_ctx) -> None:
        self.exec_ctx = exec_ctx
        self.accessor = exec_ctx.accessor
        self.storage = exec_ctx.accessor.storage
        self.view = exec_ctx.view

    @property
    def device(self):
        """Where snapshots are placed and procedures run: the interpreter
        context's device, else the card."""
        from ...device import resolve_device
        ictx = getattr(self.exec_ctx, "interpreter_context", None)
        return resolve_device(getattr(ictx, "device", None))

    def source(self):
        """The snapshot source of this call's accessor (storage/
        source.py): what the port's procedures read."""
        from ...storage.source import StorageSource
        return StorageSource(self.accessor)

    def device_graph(self, weight_property: Optional[str] = None,
                     label: Optional[str] = None,
                     edge_types: Optional[list[str]] = None):
        """Export (or fetch cached) CSR DeviceGraph for the current graph."""
        from ...ops.csr import GLOBAL_GRAPH_CACHE
        wp = None
        if weight_property is not None:
            wp = self.storage.property_mapper.maybe_name_to_id(weight_property)
        lf = None
        if label is not None:
            lf = self.storage.label_mapper.maybe_name_to_id(label)
        etf = None
        if edge_types:
            etf = {self.storage.edge_type_mapper.maybe_name_to_id(t)
                   for t in edge_types}
            etf.discard(None)
        return GLOBAL_GRAPH_CACHE.get(self.source(), weight_property=wp,
                                      label_filter=lf, edge_type_filter=etf,
                                      device=self.device)

    def vertex_by_index(self, graph, idx: int):
        """Dense device index -> VertexAccessor."""
        gid = int(graph.node_gids[idx])
        return self.accessor.find_vertex(gid, self.view)

    def vertices_by_indices(self, graph, indices):
        return [self.vertex_by_index(graph, int(i)) for i in indices]


class ProcedureRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._procedures: dict[str, Procedure] = {}
        self._loaded_builtin = False

    def register(self, proc: Procedure) -> None:
        with self._lock:
            self._procedures[proc.name.lower()] = proc

    def unregister(self, name: str) -> None:
        with self._lock:
            self._procedures.pop(name.lower(), None)

    def find(self, name: str) -> Optional[Procedure]:
        self._ensure_builtin()
        proc = self._procedures.get(name.lower())
        if proc is None:
            target = getattr(self, "_aliases", {}).get(name.lower())
            if target:
                proc = self._procedures.get(target.lower())
        return proc

    def load_callable_mappings(self, path: str) -> int:
        """JSON {alias: canonical-procedure-name} — lets Neo4j-style
        CALL names resolve to local implementations (reference:
        --query-callable-mappings-path)."""
        import json
        with open(path, encoding="utf-8") as f:
            mappings = json.load(f)
        if not isinstance(mappings, dict):
            raise ValueError("callable mappings must be a JSON object")
        with self._lock:
            aliases = getattr(self, "_aliases", None)
            if aliases is None:
                aliases = self._aliases = {}
            for alias, target in mappings.items():
                aliases[str(alias).lower()] = str(target)
        return len(mappings)

    def all_procedures(self) -> list[Procedure]:
        self._ensure_builtin()
        return sorted(self._procedures.values(), key=lambda p: p.name)

    def _ensure_builtin(self) -> None:
        if self._loaded_builtin:
            return
        with self._lock:
            if self._loaded_builtin:
                return
            self._loaded_builtin = True
        # import for side effect: modules register their procedures
        from ...procedures import load_builtin_modules
        load_builtin_modules()

    def load_directory(self, path: str) -> list[str]:
        """Load user query modules (*.py) from a directory (the
        reference's module dir scan, module.cpp:811); a native *.so
        module raises until its loader is ported."""
        import importlib.util
        import os
        loaded = []
        if not os.path.isdir(path):
            return loaded
        for fname in sorted(os.listdir(path)):
            full = os.path.join(path, fname)
            if fname.endswith(".py") and not fname.startswith("_"):
                mod_name = fname[:-3]
                spec = importlib.util.spec_from_file_location(
                    f"mg_user_module_{mod_name}", full)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                loaded.append(mod_name)
            elif fname.endswith(".so"):
                from ...exceptions import (SLICE_HOST_FEATURES,
                                           NotPortedException)
                raise NotPortedException(f"native query module {fname}",
                                         SLICE_HOST_FEATURES)
        return loaded


global_registry = fork_safe(ProcedureRegistry())
