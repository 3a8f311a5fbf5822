"""Bulk-write fast lane: plan rewrite routing batchable write shapes
through storage.batch_insert().

Detects a chain of CreateNode/CreateExpand operators at the ROOT of a
write-only plan — the shapes `UNWIND … CREATE`, multi-row `CREATE`,
`LOAD CSV/JSONL/PARQUET … CREATE`, and `MATCH … CREATE` edge loads — and
replaces it with one BatchCreateGraph operator (operators.py) that turns
N per-row operator pulls into one amortized storage batch.

Safety rules (each falls back to the unmodified per-row plan):
  * only at the plan root of a write-only query (no downstream consumer
    observes the created accessors, no RETURN/WITH columns exist);
  * the source subtree is read-only, and if it reads the graph (scans /
    expands) it must sit behind the Eager barrier the planner inserts on
    read→write clause transitions — so deferring all creates to the end
    of the input stream is unobservable;
  * no property expression references an entity created by the same
    chain (`CREATE (a {x:1}) CREATE (b {y:a.x})` keeps the row path).

Reference analog: the reference batches commits at the storage layer
(storage/v2/inmemory/storage.cpp) and dedicates an operator to LOAD CSV;
GraphBLAST (arxiv 1908.01407) and PCPM (arxiv 1709.07122) make the same
argument for amortizing per-element overhead into batch operations.

Copy of memgraph_tpu/query/plan/bulk.py for the port (its imports the port's own).
"""

from __future__ import annotations

import os

from ..frontend import ast as A
from . import operators as Op

# ops that may appear anywhere in a fast-lane source subtree
_PLAIN_SOURCES = (Op.Once, Op.Unwind, Op.Filter, Op.Eager, Op.LoadCsvOp,
                  Op.LoadJsonlOp, Op.LoadParquetOp)
# graph-reading ops additionally allowed when the source root is an Eager
# barrier (the planner's read→write fence)
_GRAPH_READERS = (Op.ScanAll, Op.ScanAllByLabel,
                  Op.ScanAllByLabelPropertyValue,
                  Op.ScanAllByLabelPropertyRange, Op.ScanAllById,
                  Op.Expand, Op.ExpandVariable)


def bulk_rewrite(plan, storage, config=None):
    """Replace a root CreateNode/CreateExpand chain with BatchCreateGraph.

    Called from Planner.plan_query for write-only, union-free,
    non-periodic-commit plans only.
    """
    if config is not None and not config.get("bulk_fast_lane", True):
        return plan
    if os.environ.get("MEMGRAPH_TPU_DISABLE_BULK"):
        return plan
    if not getattr(storage, "supports_batch_insert", False):
        return plan

    chain = []
    node = plan
    while isinstance(node, (Op.CreateNode, Op.CreateExpand)):
        chain.append(node)
        node = node.input
    if not chain:
        return plan
    source = node
    if not _source_ok(source):
        return plan

    chain.reverse()  # bottom-up = per-row execution order
    steps: list = []
    created: set[str] = set()
    for op in chain:
        if isinstance(op, Op.CreateNode):
            if _props_reference(op.properties, created):
                return plan
            steps.append(Op.BatchNodeStep(op.symbol, op.labels,
                                          op.properties))
            created.add(op.symbol)
        else:
            if op.create_to_node:
                if _props_reference(op.to_properties, created):
                    return plan
                steps.append(Op.BatchNodeStep(op.to_symbol, op.to_labels,
                                              op.to_properties))
                created.add(op.to_symbol)
            if _props_reference(op.edge_properties, created):
                return plan
            steps.append(Op.BatchEdgeStep(op.from_symbol, op.edge_symbol,
                                          op.to_symbol, op.direction,
                                          op.edge_type, op.edge_properties))
            created.add(op.edge_symbol)
    pipeline_base = pipeline = None
    inner = source.input if isinstance(source, Op.Eager) else source
    folded = _fold_pipeline(inner)
    if folded is not None:
        pipeline_base, pipeline = folded
    return Op.BatchCreateGraph(source, steps, pipeline_base, pipeline)


def _fold_pipeline(op):
    """Fold an UNWIND / equality-index-scan pipeline over a simple base
    into inline stage descriptors, or None when the shape doesn't match.
    Returns (base_operator, stages bottom-up)."""
    stages: list = []
    node = op
    while True:
        if isinstance(node, Op.Unwind):
            stages.append(("unwind", node.expr, node.symbol))
        elif isinstance(node, Op.ScanAllByLabelPropertyValue):
            stages.append(("scan", node.symbol, node.label,
                           list(node.properties), list(node.value_exprs)))
        elif isinstance(node, (Op.Once, Op.LoadCsvOp, Op.LoadJsonlOp,
                               Op.LoadParquetOp)):
            stages.reverse()
            return node, stages
        else:
            return None
        node = node.input


def _source_ok(source) -> bool:
    reads_graph = False

    def walk(op) -> bool:
        nonlocal reads_graph
        if op is None:
            return True
        if isinstance(op, _GRAPH_READERS):
            reads_graph = True
        elif not isinstance(op, _PLAIN_SOURCES):
            return False
        return all(walk(child) for child in op.children())

    if not walk(source):
        return False
    return not reads_graph or isinstance(source, Op.Eager)


def _props_reference(properties, names: set) -> bool:
    """True when a property map's expressions reference any of `names`
    (symbols bound by earlier creates of the same chain — the batch path
    evaluates property maps before any object exists)."""
    if not names or properties is None:
        return False
    if isinstance(properties, A.Parameter):
        return False
    exprs = properties.values() if isinstance(properties, dict) \
        else [properties]
    from .operators import _expr_references
    return any(_expr_references(e, names) for e in exprs)
