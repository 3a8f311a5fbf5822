"""EXPLAIN plan rendering (reference: query/plan/pretty_print.cpp).

Copy of memgraph_tpu/query/plan/pretty_print.py for the port (its imports the port's own).
"""

from __future__ import annotations

from .operators import LogicalOperator


def _describe(op: LogicalOperator) -> str:
    name = op.name()
    extras = []
    for attr in ("symbol", "label", "properties", "prop", "from_symbol",
                 "to_symbol", "edge_symbol", "direction", "edge_types",
                 "edge_type", "proc_name"):
        v = getattr(op, attr, None)
        if v is None or callable(v):
            continue
        if isinstance(v, (list, tuple)) and not v:
            continue
        if attr == "proc_name" and isinstance(v, str):
            extras.append(v)
        elif isinstance(v, str):
            extras.append(f"{attr}={v}")
        elif isinstance(v, (list, tuple)) and all(isinstance(x, str)
                                                  for x in v):
            extras.append(f"{attr}={'|'.join(v)}")
    if extras:
        return f"{name} ({', '.join(extras)})"
    return name


def plan_to_rows(plan: LogicalOperator) -> list[str]:
    rows: list[str] = []

    def walk(op, depth):
        if op is None:
            return
        rows.append("| " * depth + "* " + _describe(op))
        for child in op.children():
            walk(child, depth + 1)

    walk(plan, 0)
    return rows
