"""Anchored pattern matching for pattern predicates (exists(...)).

Builds a throwaway subplan for the pattern with already-bound frame symbols
as anchors, and streams matches. Used by Evaluator._eval_PatternExpr.

Copy of memgraph_tpu/query/plan/pattern_match.py for the port (its imports the port's own).
"""

from __future__ import annotations

from ..frontend import ast as A


def match_pattern_anchored(eval_ctx, pattern: A.Pattern, frame: dict):
    from .operators import Argument, ExecutionContext
    from .planner import Planner
    import copy

    storage = eval_ctx.storage
    planner = Planner(storage)
    bound = {k for k, v in frame.items()
             if not k.startswith("__") and v is not None}
    pattern = copy.deepcopy(pattern)
    plan = planner.plan_pattern(pattern, Argument(), set(bound), [], [])

    ctx = ExecutionContext(eval_ctx.accessor, eval_ctx.parameters,
                           eval_ctx.view)
    ctx._argument_frame = {k: v for k, v in frame.items()
                           if not k.startswith("__")}
    yield from plan.cursor(ctx)
