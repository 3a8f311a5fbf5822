"""openCypher query engine (host side).

Re-design of the reference's query layer (memgraph/src/query/):
hand-written lexer + recursive-descent parser producing an AST (the
reference uses ANTLR — frontend/opencypher/grammar/), symbol analysis,
a rule-based planner with index rewrites (query/plan/), and a Volcano
pull-based executor (query/plan/operator.hpp) — with the analytics regime
delegated to the TPU ops layer through the procedure registry.

Copy of memgraph_tpu/query/__init__.py for the port (its imports the port's own).
"""

from .interpreter import Interpreter, InterpreterContext

__all__ = ["Interpreter", "InterpreterContext"]
