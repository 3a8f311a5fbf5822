"""The openCypher TCK (tests/tck/features/, 891 scenarios) through the
port's interpreter on the CPU.

The scenarios, their Gherkin parsing and their checks are
tests/tck/runner.py's, used as they are.  The runner's three places that
name the JAX package (``canonicalize``, ``ScenarioRunner.__init__`` and
the procedure registry of ``_register_procedure`` / ``cleanup``) are
given the port's counterparts here: ``PortScenarioRunner`` overrides the
methods, and the module's ``canonicalize`` is patched for each test.
The discipline is tests/test_tck.py's, whose known-failure list is empty:
every scenario passes.  One test a feature file, so that one failure
does not hide the rest.
"""

import os
import re
import signal
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from tck import runner as R  # noqa: E402

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SCENARIO_TIMEOUT_SEC = 30
N_SCENARIOS = 891

SCENARIOS = R.load_all_scenarios()
FEATURES = sorted({s.feature for s in SCENARIOS})


def port_canonicalize(value, storage):
    """``tck.runner.canonicalize`` over the port's value types."""
    from memgraph_tpu_torch.query.values import Path
    from memgraph_tpu_torch.storage.storage import (EdgeAccessor,
                                                    VertexAccessor)

    lm = storage.label_mapper
    pm = storage.property_mapper
    em = storage.edge_type_mapper

    def props_of(d):
        return tuple(sorted((pm.id_to_name(k), canon(v))
                            for k, v in d.items()))

    def canon(v):
        if isinstance(v, VertexAccessor):
            return ("node",
                    frozenset(lm.id_to_name(lb) for lb in v.labels()),
                    props_of(v.properties()))
        if isinstance(v, EdgeAccessor):
            return ("rel", em.id_to_name(v.edge_type),
                    props_of(v.properties()))
        if isinstance(v, Path):
            items = [canon(v.items[0])]
            for k in range(1, len(v.items), 2):
                edge = v.items[k]
                frm = v.items[k - 1]
                to = v.items[k + 1]
                forward = edge.from_vertex().vertex is frm.vertex
                items.append((canon(edge), forward, canon(to)))
            return ("path", tuple(items))
        if isinstance(v, dict):
            return ("map", tuple(sorted((k, canon(x))
                                        for k, x in v.items())))
        if isinstance(v, (list, tuple)):
            return tuple(canon(x) for x in v)
        return v

    return canon(value)


class PortScenarioRunner(R.ScenarioRunner):
    """``tck.runner.ScenarioRunner`` on the port's storage, interpreter
    (``device="cpu"``) and procedure registry."""

    def __init__(self):
        from memgraph_tpu_torch.query.interpreter import (Interpreter,
                                                          InterpreterContext)
        from memgraph_tpu_torch.storage import InMemoryStorage
        self.storage = InMemoryStorage()
        self.ctx = InterpreterContext(self.storage, device="cpu")
        self.interp = Interpreter(self.ctx)
        self.params: dict = {}
        self.columns: list[str] = []
        self.rows: list[list] = []
        self.error: Exception | None = None
        self.snapshot_before: tuple | None = None
        self.executed_query = False
        self._registered_procs: list[str] = []

    def _register_procedure(self, signature: str, table: list[list[str]]):
        from memgraph_tpu_torch.query.procedures.registry import (
            Procedure, global_registry)
        sig = signature.strip().rstrip(":").strip()
        m = re.match(r"([\w.]+)\s*\((.*?)\)\s*::\s*(.*)$", sig)
        if not m:
            raise R.ScenarioFailure(
                f"unparseable procedure signature {sig!r}")
        name, args_s, results_s = m.groups()
        args = []
        for part in filter(None, (p.strip() for p in args_s.split(","))):
            aname, _, atype = part.partition("::")
            args.append((aname.strip(), atype.strip()))
        results = []
        results_s = results_s.strip()
        if results_s not in ("VOID", "()"):
            inner = results_s.strip("()")
            for part in filter(None, (p.strip() for p in inner.split(","))):
                rname, _, rtype = part.partition("::")
                results.append((rname.strip(), rtype.strip()))
        header = table[0] if table and any(table[0]) else \
            [a for a, _ in args] + [r for r, _ in results]
        data = [[R._tck_to_python(R.parse_tck_value(c)) for c in row]
                for row in table[1:]]
        n_args = len(args)

        def func(pctx, *call_args):
            for row in data:
                if list(row[:n_args]) == list(call_args):
                    yield {header[n_args + i]: v
                           for i, v in enumerate(row[n_args:])}

        global_registry.register(Procedure(
            name=name, func=func, args=args, opt_args=[], results=results,
            void=(results_s == "VOID")))
        self._registered_procs.append(name)

    def cleanup(self):
        from memgraph_tpu_torch.query.procedures.registry import \
            global_registry
        for name in self._registered_procs:
            global_registry.unregister(name)
        self._registered_procs = []


def test_the_suite_is_whole():
    assert len(SCENARIOS) == N_SCENARIOS
    assert len({s.id for s in SCENARIOS}) == N_SCENARIOS


@pytest.mark.parametrize("feature", FEATURES)
def test_feature_passes_on_the_port(feature, monkeypatch):
    monkeypatch.setattr(R, "canonicalize", port_canonicalize)
    failures = []
    for s in (s for s in SCENARIOS if s.feature == feature):
        if hasattr(signal, "SIGALRM"):
            signal.alarm(SCENARIO_TIMEOUT_SEC)
        try:
            PortScenarioRunner().run(s)
        except Exception as e:  # noqa: BLE001 — any failure counts
            failures.append(f"{s.name}: {type(e).__name__}: {e}"[:300])
        finally:
            if hasattr(signal, "SIGALRM"):
                signal.alarm(0)
    assert not failures, "\n".join(failures[:20])
