"""The port's MXU-plan cache in ``ops/pagerank.py``: per-graph build locks
and the MEMGRAPH_TPU_ROUTE_DTYPE variable, against the JAX package.

Locks: the reference (``memgraph_tpu/ops/pagerank.py:_pagerank_via_mxu``)
gives each graph its own build lock, so unrelated graphs build their
plans at once and one graph builds its plan once.  ``spmv_mxu.build_plan``
is stubbed by one that waits on a barrier (two graphs) or counts its calls
(one graph) before it builds the real plan.

Route dtype: the reference's f32 PageRank leaves the route dtype to the
variable (``bf16`` routes bf16); its bf16 PageRank asks for bf16.  The
port's f32 run under the variable is compared bit for bit with its bf16
run on a twin graph, and with the JAX package's f32 run under the same
variable within ``PRECISION_BOUNDS["bf16"]`` (both round each contribution
to bf16, at places that differ between the frameworks).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops import spmv_mxu
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9       # f32 against f32, as tests/test_torch_pagerank


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), (rng.random(e) ** 2 * n).astype(np.int64)


def _graph(seed, n=300, e=2000):
    src, dst = _edges(n, e, seed)
    return from_coo(src, dst, n_nodes=n)


def _run_threads(target, args_list):
    errors = []

    def wrap(*args):
        try:
            target(*args)
        except BaseException as exc:         # reported by the test thread
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a build thread hung"
    assert not errors, errors


def test_unrelated_graphs_build_their_plans_at_once(monkeypatch):
    """Each build waits for the other to have started: under one lock for
    all graphs the second never starts and the barrier breaks."""
    real = spmv_mxu.build_plan
    barrier = threading.Barrier(2, timeout=5)

    def build_plan(*args, **kw):
        barrier.wait()
        return real(*args, **kw)

    monkeypatch.setattr(spmv_mxu, "build_plan", build_plan)
    graphs = [_graph(1), _graph(2)]
    _run_threads(tpr._mxu_state, [(g,) for g in graphs])
    for g in graphs:
        assert g._mxu_state["plan"].n_nodes == g.n_nodes
    assert graphs[0]._mxu_build_lock is not graphs[1]._mxu_build_lock


def test_one_graph_builds_its_plan_once_under_concurrent_calls(monkeypatch):
    real = spmv_mxu.build_plan
    calls = []
    start = threading.Barrier(4, timeout=5)

    def build_plan(*args, **kw):
        calls.append(threading.get_ident())
        threading.Event().wait(0.2)          # the others reach the lock
        return real(*args, **kw)

    monkeypatch.setattr(spmv_mxu, "build_plan", build_plan)
    graph = _graph(3)
    states = []

    def first_call():
        start.wait()
        states.append(tpr._mxu_state(graph))

    _run_threads(first_call, [()] * 4)
    assert len(calls) == 1
    assert len(states) == 4 and all(s is states[0] for s in states)


def test_each_graph_gets_one_lock_under_contention():
    """32 threads over 4 graphs ask for their graph's lock at once, with
    thread switches forced often: a lock created twice for one graph
    (a lost check-then-create) would let two builds run on it."""
    graphs = [_graph(10 + i, n=40, e=100) for i in range(4)]
    seen = [set() for _ in graphs]
    start = threading.Barrier(32, timeout=10)

    def ask(i):
        start.wait()
        for _ in range(200):
            seen[i % 4].add(id(tpr._build_lock(graphs[i % 4])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(ask, [(i,) for i in range(32)])
    finally:
        sys.setswitchinterval(old)
    assert all(len(s) == 1 for s in seen)
    assert len({id(g._mxu_build_lock) for g in graphs}) == 4


@pytest.fixture
def force_mxu(monkeypatch):
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setattr(jpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)


def _port(src, dst, n, precision="f32"):
    graph = from_coo(src, dst, n_nodes=n).to_device("cpu")
    rank, _, it = tpr.pagerank(graph, max_iterations=30, tol=-1.0,
                               precision=precision)
    assert it == 30
    return rank, graph


def _jax(src, dst, n):
    rank, _, it = jpr.pagerank(jcsr.from_coo(src, dst, n_nodes=n),
                               max_iterations=30, tol=-1.0)
    assert int(it) == 30
    return np.asarray(rank)


def test_route_dtype_variable_routes_f32_pagerank_in_bf16(force_mxu,
                                                          monkeypatch):
    n = 3000
    src, dst = _edges(n, 30000, 3042)
    plain32, _ = _port(src, dst, n)
    monkeypatch.setenv("MEMGRAPH_TPU_ROUTE_DTYPE", "bf16")
    f32, graph = _port(src, dst, n)
    bf16, _ = _port(src, dst, n, precision="bf16")
    # one run, placed for bf16, on a graph of its own each time
    assert [k[1] for k in graph._mxu_state["runs"]] == [torch.bfloat16]
    assert torch.equal(f32.view(torch.int32), bf16.view(torch.int32))
    assert not torch.equal(f32, plain32)         # the variable took effect
    want = _jax(src, dst, n)
    b = PRECISION_BOUNDS["bf16"]
    diff = np.abs(f32.numpy() - want)
    assert diff.max() <= b["pagerank_linf"] and diff.sum() <= b["pagerank_l1"]
    k = b["topk_order"]
    assert np.array_equal(np.argsort(-f32.numpy())[:k], np.argsort(-want)[:k])


@pytest.mark.parametrize("value", [None, "f32", "fp16"])
def test_f32_pagerank_routes_f32_without_the_variable(force_mxu,
                                                       monkeypatch, value):
    """Unset, or any value but bf16: the f32 route, as before, against the
    JAX package's f32 run."""
    if value is not None:
        monkeypatch.setenv("MEMGRAPH_TPU_ROUTE_DTYPE", value)
    n = 3000
    src, dst = _edges(n, 30000, 3042)
    got, graph = _port(src, dst, n)
    assert [k[1] for k in graph._mxu_state["runs"]] == [torch.float32]
    np.testing.assert_allclose(got.numpy(), _jax(src, dst, n), rtol=RTOL,
                               atol=ATOL)


def test_cached_run_follows_the_variable(force_mxu, monkeypatch):
    """A run cached under one value of the variable is not returned under
    another: the f32 call places a second run for the new dtype."""
    n = 3000
    src, dst = _edges(n, 30000, 3042)
    graph = from_coo(src, dst, n_nodes=n).to_device("cpu")
    first, _, _ = tpr.pagerank(graph, max_iterations=30, tol=-1.0)
    monkeypatch.setenv("MEMGRAPH_TPU_ROUTE_DTYPE", "bf16")
    second, _, _ = tpr.pagerank(graph, max_iterations=30, tol=-1.0)
    assert sorted(str(k[1]) for k in graph._mxu_state["runs"]) == [
        "torch.bfloat16", "torch.float32"]
    bf16, _ = _port(src, dst, n, precision="bf16")
    assert torch.equal(second.view(torch.int32), bf16.view(torch.int32))
    assert not torch.equal(first, second)


@pytest.mark.parametrize("value,want", [(None, torch.float32),
                                        ("bf16", torch.bfloat16),
                                        ("f32", torch.float32),
                                        ("BF16", torch.float32)])
def test_resolve_route_dtype_reads_the_variable_as_the_reference(
        monkeypatch, value, want):
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)
    if value is not None:
        monkeypatch.setenv("MEMGRAPH_TPU_ROUTE_DTYPE", value)
    assert spmv_mxu.resolve_route_dtype(None) is want
    # an explicit dtype wins over the variable
    assert spmv_mxu.resolve_route_dtype(torch.float32) is torch.float32
    assert spmv_mxu.resolve_route_dtype(torch.bfloat16) is torch.bfloat16


def test_cpu_and_cpu0_place_one_plan_and_keep_one_run(force_mxu,
                                                      monkeypatch):
    """"cpu" and "cpu:0" name one device: the second call finds the run
    (and the routes) the first one placed."""
    real, calls = spmv_mxu.place_plan, []

    def place_plan(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(spmv_mxu, "place_plan", place_plan)
    n = 3000
    src, dst = _edges(n, 30000, 3042)
    graph = from_coo(src, dst, n_nodes=n)
    a, _, _ = tpr.pagerank(graph, max_iterations=5, tol=-1.0, device="cpu")
    b, _, _ = tpr.pagerank(graph, max_iterations=5, tol=-1.0,
                           device="cpu:0")
    assert len(calls) == 1
    key = (torch.device("cpu"), torch.float32)
    assert list(graph._mxu_state["runs"]) == [key]
    assert list(graph._mxu_state["placed"]) == [key]
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,current,want", [
    ("cpu", 0, "cpu"), ("cpu:0", 0, "cpu"), (torch.device("cpu", 0), 0,
                                             "cpu"),
    ("cuda", 0, "cuda:0"), ("cuda:0", 0, "cuda:0"), ("cuda", 1, "cuda:1"),
    ("cuda:1", 0, "cuda:1"), (torch.device("cuda"), 0, "cuda:0")])
def test_resolve_device_names_each_device_one_way(name, current, want,
                                                  monkeypatch):
    """A bare "cuda" is the current card, with its index; the CPU never
    carries one: so keys and comparisons of one device agree."""
    from memgraph_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    got = resolve_device(name)
    assert got == torch.device(want) and str(got) == want
    assert resolve_device(got) == got
