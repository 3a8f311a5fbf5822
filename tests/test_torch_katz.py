"""Katz centrality, HITS and degree centrality of the port
(``memgraph_tpu_torch/ops/katz.py``) on the CPU, against the JAX package.

MXU backend: the semiring threshold is monkeypatched to 0 in both packages
and MEMGRAPH_TPU_FORCE_MXU set, as tests/test_torch_pagerank.py forces
it, so small graphs take the plan path on the CPU (plain versions of the
Benes kernels); the JAX package's katz then runs ``mxu_fixpoint`` with a
``normalize=False`` plan.  Segment backend: both on the CPU.

Fixed-length runs pass tol=-1: err >= 0, so both packages run exactly
max_iterations.  α = 0.05 keeps αλ under 1 on every graph here.

Tolerances: both sides iterate in f32 and differ only in the order of f32
sums (XLA's einsum and segment_sum against torch's bmm and index_add_):
katz rtol 1e-5 (values 1..~10); HITS vectors are L2-normalized (entries
up to 1): atol 1e-6.  bf16 routes round each contribution at the same
place in both packages, but a rounding can land on either side of a tie
when the f32 operand differs in its last ulp: the port is held within
``PRECISION_BOUNDS["bf16"]["katz_rel"]`` of the JAX package everywhere
and to rtol 1e-5 on 99% of nodes.  The port's bf16 against its own f32
stays inside ``katz_rel`` on a graph where αλ = 1/2 (λ by a float64
power iteration).  Degree centrality is exact: bit-equal.  The derived
unnormalized plan is bit-equal, field by field, to the JAX package's
``build_plan(normalize=False)``.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import katz as jkatz
from memgraph_tpu.ops import semiring as jsemiring
from memgraph_tpu.ops import spmv_mxu as J
from memgraph_tpu_torch.ops import katz as tkatz
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops import semiring as tsemiring
from memgraph_tpu_torch.ops import spmv_mxu as T
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

from test_torch_pagerank import CASES

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9
HITS_ATOL = 1e-6
ALPHA = 0.05
ITERS = 25


@pytest.fixture
def force_mxu(monkeypatch):
    monkeypatch.setattr(tsemiring, "MXU_MIN_EDGES", 0)
    monkeypatch.setattr(jsemiring, "MXU_MIN_EDGES", 0)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)


@pytest.fixture
def segment(monkeypatch):
    monkeypatch.delenv("MEMGRAPH_TPU_FORCE_MXU", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)


@pytest.fixture(params=["mxu", "segment"])
def backend(request):
    request.getfixturevalue("force_mxu" if request.param == "mxu"
                            else "segment")
    return request.param


@functools.cache
def _jax_graph(name, mxu):
    """One JAX graph a case and backend: the JAX package caches its plan
    and kernel on the graph, so each compiles once a worker."""
    src, dst, w, n = CASES[name]()
    return jcsr.from_coo(src, dst, w, n_nodes=n)


def _port_graph(name):
    src, dst, w, n = CASES[name]()
    return from_coo(src, dst, w, n_nodes=n)


def _took(graph, backend):
    mxu = getattr(graph, "_mxu_state", None) is not None
    assert mxu == (backend == "mxu")


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_katz_matches_jax(name, precision, normalized, backend):
    kw = dict(alpha=ALPHA, max_iterations=ITERS, tol=-1.0,
              normalized=normalized, precision=precision)
    want, _, jit = jkatz.katz_centrality(_jax_graph(name, backend), **kw)
    graph = _port_graph(name)
    got, _, tit = tkatz.katz_centrality(graph, device="cpu", **kw)
    _took(graph, backend)
    want = np.asarray(want)
    assert got.device.type == "cpu" and got.shape == want.shape
    assert tit == int(jit) == ITERS
    if precision == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        return
    rel = np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max() <= PRECISION_BOUNDS["bf16"]["katz_rel"]
    assert np.isclose(got.numpy(), want, rtol=RTOL, atol=ATOL).mean() > 0.99


def test_katz_warm_start_and_tolerance_stop_match_jax(backend):
    name = "skewed"
    n = CASES[name]()[3]
    x0 = 1.0 + np.random.default_rng(1).random(n).astype(np.float32)
    want, jerr, jit = jkatz.katz_centrality(
        _jax_graph(name, backend), alpha=ALPHA, tol=1e-5, x0=x0)
    graph = _port_graph(name)
    got, terr, tit = tkatz.katz_centrality(graph, alpha=ALPHA, tol=1e-5,
                                           x0=x0, device="cpu")
    _took(graph, backend)
    assert 1 < tit < 100 and tit == int(jit)
    assert terr <= 1e-5 and float(jerr) <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _spectral_radius(src, dst, n):
    """λ of Aᵀ by a float64 power iteration (the graphs are aperiodic)."""
    a = sp.csr_matrix((np.ones(len(src)), (dst, src)), shape=(n, n))
    x = np.ones(n)
    for _ in range(500):
        y = a @ x
        lam = np.linalg.norm(y) / np.linalg.norm(x)
        x = y / np.linalg.norm(y)
    return lam


def test_katz_bf16_stays_inside_its_bound(force_mxu):
    src, dst, _, n = CASES["skewed"]()
    alpha = 0.5 / _spectral_radius(src, dst, n)
    graph = from_coo(src, dst, n_nodes=n).to_device("cpu")
    f32, _, _ = tkatz.katz_centrality(graph, alpha=alpha, max_iterations=50,
                                      tol=-1.0)
    bf16, _, _ = tkatz.katz_centrality(graph, alpha=alpha,
                                       max_iterations=50, tol=-1.0,
                                       precision="bf16")
    rel = ((bf16 - f32).abs() / f32).max()
    assert 0 < float(rel) <= PRECISION_BOUNDS["bf16"]["katz_rel"]
    # one plan, the katz runs of both dtypes on it
    runs = graph._mxu_state["semiring"]["runs"]
    assert sorted(k[2] for k in runs) == ["bf16", "f32"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_hits_matches_jax(name, segment):
    jh, ja, _, jit = jkatz.hits(_jax_graph(name, "segment"),
                                max_iterations=ITERS, tol=-1.0)
    th, ta, _, tit = tkatz.hits(_port_graph(name), max_iterations=ITERS,
                                tol=-1.0, device="cpu")
    assert tit == int(jit) == ITERS
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HITS_ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=HITS_ATOL)


def test_hits_tolerance_stop_matches_jax(segment):
    jh, ja, jerr, jit = jkatz.hits(_jax_graph("skewed", "segment"),
                                   tol=1e-6)
    th, ta, terr, tit = tkatz.hits(_port_graph("skewed"), tol=1e-6,
                                   device="cpu")
    assert 1 < tit < 100 and tit == int(jit)
    assert terr <= 1e-6 and float(jerr) <= 1e-6
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HITS_ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=HITS_ATOL)


@pytest.mark.parametrize("direction", ["in", "out", "total"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_degree_centrality_is_bit_equal(name, direction):
    want = np.asarray(jkatz.degree_centrality(_jax_graph(name, "segment"),
                                              direction))
    got = tkatz.degree_centrality(_port_graph(name), direction,
                                  device="cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # and numpy's float32 count over n - 1
    src, dst, _, n = CASES[name]()
    counts = {"in": np.bincount(dst, minlength=n),
              "out": np.bincount(src, minlength=n)}
    counts["total"] = counts["in"] + counts["out"]
    plain = counts[direction].astype(np.float32) / max(n - 1, 1)
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_derived_unnormalized_plan_is_the_jax_build(name):
    src, dst, w, n = CASES[name]()
    graph = from_coo(src, dst, w, n_nodes=n)
    s, d, ww = graph.host_edges()             # CSR order, as both build
    plan = T.build_plan(s, d, ww, n)
    got = T.unnormalized_plan(plan, s, ww)
    want = J.build_plan(s, d, ww, n, normalize=False)
    for f in dataclasses.fields(J.MXUPlan):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for f in T.ROUTED_FIELDS:                 # the same arrays, not copies
        assert getattr(got, f) is getattr(plan, f)


def test_place_mult_refuses_a_plan_with_other_routes():
    src, dst, _, n = CASES["skewed"]()
    plan = T.build_plan(src, dst, None, n)
    placed = T.place_plan(plan, device="cpu")
    other = T.build_plan(src, dst, None, n, normalize=False)   # own arrays
    with pytest.raises(ValueError, match="routes"):
        T.place_mult(placed, other)
    mine = T.place_mult(placed, T.unnormalized_plan(plan, src, None))
    with pytest.raises(ValueError, match="another plan"):
        T.make_semiring_kernel(plan, epilogue=tkatz._katz_mxu_epilogue,
                               device="cpu", placed=mine)


class _Counted:
    """Counts calls of spmv_mxu functions (the real ones run)."""

    def __init__(self, monkeypatch, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            real = getattr(T, name)

            def wrap(*args, _real=real, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _real(*args, **kw)

            monkeypatch.setattr(T, name, wrap)

    def __getitem__(self, name):
        return self.calls[name]


@pytest.mark.parametrize("order", ["pagerank_first", "katz_first"])
def test_katz_and_pagerank_share_one_plan_and_its_routes(order, force_mxu,
                                                         monkeypatch):
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    counted = _Counted(monkeypatch, "build_plan", "_put_route",
                       "place_plan", "place_mult")
    src, dst, w, n = CASES["weighted_dangling"]()
    graph = from_coo(src, dst, w, n_nodes=n).to_device("cpu")
    calls = [lambda p: tpr.pagerank(graph, max_iterations=ITERS, tol=-1.0,
                                    precision=p),
             lambda p: tkatz.katz_centrality(graph, alpha=ALPHA,
                                             max_iterations=ITERS, tol=-1.0,
                                             precision=p)]
    if order == "katz_first":
        calls.reverse()
    for call in calls:
        for p in ("f32", "bf16"):
            call(p)
    assert len(counted["build_plan"]) == 1
    # edge and node route once per device and route dtype
    assert len(counted["_put_route"]) == 4
    assert len(counted["place_plan"]) == 2 and len(counted["place_mult"]) == 2
    state = graph._mxu_state
    assert graph._mxu_base_self is True and "delta" not in state
    for dt in (torch.float32, torch.bfloat16):
        base = state["placed"][(torch.device("cpu"), dt)]
        katz = state["semiring"]["placed"][(False, torch.device("cpu"), dt)]
        assert katz["shares"] is base
        for name in ("edge", "node", "valid"):
            assert katz[name] is base[name]
        assert katz["layout"][0] is base["layout"][0]
        assert katz["layout"][1] is not base["layout"][1]      # mult
    # and the answers are the JAX package's
    want, _, _ = jkatz.katz_centrality(
        jcsr.from_coo(src, dst, w, n_nodes=n), alpha=ALPHA,
        max_iterations=ITERS, tol=-1.0)
    got, _, _ = tkatz.katz_centrality(graph, alpha=ALPHA,
                                      max_iterations=ITERS, tol=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_katz_f32_places_its_own_routes_under_a_bf16_route_dtype(
        force_mxu, monkeypatch):
    """MEMGRAPH_TPU_ROUTE_DTYPE=bf16 routes PageRank's f32 in bf16; katz
    f32 keeps the reference's f32 routes, so it places a second edge and
    node route (once), and still shares the one plan build."""
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setenv("MEMGRAPH_TPU_ROUTE_DTYPE", "bf16")
    counted = _Counted(monkeypatch, "build_plan", "_put_route",
                       "place_plan", "place_mult")
    src, dst, w, n = CASES["weighted_dangling"]()
    graph = from_coo(src, dst, w, n_nodes=n).to_device("cpu")
    tpr.pagerank(graph, max_iterations=ITERS, tol=-1.0)
    for _ in range(2):
        got, _, _ = tkatz.katz_centrality(graph, alpha=ALPHA,
                                          max_iterations=ITERS, tol=-1.0)
    assert len(counted["build_plan"]) == 1
    assert len(counted["_put_route"]) == 4 and len(counted["place_plan"]) == 2
    assert sorted(str(dt) for _, dt in graph._mxu_state["placed"]) == [
        "torch.bfloat16", "torch.float32"]
    want, _, _ = jkatz.katz_centrality(
        jcsr.from_coo(src, dst, w, n_nodes=n), alpha=ALPHA,
        max_iterations=ITERS, tol=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("pagerank_first", [True, False])
def test_katz_on_a_delta_snapshot_builds_its_own_plan(pagerank_first,
                                                      force_mxu,
                                                      monkeypatch):
    """A snapshot marked with ``_delta_ctx`` (as the JAX package's
    ``GraphCache.get`` marks it): its PageRank state is delta-derived, so
    katz builds its own normalize=False plan, against JAX katz on the
    mutated edges."""
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    n = 3000
    rng = np.random.default_rng(21)
    src = rng.integers(0, n, 30000)
    dst = (rng.random(30000) ** 2 * n).astype(np.int64)
    base = from_coo(src, dst, n_nodes=n).to_device("cpu")
    tpr.pagerank(base, max_iterations=3, tol=-1.0)
    keep = np.ones(len(src), bool)
    keep[rng.choice(len(src), 200, replace=False)] = False
    add_s, add_d = rng.integers(0, n, 300), rng.integers(0, n, 300)
    s2 = np.concatenate([src[keep], add_s])
    d2 = np.concatenate([dst[keep], add_d])
    changed = set(np.concatenate([src[~keep], add_s]).tolist())
    succ = from_coo(s2, d2, n_nodes=n,
                    node_gids=base.node_gids).to_device("cpu")
    object.__setattr__(succ, "_delta_ctx", (base, frozenset(changed)))
    counted = _Counted(monkeypatch, "build_plan")
    if pagerank_first:
        tpr.pagerank(succ, max_iterations=3, tol=-1.0)
        assert succ._mxu_state.get("delta") is not None
    got, _, _ = tkatz.katz_centrality(succ, alpha=ALPHA,
                                      max_iterations=ITERS, tol=-1.0)
    builds = counted["build_plan"]
    assert len(builds) == 1 and builds[0][1].get("normalize") is False
    assert succ._mxu_semiring["semiring"]["plans"][False] is not \
        base._mxu_state["plan"]
    want, _, _ = jkatz.katz_centrality(jcsr.from_coo(s2, d2, n_nodes=n),
                                       alpha=ALPHA, max_iterations=ITERS,
                                       tol=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


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
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a katz thread hung"
    assert not errors, errors


def _katz_graph(seed, n=300, e=2000):
    rng = np.random.default_rng(seed)
    return from_coo(rng.integers(0, n, e),
                    (rng.random(e) ** 2 * n).astype(np.int64),
                    n_nodes=n).to_device("cpu")


def test_concurrent_katz_on_one_graph_builds_once(force_mxu, monkeypatch):
    real = T.build_plan
    calls = []

    def build_plan(*args, **kw):
        calls.append(threading.get_ident())
        threading.Event().wait(0.2)          # the others reach the lock
        return real(*args, **kw)

    monkeypatch.setattr(T, "build_plan", build_plan)
    counted = _Counted(monkeypatch, "unnormalized_plan", "place_mult")
    graph = _katz_graph(3)
    start = threading.Barrier(4, timeout=10)
    out = []

    def call():
        start.wait()
        out.append(tkatz.katz_centrality(graph, alpha=ALPHA,
                                         max_iterations=5, tol=-1.0)[0])

    _run_threads(call, [()] * 4)
    assert len(calls) == 1
    assert len(counted["unnormalized_plan"]) == 1
    assert len(counted["place_mult"]) == 1
    assert len(out) == 4 and all(torch.equal(o, out[0]) for o in out)


def test_katz_on_two_graphs_builds_at_once(force_mxu, monkeypatch):
    """Each build waits for the other to have started: under one lock for
    all graphs the second never starts and the barrier breaks."""
    real = T.build_plan
    barrier = threading.Barrier(2, timeout=5)

    def build_plan(*args, **kw):
        barrier.wait()
        return real(*args, **kw)

    monkeypatch.setattr(T, "build_plan", build_plan)
    graphs = [_katz_graph(1), _katz_graph(2)]
    _run_threads(lambda g: tkatz.katz_centrality(g, alpha=ALPHA,
                                                 max_iterations=3, tol=-1.0),
                 [(g,) for g in graphs])
    assert all(len(g._mxu_state["semiring"]["runs"]) == 1 for g in graphs)


def test_cpu_and_cpu0_share_one_katz_run(force_mxu, monkeypatch):
    counted = _Counted(monkeypatch, "place_plan", "place_mult")
    graph = _port_graph("skewed")
    a, _, _ = tkatz.katz_centrality(graph, alpha=ALPHA, max_iterations=5,
                                    tol=-1.0, device="cpu")
    b, _, _ = tkatz.katz_centrality(graph, alpha=ALPHA, max_iterations=5,
                                    tol=-1.0, device="cpu:0")
    assert len(counted["place_plan"]) == 1 and len(counted["place_mult"]) == 1
    assert len(graph._mxu_state["semiring"]["runs"]) == 1
    assert torch.equal(a, b)


def test_mxu_fixpoint_refuses_int8(force_mxu):
    with pytest.raises(ValueError, match="int8"):
        tsemiring.mxu_fixpoint(_port_graph("small"),
                               epilogue=tkatz._katz_mxu_epilogue,
                               params={"alpha": 0.1, "beta": 1.0},
                               max_iterations=3, tol=-1.0,
                               precision="int8", device="cpu")
    # katz at int8 takes the segment backend instead, as the reference
    graph = _port_graph("small")
    got, _, it = tkatz.katz_centrality(graph, alpha=ALPHA, max_iterations=5,
                                       tol=-1.0, precision="int8",
                                       device="cpu")
    assert it == 5 and getattr(graph, "_mxu_state", None) is None
    want, _, _ = jkatz.katz_centrality(_jax_graph("small", "segment"),
                                       alpha=ALPHA, max_iterations=5,
                                       tol=-1.0, precision="int8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2)


@pytest.mark.parametrize("entry", ["katz", "hits", "degree"])
def test_no_quiet_cpu_path_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = _port_graph("small")
    call = {"katz": lambda g, **kw: tkatz.katz_centrality(
                g, alpha=ALPHA, max_iterations=3, **kw),
            "hits": lambda g, **kw: tkatz.hits(g, max_iterations=3, **kw),
            "degree": lambda g, **kw: (tkatz.degree_centrality(g, **kw),)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry](graph)
    # asking for the CPU, or handing in a CPU graph, runs there
    assert call[entry](graph, device="cpu")[0].device.type == "cpu"
    assert call[entry](graph.to_device("cpu"))[0].device.type == "cpu"
