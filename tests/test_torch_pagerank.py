"""The whole slice: the port's ``ops.pagerank.pagerank`` on a graph from
its own ``from_coo``, run on the CPU, against the JAX package.

MXU backend: ``MXU_MIN_EDGES`` is monkeypatched to 0 and
MEMGRAPH_TPU_FORCE_MXU set, so small graphs take the plan path on the CPU
(plain versions of the Benes kernels), against JAX ``pagerank_mxu``.
Segment backend: against JAX ``ops.pagerank.pagerank`` on the CPU.

Fixed-length runs pass tol=-1: err >= 0, so both packages run exactly
max_iterations (with tol=0 a run stops where err first rounds to exactly
0, an f32 accident that lands an iteration apart between the packages).

Tolerances: both sides iterate in f32; only the order of f32 sums differs
(XLA-CPU einsum / segment_sum against torch bmm / index_add_), so ranks
agree to a few f32 ulps per iteration — rtol 1e-5, atol 1e-9 (ranks here
are 1e-5..0.3).  The JAX MXU path gets the raw COO order and the port the
CSR order of ``from_coo``; that reorders the plan's slots, not the sums'
terms, and stays inside the same tolerance.
"""

import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu.ops.spmv_mxu import pagerank_mxu
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9


def _skewed(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), (rng.random(e) ** 2 * n).astype(np.int64)


def _uniform(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def _weighted_dangling():
    rng = np.random.default_rng(5)
    n, e = 500, 3000
    src = rng.integers(0, n // 2, e)      # a tail of dangling nodes
    dst = rng.integers(0, n, e)
    return src, dst, rng.random(e).astype(np.float32) + 0.1, n


CASES = {
    "small": lambda: (*_uniform(200, 1500, 242), None, 200),
    "skewed": lambda: (*_skewed(3000, 30000, 3042), None, 3000),
    "weighted_dangling": _weighted_dangling,
    "multi_edges": lambda: (np.array([0, 0, 0, 1, 1, 2, 3, 3]),
                            np.array([1, 1, 0, 2, 2, 2, 3, 0]), None, 5),
}


@pytest.fixture
def force_mxu(monkeypatch):
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mxu_backend_matches_jax_pagerank_mxu(name, force_mxu):
    src, dst, w, n = CASES[name]()
    want, _, jit = pagerank_mxu(src, dst, w, n, max_iterations=25,
                                tol=-1.0)
    graph = from_coo(src, dst, w, n_nodes=n)
    got, _, tit = tpr.pagerank(graph, max_iterations=25, tol=-1.0,
                               device="cpu")
    assert getattr(graph, "_mxu_state", None) is not None   # took the plan
    assert got.device.type == "cpu" and got.shape == (n,)
    assert tit == jit
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mxu_bf16_stays_inside_precision_bounds(force_mxu):
    src, dst, _, n = CASES["skewed"]()
    graph = from_coo(src, dst, n_nodes=n).to_device("cpu")
    f32, _, _ = tpr.pagerank(graph, max_iterations=30, tol=-1.0)
    bf16, _, _ = tpr.pagerank(graph, max_iterations=30, tol=-1.0,
                              precision="bf16")
    b = PRECISION_BOUNDS["bf16"]
    diff = (bf16 - f32).abs()
    assert float(diff.max()) <= b["pagerank_linf"]
    assert float(diff.sum()) <= b["pagerank_l1"]
    k = b["topk_order"]
    assert torch.equal(torch.argsort(-bf16)[:k], torch.argsort(-f32)[:k])
    # one plan served both precisions
    assert len(graph._mxu_state["runs"]) == 2


def _jax_segment(src, dst, w, n, **kw):
    graph = jcsr.from_coo(src, dst, w, n_nodes=n)
    rank, err, it = jpr.pagerank(graph, **kw)
    return np.asarray(rank), float(err), int(it)


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_backend_matches_jax_pagerank(name, monkeypatch):
    monkeypatch.delenv("MEMGRAPH_TPU_FORCE_MXU", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    src, dst, w, n = CASES[name]()
    want, _, jit = _jax_segment(src, dst, w, n, max_iterations=25,
                                tol=-1.0)
    graph = from_coo(src, dst, w, n_nodes=n)
    got, _, tit = tpr.pagerank(graph, max_iterations=25, tol=-1.0,
                               device="cpu")
    assert getattr(graph, "_mxu_state", None) is None   # segment backend
    assert tit == jit
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_segment_reduced_precision_matches_jax(precision, monkeypatch):
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    src, dst, _, n = CASES["skewed"]()
    want, _, jit = _jax_segment(src, dst, None, n, max_iterations=20,
                                tol=-1.0, precision=precision)
    got, _, tit = tpr.pagerank(from_coo(src, dst, n_nodes=n),
                               max_iterations=20, tol=-1.0,
                               precision=precision, device="cpu")
    assert tit == jit
    # a reduced-precision rounding can land on either side of a tie when
    # the f32 operand differs in its last ulp: hold the port to the
    # documented bound against JAX, and most ranks to f32 agreement
    b = PRECISION_BOUNDS[precision]
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= b["pagerank_linf"] and diff.sum() <= b["pagerank_l1"]
    close = np.isclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert close.mean() > 0.99


@pytest.mark.parametrize("mxu", [False, True])
def test_warm_start_and_tolerance_stop_match_jax(mxu, monkeypatch):
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    if mxu:
        monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
        monkeypatch.setattr(jpr, "MXU_MIN_EDGES", 0)
        monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    src, dst, _, n = CASES["skewed"]()
    jgraph = jcsr.from_coo(src, dst, n_nodes=n)
    tgraph = from_coo(src, dst, n_nodes=n)
    x0 = np.random.default_rng(1).random(n).astype(np.float32)
    want, jerr, jit = jpr.pagerank(jgraph, tol=1e-6, x0=x0)
    got, terr, tit = tpr.pagerank(tgraph, tol=1e-6, x0=x0, device="cpu")
    assert (getattr(tgraph, "_mxu_state", None) is not None) == mxu
    assert 1 < tit < 100 and tit == int(jit)
    assert terr <= 1e-6 and float(jerr) <= 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_no_quiet_cpu_path_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, _, n = CASES["small"]()
    graph = from_coo(src, dst, n_nodes=n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpr.pagerank(graph)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph.to_device()
    # asking for the CPU, or handing in a CPU graph, runs there
    rank, _, _ = tpr.pagerank(graph.to_device("cpu"), max_iterations=3)
    assert rank.device.type == "cpu"


def test_placed_graph_keeps_its_arrays():
    src, dst, w, n = CASES["weighted_dangling"]()
    host = from_coo(src, dst, w, n_nodes=n)
    placed = host.to_device("cpu")
    assert host.device is None and placed.device.type == "cpu"
    for name in ("row_ptr", "col_idx", "src_idx", "weights", "csc_src",
                 "csc_dst", "csc_weights", "out_degree"):
        assert np.array_equal(getattr(placed, name).numpy(),
                              getattr(host, name)), name
    jhost = jcsr.from_coo(src, dst, w, n_nodes=n)
    for name in ("row_ptr", "col_idx", "src_idx", "weights", "out_degree"):
        assert np.array_equal(getattr(host, name),
                              np.asarray(getattr(jhost, name))), name
    s, d, ww = placed.host_edges()
    assert len(s) == len(d) == len(ww) == len(src)
