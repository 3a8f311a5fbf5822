"""Traversal of the port (memgraph_tpu_torch/ops/traversal.py: ``sssp``,
``do_bfs``, ``bfs_levels``, ``multi_source_sssp``,
``khop_neighborhood``) on the CPU, against the JAX package's
(memgraph_tpu/ops/traversal.py).

Models: tests/test_semiring.py:389-434 (SSSP and BFS pins) and :587-621
(select_pull, push against pull), tests/test_ops_kernels.py:127-217
(SSSP, BFS levels and k-hop against networkx).  Min-plus relaxation adds
one f32 pair an edge and reduces by min, exact in any order, so every
comparison is exact: the same bits and the same iteration counts.
"""

import functools

import networkx as nx
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import semiring as JS
from memgraph_tpu.ops import traversal as jtrav
from memgraph_tpu_torch.ops import semiring as TS
from memgraph_tpu_torch.ops import traversal as ttrav
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _random(n, e, seed, skew=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = ((rng.random(e) ** 2 * n).astype(np.int64) if skew
           else rng.integers(0, n, e))
    return src, dst, rng.uniform(0.5, 2.0, e).astype(np.float32), n


GRAPHS = {
    "uniform": lambda: _random(203, 1500, 42),
    "skewed": lambda: _random(400, 4000, 7, skew=True),
    # under one edge a node: many unreachable nodes
    "sparse": lambda: _random(300, 250, 4),
    "path": lambda: (np.arange(30), np.arange(1, 31),
                     np.linspace(0.5, 1.5, 30).astype(np.float32), 40),
}


@functools.cache
def _graphs(name):
    src, dst, w, n = GRAPHS[name]()
    return (jcsr.from_coo(src, dst, w, n_nodes=n),
            from_coo(src, dst, w, n_nodes=n).to_device("cpu"),
            (src, dst, w, n))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got.view(np.int32) if got.dtype == np.float32
                       else got, want.view(np.int32)
                       if want.dtype == np.float32 else want)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sssp_matches_jax(name, weighted, directed):
    jg, tg, _ = _graphs(name)
    want, jit = jtrav.sssp(jg, 0, weighted=weighted, directed=directed)
    got, it = ttrav.sssp(tg, 0, weighted=weighted, directed=directed)
    assert isinstance(got, torch.Tensor) and _same(got, want) and it == jit


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_levels_match_jax(name, directed):
    jg, tg, _ = _graphs(name)
    want, jit = jtrav.bfs_levels(jg, 1, directed=directed)
    got, it = ttrav.bfs_levels(tg, 1, directed=directed)
    assert got.dtype == torch.int32 and _same(got, want) and it == jit


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_do_bfs_matches_jax(name):
    jg, tg, _ = _graphs(name)
    want, jit = jtrav.do_bfs(jg, 2)
    got, it = ttrav.do_bfs(tg, 2)
    assert _same(got, want) and it == jit


@pytest.mark.parametrize("alpha", [1e-6, 14.0, 1e9])
def test_push_and_pull_give_the_same_levels(alpha, monkeypatch):
    """Always push (tiny alpha: the pull threshold n_edges / alpha is
    never passed), the default switch, pull wherever the frontier has an
    out-edge (huge alpha): the same levels; the levels run are counted by
    kind."""
    jg, tg, _ = _graphs("skewed")
    want, _ = jtrav.bfs_levels(jg, 0)
    monkeypatch.setattr(TS, "DIRECTION_ALPHA", alpha)
    ttrav.do_bfs.levels.update(push=0, pull=0)
    got, it = ttrav.bfs_levels(tg, 0)
    assert _same(got, want)
    levels = dict(ttrav.do_bfs.levels)
    assert levels["push"] + levels["pull"] == it
    if alpha < 1:
        assert levels["pull"] == 0
    elif alpha > 1e6:
        assert levels["pull"] >= it - 1
    else:
        assert levels["push"] > 0 and levels["pull"] > 0


def test_push_equals_pull_on_one_level():
    """tests/test_semiring.py:test_push_equals_pull_for_bfs on the port."""
    _, tg, _ = _graphs("uniform")
    dist = torch.full((tg.n_pad,), ttrav.INF)
    dist[0] = 0.0
    frontier = torch.zeros(tg.n_pad, dtype=torch.bool)
    frontier[0] = True
    w = ttrav._inert_padding(tg, torch.ones_like(tg.weights))
    args = (dist, tg.src_idx.long(), tg.col_idx.long(), w)
    pull = TS.spmv("min_plus", *args, n_out=tg.n_pad)
    push = TS.spmv("min_plus", *args, n_out=tg.n_pad, frontier=frontier)
    finite = pull < ttrav.INF / 2
    assert torch.equal(pull[finite], push[finite])


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", ["uniform", "skewed", "sparse"])
def test_multi_source_sssp_matches_jax(name, weighted, directed):
    jg, tg, (_, _, _, n) = _graphs(name)
    sources = np.random.default_rng(3).choice(n, 5, replace=False)
    want = jtrav.multi_source_sssp(jg, sources, weighted=weighted,
                                   directed=directed)
    got = ttrav.multi_source_sssp(tg, sources, weighted=weighted,
                                  directed=directed)
    assert got.shape == (5, n) and _same(got, want)
    # each lane is the single-source run (both reach the least fixpoint)
    for lane, s in enumerate(sources):
        one, _ = ttrav.sssp(tg, int(s), weighted=weighted,
                            directed=directed)
        assert torch.equal(got[lane], one)


def test_multi_source_sssp_iteration_cap_matches_jax():
    jg, tg, _ = _graphs("path")
    want = jtrav.multi_source_sssp(jg, [0, 10], max_iterations=4)
    got = ttrav.multi_source_sssp(tg, [0, 10], max_iterations=4)
    assert _same(got, want)
    assert torch.isinf(got[0, 5]) and float(got[0, 4]) > 0


def test_multi_source_sssp_without_sources():
    _, tg, (_, _, _, n) = _graphs("uniform")
    assert ttrav.multi_source_sssp(tg, []).shape == (0, n)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["uniform", "sparse", "path"])
def test_khop_matches_jax(name, k, directed):
    jg, tg, _ = _graphs(name)
    want = jtrav.khop_neighborhood(jg, [0, 7], k, directed=directed)
    got = ttrav.khop_neighborhood(tg, [0, 7], k, directed=directed)
    assert got.dtype == torch.bool and _same(got, want)


def test_sssp_and_bfs_match_networkx():
    """tests/test_ops_kernels.py's oracles on the port."""
    _, tg, (src, dst, w, n) = _graphs("sparse")
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    for s, d, wi in zip(src.tolist(), dst.tolist(), w.tolist()):
        if not g.has_edge(s, d) or g[s][d]["weight"] > wi:
            g.add_edge(s, d, weight=wi)
    source = int(src[0])
    dist, _ = ttrav.sssp(tg, source)
    exp = nx.single_source_dijkstra_path_length(g, source, weight="weight")
    levels, _ = ttrav.bfs_levels(tg, source)
    hops = nx.single_source_shortest_path_length(g, source)
    for v in range(n):
        if v in exp:
            assert abs(float(dist[v]) - exp[v]) < 1e-4
        else:
            assert torch.isinf(dist[v])
        assert int(levels[v]) == hops.get(v, -1)


def test_inf_is_the_references():
    assert np.float32(ttrav.INF) == np.float32(jtrav.INF)
    assert TS.DIRECTION_ALPHA == JS.DIRECTION_ALPHA


def test_no_quiet_cpu_path_without_a_card(monkeypatch):
    src, dst, w, n = _random(50, 200, 9)
    host = from_coo(src, dst, w, n_nodes=n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ttrav.sssp(host, 0),
                 lambda: ttrav.do_bfs(host, 0),
                 lambda: ttrav.bfs_levels(host, 0),
                 lambda: ttrav.multi_source_sssp(host, [0, 1]),
                 lambda: ttrav.khop_neighborhood(host, [0], 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    dist, _ = ttrav.sssp(host, 0, device="cpu")
    assert dist.device.type == "cpu"
