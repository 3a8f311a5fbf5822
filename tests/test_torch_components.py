"""Connected components of the port (memgraph_tpu_torch/ops/components.py)
on the CPU, against the JAX package's (memgraph_tpu/ops/components.py).

Models: tests/test_semiring.py:376-386 (WCC pin) and
tests/test_ops_kernels.py:127-217 (WCC/SCC against networkx, the chain of
cycles, the 500-node cycle).  Labels are integers reduced by min, exact in
any order, so every comparison is exact: the same labels and the same
iteration counts.
"""

import functools

import networkx as nx
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import components as jcomp
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu_torch.ops import components as tcomp
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _random(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def _sparse_forest(seed=5):
    """Many small weak components and isolated nodes."""
    rng = np.random.default_rng(seed)
    n = 200
    src = rng.integers(0, n, 120)
    dst = np.clip(src + rng.integers(-4, 5, 120), 0, n - 1)
    return src, dst, n


def _cycles_and_tendrils(seed=9):
    """Directed cycles of several lengths joined by one-way bridges, with
    tails in and out: SCCs of many sizes, and nodes the trim settles."""
    rng = np.random.default_rng(seed)
    src, dst, base = [], [], 0
    for length in (1, 2, 3, 7, 20, 4):
        ring = np.arange(base, base + length)
        src += list(ring)
        dst += list(np.roll(ring, -1))
        base += length
    for _ in range(40):
        a, b = sorted(rng.integers(0, base, 2))
        src.append(a)
        dst.append(b)           # forward-only bridges keep the DAG above
    tails = np.arange(base, base + 15)
    src += list(tails)
    dst += list(rng.integers(0, base, 15))
    return np.array(src), np.array(dst), base + 15


GRAPHS = {
    "random_sparse": lambda: _random(150, 140, 1),
    "random_dense": lambda: _random(120, 900, 2),
    "forest": _sparse_forest,
    "cycles": _cycles_and_tendrils,
    "chain_of_cycles": lambda: (np.array([0, 1, 2, 3, 4, 5, 2]),
                                np.array([1, 2, 0, 4, 5, 3, 3]), 6),
    "long_cycle": lambda: (np.arange(500), (np.arange(500) + 1) % 500, 500),
}


@functools.cache
def _graphs(name):
    src, dst, n = GRAPHS[name]()
    return (jcsr.from_coo(src, dst, n_nodes=n),
            from_coo(src, dst, n_nodes=n).to_device("cpu"), (src, dst, n))


@pytest.mark.parametrize("max_iterations", [1, 200])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wcc_matches_jax(name, max_iterations):
    jg, tg, _ = _graphs(name)
    want, jit = jcomp.weakly_connected_components(
        jg, max_iterations=max_iterations)
    got, it = tcomp.weakly_connected_components(
        tg, max_iterations=max_iterations)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want)) and it == jit


@pytest.mark.parametrize("name", ["random_sparse", "forest", "cycles"])
def test_wcc_warm_start_matches_jax(name):
    """comp0 from the graph less a third of its edges: the added edges
    may only merge components (the monotone contract)."""
    jg, tg, (src, dst, n) = _graphs(name)
    keep = np.arange(len(src)) % 3 != 0
    part = from_coo(src[keep], dst[keep], n_nodes=n).to_device("cpu")
    comp0, _ = tcomp.weakly_connected_components(part)
    want, jit = jcomp.weakly_connected_components(jg, comp0=comp0)
    got, it = tcomp.weakly_connected_components(tg, comp0=comp0)
    assert np.array_equal(got, np.asarray(want)) and it == jit
    cold, cold_it = tcomp.weakly_connected_components(tg)
    assert np.array_equal(got, cold) and it <= cold_it


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_scc_matches_jax(name):
    jg, tg, _ = _graphs(name)
    want = jcomp.strongly_connected_components(jg)
    stats = {}
    got = tcomp.strongly_connected_components(tg, stats=stats)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))
    assert stats["rounds"] >= 0


@pytest.mark.parametrize("name", ["random_dense", "cycles", "forest"])
def test_components_match_networkx(name):
    _, tg, (src, dst, n) = _graphs(name)
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    weak, _ = tcomp.weakly_connected_components(tg)
    strong = tcomp.strongly_connected_components(tg)
    for got, comps in ((weak, nx.weakly_connected_components(g)),
                       (strong, nx.strongly_connected_components(g))):
        comps = list(comps)
        for c in comps:
            assert {int(got[v]) for v in c} == {min(c)}
        assert len(set(got.tolist())) == len(comps)


def test_scc_long_cycle_is_one_component():
    """tests/test_ops_kernels.py:test_scc_long_cycle on the port: the inner
    propagation runs to its fixpoint, beyond any small cap."""
    _, tg, _ = _graphs("long_cycle")
    assert set(tcomp.strongly_connected_components(tg).tolist()) == {0}


def test_scc_chain_of_cycles():
    _, tg, _ = _graphs("chain_of_cycles")
    assert tcomp.strongly_connected_components(tg).tolist() == \
        [0, 0, 0, 3, 3, 3]


def test_scc_inner_cap_matches_jax():
    """A cap on the inner propagation leaves the 500-cycle unsettled; the
    no-progress guard then labels each node by itself, in both."""
    jg, tg, _ = _graphs("long_cycle")
    want = jcomp.strongly_connected_components(jg, max_iterations=10)
    got = tcomp.strongly_connected_components(tg, max_iterations=10)
    assert np.array_equal(got, np.asarray(want))


def test_no_quiet_cpu_path_without_a_card(monkeypatch):
    src, dst, n = _random(50, 100, 3)
    host = from_coo(src, dst, n_nodes=n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcomp.weakly_connected_components(host),
                 lambda: tcomp.strongly_connected_components(host)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got, _ = tcomp.weakly_connected_components(host, device="cpu")
    assert got.shape == (n,)
