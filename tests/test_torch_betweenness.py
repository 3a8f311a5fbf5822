"""The port's batched Brandes betweenness (memgraph_tpu_torch/ops/
betweenness.py) against the JAX package's ``betweenness_centrality`` and
networkx on the CPU.

Scores agree with the JAX package within 1e-5 of the largest score (the
backward sweep factors sigma[u] out of the reference's per-edge quotient,
so its f32 roundings differ), and both within 1e-4 of networkx's float64
Brandes, exact or over the same sampled sources
(tests/test_structure_modules.py holds the JAX package to 1e-4).  The
forward sweep's path counts and hop counts are bit-equal to the
reference's forward loop: integer sums below 2^24.
"""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import semiring as JS
from memgraph_tpu.ops.betweenness import autotune_chunk as jax_autotune
from memgraph_tpu.ops.betweenness import betweenness_centrality as jax_bc
from memgraph_tpu_torch.ops import betweenness as TB
from memgraph_tpu_torch.ops import segment_cuda as SC
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REL_JAX = 1e-5
ABS_NX = 1e-4


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    return src, dst


def _graphs(src, dst, n):
    return (jcsr.from_coo(src, dst, n_nodes=n).to_device(),
            from_coo(src, dst, n_nodes=n).to_device("cpu"))


def _networkx(src, dst, n, directed, normalized, sources=None):
    g = nx.DiGraph() if directed else nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from((int(a), int(b)) for a, b in zip(src, dst) if a != b)
    if sources is None:
        got = nx.betweenness_centrality(g, normalized=normalized)
        return np.array([got[i] for i in range(n)])
    # the sampled estimate: the sources' dependencies, scaled by n / k,
    # halved when undirected (betweenness_centrality_subset halves them),
    # then normalized as the reference normalizes
    got = nx.betweenness_centrality_subset(
        g, [int(s) for s in sources], list(range(n)), normalized=False)
    bc = np.array([got[i] for i in range(n)]) * n / len(sources)
    if normalized and n > 2:
        bc /= (n - 1) * (n - 2) / (1.0 if directed else 2.0)
    return bc


def _check(src, dst, n, directed=True, normalized=True, samples=None,
           chunk=None, seed=0, max_levels=None, stats=None):
    jg, tg = _graphs(src, dst, n)
    kw = dict(directed=directed, normalized=normalized, samples=samples,
              chunk=chunk, seed=seed, max_levels=max_levels)
    want = np.asarray(jax_bc(jg, **kw))
    got = TB.betweenness_centrality(tg, stats=stats, **kw)
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL_JAX * scale
    return got, want


@pytest.mark.parametrize("chunk", [1, 3, None])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("directed", [True, False])
def test_exact_against_the_jax_package_and_networkx(directed, normalized,
                                                    chunk):
    n = 60
    src, dst = _edges(n, 240, 1)
    stats = {}
    got, want = _check(src, dst, n, directed, normalized, chunk=chunk,
                       stats=stats)
    ref = _networkx(src, dst, n, directed, normalized)
    assert np.abs(got - ref).max() <= ABS_NX
    assert np.abs(want - ref).max() <= ABS_NX
    b = chunk or autotune_chunk_of(src, dst, n, directed)
    assert stats["chunk"] == b and len(stats["levels"]) == -(-n // b)


def autotune_chunk_of(src, dst, n, directed):
    s, _ = TB._dedup_pairs(torch.from_numpy(src), torch.from_numpy(dst), n,
                           directed)
    return TB.autotune_chunk(len(s), from_coo(src, dst, n_nodes=n).n_pad)


@pytest.mark.parametrize("directed", [True, False])
def test_deduplicated_pairs_are_the_references(directed):
    """The pairs the paths count on: memgraph_tpu/ops/betweenness.py's
    np.unique of (src, dst) rows, mirrored when undirected."""
    src, dst = _edges(70, 400, 6)
    src[:5] = dst[:5]                   # self-loops
    keep = src != dst
    s, d = src[keep], dst[keep]
    if directed:
        pairs = np.unique(np.stack([s, d], axis=1), axis=0)
        want = {tuple(p) for p in pairs}
    else:
        pairs = np.unique(np.stack([np.minimum(s, d), np.maximum(s, d)],
                                   axis=1), axis=0)
        want = {tuple(p) for p in pairs} | {(b, a) for a, b in pairs}
    gs, gd = TB._dedup_pairs(torch.from_numpy(src), torch.from_numpy(dst),
                             70, directed)
    got = list(zip(gs.tolist(), gd.tolist()))
    assert len(got) == len(want) and set(got) == want
    assert got == sorted(got)            # (src, dst) order: the CSR runs'
    A, n_pad = TB.pair_runs(from_coo(src, dst, n_nodes=70), directed,
                            torch.device("cpu"))
    ptr = A["csc_ptr"].numpy()
    assert ptr[-1] == len(got) and A["csc_longest"] == np.diff(ptr).max()
    csc = sorted((b, a) for a, b in got)
    assert [(b, a) for a, b in csc] == list(zip(
        A["csc_src"].tolist(), np.repeat(np.arange(n_pad), np.diff(ptr))))
    assert np.array_equal(A["csr_dst"].numpy(), gd.numpy())


@pytest.mark.parametrize("samples,chunk", [(7, 3), (10, 4), (9, None),
                                           (200, 5)])
@pytest.mark.parametrize("directed", [True, False])
def test_sampled_against_the_jax_package_and_networkx(samples, chunk,
                                                      directed):
    """Sampled sources, the last chunk padded with zero-weighted repeats
    (7 sources in chunks of 3, 10 in 4); samples >= n is exact."""
    n = 120
    src, dst = _edges(n, 500, 2)
    got, want = _check(src, dst, n, directed, samples=samples, chunk=chunk,
                       seed=5)
    sources = (None if samples >= n else
               np.random.default_rng(5).choice(n, size=samples,
                                               replace=False))
    ref = _networkx(src, dst, n, directed, True, sources)
    assert np.abs(got - ref).max() <= ABS_NX
    assert np.abs(want - ref).max() <= ABS_NX


@pytest.mark.parametrize("max_levels", [1, 2, 4])
def test_max_levels(max_levels):
    n = 80
    src, dst = _edges(n, 200, 3)
    stats = {}
    got, want = _check(src, dst, n, max_levels=max_levels, chunk=16,
                       stats=stats)
    assert max(stats["levels"]) == max_levels


def test_a_path_a_star_and_parallel_edges():
    # 0 -> 1 -> 2 -> 3 twice over, a self-loop, and a star into 4
    src = np.array([0, 1, 2, 0, 1, 2, 3, 5, 6, 7, 3])
    dst = np.array([1, 2, 3, 1, 2, 3, 3, 4, 4, 4, 4])
    for directed in (True, False):
        got, _ = _check(src, dst, 8, directed, normalized=False, chunk=3)
        ref = _networkx(src, dst, 8, directed, False)
        assert np.abs(got - ref).max() <= ABS_NX


def test_empty_and_tiny_graphs():
    empty = np.zeros(0, dtype=np.int64)
    got = TB.betweenness_centrality(from_coo(empty, empty, n_nodes=0),
                                    device="cpu")
    assert got.shape == (0,)
    got, _ = _check(empty, empty, 5)
    assert not got.any()
    got, _ = _check(np.array([0]), np.array([1]), 2)
    assert not got.any()


def test_autotune_chunk_is_the_reference_rule(monkeypatch):
    for e, n in ((10, 16), (10_000_000, 1 << 20), (3_000_000, 1 << 19)):
        assert TB.autotune_chunk(e, n) == jax_autotune(e, n)
    monkeypatch.setenv("MEMGRAPH_TPU_BC_MEM_BUDGET_MB", "64")
    assert TB.autotune_chunk(10_000_000, 1 << 20) == \
        jax_autotune(10_000_000, 1 << 20) == 1
    assert TB.n_levels_bound(5) == 5 and TB.n_levels_bound(1) == 2


def _jax_forward(src, dst, n_pad, sources, max_levels):
    """The reference's forward loop (memgraph_tpu/ops/betweenness.py
    ``_brandes_chunk``'s fwd_body, on the JAX package's edge_reduce),
    unrolled on the host: (dist, sigma) as (B, n_pad), levels."""
    B = len(sources)
    rows = jnp.arange(B)
    seg_ids = (rows[:, None] * n_pad + dst[None, :]).reshape(-1)
    dist = jnp.full((B, n_pad), 3.0e38, jnp.float32).at[
        rows, sources].set(0.0)
    sigma = jnp.zeros((B, n_pad), jnp.float32).at[rows, sources].set(1.0)
    level, progressed = 0.0, True
    while progressed and level < max_levels:
        on = dist[:, src] == level
        contrib = jnp.where(on, sigma[:, src], 0.0)
        sig_new = JS.edge_reduce("sum", contrib.reshape(-1), seg_ids,
                                 B * n_pad).reshape(B, n_pad)
        newly = (dist >= 3.0e38 / 2) & (sig_new > 0)
        dist = jnp.where(newly, level + 1.0, dist)
        sigma = jnp.where(newly, sig_new, sigma)
        progressed = bool(jnp.any(newly))
        level += 1.0
    return np.asarray(dist), np.asarray(sigma), int(level)


@pytest.mark.parametrize("directed", [True, False])
def test_forward_path_counts_are_bit_equal(directed):
    """Many shortest paths: a layered graph (every node of a layer to
    every node of the next) makes sigma grow as 5^level."""
    layers, width = 7, 5
    src, dst = [], []
    for lay in range(layers - 1):
        for a in range(width):
            for b in range(width):
                src.append(lay * width + a)
                dst.append((lay + 1) * width + b)
    rng = np.random.default_rng(0)
    n = layers * width + 20
    # and a random part of its own, joined to the last layer
    src = np.concatenate([src, rng.integers(layers * width - 1, n, 60)])
    dst = np.concatenate([dst, rng.integers(layers * width - 1, n, 60)])
    tg = from_coo(src, dst, n_nodes=n).to_device("cpu")
    A, n_pad = TB.pair_runs(tg, directed, torch.device("cpu"))
    sources = np.array([0, 1, 7, 30, 44], dtype=np.int64)
    dist, sigma, levels = TB._brandes_forward(
        A, torch.from_numpy(sources), n_pad, 100)
    s, d = TB._dedup_pairs(torch.from_numpy(src), torch.from_numpy(dst), n,
                           directed)
    jd, js, jl = _jax_forward(jnp.asarray(s.numpy(), jnp.int32),
                              jnp.asarray(d.numpy(), jnp.int32), n_pad,
                              jnp.asarray(sources, jnp.int32), 100)
    assert levels == jl
    assert np.array_equal(dist.T.numpy(), jd)
    assert np.array_equal(sigma.T.numpy(), js)
    assert sigma.max() >= 5 ** 5


def test_two_run_sums_a_level(monkeypatch):
    calls = []
    real = SC.csr_spmm_sum

    def spy(x, ptr, g=None, w=None, **kw):
        calls.append(x.shape)
        return real(x, ptr, g, w, **kw)

    monkeypatch.setattr(SC, "csr_spmm_sum", spy)
    src, dst = _edges(90, 400, 4)
    stats = {}
    TB.betweenness_centrality(from_coo(src, dst, n_nodes=90), chunk=32,
                              device="cpu", stats=stats)
    assert len(stats["levels"]) == 3
    assert len(calls) == 2 * sum(stats["levels"])
    assert all(shape[1] == 32 for shape in calls)
