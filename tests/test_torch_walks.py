"""The port's random walks (memgraph_tpu_torch/ops/walks.py) against the
JAX package's ``ops/walks.py`` on the CPU.

The two packages draw from different generators (``jax.random`` and
``torch.Generator``), so single walks differ; what is held:
- every step is an edge, or a stall at a node with no out-edge;
- the skip-gram pairs are the reference's bits on the same walks;
- at p = q = 1 the next node from a node is uniform over its CSR row
  (a chi-square test, p-value above 1e-4);
- at p = 0.5, q = 2 each (prev, cur) -> next frequency of the port and
  of the reference's own kernel lies within 5 binomial standard errors
  of the probability the single-retry rule gives (float64 from the
  graph), and the two within 5 standard errors of their difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import walks as jwalks
from memgraph_tpu_torch.ops import walks as W
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SIGMAS = 5.0


def _graph(seed, n=40, e=160, sinks=4, both_ways=True):
    """Random edges (both ways when asked, so that returns happen), with
    parallel edges, self loops and ``sinks`` nodes that have no
    out-edge."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if both_ways:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    src = np.concatenate([src, src[:7], [1, 2]])
    dst = np.concatenate([dst, dst[:7], [1, 2]])
    keep = src >= sinks                  # nodes 0..sinks-1 have no out-edge
    return src[keep], dst[keep], n


def _steps_are_edges(walks, src, dst, n):
    edges = set(zip(src.tolist(), dst.tolist()))
    has_out = np.zeros(n, bool)
    has_out[src] = True
    for a, b in zip(walks[:, :-1].ravel().tolist(),
                    walks[:, 1:].ravel().tolist()):
        assert (a, b) in edges or (a == b and not has_out[a])


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
def test_every_step_is_an_edge_or_a_stall(p, q):
    src, dst, n = _graph(0)
    g = from_coo(src, dst, n_nodes=n)
    starts = np.tile(np.arange(n), 5)
    walks = W.random_walks(g, starts, 12, torch.Generator().manual_seed(3),
                           p=p, q=q, device="cpu")
    assert walks.shape == (5 * n, 13) and walks.dtype == torch.int32
    w = walks.numpy()
    assert np.array_equal(w[:, 0], starts)
    _steps_are_edges(w, src, dst, n)
    assert (w[:, 1:] == w[:, :1]).all(axis=1)[starts < 4].all()
    again = W.random_walks(g, starts, 12, torch.Generator().manual_seed(3),
                           p=p, q=q, device="cpu")
    assert torch.equal(walks, again)


@pytest.mark.parametrize("window,length", [(1, 8), (3, 8), (5, 21), (6, 4)])
def test_skipgram_pairs_are_the_references(window, length):
    rng = np.random.default_rng(window)
    walks = rng.integers(0, 100, (17, length)).astype(np.int32)
    want = np.asarray(jwalks.walks_to_skipgram_pairs(jnp.asarray(walks),
                                                     window))
    got = W.walks_to_skipgram_pairs(torch.from_numpy(walks), window)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_first_order_is_uniform_over_the_row():
    src, dst, n = _graph(1, n=200, e=3000, sinks=0, both_ways=False)
    g = from_coo(src, dst, n_nodes=n)
    hub = int(np.bincount(src, minlength=n).argmax())
    row = dst[src == hub]
    walks = W.random_walks(g, np.full(40_000, hub), 1,
                           torch.Generator().manual_seed(5), device="cpu")
    counts = np.bincount(walks[:, 1].numpy(), minlength=n)
    expected = np.bincount(row, minlength=n) / len(row) * 40_000
    used = expected > 0
    assert counts[~used].sum() == 0
    assert scipy.stats.chisquare(counts[used], expected[used]).pvalue > 1e-4


def _rule(src, dst, n, p, q):
    """P(next | prev, cur) of the reference's single-retry rule, float64:
    a uniform candidate over cur's row accepted with α / max(1, 1/p,
    1/q), else a second uniform candidate."""
    rows = [dst[src == v] for v in range(n)]
    linked = [set(r.tolist()) for r in rows]
    limit = max(1.0, 1.0 / p, 1.0 / q)

    def probs(prev, cur):
        row = rows[cur]
        if len(row) == 0:
            return {cur: 1.0}
        alpha = np.where(row == prev, 1.0 / p,
                         np.where([x in linked[prev] for x in row], 1.0,
                                  1.0 / q)) / limit
        reject = float(np.mean(1.0 - alpha))
        out = {}
        for x, a in zip(row.tolist(), alpha):
            out[x] = out.get(x, 0.0) + (a + reject) / len(row)
        return out
    return probs


def _transitions(walks):
    """(prev, cur, next) counts from the second step on."""
    w = np.asarray(walks)
    triples = np.stack([w[:, :-2].ravel(), w[:, 1:-1].ravel(),
                        w[:, 2:].ravel()], axis=1)
    keys, counts = np.unique(triples, axis=0, return_counts=True)
    return {tuple(k): c for k, c in zip(keys.tolist(), counts)}


def test_biased_transitions_match_the_references_kernel_and_the_rule():
    src, dst, n = _graph(2, n=24, e=60, sinks=2)
    p, q = 0.5, 2.0
    starts = np.tile(np.arange(n), 800)
    jg = jcsr.from_coo(src, dst, n_nodes=n).to_device()
    ref = jwalks.random_walks(jg, starts, 8, key=jax.random.PRNGKey(0), p=p,
                              q=q)
    got = W.random_walks(from_coo(src, dst, n_nodes=n), starts, 8,
                         torch.Generator().manual_seed(0), p=p, q=q,
                         device="cpu")
    rule = _rule(src, dst, n, p, q)
    by = [_transitions(ref), _transitions(got.numpy())]
    contexts = {k[:2] for t in by for k in t}
    checked = 0
    for prev, cur in contexts:
        totals = [sum(c for k, c in t.items() if k[:2] == (prev, cur))
                  for t in by]
        if min(totals) < 200:
            continue
        want = rule(prev, cur)
        for nxt in set(want) | {k[2] for t in by for k in t
                                if k[:2] == (prev, cur)}:
            f = [t.get((prev, cur, nxt), 0) / tot
                 for t, tot in zip(by, totals)]
            pr = want.get(nxt, 0.0)
            for fi, tot in zip(f, totals):
                assert abs(fi - pr) <= SIGMAS * np.sqrt(
                    pr * (1 - pr) / tot) + 1e-12
            assert abs(f[0] - f[1]) <= SIGMAS * np.sqrt(
                pr * (1 - pr) * (1 / totals[0] + 1 / totals[1])) + 1e-12
            checked += 1
    assert checked >= 100
