"""The port's vector search (memgraph_tpu_torch/ops/knn.py) against the
JAX package's ``ops/knn.py`` on the CPU.

kNN indices must be equal, ties included (``lax.top_k`` puts the lower
index first, among masked -inf rows too).  Scores may differ in their
last bits (the two packages' f32 products add in other orders): they are
held within 1e-6 of the largest finite |score| (or of 1), a few f32 ulps
of it.  k-means: from the reference's own initial rows (the same
``jax.random.choice`` call), on blobs of coinciding points (where Lloyd's
answer does not hang on the last bits: equal centroids tie to the first),
the assignments are equal and the centroids within 1e-4 relative (the
port sums a cluster's m points in order, up to m 2^-24 relative, the
reference by a product); on noisy blobs
seeded one row a blob the assignments equal a float64 Lloyd run's.  IVF
searches carried from a trained reference index (``ivf_from_jax``) give
the same ids.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import knn as jknn
from memgraph_tpu_torch.ops import knn as K

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want):
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    scale = max(1.0, float(np.abs(want[finite]).max(initial=0.0)))
    assert np.abs(got[finite] - want[finite]).max(initial=0.0) \
        <= 1e-6 * scale


def _data(n=3000, d=32, q=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    x[100] = x[200] = x[5]               # duplicates of a row
    queries[0] = x[5]
    mask = (rng.random(n) > 0.1).astype(np.float32)
    return x, queries, mask


def _both(x, queries, k, **kw):
    j_kw = {a: jnp.asarray(b) if isinstance(b, np.ndarray) else b
            for a, b in kw.items()}
    t_kw = {a: torch.from_numpy(b) if isinstance(b, np.ndarray) else b
            for a, b in kw.items()}
    js, ji = jknn.knn(jnp.asarray(x), jnp.asarray(queries), k=k, **j_kw)
    ts, ti = K.knn(torch.from_numpy(x), torch.from_numpy(queries), k, **t_kw)
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


@pytest.mark.parametrize("metric", ["cosine", "l2sq", "dot"])
@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("valid", ["none", "count", "mask"])
def test_knn_matches_the_reference(metric, use_bf16, valid):
    x, queries, mask = _data()
    kw = {"metric": metric, "use_bf16": use_bf16}
    if valid == "count":
        kw["valid_count"] = 2500
    elif valid == "mask":
        kw["valid_mask"] = mask
    js, ji, ts, ti = _both(x, queries, 20, **kw)
    assert ti.dtype == np.int64 and ts.dtype == np.float32
    assert np.array_equal(ti, ji)
    _close(ts, js)


@pytest.mark.parametrize("metric", ["cosine", "l2sq", "dot"])
def test_duplicate_rows_tie_to_the_lower_index(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    copies = [3, 77, 150, 151, 399]
    x[copies] = x[200]
    x[10:40] = x[300]
    queries = x[[200, 300]].copy()
    js, ji, ts, ti = _both(x, queries, 40, metric=metric, use_bf16=False)
    assert np.array_equal(ti, ji)
    # the copies come in ascending index order
    at = [int(np.flatnonzero(ti[0] == c)[0]) for c in sorted(copies + [200])]
    assert at == sorted(at)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_k_above_the_live_rows(use_bf16):
    x, queries, _ = _data(n=500)
    mask = np.zeros(500, dtype=np.float32)
    mask[[3, 50, 7]] = 1.0
    js, ji, ts, ti = _both(x, queries, 10, metric="dot", use_bf16=use_bf16,
                           valid_mask=mask)
    assert np.array_equal(ti, ji)
    assert set(ti[:, :3].ravel()) == {3, 7, 50}
    assert np.array_equal(ti[:, 3:], np.tile([0, 1, 2, 4, 5, 6, 8],
                                             (len(ti), 1)))
    _close(ts, js)


@pytest.mark.parametrize("k", [1, 5, 17, 64])
def test_top_k_with_ties_across_the_kth(k):
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 6, (9, 64)).astype(np.float32)
    scores[0] = 2.0
    scores[1, ::3] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_v, got_i = K.top_k(torch.from_numpy(scores), k)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("metric", ["cosine", "l2sq", "dot"])
def test_a_nan_row_comes_first_as_the_references(metric):
    """A NaN in one corpus row makes that row's score NaN for every query
    (all three metrics); ``lax.top_k`` ranks it above every number."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    x[7, 3] = np.nan
    queries = rng.standard_normal((2, 8)).astype(np.float32)
    js, ji, ts, ti = _both(x, queries, 5, metric=metric, use_bf16=False)
    assert np.array_equal(ti, ji)
    assert (ti[:, 0] == 7).all() and np.isnan(ts[:, 0]).all()
    _close(ts[:, 1:], js[:, 1:])


@pytest.mark.parametrize("k", [1, 3, 6, 20])
def test_top_k_ranks_nan_above_every_number(k):
    """NaNs (several in a row, one across the k-th) and ties around them:
    ``lax.top_k``'s indices and values, NaN first, ties to the lower
    index."""
    rng = np.random.default_rng(k + 40)
    scores = rng.integers(0, 4, (6, 32)).astype(np.float32)
    scores[0, [2, 9, 30]] = np.nan
    scores[1, :] = np.nan
    scores[2, 5] = np.nan
    scores[3, ::2] = np.inf
    scores[3, 1] = np.nan
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_v, got_i = K.top_k(torch.from_numpy(scores), k)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v), equal_nan=True)


def _coinciding_blobs(seed, blobs=8, per=300, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, d)).astype(np.float32) * 5
    return centers[rng.permutation(np.repeat(np.arange(blobs), per))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kmeans_steps_from_the_references_initial_rows(seed):
    points = _coinciding_blobs(seed)
    key = jax.random.PRNGKey(seed)
    cent, assign = jknn.kmeans_fit(jnp.asarray(points), key, 8, iters=10)
    rows = np.asarray(jax.random.choice(key, len(points), shape=(8,),
                                        replace=False))
    got_c, got_a = K.kmeans_steps(torch.from_numpy(points),
                                  torch.from_numpy(points[rows]), 10)
    assert np.array_equal(got_a.numpy(), np.asarray(assign))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(cent), rtol=1e-4)


def lloyd64(points, cent, iters):
    """float64 Lloyd steps (the nearest centroid, the first on a tie)."""
    p, c = points.astype(np.float64), cent.astype(np.float64)

    def assign(c):
        return np.argmin(((p[:, None, :] - c[None]) ** 2).sum(-1), axis=1)

    for _ in range(iters):
        a = assign(c)
        c = np.stack([p[a == j].mean(0) if (a == j).any() else c[j]
                      for j in range(len(c))])
    return c, assign(c)


def test_kmeans_steps_on_noisy_blobs_equal_float64():
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((6, 24)).astype(np.float32) * 4
    blob = rng.integers(0, 6, 2000)
    points = centers[blob] + rng.standard_normal((2000, 24)).astype(
        np.float32)
    rows = np.unique(blob, return_index=True)[1]
    want_c, want_a = lloyd64(points, points[rows], 10)
    got_c, got_a = K.kmeans_steps(torch.from_numpy(points),
                                  torch.from_numpy(points[rows]), 10)
    assert np.array_equal(got_a.numpy(), want_a)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-4)


def test_kmeans_fit_draws_its_rows_from_the_generator():
    points = _coinciding_blobs(5)
    rows = K.kmeans_init(len(points), 8, torch.Generator().manual_seed(4))
    assert len(set(rows.tolist())) == 8
    got = K.kmeans_fit(torch.from_numpy(points), 8,
                       generator=torch.Generator().manual_seed(4))
    want = K.kmeans_steps(torch.from_numpy(points),
                          torch.from_numpy(points)[rows], 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("metric", ["cosine", "l2sq"])
def test_ivf_from_a_trained_reference_index(metric):
    rng = np.random.default_rng(11)
    points = rng.standard_normal((1500, 16)).astype(np.float32)
    index = jknn.IvfIndex(points, n_clusters=16, seed=2)
    port = K.ivf_from_jax(index, device="cpu")
    queries = points[:6] + 0.01
    want_s, want_i = index.search(queries, k=10, n_probe=3, metric=metric)
    got_s, got_i = port.search(queries, k=10, n_probe=3, metric=metric)
    assert got_i.dtype == np.int64
    assert np.array_equal(got_i, want_i)
    _close(got_s, want_s)


def test_ivf_trained_by_the_port_finds_the_exact_neighbors():
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((20, 16)).astype(np.float32) * 4
    points = centers[rng.integers(0, 20, 2000)] + rng.standard_normal(
        (2000, 16)).astype(np.float32)
    index = K.IvfIndex(points, n_clusters=20, seed=1, device="cpu")
    assert index.cell_start[-1] == 2000
    assert sorted(index.order.tolist()) == list(range(2000))
    queries = points[:20]
    _, ids = index.search(queries, k=10, n_probe=4, metric="l2sq")
    _, exact = K.knn(torch.from_numpy(points), torch.from_numpy(queries), 10,
                     "l2sq", use_bf16=False)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(ids, exact.numpy())])
    assert recall >= 0.95
    # fewer members than k: padded
    small = K.IvfIndex(points[:5], n_clusters=2, device="cpu")
    s, i = small.search(points[:1], k=8, n_probe=1, metric="l2sq")
    assert (i[0] == -1).sum() == 8 - (s[0] > -np.inf).sum()


def test_knn_turns_tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        x, queries, _ = _data(n=300)
        K.knn(torch.from_numpy(x), torch.from_numpy(queries), 3)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def _sage_forward():
    from memgraph_tpu_torch.ops import gnn as G
    from memgraph_tpu_torch.ops.csr import from_coo
    rng = np.random.default_rng(2)
    graph = from_coo(rng.integers(0, 30, 90), rng.integers(0, 30, 90),
                     n_nodes=30).to_device("cpu")
    model = G.init_sage_params(16, 8, 4, 2, torch.Generator().manual_seed(0),
                               device="cpu")
    model(G.degree_features(graph, device="cpu"), graph)


def _similarity():
    from memgraph_tpu_torch.ops import similarity as SIM
    from memgraph_tpu_torch.ops.csr import from_coo
    rng = np.random.default_rng(3)
    SIM.similarity_matrix(from_coo(
        rng.integers(0, 30, 90), rng.integers(0, 30, 90),
        n_nodes=30).to_device("cpu"))


@pytest.mark.parametrize("run", [
    lambda: K.kmeans_steps(torch.from_numpy(_data(n=300)[0]),
                           torch.from_numpy(_data(n=300)[0][:4]), 2),
    _similarity,
    _sage_forward,
], ids=["kmeans_steps", "similarity_matrix", "sage_forward"])
def test_dense_entry_points_turn_tf32_off(run):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        run()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


_FRESH = """
import sys, numpy as np, torch
def flags():
    return (f"{torch.backends.cuda.matmul.allow_tf32}/"
            f"{torch.get_float32_matmul_precision()}")
torch.backends.cuda.matmul.allow_tf32 = True
torch.set_float32_matmul_precision("medium")
if sys.argv[1] == "pagerank":
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.pagerank import pagerank
    rng = np.random.default_rng(0)
    g = from_coo(rng.integers(0, 200, 900), rng.integers(0, 200, 900),
                 n_nodes=200).to_device("cpu")
    pagerank(g, max_iterations=5)
before = flags()
from memgraph_tpu_torch.ops.knn import knn
rng = np.random.default_rng(1)
x = torch.from_numpy(rng.standard_normal((2000, 64)).astype(np.float32))
q = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
s, i = knn(x, q, 10, metric="l2sq", use_bf16=False)
sys.stdout.write(before + " " + flags() + " " + s.numpy().tobytes().hex()
                 + " " + i.numpy().tobytes().hex())
"""


def test_fresh_process_knn_scores_do_not_depend_on_pagerank_first():
    """A fresh process that starts with TF32 and the "medium" matmul
    precision on, with and without a PageRank run (MXU forced) before its
    f32 kNN: the matmul flags are full f32 once PageRank has run and once
    kNN has run (the CPU's products ignore TF32, so the flags are what
    can show the hazard here), and the scores are the same bits."""
    env = dict(os.environ, PYTHONPATH=HERE, MEMGRAPH_TPU_FORCE_MXU="1",
               MEMGRAPH_TPU_MXU_MIN_EDGES="0")
    outs = {first: subprocess.run(
        [sys.executable, "-c", _FRESH, first], capture_output=True,
        text=True, env=env, timeout=300, check=True).stdout.split()
        for first in ("knn", "pagerank")}
    assert outs["knn"][0] == "True/medium"
    assert outs["pagerank"][0] == "False/highest"
    assert outs["knn"][1] == outs["pagerank"][1] == "False/highest"
    assert outs["knn"][2:] == outs["pagerank"][2:]
    assert len(outs["knn"]) == 4
