"""Personalized PageRank of the port (memgraph_tpu_torch/ops/pagerank.py:
``personalized_pagerank``, ``personalized_pagerank_batch``,
``ppr_topk``) on the CPU, against the JAX package's.

Models: tests/test_ppr_serving.py:67-124 (batch against sequential, bf16
bounds, warm start, top-k, empty batch and bucketing) and
tests/test_semiring.py's PPR pin.

Tolerances: at tol = 0 the two packages may stop an iteration apart
(where the L1 error first rounds to 0, an f32 accident), so ranks are
held within 1e-6 of the largest entry of JAX's; at a tolerance stop the
iteration counts are equal and the ranks within the same 1e-6.  The
port's batch against its own sequential runs is exact, bit for bit
(every reduction of the loop is B-independent: ops/segment_cuda.py).
bf16 is held within ``PRECISION_BOUNDS["bf16"]`` of f32.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-8
# a stop the two packages take at the same iteration: the L1 error there
# is far above its f32 noise (TOL sits at it, where their differently
# ordered error sums may stop a lane an iteration apart)
STOP = 1e-6


def _skewed(seed=7, n=300, e=3000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), (rng.random(e) ** 2 * n).astype(np.int64), \
        None, n


def _uniform(seed=0, n=300, e=1800):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), None, n


def _weighted_dangling(seed=3, n=250, e=1500):
    """Weighted edges, and a tenth of the nodes with no out-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - n // 10, e)
    dst = rng.integers(0, n, e)
    return src, dst, rng.uniform(0.2, 3.0, e).astype(np.float32), n


GRAPHS = {"skewed": _skewed, "uniform": _uniform,
          "weighted_dangling": _weighted_dangling}


@functools.cache
def _graphs(name):
    src, dst, w, n = GRAPHS[name]()
    return (jcsr.from_coo(src, dst, w, n_nodes=n),
            from_coo(src, dst, w, n_nodes=n).to_device("cpu"))


def _largest_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("sources", [[3, 7], [0], [5, 17, 42, 101]])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ppr_at_tol_zero_matches_jax(name, sources):
    jg, tg = _graphs(name)
    want, _, _ = jpr.personalized_pagerank(jg, sources, tol=0.0)
    got, err, iters = tpr.personalized_pagerank(tg, sources, tol=0.0)
    assert isinstance(err, float) and isinstance(iters, int)
    assert got.shape == (tg.n_nodes,) and got.dtype == torch.float32
    assert _largest_err(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("tol", [1e-4, 1e-6])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ppr_tolerance_stop_matches_jax(name, tol):
    jg, tg = _graphs(name)
    want, jerr, jit = jpr.personalized_pagerank(jg, [3, 7], tol=tol)
    got, err, iters = tpr.personalized_pagerank(tg, [3, 7], tol=tol)
    assert iters == jit
    assert _largest_err(got.numpy(), want) <= 1e-6
    assert err <= tol and abs(err - jerr) <= 1e-6


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_ppr_reduced_precision_matches_jax(precision):
    jg, tg = _graphs("skewed")
    want, _, jit = jpr.personalized_pagerank(jg, [3, 7], tol=STOP,
                                             precision=precision)
    got, _, iters = tpr.personalized_pagerank(tg, [3, 7], tol=STOP,
                                              precision=precision)
    assert iters == jit
    assert _largest_err(got.numpy(), want) <= 1e-6


def _sets(n, lanes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.choice(n, size=int(rng.integers(1, 6)), replace=False)
            for _ in range(lanes)]


@pytest.mark.parametrize("lanes", [1, 3, 6, 17])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_batch_lanes_are_bit_equal_to_sequential_runs(name, lanes):
    _, tg = _graphs(name)
    sets = _sets(tg.n_nodes, lanes)
    ranks, err, iters = tpr.personalized_pagerank_batch(tg, sets, tol=TOL)
    assert ranks.shape == (lanes, tg.n_nodes) and iters.dtype == np.int32
    for lane, sources in enumerate(sets):
        got, e, it = tpr.personalized_pagerank(tg, sources, tol=TOL)
        assert np.array_equal(got.numpy().view(np.int32),
                              ranks[lane].view(np.int32))
        assert it == int(iters[lane]) and np.float32(e) == err[lane]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_batch_matches_jax(name, precision):
    jg, tg = _graphs(name)
    sets = _sets(tg.n_nodes, 6, seed=2)
    want, _, jit = jpr.personalized_pagerank_batch(jg, sets, tol=STOP,
                                                   precision=precision)
    got, _, iters = tpr.personalized_pagerank_batch(tg, sets, tol=STOP,
                                                    precision=precision)
    assert np.array_equal(iters, np.asarray(jit))
    assert _largest_err(got, want) <= 1e-6


def test_batched_bf16_within_precision_bounds():
    """tests/test_ppr_serving.py:test_batched_bf16_within_precision_bounds
    on the port."""
    _, tg = _graphs("uniform")
    sets = [[3], [7, 11], [42]]
    f32, _, _ = tpr.personalized_pagerank_batch(tg, sets, tol=TOL)
    bf16, _, _ = tpr.personalized_pagerank_batch(tg, sets, tol=TOL,
                                                 precision="bf16")
    bounds = PRECISION_BOUNDS["bf16"]
    assert np.abs(bf16 - f32).max() <= bounds["pagerank_linf"]
    assert np.abs(bf16 - f32).sum(axis=1).max() <= bounds["pagerank_l1"]


def test_warm_start_converges_no_slower_than_cold():
    _, tg = _graphs("uniform")
    sets = [[3], [7], [11, 13]]
    cold, _, cold_iters = tpr.personalized_pagerank_batch(tg, sets, tol=TOL)
    x0 = np.zeros((tg.n_pad, len(sets)), dtype=np.float32)
    x0[:tg.n_nodes] = cold.T
    _, _, warm_iters = tpr.personalized_pagerank_batch(tg, sets, tol=TOL,
                                                       x0=x0)
    assert (warm_iters <= cold_iters).all()
    assert warm_iters.max() <= 2


def test_warm_start_matches_jax():
    jg, tg = _graphs("skewed")
    sets = _sets(tg.n_nodes, 3, seed=4)
    cold, _, _ = tpr.personalized_pagerank_batch(tg, sets, tol=1e-4)
    x0 = np.zeros((tg.n_pad, len(sets)), dtype=np.float32)
    x0[:tg.n_nodes] = cold.T
    want, _, jit = jpr.personalized_pagerank_batch(jg, sets, tol=STOP,
                                                   x0=x0)
    got, _, iters = tpr.personalized_pagerank_batch(tg, sets, tol=STOP,
                                                    x0=x0)
    assert np.array_equal(iters, np.asarray(jit))
    assert _largest_err(got, want) <= 1e-6


def test_personalization_matrix_input():
    _, tg = _graphs("skewed")
    sets = _sets(tg.n_nodes, 3, seed=5)
    pm = np.zeros((tg.n_pad, 3), dtype=np.float32)
    for lane, sources in enumerate(sets):
        pm[sources, lane] = 1.0
    a, _, ia = tpr.personalized_pagerank_batch(tg, pm, tol=TOL)
    b, _, ib = tpr.personalized_pagerank_batch(tg, sets, tol=TOL)
    assert np.array_equal(a, b) and np.array_equal(ia, ib)


def test_empty_batch_and_lane_bucketing():
    _, tg = _graphs("uniform")
    ranks, err, iters = tpr.personalized_pagerank_batch(tg, [], tol=TOL)
    assert ranks.shape == (0, tg.n_nodes)
    assert err.shape == iters.shape == (0,)
    # 3 lanes pad to the 4-bucket; padding lanes must not leak out
    ranks3, err3, iters3 = tpr.personalized_pagerank_batch(
        tg, [[1], [2], [3]], tol=TOL)
    assert ranks3.shape == (3, tg.n_nodes) and err3.shape == (3,)
    x, err, iters = tpr.personalized_pagerank_batch(
        tg, [[1], [2], [3]], tol=TOL, raw=True)
    assert isinstance(x, torch.Tensor) and x.shape == (tg.n_pad, 4)
    assert iters.shape == (4,)
    # the padding lane restarts on lane 0's sources
    assert torch.equal(x[:, 3], x[:, 0])
    assert np.array_equal(x[:tg.n_nodes, :3].T.numpy(), ranks3)


@pytest.mark.parametrize("b,bucket", [(1, 1), (2, 2), (3, 4), (5, 8),
                                      (17, 32), (128, 128), (130, 130)])
def test_lane_buckets(b, bucket):
    assert tpr._bucket_lanes(b) == bucket == jpr._bucket_lanes(b)


def test_max_iterations_stops_every_lane():
    _, tg = _graphs("skewed")
    _, err, iters = tpr.personalized_pagerank_batch(
        tg, _sets(tg.n_nodes, 4), tol=TOL, max_iterations=3)
    assert (iters == 3).all() and (err > TOL).all()


@pytest.mark.parametrize("k", [1, 5, 40, 400])
def test_topk_matches_jax_with_ties(k):
    """Ties are common once k passes the reachable set: sources with no
    out-edge keep their mass and every other entry is 0."""
    jg, tg = _graphs("weighted_dangling")
    n = tg.n_nodes
    dangling = [n - 1, n - 2]
    sets = [[3], dangling, [n - 3, 5]]
    ranks, _, _ = tpr.personalized_pagerank_batch(tg, sets, tol=TOL)
    assert (ranks[1] == 0).sum() >= n - 2
    vals, idx = tpr.ppr_topk(ranks, n, k, device="cpu")
    jvals, jidx = jpr.ppr_topk(ranks, n, k)
    kk = min(k, n)
    assert vals.shape == idx.shape == (3, kk) and idx.dtype == np.int32
    assert np.array_equal(vals, np.asarray(jvals))
    assert np.array_equal(idx, np.asarray(jidx))
    for lane in range(3):
        want = np.sort(ranks[lane])[::-1][:kk]
        assert np.array_equal(vals[lane], want)
        assert np.array_equal(ranks[lane][idx[lane]], vals[lane])


def test_topk_raw_stays_a_tensor():
    _, tg = _graphs("skewed")
    x, _, _ = tpr.personalized_pagerank_batch(tg, [[3], [4]], tol=TOL,
                                              raw=True)
    vals, idx = tpr.ppr_topk(x.T, tg.n_nodes, 10, raw=True)
    assert isinstance(vals, torch.Tensor) and vals.shape == (2, 10)
    assert idx.dtype == torch.int32


def test_kernel_route_is_not_ported(tmp_path):
    """The kernel route exists now (server/kernel_server.py): with no
    daemon on the socket the call falls back to the in-process run,
    loudly (counted), with the in-process bits."""
    from memgraph_tpu_torch.utils.metrics import global_metrics
    _, tg = _graphs("skewed")
    before = global_metrics.value("analytics.kernel_route_fallback_total")
    got, _, iters = tpr.personalized_pagerank(
        tg, [3], tol=STOP, kernel=str(tmp_path / "nothing.sock"))
    want, _, want_iters = tpr.personalized_pagerank(tg, [3], tol=STOP)
    assert torch.equal(got, want) and iters == want_iters
    assert global_metrics.value("analytics.kernel_route_fallback_total") \
        == before + 1


def test_no_quiet_cpu_path_without_a_card(monkeypatch):
    src, dst, w, n = _uniform()
    host = from_coo(src, dst, w, n_nodes=n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpr.personalized_pagerank(host, [3]),
                 lambda: tpr.personalized_pagerank_batch(host, [[3]]),
                 lambda: tpr.ppr_topk(np.ones((2, 5), np.float32), 5, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got, _, _ = tpr.personalized_pagerank(host, [3], device="cpu")
    assert got.device.type == "cpu"


def test_jax_stays_on_the_cpu():
    assert jax.default_backend() == "cpu"
