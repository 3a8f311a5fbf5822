"""The port's semiring core (memgraph_tpu_torch/ops/semiring.py) on the
CPU, against the JAX package's (memgraph_tpu/ops/semiring.py).

Models: tests/test_semiring.py (the table against numpy, masks and
``mask_fill``, ``select_pull``, push against pull).  Every check of
``spmv`` and ``edge_reduce`` here is exact, bit for bit:

  * min, max and or are exact in any order, and so are integer sums;
  * a float32 sum adds each segment in edge order from 0.0 on the port
    (the run sum of ops/segment_cuda.py, ``index_add_`` in edge order on
    the CPU), and XLA's CPU segment_sum adds in the same order here;
  * bf16 rounds each contribution once at the same place in both; int8
    dequantizes per node on the port and per edge in the reference, the
    same value.

The plus-times ``fixpoint`` runs are held to rtol 1e-6 with the same
iteration count (the reference's jitted epilogue may fuse a multiply-add
that the port rounds twice); the min-label ones are exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import semiring as JS
from memgraph_tpu_torch.ops import semiring as TS

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N, E = 40, 300
MODES = ("plain", "mask", "mask_fill", "frontier")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@functools.cache
def _edges(sorted_keys: bool):
    rng = np.random.default_rng(3)
    src = rng.integers(0, N, E)
    # the last 5 rows get no edge: empty segments
    dst = rng.integers(0, N - 5, E)
    if sorted_keys:
        dst = np.sort(dst)
    w = rng.uniform(0.1, 2.0, E).astype(np.float32)
    mask = rng.random(E) < 0.7
    frontier = rng.random(N) < 0.3
    return src, dst, w, mask, frontier


def _inputs(name, lanes):
    rng = np.random.default_rng(5)
    shape = (N,) if lanes is None else (N, lanes)
    x = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    src, dst, w, mask, frontier = _edges(True)
    if name == "or_and":
        return x > 0.5, w > 1.0
    if name == "min_first":
        return (x * 1000).astype(np.int32), w
    return x, w


def _case(name, precision):
    return not (name in ("or_and", "min_first") and precision != "f32")


CASES = [(name, precision) for name in sorted(JS.SEMIRINGS)
         for precision in ("f32", "bf16", "int8") if _case(name, precision)]


def _run_both(name, x, src, dst, w, mode, **kw):
    _, _, _, mask, frontier = _edges(True)
    jkw, tkw = dict(kw), dict(kw)
    if mode in ("mask", "mask_fill"):
        jkw["mask"] = jnp.asarray(mask)
        tkw["mask"] = torch.from_numpy(mask)
    if mode == "mask_fill":
        fill = 7 if x.dtype == np.int32 else 0.25
        if x.dtype == bool:
            fill = True
        jkw["mask_fill"] = fill
        tkw["mask_fill"] = fill
    if mode == "frontier":
        jkw["frontier"] = jnp.asarray(frontier)
        tkw["frontier"] = torch.from_numpy(frontier)
    want = JS.spmv(name, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                   jnp.asarray(w), n_out=N, **jkw)
    got = TS.spmv(name, torch.from_numpy(np.ascontiguousarray(x)),
                  torch.from_numpy(src), torch.from_numpy(dst),
                  torch.from_numpy(np.ascontiguousarray(w)), n_out=N, **tkw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("name,precision", CASES)
def test_spmv_every_semiring_matches_jax(name, precision, lanes, mode):
    x, w = _inputs(name, lanes)
    src, dst, _, _, _ = _edges(True)
    want, got = _run_both(name, x, src, dst, w, mode, sorted=True,
                          precision=precision)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("name", ["plus_times", "plus_first", "min_plus",
                                  "max_min"])
def test_spmv_unsorted_keys_match_jax(name, lanes):
    """Unsorted keys: the port stably sorts a float sum first, so each
    segment still adds in edge order."""
    x, w = _inputs(name, lanes)
    src, dst, _, _, _ = _edges(False)
    want, got = _run_both(name, x, src, dst, w, "plain")
    assert np.array_equal(_bits(got), _bits(want))


def test_spmv_given_runs_equal_searched_runs():
    x, w = _inputs("plus_times", 3)
    src, dst, _, _, _ = _edges(True)
    args = (torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(w))
    ptr = torch.from_numpy(np.searchsorted(dst, np.arange(N + 1))).int()
    a = TS.spmv("plus_times", *args, n_out=N, sorted=True)
    b = TS.spmv("plus_times", *args, n_out=N, ptr=ptr)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_spmv_masked_uses_fill():
    """tests/test_semiring.py:test_spmv_masked_uses_fill, on the port."""
    src, dst = torch.tensor([0, 1]), torch.tensor([2, 2])
    x = torch.tensor([5, 7], dtype=torch.int32)
    got = TS.spmv("min_first", x, src, dst, n_out=3,
                  mask=torch.tensor([False, True]), mask_fill=99)
    assert int(got[2]) == 7
    got = TS.spmv("min_first", x, src, dst, n_out=3,
                  mask=torch.tensor([False, False]), mask_fill=99)
    assert int(got[2]) == 99


def test_spmv_or_and_reachability():
    got = TS.spmv("or_and", torch.tensor([True, True, False, False]),
                  torch.tensor([0, 1]), torch.tensor([1, 2]),
                  torch.tensor([True, True]), n_out=4)
    assert got.tolist() == [False, True, True, False]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("kind", ["sum", "min", "max", "or"])
@pytest.mark.parametrize("sorted_keys", [True, False])
def test_edge_reduce_matches_jax_with_empty_segments(kind, dtype,
                                                     sorted_keys):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, N - 5, E)
    if sorted_keys:
        ids = np.sort(ids)
    vals = (rng.uniform(-50, 50, (E, 2))).astype(dtype)
    want = JS.edge_reduce(kind, jnp.asarray(vals), jnp.asarray(ids), N,
                          sorted=sorted_keys)
    got = TS.edge_reduce(kind, torch.from_numpy(vals), torch.from_numpy(ids),
                         N, sorted=sorted_keys)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_edge_reduce_refuses_other_floats_and_kinds():
    ids = torch.tensor([0, 1])
    with pytest.raises(TypeError):
        TS.edge_reduce("sum", torch.ones(2, dtype=torch.float64), ids, 2)
    with pytest.raises(ValueError):
        TS.edge_reduce("prod", torch.ones(2), ids, 2)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(JS.SEMIRINGS))
def test_reduce_identity_matches_jax(name, dtype):
    want = np.asarray(JS.reduce_identity(name, getattr(jnp, dtype)))
    got = TS.reduce_identity(name, getattr(torch, dtype))
    assert got.dim() == 0
    assert float(got.float()) == float(want.astype(np.float32))
    assert (got.dtype == torch.bool) == (want.dtype == bool)


@pytest.mark.parametrize("name", sorted(JS.SEMIRINGS))
def test_combine_accumulators_matches_jax(name):
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, 20).astype(np.float32)
    b = rng.uniform(-1, 1, 20).astype(np.float32)
    if name == "or_and":
        a, b = a > 0, b > 0
    want = np.asarray(JS.combine_accumulators(name, jnp.asarray(a),
                                              jnp.asarray(b)))
    got = TS.combine_accumulators(name, torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mul", ["times", "plus", "min", "and", "first"])
def test_edge_combine_broadcasts_edge_values_over_lanes(mul):
    sr = TS.Semiring("t", "sum", mul)
    xe = torch.arange(12, dtype=torch.float32).view(4, 3)
    w = torch.tensor([1.0, 0.0, 2.0, 3.0])
    got = TS.edge_combine(sr, xe, w)
    want = JS.edge_combine(JS.Semiring("t", "sum", mul), jnp.asarray(xe),
                           jnp.asarray(w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    if mul != "first":
        with pytest.raises(ValueError):
            TS.edge_combine(sr, xe)


def test_semiring_table_and_resolution():
    assert {k: (s.add, s.mul) for k, s in TS.SEMIRINGS.items()} == \
        {k: (s.add, s.mul) for k, s in JS.SEMIRINGS.items()}
    assert TS.resolve_semiring("min_plus") is TS.SEMIRINGS["min_plus"]
    sr = TS.Semiring("x", "max", "plus")
    assert TS.resolve_semiring(sr) is sr
    with pytest.raises(KeyError):
        TS.resolve_semiring("plus_plus")
    with pytest.raises(ValueError):
        TS.Semiring("x", "prod", "times")


def test_select_pull_threshold():
    """tests/test_semiring.py:test_select_pull_threshold, on the port."""
    deg = torch.full((100,), 10.0)
    sparse = torch.zeros(100, dtype=torch.bool)
    sparse[0] = True
    dense = torch.ones(100, dtype=torch.bool)
    assert not bool(TS.select_pull(sparse, deg, 1000.0))
    assert bool(TS.select_pull(dense, deg, 1000.0))


@pytest.mark.parametrize("alpha", [None, 2.0, 50.0])
@pytest.mark.parametrize("density", [0.01, 0.07, 0.2, 0.9])
def test_select_pull_matches_jax(density, alpha):
    rng = np.random.default_rng(int(density * 100))
    deg = rng.integers(0, 20, 500).astype(np.float32)
    frontier = rng.random(500) < density
    n_edges = np.float32(deg.sum())
    want = bool(JS.select_pull(jnp.asarray(frontier), jnp.asarray(deg),
                               n_edges, alpha))
    got = TS.select_pull(torch.from_numpy(frontier), torch.from_numpy(deg),
                         n_edges, alpha)
    assert got.dim() == 0 and bool(got) == want


def test_direction_alpha_matches_the_reference():
    assert TS.DIRECTION_ALPHA == JS.DIRECTION_ALPHA


def _label_epilogue(comp, acc, env, P):
    if isinstance(comp, torch.Tensor):
        new = torch.minimum(comp, acc)
        return new, torch.any(new != comp)
    new = jnp.minimum(comp, acc)
    return new, jnp.any(new != comp)


@pytest.mark.parametrize("max_iterations", [2, 200])
def test_fixpoint_changed_metric_both_directions_matches_jax(max_iterations):
    """min-label propagation over both directions (WCC without the
    pointer jumping) through both packages' ``fixpoint``."""
    rng = np.random.default_rng(13)
    n, e = 60, 50
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x0 = np.arange(n, dtype=np.int32)
    jx, jm, jit = JS.fixpoint(
        "min_first", arrays={"src": jnp.asarray(src), "dst": jnp.asarray(dst)},
        x0=jnp.asarray(x0), n_out=n, epilogue=_label_epilogue,
        max_iterations=max_iterations, metric="changed", direction="both")
    tx, tm, tit = TS.fixpoint(
        "min_first", arrays={"src": torch.from_numpy(src),
                             "dst": torch.from_numpy(dst)},
        x0=torch.from_numpy(x0), n_out=n, epilogue=_label_epilogue,
        max_iterations=max_iterations, metric="changed", direction="both")
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert tit == int(jit) and tm == bool(jm)
    assert isinstance(tm, bool)


def _damped(x, acc, env, P):
    if isinstance(x, torch.Tensor):
        new = 0.15 + 0.85 * acc
        return new, torch.sum(torch.abs(new - x))
    new = 0.15 + 0.85 * acc
    return new, jnp.sum(jnp.abs(new - x))


@pytest.mark.parametrize("direction,tol", [("fwd", 1e-6), ("fwd", -1.0),
                                           ("both", -1.0)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fixpoint_err_metric_sorted_sums_match_jax(precision, direction,
                                                   tol):
    """A plus-times fixpoint over sorted CSC keys (and, both ways, the
    reversed edges over unsorted keys) with an err metric: stopped by the
    tolerance at the same iteration, or run to a fixed length.  rtol 1e-6:
    XLA may fuse the epilogue's multiply-add, the port rounds each op."""
    rng = np.random.default_rng(17)
    n, e = 50, 400
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    w = (rng.uniform(0.0, 1.0, e) / 12).astype(np.float32)
    params = {"tol": np.float32(tol)}
    x0 = np.ones(n, dtype=np.float32)
    kw = dict(params=params, n_out=n, epilogue=_damped, max_iterations=30,
              precision=precision, sorted=True, sorted_backward=False,
              direction=direction)
    jx, jm, jit = JS.fixpoint(
        "plus_times", arrays={"src": jnp.asarray(src),
                              "dst": jnp.asarray(dst), "w": jnp.asarray(w)},
        x0=jnp.asarray(x0), **kw)
    tx, tm, tit = TS.fixpoint(
        "plus_times", arrays={"src": torch.from_numpy(src),
                              "dst": torch.from_numpy(dst),
                              "w": torch.from_numpy(w)},
        x0=torch.from_numpy(x0), **kw)
    assert tit == int(jit) and isinstance(tm, float)
    assert (tit < 30) == (tol > 0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6)


def test_fixpoint_step_hook_and_setup_x0():
    calls = []

    def setup(A, P, n_out):
        return {"x0": torch.zeros(n_out), "k": 2.0}

    def step(x, A, env, P, n_out):
        calls.append(1)
        return x + env["k"]

    def epilogue(x, acc, env, P):
        return acc, torch.tensor(float(acc.max() < 6))

    x, m, it = TS.fixpoint("plus_times", arrays={"src": torch.zeros(1)},
                           params={"tol": 0.5}, n_out=4, setup=setup,
                           step=step, epilogue=epilogue, max_iterations=10)
    assert it == len(calls) == 3 and x.tolist() == [6.0] * 4 and m == 0.0


@pytest.mark.parametrize("bad", [{"metric": "delta"},
                                 {"direction": "back"},
                                 {"precision": "fp8"}])
def test_fixpoint_refuses_unknown_options(bad):
    with pytest.raises(ValueError):
        TS.fixpoint("plus_times", arrays={}, n_out=1, epilogue=_damped,
                    max_iterations=1, **bad)


def test_route_backend_keeps_non_sum_semirings_off_the_mxu_plan(monkeypatch):
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")

    class G:
        n_edges = 10 ** 7

    cpu = torch.device("cpu")
    assert TS.route_backend(G, cpu) == ("mxu", None)
    assert TS.route_backend(G, cpu, semiring="plus_first") == ("mxu", None)
    for name in ("min_first", "min_plus", "max_min", "or_and"):
        assert TS.route_backend(G, cpu, semiring=name) == ("segment", None)
    assert TS.route_backend(G, cpu, precision="int8") == ("segment", None)
