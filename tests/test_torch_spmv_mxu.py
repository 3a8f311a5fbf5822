"""The port's MXU plan (memgraph_tpu_torch/ops/spmv_mxu.py) against the JAX
package's: identical plans from identical edges, and one JAX plan carried
across (``plan_from_arrays``) into both packages' kernels on the CPU.

Tolerances: the plan build is the same numpy code in both packages, so its
arrays are equal.  The Benes route is exact.  Ranks differ only by the
order of f32 sums (XLA-CPU einsums against torch bmm, and L1 err sums), a
few f32 ulps per iteration: rtol 1e-5 with atol 1e-9 (ranks here are
1e-4..6e-2; measured differences stay below 4e-7 relative).  Fixed-length
runs pass tol=-1 (err >= 0, so both run exactly max_iterations; with tol=0
a run stops where err first rounds to exactly 0, which can land an
iteration apart between the packages).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import spmv_mxu as J
from memgraph_tpu_torch.ops import spmv_mxu as T

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-9


def _graph(n, e, skew, seed, weighted=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (((rng.random(e) ** 2) * n).astype(np.int64)
           if skew else rng.integers(0, n, e))
    w = rng.random(e).astype(np.float32) + 0.1 if weighted else None
    return src, dst, w


GRAPHS = {
    "small": (200, 1500, False, 242, False),
    "skewed": (3000, 30000, True, 3042, False),
    "weighted": (500, 3000, False, 5, True),
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_plan_matches_the_jax_package(name, normalize):
    n, e, skew, seed, weighted = GRAPHS[name]
    src, dst, w = _graph(n, e, skew, seed, weighted)
    if name == "weighted":
        src = src % (n // 2)         # a tail of dangling nodes
    want = J.build_plan(src, dst, w, n, normalize=normalize)
    got = T.build_plan(src, dst, w, n, normalize=normalize)
    for f in dataclasses.fields(J.MXUPlan):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _carried(name):
    n, e, skew, seed, weighted = GRAPHS[name]
    src, dst, w = _graph(n, e, skew, seed, weighted)
    jplan = J.build_plan(src, dst, w, n)
    return jplan, T.plan_from_arrays(dataclasses.asdict(jplan))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["small", "skewed"])
def test_carried_plan_feeds_both_kernels(name, precision):
    jplan, tplan = _carried(name)
    jdt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    tdt = torch.bfloat16 if precision == "bf16" else torch.float32
    jrank, jerr, jit = J.make_pagerank_kernel(jplan, route_dtype=jdt)(
        None, jnp.float32(0.85), 25, jnp.float32(-1.0))
    trank, terr, tit = T.make_pagerank_kernel(
        tplan, route_dtype=tdt, device="cpu")(None, 0.85, 25, -1.0)
    assert tit == int(jit)
    np.testing.assert_allclose(trank.numpy(), np.asarray(jrank),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(terr, float(jerr), rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_carried_plan_stops_at_the_same_iteration(tol):
    jplan, tplan = _carried("skewed")
    _, jerr, jit = J.make_pagerank_kernel(jplan)(
        None, jnp.float32(0.85), 100, jnp.float32(tol))
    _, terr, tit = T.make_pagerank_kernel(tplan, device="cpu")(
        None, 0.85, 100, tol)
    assert 1 < tit < 100
    assert tit == int(jit)
    assert terr <= tol and float(jerr) <= tol


def test_carried_plan_warm_start_matches():
    jplan, tplan = _carried("small")
    x0 = np.random.default_rng(0).random(len(jplan.valid_out)).astype(
        np.float32) * jplan.valid_out
    x0 /= x0.sum()
    jrank, _, jit = J.make_pagerank_kernel(jplan)(
        jnp.asarray(x0), jnp.float32(0.85), 10, jnp.float32(-1.0))
    trank, _, tit = T.make_pagerank_kernel(tplan, device="cpu")(
        x0, 0.85, 10, -1.0)
    assert tit == int(jit) == 10
    np.testing.assert_allclose(trank.numpy(), np.asarray(jrank),
                               rtol=RTOL, atol=ATOL)


def test_pagerank_mxu_matches_the_jax_package():
    src, dst, _ = _graph(1000, 8000, True, 1042)
    want, _, jit = J.pagerank_mxu(src, dst, None, 1000, max_iterations=25,
                                  tol=-1.0)
    got, _, tit = T.pagerank_mxu(src, dst, None, 1000, max_iterations=25,
                                 tol=-1.0, device="cpu")
    assert tit == jit
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_save_and_load_plan_round_trip(tmp_path):
    _, plan = _carried("small")
    path = str(tmp_path / "plan.npz")
    T.save_plan(plan, path)
    back = T.load_plan(path)
    for f in dataclasses.fields(T.MXUPlan):
        a, b = getattr(plan, f.name), getattr(back, f.name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b), f.name
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert T.load_plan(str(tmp_path / "bad.npz")) is None
    assert T.load_plan(str(tmp_path / "missing.npz")) is None
