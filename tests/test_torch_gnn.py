"""The port's GraphSAGE inference (memgraph_tpu_torch/ops/gnn.py) against
the JAX package's ``ops/gnn.py`` on the CPU.

The mean aggregation is bit-equal to the reference's on the true rows
(the sink row, index n_nodes, takes no padding edge in the port): both
add each row's neighbor values in the same order from 0.0.  The forward
is held within one bf16 ulp of the largest |h| (2^-7 max |h|): both
round the same values to bfloat16, but the f32 products under each
rounding may add in another order, which can move a rounding by an ulp.
Degree features are bit-equal (the same numpy code); edge scores within
1e-6 relative (a 32-lane f32 dot in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import gnn as jgnn
from memgraph_tpu_torch.ops import gnn as G
from memgraph_tpu_torch.ops import semiring as S
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FORWARD_ULP = 2.0 ** -7


def _graph(n, e, seed, pad=True):
    """A skewed digraph with parallel edges and self loops, in both
    packages."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    src = np.concatenate([src, src[:e // 20], np.arange(5)])
    dst = np.concatenate([dst, dst[:e // 20], np.arange(5)])
    jg = jcsr.from_coo(src, dst, None, n_nodes=n, pad=pad).to_device()
    tg = from_coo(src, dst, None, n_nodes=n, pad=pad).to_device("cpu")
    return jg, tg


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("width", [1, 16, 64, 128])
@pytest.mark.parametrize("n,e,seed,pad", [(300, 2000, 0, True),
                                          (1000, 6000, 1, True),
                                          (257, 900, 2, False)])
def test_mean_aggregate_is_the_references_bits(width, n, e, seed, pad):
    jg, tg = _graph(n, e, seed, pad)
    x = np.random.default_rng(seed + 10).standard_normal(
        (jg.n_pad, width)).astype(np.float32)
    want = np.asarray(jgnn._mean_aggregate(jnp.asarray(x), jg.csc_src,
                                           jg.csc_dst, jg.n_pad))
    got = G._mean_aggregate(torch.from_numpy(x), tg).numpy()
    assert got.shape == want.shape
    assert np.array_equal(_bits(got[:n]), _bits(want[:n]))


@pytest.mark.parametrize("width", [1, 16, 128])
def test_csr_runs_sum_the_stable_sort_routes_bits(width):
    """The transposed direction over the CSR runs (col_idx gathered) is
    the bits of semiring.spmv's route for unsorted keys (a stable sort of
    csc_src, then the run sum) on every true row."""
    jg, tg = _graph(500, 4000, 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (tg.n_pad, width)).astype(np.float32))
    runs = S.SC.csr_spmm_sum(x, tg.row_ptr, tg.col_idx, mul="first",
                             longest=tg.longest_csr_run)
    sorted_route = S.spmv("plus_first", x, tg.csc_dst, tg.csc_src,
                          n_out=tg.n_pad)
    n = tg.n_nodes
    assert torch.equal(runs[:n].view(torch.int32),
                       sorted_route[:n].view(torch.int32))


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("width", [16, 128])
def test_forward_with_carried_params_within_one_bf16_ulp(layers, width):
    jg, tg = _graph(600, 4000, 5)
    x = np.random.default_rng(layers).standard_normal(
        (jg.n_pad, width)).astype(np.float32)
    params = jgnn.init_sage_params(jax.random.PRNGKey(layers), width, 64,
                                   32, layers)
    want = np.asarray(jgnn.sage_forward(params, jnp.asarray(x), jg.csc_src,
                                        jg.csc_dst, jg.n_pad))[:jg.n_nodes]
    model = G.sage_params_from_jax(
        [[np.asarray(a) for a in layer] for layer in params], device="cpu")
    assert model.dims == [width] + [64] * (layers - 1) + [32]
    got = G.sage_forward(model, x, tg).numpy()[:tg.n_nodes]
    assert np.isfinite(got).all()
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= FORWARD_ULP * top


def test_forward_on_degree_features_and_twice_equal():
    jg, tg = _graph(400, 3000, 6)
    params = jgnn.init_sage_params(jax.random.PRNGKey(0), 16, 64, 32, 2)
    want = np.asarray(jgnn.sage_forward(params, jgnn.degree_features(jg),
                                        jg.csc_src, jg.csc_dst,
                                        jg.n_pad))[:400]
    model = G.sage_params_from_jax(params, device="cpu")
    feats = G.degree_features(tg)
    got = G.sage_forward(model, feats, tg)
    assert torch.equal(got, G.sage_forward(model, feats, tg))
    got = got.numpy()[:400]
    assert np.abs(got - want).max() <= FORWARD_ULP * np.abs(want).max()


@pytest.mark.parametrize("dim", [16, 7, 128])
def test_degree_features_are_the_references_bits(dim):
    jg, tg = _graph(700, 5000, 7)
    want = np.asarray(jgnn.degree_features(jg, dim))
    got = G.degree_features(tg, dim, device="cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))


def test_glorot_init_statistics():
    gen = torch.Generator().manual_seed(3)
    model = G.init_sage_params(128, 64, 32, 3, generator=gen, device="cpu")
    assert model.dims == [128, 64, 64, 32]
    for k, (fan_in, fan_out) in enumerate([(128, 64), (64, 64), (64, 32)]):
        std = np.sqrt(2.0 / (fan_in + fan_out))
        for w in (model.w_self[k], model.w_neigh[k]):
            assert w.shape == (fan_in, fan_out) and w.dtype == torch.float32
            assert abs(float(w.std()) / std - 1.0) < 0.1
            assert abs(float(w.mean())) < 4 * std / np.sqrt(w.numel())
        assert torch.equal(model.b[k], torch.zeros(fan_out))
    again = G.init_sage_params(128, 64, 32, 3, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_edge_scores():
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((50, 32)).astype(np.float32)
    src, dst = rng.integers(0, 50, 200), rng.integers(0, 50, 200)
    want = np.asarray(jgnn._edge_scores(jnp.asarray(emb), src, dst))
    got = G._edge_scores(torch.from_numpy(emb), torch.from_numpy(src),
                         torch.from_numpy(dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
