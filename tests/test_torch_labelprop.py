"""The port's label propagation (memgraph_tpu_torch/ops/labelprop.py)
against the JAX package's ``label_propagation`` on the CPU.

Labels and iteration counts must be equal: the election is exact (sorts,
min / max reductions, comparisons) except the run weights, f32 sums that
both packages add in edge order within a (dst, label) run.  On unit
weights those sums are small integers, exact in any order; on the random
weighted graphs here the two packages' sums agree as well (the JAX
package's ``lax.sort`` is not promised stable on equal keys, which would
only reorder a run's weights).
"""

import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops.labelprop import label_propagation as jax_lp
from memgraph_tpu_torch.ops import segment_cuda as SC
from memgraph_tpu_torch.ops import semiring as S
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.labelprop import label_propagation

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _graph(n, e, seed, weighted):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    w = (rng.integers(1, 5, e) * 0.5 + rng.random(e)).astype(np.float32) \
        if weighted else None
    return src, dst, w


def _both(src, dst, w, n, pad=True, **kw):
    jg = jcsr.from_coo(src, dst, w, n_nodes=n, pad=pad).to_device()
    tg = from_coo(src, dst, w, n_nodes=n, pad=pad).to_device("cpu")
    want, jit = jax_lp(jg, **kw)
    got, it = label_propagation(tg, **kw)
    return np.asarray(want), int(jit), got, it


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("directed", [False, True])
def test_labels_and_iterations_equal_the_jax_package(seed, weighted,
                                                     directed):
    n, e = (300, 1500) if seed < 2 else (2000, 6000)
    src, dst, w = _graph(n, e, seed, weighted)
    want, jit, got, it = _both(src, dst, w, n, directed=directed)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert it == jit
    assert np.array_equal(got, want)


@pytest.mark.parametrize("self_weight", [0.5, 1.0, 2.0, 3.0])
def test_self_weight(self_weight):
    src, dst, _ = _graph(400, 1600, 4, False)
    want, jit, got, it = _both(src, dst, None, 400, self_weight=self_weight)
    assert it == jit and np.array_equal(got, want)


@pytest.mark.parametrize("max_iterations", [1, 2, 5])
def test_max_iterations(max_iterations):
    src, dst, w = _graph(500, 2500, 5, True)
    want, jit, got, it = _both(src, dst, w, 500,
                               max_iterations=max_iterations)
    assert it == jit == max_iterations
    assert np.array_equal(got, want)


def test_warm_start_from_labels0():
    src, dst, _ = _graph(600, 3000, 6, False)
    first, _, _, _ = _both(src, dst, None, 600, max_iterations=2)
    want, jit, got, it = _both(src, dst, None, 600, labels0=first)
    assert it == jit and np.array_equal(got, want)


def test_an_unpadded_graph():
    src, dst, w = _graph(250, 1000, 7, True)
    want, jit, got, it = _both(src, dst, w, 250, pad=False)
    assert it == jit and np.array_equal(got, want)


@pytest.mark.parametrize("directed", [False, True])
def test_negative_weights_without_padding_edges(directed):
    """With no padding edge the reference's empty run slots land on the
    last sorted dst with weight 0.0, which outweighs that node's negative
    runs: the port applies the same 0.0 there."""
    src, dst, _ = _graph(200, 900, 10, False)
    w = -(np.random.default_rng(10).random(900) * 0.9
          + 0.1).astype(np.float32)
    want, jit, got, it = _both(src, dst, w, 200, pad=False,
                               self_weight=-5.0, directed=directed)
    assert it == jit and np.array_equal(got, want)


def test_two_cliques():
    """Two 5-cliques joined by one bridge (tests/test_ops_kernels.py)."""
    edges = [(b + i, b + j) for b in (0, 5) for i in range(5)
             for j in range(i + 1, 5)] + [(0, 5)]
    src = np.array([a for a, _ in edges])
    dst = np.array([b for _, b in edges])
    want, jit, got, it = _both(src, dst, None, 10, max_iterations=50)
    assert it == jit and np.array_equal(got, want)
    assert len(set(got[:5])) == 1 and len(set(got[5:])) == 1
    assert got[0] != got[5]


def test_isolated_nodes_and_an_empty_graph():
    src = np.array([0, 1, 2])
    dst = np.array([1, 2, 0])
    want, jit, got, it = _both(src, dst, None, 8)
    assert it == jit and np.array_equal(got, want)
    assert list(got[3:]) == [3, 4, 5, 6, 7]
    empty = np.zeros(0, dtype=np.int64)
    want, jit, got, it = _both(empty, empty, None, 4)
    assert it == jit and np.array_equal(got, want)


def test_one_run_sum_a_round(monkeypatch):
    """The run weights are one launch of the run sum a round, in its
    no-gather form, over runs that leave out the sink's padding run."""
    calls = []
    real = SC.csr_spmm_sum

    def spy(x, ptr, g=None, w=None, **kw):
        calls.append((g is None, int(ptr[-1]), x.numel()))
        return real(x, ptr, g, w, **kw)

    monkeypatch.setattr(SC, "csr_spmm_sum", spy)
    src, dst, _ = _graph(300, 1000, 8, False)
    g = from_coo(src, dst, n_nodes=300).to_device("cpu")
    _, it = label_propagation(g)
    assert len(calls) == it
    assert all(no_g and last == 2 * g.n_edges and e2 == 2 * g.e_pad
               for no_g, last, e2 in calls)


def test_the_election_scatters_only_the_runs(monkeypatch):
    """The max and min passes of a round run over the (dst, label) runs,
    not over all 2 e_pad slots: in the first round (every label its own
    node) a run is a distinct mirrored (dst, src) pair."""
    sizes = []
    real = S.edge_reduce

    def spy(kind, vals, ids, n, *a, **kw):
        if kind in ("max", "min"):
            sizes.append(vals.numel())
        return real(kind, vals, ids, n, *a, **kw)

    monkeypatch.setattr(S, "edge_reduce", spy)
    src, dst, _ = _graph(300, 1200, 11, False)
    g = from_coo(src, dst, n_nodes=300).to_device("cpu")
    label_propagation(g, max_iterations=1)
    s2 = np.concatenate([g.src_idx.numpy(), g.col_idx.numpy()])
    d2 = np.concatenate([g.col_idx.numpy(), g.src_idx.numpy()])
    runs = len(np.unique(d2.astype(np.int64) * g.n_pad + s2))
    assert runs < 2 * g.e_pad
    assert sizes == [runs, runs]


def test_labelprop_against_needs_a_card(monkeypatch):
    from memgraph_tpu_torch.benchmarks import labelprop_against
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        labelprop_against.main([])


def test_runs_on_the_card_unless_asked_for_the_cpu():
    src, dst, _ = _graph(50, 100, 9, False)
    g = from_coo(src, dst, n_nodes=50)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError):
        label_propagation(g)
    labels, _ = label_propagation(g, device="cpu")
    assert labels.shape == (50,)
