"""The port's node similarity (memgraph_tpu_torch/ops/similarity.py)
against the JAX package's ``ops/similarity.py`` on the CPU: the dense
matrices bit-equal in all three modes (the common-neighbor counts are
exact in both, and each mode divides them the same way), the pairwise
scores equal, and the same refusal past ``DENSE_LIMIT``.
"""

import numpy as np
import pytest

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import similarity as jsim
from memgraph_tpu_torch.ops import similarity as T
from memgraph_tpu_torch.ops.csr import from_coo

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)


def _graph(n, e, seed, pad=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    src = np.concatenate([src, src[:e // 10], [0, 1]])
    dst = np.concatenate([dst, dst[:e // 10], [0, 1]])
    return (jcsr.from_coo(src, dst, None, n_nodes=n, pad=pad).to_device(),
            from_coo(src, dst, None, n_nodes=n, pad=pad).to_device("cpu"))


@pytest.mark.parametrize("mode", ["jaccard", "overlap", "cosine"])
@pytest.mark.parametrize("n,e,seed,pad", [(700, 5000, 0, True),
                                          (300, 3000, 1, True),
                                          (129, 400, 2, False)])
def test_matrix_is_the_references_bits(mode, n, e, seed, pad):
    jg, tg = _graph(n, e, seed, pad)
    want = np.asarray(jsim.similarity_matrix(jg, mode))
    got = T.similarity_matrix(tg, mode).numpy()
    assert got.dtype == np.float32 and got.shape == (n, n)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mode", ["jaccard", "overlap", "cosine"])
def test_pairwise_equals_the_reference(mode):
    jg, tg = _graph(500, 4000, 3)
    rng = np.random.default_rng(4)
    pairs = [(int(i), int(j)) for i, j in rng.integers(0, 500, (200, 2))]
    pairs += [(7, 7), (499, 0)]
    assert T.pairwise_similarity(tg, pairs, mode) == \
        jsim.pairwise_similarity(jg, pairs, mode)


def test_dense_limit():
    assert T.DENSE_LIMIT == jsim.DENSE_LIMIT == 8192
    n = T.DENSE_LIMIT + 1
    src, dst = np.arange(10), np.arange(1, 11)
    jg = jcsr.from_coo(src, dst, None, n_nodes=n).to_device()
    tg = from_coo(src, dst, None, n_nodes=n).to_device("cpu")
    with pytest.raises(ValueError) as want:
        jsim.similarity_matrix(jg)
    with pytest.raises(ValueError) as got:
        T.similarity_matrix(tg)
    assert str(got.value) == str(want.value)
