"""The port's native CSR + CSC builder (memgraph_tpu_torch/native/
csr_builder.cpp, bound in ops/native.py) and ``from_coo`` against the JAX
package's.

The builder is two stable counting sorts, the numpy path a lexsort and a
stable argsort: both order edges by (src, dst) and then by input order,
so every array is bit-equal between the two paths and the two packages.
"""

import numpy as np
import pytest

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import native as jnative
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import native as tnative

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_KEYS = ("csr_src", "csr_dst", "csr_w", "csc_src", "csc_dst", "csc_w",
         "row_ptr", "out_degree")
_FIELDS = ("row_ptr", "col_idx", "src_idx", "weights", "csc_src", "csc_dst",
           "csc_weights", "out_degree")


def _coo(n, e, seed, weighted=True):
    """Random edges with duplicates, self loops and isolated nodes: ids
    come from the first 3/4 of the nodes, a few edges are repeated and a
    few are self loops."""
    rng = np.random.default_rng(seed)
    live = max(1, 3 * n // 4)
    src = rng.integers(0, live, e)
    dst = rng.integers(0, live, e)
    dup = rng.integers(0, e, e // 10)
    src[:len(dup)], dst[:len(dup)] = src[dup], dst[dup]
    loops = rng.integers(0, e, e // 20)
    dst[loops] = src[loops]
    w = (rng.random(e).astype(np.float32) * 4 - 1) if weighted else None
    return src, dst, w


GRAPHS = {
    "tiny": (5, 9, 1),
    "small": (200, 1500, 2),
    "dense": (64, 4000, 3),
    "sparse": (5000, 3000, 4),
}


def _pads(n, e):
    return tcsr._bucket(n + 1), tcsr._bucket(e)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_builder_matches_the_jax_packages(name, weighted):
    n, e, seed = GRAPHS[name]
    src, dst, w = _coo(n, e, seed, weighted)
    n_pad, e_pad = _pads(n, e)
    want = jnative.build_csr_csc_native(src, dst, w, n, n_pad, e_pad)
    got = tnative.build_csr_csc_native(src, dst, w, n, n_pad, e_pad)
    assert want is not None and got is not None
    for k in _KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k].view(np.int32),
                              want[k].view(np.int32)), k
    assert got["row_ptr"][-1] == e
    isolated = np.setdiff1d(np.arange(n), src)
    assert (got["out_degree"][isolated] == 0).all()


def _arrays(g):
    return {f: getattr(g, f) for f in _FIELDS}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_from_coo_native_numpy_and_jax_agree(name, monkeypatch):
    n, e, seed = GRAPHS[name]
    src, dst, w = _coo(n, e, seed)
    gids = np.arange(n, dtype=np.int64) * 7 + 3
    served = tnative.build_csr_csc_native.served
    native = tcsr.from_coo(src, dst, w, n_nodes=n, node_gids=gids)
    assert tnative.build_csr_csc_native.served == served + 1
    jax_g = jcsr.from_coo(src, dst, w, n_nodes=n, node_gids=gids)
    monkeypatch.setattr(tnative, "build_csr_csc_native",
                        lambda *a, **k: None)
    numpy_g = tcsr.from_coo(src, dst, w, n_nodes=n, node_gids=gids)
    for other in (numpy_g, jax_g):
        for f, a in _arrays(native).items():
            b = np.asarray(getattr(other, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (other.n_nodes, other.n_edges, other.n_pad, other.e_pad) == (
            native.n_nodes, native.n_edges, native.n_pad, native.e_pad)
        assert np.array_equal(other.node_gids, native.node_gids)
        assert other.gid_to_idx == native.gid_to_idx
        for a, b in zip(native.host_coo, other.host_coo):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_coo_keeps_the_input_order_and_types():
    src, dst, w = _coo(200, 1500, 9)
    g = tcsr.from_coo(src, dst, w, n_nodes=200)
    hs, hd, hw = g.host_coo
    assert (hs.dtype, hd.dtype, hw.dtype) == (np.int32, np.int32, np.float32)
    assert np.array_equal(hs, src) and np.array_equal(hd, dst)
    assert np.array_equal(hw, w)
    assert tcsr.from_coo(src, dst, n_nodes=200).host_coo[2].tolist() == \
        [1.0] * len(src)


@pytest.mark.parametrize("bad", ["negative_src", "negative_dst", "src_high",
                                 "dst_high"])
def test_ids_out_of_range_raise(bad):
    src, dst, w = _coo(50, 300, 5)
    arr, val = {"negative_src": (src, -1), "negative_dst": (dst, -1),
                "src_high": (src, 50), "dst_high": (dst, 50)}[bad]
    arr[17] = val
    with pytest.raises(ValueError, match="out of range"):
        tcsr.from_coo(src, dst, w, n_nodes=50)
    # the builder itself refuses them (rc 2), as the JAX package's does
    n_pad, e_pad = _pads(50, 300)
    with pytest.raises(ValueError, match="out of range"):
        tnative.build_csr_csc_native(src, dst, w, 50, n_pad, e_pad)
    with pytest.raises(ValueError, match="out of range"):
        jnative.build_csr_csc_native(src, dst, w, 50, n_pad, e_pad)


def test_mismatched_lengths_raise_before_the_builder_reads():
    src, dst, w = _coo(50, 300, 8)
    n_pad, e_pad = _pads(50, 300)
    with pytest.raises(ValueError, match="one entry an edge"):
        tnative.build_csr_csc_native(src, dst[:-1], w, 50, n_pad, e_pad)
    with pytest.raises(ValueError, match="one entry an edge"):
        tnative.build_csr_csc_native(src, dst, w[:10], 50, n_pad, e_pad)


def test_other_builder_failures_return_none():
    """rc 1 (padding too small) is not an input fault: None, and
    from_coo's numpy path serves."""
    src, dst, w = _coo(50, 300, 6)
    assert tnative.build_csr_csc_native(src, dst, w, 50, 50, 512) is None
    assert tnative.build_csr_csc_native(src, dst, w, 50, 64, 100) is None


def test_empty_graph_takes_the_numpy_path():
    served = tnative.build_csr_csc_native.served
    g = tcsr.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                      n_nodes=4)
    assert tnative.build_csr_csc_native.served == served
    assert g.n_edges == 0 and g.row_ptr.tolist() == [0] * (g.n_pad + 1)
    assert [len(a) for a in g.host_coo] == [0, 0, 0]


def test_host_coo_survives_to_device():
    src, dst, w = _coo(200, 1500, 7)
    host = tcsr.from_coo(src, dst, w, n_nodes=200)
    placed = host.to_device("cpu")
    assert placed.host_coo is host.host_coo
    assert placed.device.type == "cpu"
    assert all(isinstance(a, np.ndarray) for a in placed.host_coo)
    # the placed arrays are the host arrays
    for f, a in _arrays(host).items():
        assert np.array_equal(getattr(placed, f).numpy(), a), f
