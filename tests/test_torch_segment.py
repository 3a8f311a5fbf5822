"""The deterministic segment sums of the port (memgraph_tpu_torch/ops/
segment_cuda.py) and the CSC run offsets they walk (``col_ptr``), on the
CPU.

The CUDA kernels (``csrc/segment.cu``) cannot run here; their plain
versions can, and ``chip_smoke.py`` holds the kernels to them bit for bit
on the card.  What is checked here is what the kernels promise:

  * ``csr_spmm_sum`` (K1) is the sum of each run in run order from 0.0:
    bit-equal to numpy's ``np.add.at`` (sequential, unbuffered) over the
    same contributions, and to ``index_add_`` in edge order;
  * a column's bits do not depend on the lanes beside it (B = 1, 3, 32),
    for K1 and for ``lane_sum`` (K2) in each of its three forms;
  * K2's chunked halving tree, replayed here in numpy, is its order, and
    stays within float32 rounding of a float64 sum;
  * ``col_ptr`` from the native builder and from the numpy path equals
    ``searchsorted`` of the CSC destinations, the padding edges in the
    sink's run; ``csc_runs`` drops them.
"""

import numpy as np
import pytest
import torch

from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import native as tnative
from memgraph_tpu_torch.ops import segment_cuda as SC

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

LANES = (1, 3, 32)


def _graph(n=300, e=2500, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32) if weighted else None
    return tcsr.from_coo(src, dst, w, n_nodes=n).to_device("cpu")


def _x(rows, lanes, seed=1):
    rng = np.random.default_rng(seed)
    # magnitudes over six decades: the order of the adds shows in the bits
    x = rng.random((rows, lanes)) * 10.0 ** rng.uniform(-3, 3, (rows, 1))
    return torch.from_numpy(x.astype(np.float32))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _numpy_runs(x, ptr, g, w, mul, precision):
    """Each run's contributions added one at a time in run order."""
    x = x.numpy().reshape(x.shape[0], -1)
    ptr = ptr.numpy().astype(np.int64)
    rows = g.numpy()[ptr[0]:ptr[-1]] if g is not None else \
        np.arange(ptr[0], ptr[-1])
    vals = x[rows]
    if mul == "times":
        vals = vals * w.numpy()[ptr[0]:ptr[-1], None]
    if precision == "bf16":
        vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    ids = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    out = np.zeros((len(ptr) - 1, x.shape[1]), dtype=np.float32)
    np.add.at(out, ids, vals)
    return out


def _runs(g, which):
    if which == "csc":
        return g.csc_runs(), g.csc_src, g.csc_weights
    if which == "csc_all":
        return g.col_ptr, g.csc_src, g.csc_weights
    return g.row_ptr, g.col_idx, g.weights


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mul", ["times", "first"])
@pytest.mark.parametrize("runs", ["csc", "csc_all", "csr"])
@pytest.mark.parametrize("lanes", LANES)
def test_spmm_sum_adds_each_run_in_order(lanes, runs, mul, precision):
    g = _graph()
    ptr, idx, w = _runs(g, runs)
    x = _x(g.n_pad, lanes)
    got = SC.csr_spmm_sum(x, ptr, idx, w if mul == "times" else None,
                          mul=mul, precision=precision)
    want = _numpy_runs(x, ptr, idx, w, mul, precision)
    assert got.shape == (g.n_pad, lanes)
    assert np.array_equal(_bits(got).numpy(), want.view(np.int32))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("lanes", [3, 32])
def test_spmm_sum_column_does_not_depend_on_lanes(lanes, precision):
    g = _graph(seed=2)
    ptr, idx, w = _runs(g, "csc")
    x = _x(g.n_pad, lanes, seed=3)
    many = SC.csr_spmm_sum(x, ptr, idx, w, precision=precision)
    for lane in range(lanes):
        one = SC.csr_spmm_sum(x[:, lane].contiguous(), ptr, idx, w,
                              precision=precision)
        assert one.shape == (g.n_pad,)
        assert torch.equal(_bits(one), _bits(many[:, lane]))


def test_spmm_sum_equals_index_add_in_edge_order():
    g = _graph(seed=4)
    x = _x(g.n_pad, 3, seed=5)
    got = SC.csr_spmm_sum(x, g.col_ptr, g.csc_src, g.csc_weights)
    vals = x[g.csc_src.long()] * g.csc_weights.unsqueeze(1)
    want = torch.zeros(g.n_pad, 3).index_add_(0, g.csc_dst.long(), vals)
    assert torch.equal(_bits(got), _bits(want))


def test_spmm_sum_without_gather_reduces_given_values():
    g = _graph(seed=6)
    x = _x(g.n_pad, 3, seed=7)
    gathered = SC.csr_spmm_sum(x, g.csc_runs(), g.csc_src, g.csc_weights)
    vals = x[g.csc_src.long()] * g.csc_weights.unsqueeze(1)
    given = SC.csr_spmm_sum(vals, g.csc_runs(), mul="first")
    assert torch.equal(_bits(gathered), _bits(given))


def test_spmm_sum_int64_offsets_and_indices_agree():
    g = _graph(seed=8)
    x = _x(g.n_pad, 1, seed=9)
    a = SC.csr_spmm_sum(x, g.csc_runs(), g.csc_src, g.csc_weights)
    b = SC.csr_spmm_sum(x, g.csc_runs().long(), g.csc_src.long(),
                        g.csc_weights)
    assert torch.equal(_bits(a), _bits(b))


def test_spmm_sum_empty_runs_are_zero():
    ptr = torch.tensor([0, 0, 2, 2, 3], dtype=torch.int32)
    x = torch.tensor([[1.5], [2.5], [-4.0]])
    got = SC.csr_spmm_sum(x, ptr, mul="first")
    assert got.view(-1).tolist() == [0.0, 4.0, 0.0, -4.0]


@pytest.mark.parametrize("bad", ["dtype", "w_len", "w_first", "mul",
                                 "precision", "ptr_dtype", "g_2d", "meta"])
def test_spmm_sum_refuses_what_the_kernel_does_not_take(bad):
    x = torch.ones(4, 2)
    ptr = torch.tensor([0, 2, 4], dtype=torch.int32)
    g = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    w = torch.ones(4)
    kw = {"x": x, "ptr": ptr, "g": g, "w": w}
    opts = {}
    if bad == "dtype":
        kw["x"] = x.double()
    elif bad == "w_len":
        kw["w"] = torch.ones(3)
    elif bad == "w_first":
        opts["mul"] = "first"
    elif bad == "mul":
        opts["mul"] = "plus"
    elif bad == "precision":
        opts["precision"] = "int8"
    elif bad == "ptr_dtype":
        kw["ptr"] = ptr.float()
    elif bad == "g_2d":
        kw["g"] = g.view(2, 2)
    elif bad == "meta":
        kw = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises((TypeError, ValueError)):
        SC.csr_spmm_sum(kw["x"], kw["ptr"], kw["g"], kw["w"], **opts)


def _numpy_tree(v):
    """K2's order in numpy: chunks of 256 rows (zero-padded), each by the
    halving tree, then the partials the same way."""
    v = v.astype(np.float32)
    while True:
        chunks = max(1, -(-v.shape[0] // SC.CHUNK))
        pad = np.zeros((chunks * SC.CHUNK - v.shape[0], v.shape[1]),
                       dtype=np.float32)
        t = np.concatenate([v, pad]).reshape(chunks, SC.CHUNK, v.shape[1])
        h = SC.CHUNK // 2
        while h >= 1:
            t = t[:, :h] + t[:, h:2 * h]
            h //= 2
        v = t.reshape(chunks, -1)
        if chunks == 1:
            return v[0]


@pytest.mark.parametrize("rows", [1, 255, 256, 257, 70000])
@pytest.mark.parametrize("form", ["sum", "dot", "l1"])
def test_lane_sum_order_is_the_chunked_tree(form, rows):
    a = _x(rows, 3, seed=rows)
    b = _x(rows, 3, seed=rows + 1)
    m = torch.from_numpy(np.random.default_rng(rows).random(rows).astype(
        np.float32))
    kw = {"sum": {}, "dot": {"m": m}, "l1": {"b": b}}[form]
    got = SC.lane_sum(a, **kw)
    an = a.numpy()
    v = {"sum": an, "dot": an * m.numpy()[:, None],
         "l1": np.abs(an - b.numpy())}[form]
    assert got.shape == (3,)
    assert np.array_equal(_bits(got).numpy(), _numpy_tree(v).view(np.int32))
    exact = v.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5)


@pytest.mark.parametrize("form", ["sum", "dot", "l1"])
@pytest.mark.parametrize("lanes", [3, 32])
def test_lane_sum_column_does_not_depend_on_lanes(lanes, form):
    rows = 5000
    a = _x(rows, lanes, seed=11)
    b = _x(rows, lanes, seed=12)
    m = torch.from_numpy((np.arange(rows) % 7 == 0).astype(np.float32))
    many = SC.lane_sum(a, **{"sum": {}, "dot": {"m": m},
                             "l1": {"b": b}}[form])
    for lane in range(lanes):
        kw = {"sum": {}, "dot": {"m": m},
              "l1": {"b": b[:, lane].contiguous()}}[form]
        one = SC.lane_sum(a[:, lane].contiguous(), **kw)
        assert one.shape == ()
        assert torch.equal(_bits(one.view(1)), _bits(many[lane:lane + 1]))


def test_lane_sum_refuses_both_forms_and_bad_shapes():
    a = torch.ones(10, 2)
    with pytest.raises(ValueError):
        SC.lane_sum(a, b=a, m=torch.ones(10))
    with pytest.raises(ValueError):
        SC.lane_sum(a, m=torch.ones(9))
    with pytest.raises(ValueError):
        SC.lane_sum(a, b=torch.ones(10, 3))
    with pytest.raises(TypeError):
        SC.lane_sum(a.double())


def test_segment_runs_are_searchsorted_and_drop_out_of_range_ids():
    ids = torch.tensor([-1, 0, 0, 2, 2, 2, 5, 7])
    ptr = SC.segment_runs(ids, 6)
    assert ptr.dtype == torch.int32
    assert ptr.tolist() == np.searchsorted(ids.numpy(), np.arange(7)).tolist()
    assert ptr.tolist() == [1, 3, 3, 6, 6, 6, 7]


def test_reset_launch_counts():
    SC.csr_spmm_sum.launches = 5
    SC.lane_sum.launches = 3
    SC.reset_launch_counts()
    assert SC.csr_spmm_sum.launches == SC.lane_sum.launches == 0


@pytest.mark.parametrize("n,e", [(5, 9), (200, 1500), (64, 4000),
                                 (5000, 3000)])
def test_col_ptr_native_numpy_and_searchsorted_agree(n, e, monkeypatch):
    rng = np.random.default_rng(n + e)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    served = tnative.build_csr_csc_native.served
    native = tcsr.from_coo(src, dst, n_nodes=n)
    assert tnative.build_csr_csc_native.served == served + 1
    monkeypatch.setattr(tnative, "build_csr_csc_native",
                        lambda *a, **k: None)
    numpy_g = tcsr.from_coo(src, dst, n_nodes=n)
    want = np.searchsorted(native.csc_dst, np.arange(native.n_pad + 1))
    for g in (native, numpy_g):
        assert g.col_ptr.dtype == np.int32
        assert np.array_equal(g.col_ptr, want)
        # the sink's run is the padding edges, every later run is empty
        assert g.col_ptr[n] == e and g.col_ptr[n + 1] == g.e_pad
        assert (g.col_ptr[n + 1:] == g.e_pad).all()
        assert np.array_equal(g.csc_runs(), np.minimum(want, e))
    placed = native.to_device("cpu")
    assert torch.equal(placed.col_ptr, torch.from_numpy(want).int())
    assert placed.csc_runs().tolist() == np.minimum(want, e).tolist()


def test_col_ptr_of_an_empty_graph():
    g = tcsr.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                      n_nodes=4)
    assert g.col_ptr.tolist() == [0] * 5 + [g.e_pad] * (g.n_pad - 4)
