"""The port's mesh (memgraph_tpu_torch/parallel/mesh.py, distributed.py,
analytics.py, ops/csr.py's placement, ops/blob.py, ops/spmv_mxu_sharded.py)
against the JAX package on the CPU, in one process.

The fixture is the reference's (tests/test_sharded_analytics.py): 203
nodes, 1,500 weighted edges from seed 42, uneven over 8 shards.  The port
runs on an 8-shard mesh of ``cpu`` devices and on a mesh of 1; the JAX
package on its 8 virtual host devices (tests/conftest.py) and a mesh of 1.
The JAX answers are computed once a module (``jref``), so each JAX program
compiles once.

Tolerances are the reference's own: PageRank within atol 1e-5 of JAX's
single-device run (8 shards) and 1e-6 (mesh of 1), and of
``pagerank_sharded`` / ``_15d`` at 1e-5; katz within atol 1e-5, SSSP
1e-4; labels, components and BFS levels equal; the sharded MXU route
within tests/test_spmv_mxu_sharded.py's bounds.  JAX's
``pagerank_partition_centric`` is not a reference here: it fails on this
container's jax (its while_loop carry types differ, ROADMAP Queue 3 item
4).
"""

import numpy as np
import pytest
import torch

import jax

from memgraph_tpu.ops import blob as jblob
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops.pagerank import pagerank as jpagerank
from memgraph_tpu.parallel import analytics as janalytics
from memgraph_tpu.parallel import distributed as jdist
from memgraph_tpu.parallel.mesh import get_mesh_context as jmesh
from memgraph_tpu_torch.ops import blob as tblob
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import semiring as TS
from memgraph_tpu_torch.ops.components import weakly_connected_components
from memgraph_tpu_torch.ops.katz import katz_centrality
from memgraph_tpu_torch.ops.labelprop import label_propagation
from memgraph_tpu_torch.ops.pagerank import pagerank
from memgraph_tpu_torch.parallel import analytics as A
from memgraph_tpu_torch.parallel import distributed as D
from memgraph_tpu_torch.parallel import mesh as M
from memgraph_tpu_torch.parallel.checkpoint import CheckpointStore, RunReport
from memgraph_tpu_torch.utils import faultinject as FI

N, E = 203, 1500
KATZ = {"alpha": 0.05, "max_iterations": 100, "tol": 1e-8}
PR = {"tol": 1e-10, "max_iterations": 200}


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(42)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def graph(coo):
    return tcsr.from_coo(*coo, n_nodes=N)


@pytest.fixture(scope="module")
def ctx8():
    return M.get_mesh_context(devices=("cpu",) * 8)


@pytest.fixture(scope="module")
def ctx1():
    return M.get_mesh_context(1, device="cpu")


@pytest.fixture(scope="module")
def jref(coo):
    """Every JAX answer the module holds the port against, once."""
    assert len(jax.devices()) == 8, "conftest must provide 8 devices"
    g = jcsr.from_coo(*coo, n_nodes=N)
    c8, c1 = jmesh(8), jmesh(1)
    out = {"graph": g}
    for name, c in (("8", c8), ("1", c1)):
        out["scsr_src_" + name] = jcsr.shard_csr(g, c, by="src")
        out["scsr_dst_" + name] = jcsr.shard_csr(g, c, by="dst",
                                                 doubled=True)
        out["katz_" + name] = janalytics.katz_mesh(g, c, **KATZ)
        out["katz_tol5_" + name] = janalytics.katz_mesh(
            g, c, **{**KATZ, "tol": 1e-5})
        out["lp_" + name] = janalytics.label_propagation_mesh(
            g, c, max_iterations=30)
        out["wcc_" + name] = janalytics.components_mesh(g, c)
        out["bfs_" + name] = janalytics.bfs_mesh(g, c, 0)
    out["sssp_8"] = janalytics.sssp_mesh(g, c8, source=0)
    out["pr"] = jpagerank(g, **PR)
    out["pr_tol6"] = jpagerank(g, tol=1e-6, max_iterations=200)
    mesh = c8.mesh
    out["pr_sharded"] = jdist.pagerank_sharded(
        jdist.shard_graph(g, mesh), **PR)
    out["pr_15d"] = jdist.pagerank_sharded_15d(
        jdist.shard_graph_by_src(g, mesh), **PR)
    out["wcc_sharded"] = jdist.wcc_sharded(jdist.shard_graph(g, mesh))
    return out


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards", ["8", "1"])
@pytest.mark.parametrize("by", ["src", "dst"])
def test_layout_equals_jax_array_for_array(graph, jref, ctx8, ctx1, shards,
                                           by):
    ctx = ctx8 if shards == "8" else ctx1
    got = tcsr.shard_csr(graph, ctx, by=by, doubled=by == "dst")
    want = jref[f"scsr_{by}_{shards}"]
    assert got.placed and len(got.src) == ctx.n_shards
    for f in ("n_nodes", "n_edges", "n_shards", "block", "n_pad2", "per",
              "by"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.block_ptr, want.block_ptr)
    for f in ("src", "dst", "weights"):
        rows = np.stack([_np(t) for t in getattr(got, f)])
        assert rows.tobytes() == np.asarray(getattr(want, f)).tobytes(), f
    for p in range(ctx.n_shards):
        r = got.runs[p]
        dst = _np(got.dst[p])
        ptr = _np(r["dst_ptr"])
        assert ptr[-1] == r["rc"] == int((dst < N).sum())
        for j in np.flatnonzero(np.diff(ptr)):
            assert np.all(dst[ptr[j]:ptr[j + 1]] == j)


def test_shard_csr_cached_per_mesh_and_refresh_replaces(graph, ctx8, ctx1):
    a = tcsr.shard_csr(graph, ctx8)
    assert tcsr.shard_csr(graph, ctx8) is a
    c = tcsr.shard_csr(graph, ctx1)
    assert c is not a and c.n_shards == 1
    b = a.refresh(ctx8)
    assert b is not a and b.host is a.host
    assert all(torch.equal(x, y) for x, y in zip(a.src, b.src))


# --------------------------------------------------------------------------
# the algorithms against the JAX mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards", ["8", "1"])
def test_katz_matches_jax_mesh(graph, jref, ctx8, ctx1, shards):
    ctx = ctx8 if shards == "8" else ctx1
    got, _, _ = A.katz_mesh(graph, ctx, **KATZ)
    np.testing.assert_allclose(_np(got), np.asarray(jref["katz_" + shards][0]),
                               atol=1e-5)
    # at a tol above float32's rounding of the scores, the iteration
    # count is the fixpoint's, not the rounding's
    _, _, iters = A.katz_mesh(graph, ctx, **{**KATZ, "tol": 1e-5})
    assert iters == jref["katz_tol5_" + shards][2]


@pytest.mark.parametrize("shards", ["8", "1"])
def test_labelprop_wcc_bfs_equal_jax_mesh(graph, jref, ctx8, ctx1, shards):
    ctx = ctx8 if shards == "8" else ctx1
    labels, _ = A.label_propagation_mesh(graph, ctx, max_iterations=30)
    np.testing.assert_array_equal(labels, np.asarray(jref["lp_" + shards][0]))
    comp, _ = A.components_mesh(graph, ctx)
    np.testing.assert_array_equal(comp, np.asarray(jref["wcc_" + shards][0]))
    levels, _ = A.bfs_mesh(graph, ctx, 0)
    np.testing.assert_array_equal(levels,
                                  np.asarray(jref["bfs_" + shards][0]))


def test_labelprop_equals_the_single_card_labels(graph, ctx8):
    labels, _ = A.label_propagation_mesh(graph, ctx8, max_iterations=30)
    single, _ = label_propagation(graph, max_iterations=30, device="cpu")
    np.testing.assert_array_equal(labels, single)


def test_sssp_matches_jax_mesh(graph, jref, ctx8):
    got, _ = A.sssp_mesh(graph, ctx8, source=0)
    np.testing.assert_allclose(got, np.asarray(jref["sssp_8"][0]),
                               atol=1e-4)


@pytest.mark.parametrize("shards,atol", [("8", 1e-5), ("1", 1e-6)])
def test_pagerank_matches_jax_single_device(graph, jref, ctx8, ctx1,
                                            shards, atol):
    ctx = ctx8 if shards == "8" else ctx1
    got, _, _ = A.pagerank_mesh(graph, ctx, **PR)
    np.testing.assert_allclose(_np(got), np.asarray(jref["pr"][0]),
                               atol=atol)


@pytest.mark.parametrize("shards", ["8", "1"])
def test_pagerank_takes_at_most_one_more_iteration(graph, jref, ctx8, ctx1,
                                                   shards):
    ctx = ctx8 if shards == "8" else ctx1
    _, err, iters = A.pagerank_mesh(graph, ctx, tol=1e-6,
                                    max_iterations=200)
    assert err <= 1e-6
    assert iters <= jref["pr_tol6"][2] + 1


def test_edge_blocked_family_matches_jax(graph, jref, ctx8):
    got, _, _ = D.pagerank_sharded(D.shard_graph(graph, ctx8), **PR)
    np.testing.assert_allclose(_np(got), np.asarray(jref["pr_sharded"][0]),
                               atol=1e-5)
    got, _, _ = D.pagerank_sharded_15d(D.shard_graph_by_src(graph, ctx8),
                                       **PR)
    np.testing.assert_allclose(_np(got), np.asarray(jref["pr_15d"][0]),
                               atol=1e-5)
    comp, _ = D.wcc_sharded(D.shard_graph(graph, ctx8))
    np.testing.assert_array_equal(_np(comp),
                                  np.asarray(jref["wcc_sharded"][0]))


def test_bf16_within_the_precision_bounds(graph, ctx8, ctx1):
    f32, _, _ = A.pagerank_mesh(graph, ctx8, **PR)
    for ctx in (ctx8, ctx1):
        b16, _, _ = A.pagerank_mesh(graph, ctx, precision="bf16", **PR)
        diff = np.abs(_np(b16) - _np(f32))
        assert diff.max() <= TS.PRECISION_BOUNDS["bf16"]["pagerank_linf"]
        assert diff.sum() <= TS.PRECISION_BOUNDS["bf16"]["pagerank_l1"]
    k32, _, _ = A.katz_mesh(graph, ctx8, **KATZ)
    k16, _, _ = A.katz_mesh(graph, ctx8, precision="bf16", **KATZ)
    np.testing.assert_allclose(_np(k16), _np(k32), atol=5e-2, rtol=2e-2)


def test_two_runs_are_bit_equal(graph, ctx8):
    a, _, _ = A.pagerank_mesh(graph, ctx8, tol=0.0, max_iterations=30)
    b, _, _ = A.pagerank_mesh(graph, ctx8, tol=0.0, max_iterations=30)
    assert _np(a).tobytes() == _np(b).tobytes()


# --------------------------------------------------------------------------
# the contracts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["pagerank", "pagerank_bf16", "katz",
                                  "labelprop", "wcc"])
def test_one_collective_an_iteration(graph, ctx8, algo):
    M.reset_collective_counts()
    if algo.startswith("pagerank"):
        _, _, iters = A.pagerank_mesh(
            graph, ctx8, tol=1e-6,
            precision="bf16" if algo.endswith("bf16") else "f32")
        kind = "psum_scatter"
    elif algo == "katz":
        _, _, iters = A.katz_mesh(graph, ctx8, **KATZ)
        kind = "psum"
    elif algo == "labelprop":
        _, iters = A.label_propagation_mesh(graph, ctx8)
        kind = "all_gather"
    else:
        _, iters = A.components_mesh(graph, ctx8)
        kind = "pmin"
    assert iters > 1
    assert M.collective_counts[kind] == iters
    assert M.collectives_total() == iters


def test_int8_is_refused(graph, ctx1):
    with pytest.raises(ValueError):
        A.pagerank_mesh(graph, ctx1, max_iterations=5, precision="int8")
    with pytest.raises(ValueError):
        pagerank(graph, max_iterations=5, precision="int8", mesh=ctx1,
                 device="cpu")


def test_mesh_routes_equal_the_mesh_calls(graph, ctx8):
    def same(a, b):
        assert _np(a).tobytes() == _np(b).tobytes()

    same(pagerank(graph, device="cpu", mesh=ctx8, **PR)[0],
         A.pagerank_mesh(graph, ctx8, **PR)[0])
    same(pagerank(graph, device="cpu", mesh=8, **PR)[0],
         A.pagerank_mesh(graph, ctx8, **PR)[0])
    same(katz_centrality(graph, device="cpu", mesh=ctx8, **KATZ)[0],
         A.katz_mesh(graph, ctx8, **KATZ)[0])
    same(label_propagation(graph, device="cpu", mesh=ctx8)[0],
         A.label_propagation_mesh(graph, ctx8)[0])
    same(weakly_connected_components(graph, device="cpu", mesh=ctx8)[0],
         A.components_mesh(graph, ctx8)[0])
    assert TS.route_backend(graph, torch.device("cpu"), ctx8) == \
        ("mesh", ctx8)


def test_environment_routes_and_unset_keeps_the_single_card_routes(
        graph, ctx8, monkeypatch):
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    cpu = torch.device("cpu")
    assert TS.route_backend(graph, cpu) == ("segment", None)
    M.reset_collective_counts()
    single, _, _ = pagerank(graph, device="cpu", **PR)
    weakly_connected_components(graph, device="cpu")
    label_propagation(graph, device="cpu")
    katz_centrality(graph, device="cpu", **KATZ)
    assert M.collectives_total() == 0
    monkeypatch.setenv("MEMGRAPH_TPU_MESH_DEVICES", "8")
    assert TS.route_backend(graph, cpu) == ("mesh", ctx8)
    routed, _, _ = pagerank(graph, device="cpu", **PR)
    assert M.collectives_total() > 0
    assert _np(routed).tobytes() == \
        _np(A.pagerank_mesh(graph, ctx8, **PR)[0]).tobytes()
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES")
    again, _, _ = pagerank(graph, device="cpu", **PR)
    assert _np(again).tobytes() == _np(single).tobytes()


def test_mesh_devices_and_reachability():
    with pytest.raises(ValueError):
        M.MeshContext(devices=())
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            M.MeshContext(devices=("cpu", "cuda:0"))
    ctx = M.get_mesh_context(devices=("cpu",) * 2)
    assert ctx.n_shards == 2 and ctx.distinct == (torch.device("cpu"),)
    assert M.resolve_mesh(("cpu", "cpu")) is ctx
    assert M.resolve_mesh(2, device="cpu") is ctx
    with pytest.raises(TypeError):
        M.resolve_mesh("two")
    with pytest.raises(ValueError):
        M.psum(ctx, [torch.zeros(3)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.get_mesh_context(1)
    got = M.psum_scatter(ctx, [torch.arange(6.).view(2, 3),
                               torch.ones(2, 3)])
    assert torch.equal(got[0], torch.tensor([1., 2., 3.]))
    assert torch.equal(got[1], torch.tensor([4., 5., 6.]))
    assert torch.equal(M.all_gather(ctx, [torch.zeros(2),
                                          torch.ones(1)])[1],
                       torch.tensor([0., 0., 1.]))


@pytest.mark.parametrize("algo,every", [
    ("pagerank", 3), ("katz", 3), ("labelprop", 3), ("wcc", 1), ("bfs", 1)])
def test_device_lost_resumes_bit_equal(graph, ctx8, algo, every):
    """A device.lost at the third chunk (chunks of 3 iterations; of 1 for
    WCC and BFS, which converge in 3 and 5 here): the run resumes from
    the checkpoint (the rows placed again) and answers what an unfaulted
    run answers, bit for bit."""
    def run(**kw):
        if algo == "pagerank":
            return A.pagerank_mesh(graph, ctx8, tol=0.0, max_iterations=12,
                                   **kw)[0]
        if algo == "katz":
            return A.katz_mesh(graph, ctx8, alpha=0.05, tol=0.0,
                               max_iterations=12, **kw)[0]
        if algo == "labelprop":
            return A.label_propagation_mesh(graph, ctx8, **kw)[0]
        if algo == "wcc":
            return A.components_mesh(graph, ctx8, **kw)[0]
        return A.bfs_mesh(graph, ctx8, 0, **kw)[0]

    want = _np(run(checkpoint_every=every, store=CheckpointStore()))
    report = RunReport()
    FI.reset()
    FI.arm("device.lost", "raise", at=3)
    try:
        got = _np(run(checkpoint_every=every, store=CheckpointStore(),
                      report=report))
    finally:
        FI.reset()
    assert report.resumes == 1 and report.rebuilds == 1
    assert report.faults == ["device_lost"]
    assert got.tobytes() == want.tobytes()


# --------------------------------------------------------------------------
# ops/blob.py and the sharded MXU route
# --------------------------------------------------------------------------

def test_pack_blob_equals_jax_byte_for_byte():
    rng = np.random.default_rng(3)
    arrays = {"f": rng.random((3, 5)).astype(np.float32),
              "i16": rng.integers(-300, 300, 7).astype(np.int16),
              "u8": rng.integers(0, 255, 9).astype(np.uint8),
              "b": rng.random(4) > 0.5,
              "bits": ("bits", rng.integers(0, 255, (3, 6)).astype(np.uint8)),
              "u32": rng.integers(0, 2 ** 31, 4).astype(np.uint32)}
    got, gsegs = tblob.pack_blob(arrays)
    want, wsegs = jblob.pack_blob(arrays)
    assert got.tobytes() == want.tobytes()
    assert {k: v[:3] for k, v in gsegs.items()} == \
        {k: v[:3] for k, v in wsegs.items()}
    out = tblob.put_packed(arrays, "cpu")
    for k in ("f", "i16", "u8", "b"):
        np.testing.assert_array_equal(out[k].numpy(), arrays[k])
    bits = tblob.unpack_bit_words(out["bits"], 48).numpy()
    np.testing.assert_array_equal(
        bits, np.unpackbits(arrays["bits"][1], axis=-1).astype(bool))


def test_pagerank_mxu_sharded_matches_jax(ctx8):
    import jax.numpy as jnp
    from memgraph_tpu.ops.spmv_mxu_sharded import \
        pagerank_mxu_sharded as jmxu
    from memgraph_tpu.parallel import make_mesh
    from memgraph_tpu_torch.ops.spmv_mxu_sharded import \
        pagerank_mxu_sharded as tmxu

    rng = np.random.default_rng(42)
    n, e = 300, 3000
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    want, _, _ = jmxu(src, dst, None, n, make_mesh(8), max_iterations=40,
                      tol=0.0, route_dtype=jnp.float32)
    got, _, iters = tmxu(src, dst, None, n, ctx8, max_iterations=40,
                         tol=0.0, route_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-10)
    # the default route dtype is bfloat16, as the reference's
    b16, _, _ = tmxu(src, dst, None, n, ctx8, max_iterations=40, tol=0.0)
    diff = np.abs(_np(b16) - np.asarray(want))
    assert diff.max() <= TS.PRECISION_BOUNDS["bf16"]["pagerank_linf"]
    assert diff.sum() <= TS.PRECISION_BOUNDS["bf16"]["pagerank_l1"]


def test_wcc_masks_the_padding_that_the_jax_mesh_does_not(ctx8):
    """On a sparse graph (203 nodes, 60 edges, 8 shards) the port's mesh
    WCC equals the single-card WCC; the JAX package's mesh WCC merges the
    padded rows' base vertices through the sink row (ROADMAP Queue 3
    item 9)."""
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, N, 60), rng.integers(0, N, 60)
    got, _ = A.components_mesh(tcsr.from_coo(src, dst, n_nodes=N), ctx8)
    single, _ = weakly_connected_components(
        tcsr.from_coo(src, dst, n_nodes=N), device="cpu")
    np.testing.assert_array_equal(got, single)
    jgot, _ = janalytics.components_mesh(
        jcsr.from_coo(src, dst, n_nodes=N), jmesh(8))
    assert not np.array_equal(np.asarray(jgot), single)
