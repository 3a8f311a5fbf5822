"""The port's out-of-core tier (memgraph_tpu_torch/ops/tier.py, the host
``ShardedCSR`` of ops/csr.py, parallel/streamed.py, parallel/
checkpoint.py and ``apply_edge_delta`` / ``ResidentGraph.ensure_tier`` of
ops/delta.py) against the JAX package's on the same seeded COO, on the
CPU.  The port's counterpart of tests/test_tier.py.

Exact: the blocked layout (``shard_edges``: src, dst, weights,
block_ptr, per, the n_pad2 sink row), the block codec's payloads byte
for byte (bf16 compared as 16-bit words), ``plan_blocks``,
``streamed_request_bytes``, ``admission_verdict``, the blocks a delta
re-packs, WCC's labels.  The port's streamed output is bit-equal to its
resident comparator at f32, bf16 and int8, and to an unfaulted or
unchunked run after a fault or in chunks.  Streamed PageRank and katz
are within 1e-5 of the largest entry of JAX's ``pagerank_streamed`` /
``katz_streamed`` (the two sum in different orders), with iteration
counts equal or within one.
"""

import numpy as np
import pytest

from memgraph_tpu.ops import delta as jdelta
from memgraph_tpu.ops import tier as jtier
from memgraph_tpu.ops.csr import shard_edges as jshard
from memgraph_tpu.parallel import distributed as jdist
from memgraph_tpu_torch.ops import delta as tdelta
from memgraph_tpu_torch.ops import tier as ttier
from memgraph_tpu_torch.ops.csr import from_coo, shard_edges
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS
from memgraph_tpu_torch.parallel import streamed as ST
from memgraph_tpu_torch.parallel.checkpoint import RunReport
from memgraph_tpu_torch.server.kernel_server import KernelServer
from memgraph_tpu_torch.utils import faultinject as FI
from memgraph_tpu_torch.utils.metrics import global_metrics

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N, M = 600, 5000
N_BLOCKS = 7          # small blocks: every run really streams
REL = 1e-5
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_faults():
    FI.reset()
    yield
    FI.reset()


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(7)
    src = rng.integers(0, N, M).astype(np.int64)
    dst = rng.integers(0, N, M).astype(np.int64)
    w = (rng.random(M) + 0.1).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def tiers(coo):
    return {p: ttier.plan_tier(*coo, N, precision=p, n_blocks=N_BLOCKS)
            for p in ("f32", "bf16", "int8")}


@pytest.fixture(scope="module")
def jtiers(coo):
    return {p: jtier.plan_tier(*coo, N, precision=p, n_blocks=N_BLOCKS)
            for p in ("f32", "bf16", "int8")}


def _words(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def assert_same_block(jb, tb):
    assert set(jb.payload) == set(tb.payload)
    for k, v in jb.payload.items():
        a, b = _words(v), _words(tb.payload[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert (jb.nbytes, jb.raw_nbytes) == (tb.nbytes, tb.raw_nbytes)


# --------------------------------------------------------------------------
# layout and codec
# --------------------------------------------------------------------------


@pytest.mark.parametrize("by", ["src", "dst"])
@pytest.mark.parametrize("shards", [1, 3, 7, 16])
def test_shard_edges_equals_the_reference(coo, by, shards):
    src, dst, w = coo
    for weights in (w, None):
        a = jshard(src, dst, weights, N, shards, by=by)
        b = shard_edges(src, dst, weights, N, shards, by=by)
        for f in ("src", "dst", "weights", "block_ptr"):
            x, y = np.asarray(getattr(a, f)), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        for f in ("n_nodes", "n_edges", "n_shards", "block", "n_pad2",
                  "per", "by"):
            assert getattr(a, f) == getattr(b, f), f
        assert b.n_pad2 > N      # the sink row exists


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_block_payloads_equal_the_reference(tiers, jtiers, precision):
    t, j = tiers[precision], jtiers[precision]
    assert t.n_blocks == j.n_blocks and t.u16
    for jb, tb in zip(j.blocks, t.blocks):
        assert_same_block(jb, tb)
    assert t.wire_bytes_per_sweep == j.wire_bytes_per_sweep
    assert t.raw_bytes_per_sweep == j.raw_bytes_per_sweep


def test_wide_blocks_ship_int32_indices_as_the_reference():
    rng = np.random.default_rng(2)
    n = 70_000                       # block past 65536 at 1 shard
    src, dst = rng.integers(0, n, 300), rng.integers(0, n, 300)
    t = ttier.plan_tier(src, dst, None, n, n_blocks=1)
    j = jtier.plan_tier(src, dst, None, n, n_blocks=1)
    assert not t.u16 and "src" in t.blocks[0].payload
    assert_same_block(j.blocks[0], t.blocks[0])


def test_block_codec_roundtrips_indices_losslessly(tiers):
    tier = tiers["f32"]
    scsr = tier.scsr
    for p, hb in enumerate(tier.blocks):
        pay = hb.payload
        src = pay["src_off"].astype(np.int64) + int(pay["base"])
        q = np.searchsorted(pay["bounds"][1:], np.arange(scsr.per),
                            side="right")
        dst = pay["dst_off"].astype(np.int64) + q * scsr.block
        assert np.array_equal(src, scsr.src[p])
        assert np.array_equal(dst, scsr.dst[p])
        assert (scsr.dst[p][:int(pay["rc"])] < N).all()
        assert (scsr.dst[p][int(pay["rc"]):] == N).all()


def test_compression_cuts_wire_bytes(tiers):
    ratios = {p: t.raw_bytes_per_sweep / t.wire_bytes_per_sweep
              for p, t in tiers.items()}
    assert ratios["f32"] > 1.3
    assert ratios["int8"] > ratios["bf16"] >= 1.8


def test_plans_and_estimates_equal_the_reference(monkeypatch):
    """The plan and the estimates' formulas are the reference's; the port
    refits the decoded bytes an edge on its own peaks (ops/tier.py), so
    the formulas are compared with the reference's coefficients."""
    assert ttier.DECODED_EDGE_BYTES.keys() == jtier.DECODED_EDGE_BYTES.keys()
    monkeypatch.setattr(ttier, "DECODED_EDGE_BYTES",
                        dict(jtier.DECODED_EDGE_BYTES))
    for n, m in ((600, 5000), (1_000_000, 10_000_000), (70_000, 100),
                 (10, 0), (5_000_000, 300_000_000)):
        for p in ("f32", "bf16", "int8"):
            for bb in (None, 1 << 14, 5 << 20):
                assert ttier.plan_blocks(n, m, p, bb) \
                    == jtier.plan_blocks(n, m, p, bb)
                for algo in ("pagerank", "katz", "wcc"):
                    assert ttier.streamed_request_bytes(
                        n, m, p, bb, algorithm=algo) \
                        == jtier.streamed_request_bytes(
                            n, m, p, bb, algorithm=algo)
            est = 3 * m * 20 + n * 32
            s = ttier.streamed_request_bytes(n, m, p)
            for budget in (est + 1, s + 1, s - 1, 1024):
                for streamable in (True, False):
                    kw = dict(n_nodes=n, n_edges=m, streamable=streamable,
                              precision=p)
                    assert ttier.admission_verdict(est, budget, **kw) \
                        == jtier.admission_verdict(est, budget, **kw)


def test_admission_verdict_resident_streamed_shed():
    n, m = 10_000, 1_000_000
    est = 3 * m * 20 + n * 32
    assert ttier.admission_verdict(est, est + 1, n_nodes=n,
                                   n_edges=m)[0] == "resident"
    s = ttier.streamed_request_bytes(n, m)
    assert s < est
    assert ttier.admission_verdict(est, s + 1, n_nodes=n, n_edges=m) \
        == ("streamed", s)
    assert ttier.admission_verdict(est, s - 1, n_nodes=n,
                                   n_edges=m)[0] == "shed"
    assert ttier.admission_verdict(est, s + 1, n_nodes=n, n_edges=m,
                                   streamable=False)[0] == "shed"


# --------------------------------------------------------------------------
# the streamed fixpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_pagerank_streamed_bit_equal_to_resident_and_near_jax(
        tiers, jtiers, precision):
    t = tiers[precision]
    stats = {}
    s, err_s, it_s = ST.pagerank_streamed(t, stats=stats, **CPU)
    r, err_r, it_r = ST.pagerank_streamed(t, resident=True, **CPU)
    assert it_s == it_r and err_s == err_r
    assert s.tobytes() == r.tobytes()
    j, _, it_j = jdist.pagerank_streamed(jtiers[precision])
    j = np.asarray(j)
    assert abs(it_s - it_j) <= 1
    assert np.abs(s - j).max() <= REL * np.abs(j).max()
    assert stats["mode"] == "streamed" and stats["n_blocks"] == N_BLOCKS
    assert stats["iterations"] == it_s


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_katz_streamed_bit_equal_to_resident_and_near_jax(
        tiers, jtiers, precision):
    t = tiers[precision]
    s, _, it_s = ST.katz_streamed(t, alpha=0.05, **CPU)
    r, _, it_r = ST.katz_streamed(t, alpha=0.05, resident=True, **CPU)
    assert it_s == it_r and s.tobytes() == r.tobytes()
    j, _, it_j = jdist.katz_streamed(jtiers[precision], alpha=0.05)
    j = np.asarray(j)
    assert abs(it_s - it_j) <= 1
    assert np.abs(s - j).max() <= REL * np.abs(j).max()


def test_wcc_streamed_equals_jax_and_union_find(tiers, jtiers, coo):
    s, ch_s, it_s = ST.wcc_streamed(tiers["f32"], **CPU)
    r, _, _ = ST.wcc_streamed(tiers["f32"], resident=True, **CPU)
    j, ch_j, it_j = jdist.wcc_streamed(jtiers["f32"])
    assert np.array_equal(s, r) and np.array_equal(s, np.asarray(j))
    assert (ch_s, it_s) == (bool(ch_j), it_j)
    src, dst, _ = coo
    parent = list(range(N))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in zip(src, dst):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    truth = np.array([find(i) for i in range(N)])
    pairs = {(int(a), int(b)) for a, b in zip(truth, s)}
    assert len(pairs) == len(np.unique(truth)) == len(np.unique(s))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_precision_within_bounds(tiers, precision):
    exact, _, _ = ST.pagerank_streamed(tiers["f32"], **CPU)
    approx, _, _ = ST.pagerank_streamed(tiers[precision], **CPU)
    b = PRECISION_BOUNDS[precision]
    assert float(np.max(np.abs(approx - exact))) <= b["pagerank_linf"]
    assert float(np.sum(np.abs(approx - exact))) <= b["pagerank_l1"]


def test_warm_starts_equal_jax(tiers, jtiers):
    t, j = tiers["f32"], jtiers["f32"]
    x, _, _ = ST.pagerank_streamed(t, **CPU)
    seed = x * 1.01
    a, _, it_a = ST.pagerank_streamed(t, x0=seed, **CPU)
    b, _, it_b = jdist.pagerank_streamed(j, x0=seed)
    assert abs(it_a - it_b) <= 1
    assert np.abs(a - np.asarray(b)).max() <= REL * np.abs(a).max()
    comp, _, _ = ST.wcc_streamed(t, **CPU)
    c2, _, it_c = ST.wcc_streamed(t, comp0=comp, **CPU)
    j2, _, it_j = jdist.wcc_streamed(j, comp0=comp)
    assert np.array_equal(c2, np.asarray(j2)) and it_c == it_j == 1


# --------------------------------------------------------------------------
# commits
# --------------------------------------------------------------------------


def _delta(mod, coo, t0, seed=3):
    src, dst, w = coo
    lo = int(t0.block) - 1
    in_lo = np.flatnonzero(src < lo)[:2]
    rng = np.random.default_rng(seed)
    # the last block holds fewer real vertices: room for its adds
    add_src = np.concatenate([[0, 1, 2], rng.integers(N - 50, N, 5)])
    add_dst = np.concatenate([[3, 4, 5], rng.integers(0, N, 5)])
    return mod.EdgeDelta(
        1, 2, add_src=add_src.astype(np.int64),
        add_dst=add_dst.astype(np.int64),
        add_w=np.linspace(0.5, 1.5, 8).astype(np.float32),
        rem_src=src[in_lo], rem_dst=dst[in_lo], rem_w=w[in_lo]), in_lo


def _spliced_coo(coo, d, in_lo):
    src, dst, w = coo
    keep = np.ones(M, dtype=bool)
    keep[in_lo] = False
    return (np.concatenate([src[keep], d.add_src]),
            np.concatenate([dst[keep], d.add_dst]),
            np.concatenate([w[keep], d.add_w]))


def _row_triples(scsr, p):
    rc = int(np.searchsorted(scsr.dst[p], scsr.n_nodes, side="left"))
    s, d, w = scsr.src[p][:rc], scsr.dst[p][:rc], scsr.weights[p][:rc]
    order = np.lexsort((w, s, d))
    return s[order], d[order], w[order]


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_apply_delta_repacks_the_blocks_the_reference_does(
        coo, tiers, jtiers, precision):
    t0, j0 = tiers[precision], jtiers[precision]
    d, in_lo = _delta(tdelta, coo, t0)
    jd, _ = _delta(jdelta, coo, j0)
    before = {k: global_metrics.value(f"tier.blocks_{k}_total")
              for k in ("repacked", "reused")}
    t1, j1 = t0.apply_delta(d), j0.apply_delta(jd)
    assert t1 is not None and j1 is not None
    touched = [p for p in range(t0.n_blocks) if t1.blocks[p] is not
               t0.blocks[p]]
    assert touched == [p for p in range(j0.n_blocks)
                       if j1.blocks[p] is not j0.blocks[p]]
    assert 0 < len(touched) < t0.n_blocks
    for jb, tb in zip(j1.blocks, t1.blocks):
        assert_same_block(jb, tb)
    assert global_metrics.value("tier.blocks_repacked_total") \
        == before["repacked"] + len(touched)
    assert global_metrics.value("tier.blocks_reused_total") \
        == before["reused"] + t0.n_blocks - len(touched)
    # the same edges, block for block, as a fresh plan of the spliced COO
    fresh = ttier.plan_tier(*_spliced_coo(coo, d, in_lo), N,
                            precision=precision, n_blocks=N_BLOCKS)
    for p in range(N_BLOCKS):
        for a, b in zip(_row_triples(t1.scsr, p),
                        _row_triples(fresh.scsr, p)):
            assert np.array_equal(a, b)
    got, _, _ = ST.pagerank_streamed(t1, **CPU)
    ref, _, _ = ST.pagerank_streamed(fresh, **CPU)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_apply_edge_delta_equals_the_reference(coo):
    src, dst, w = coo
    for by in ("src", "dst"):
        a = jshard(src, dst, w, N, 5, by=by)
        b = shard_edges(src, dst, w, N, 5, by=by)
        d, _ = _delta(tdelta, coo, b)
        jd, _ = _delta(jdelta, coo, a)
        a1, b1 = jdelta.apply_edge_delta(a, jd), \
            tdelta.apply_edge_delta(b, d)
        for f in ("src", "dst", "weights", "block_ptr"):
            assert np.array_equal(np.asarray(getattr(a1, f)),
                                  getattr(b1, f)), f
        assert a1.n_edges == b1.n_edges
    # a removal that matches no edge: both refuse the splice
    bad = tdelta.EdgeDelta(1, 2, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32), np.array([0]),
                           np.array([0]), np.array([9.0], np.float32))
    assert tdelta.apply_edge_delta(b, bad) is None
    empty = tdelta.empty_delta(1, 2)
    assert tdelta.apply_edge_delta(b, empty) is b


def test_resident_graph_tier_follows_commits(coo):
    src, dst, w = coo
    gen = tdelta.ResidentGraph("tier-gen", 1, from_coo(src, dst, w, N))
    t0 = gen.ensure_tier(block_bytes=1 << 13)
    assert gen.ensure_tier(block_bytes=1 << 13) is t0
    assert t0.n_blocks > 2
    d = tdelta.EdgeDelta(
        1, 2, add_src=np.array([9], dtype=np.int64),
        add_dst=np.array([11], dtype=np.int64),
        add_w=np.ones(1, np.float32), rem_src=np.zeros(0, np.int64),
        rem_dst=np.zeros(0, np.int64), rem_w=np.zeros(0, np.float32))
    assert gen.apply(d)
    t1 = gen.ensure_tier(block_bytes=1 << 13)
    assert t1 is not t0
    touched = 9 // t0.block
    for p in range(t0.n_blocks):
        assert (t1.blocks[p] is t0.blocks[p]) == (p != touched)
    ref, _, _ = ST.pagerank_streamed(ttier.plan_tier(
        np.concatenate([src, [9]]), np.concatenate([dst, [11]]),
        np.concatenate([w, np.ones(1, np.float32)]), N,
        n_blocks=t1.n_blocks), **CPU)
    got, _, _ = ST.pagerank_streamed(t1, **CPU)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # a compaction drops the plans; ensure_tier rebuilds from the COO
    assert gen._compact(None, why="test")
    assert gen.tiers == {}
    assert gen.ensure_tier(block_bytes=1 << 13).n_edges == M + 1


def test_generation_plan_keeps_room_for_a_commit(coo):
    """The generation's plan keeps ``TIER_ROW_SLACK`` of room in its rows:
    40 added edges re-pack their blocks in place, where the reference's
    plan (rows without room) overflows and is dropped for a cold
    re-encode (ROADMAP Queue 3)."""
    from memgraph_tpu.ops.csr import from_coo as jfrom_coo
    src, dst, w = coo
    rng = np.random.default_rng(17)
    a_s, a_d = rng.integers(0, N, 40), rng.integers(0, N, 40)
    z = np.zeros(0, np.int64)
    kw = dict(add_src=a_s, add_dst=a_d, add_w=np.ones(40, np.float32),
              rem_src=z, rem_dst=z, rem_w=np.zeros(0, np.float32))
    gen = tdelta.ResidentGraph("room", 1, from_coo(src, dst, w, N))
    jgen = jdelta.ResidentGraph("room", 1, jfrom_coo(src, dst, w, N))
    t0, j0 = gen.ensure_tier(), jgen.ensure_tier()
    assert t0.per > j0.per and t0.n_blocks == j0.n_blocks
    assert gen.apply(tdelta.EdgeDelta(1, 2, **kw))
    assert jgen.apply(jdelta.EdgeDelta(1, 2, **kw))
    assert ("f32", None) not in jgen.tiers        # the reference dropped it
    t1 = gen.tiers[("f32", None)]
    assert t1.n_edges == M + 40
    fresh = ttier.plan_tier(np.concatenate([src, a_s]),
                            np.concatenate([dst, a_d]),
                            np.concatenate([w, np.ones(40, np.float32)]), N,
                            n_blocks=t1.n_blocks)
    for p in range(t1.n_blocks):
        for a, b in zip(_row_triples(t1.scsr, p), _row_triples(fresh.scsr, p)):
            assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# faults and chunks
# --------------------------------------------------------------------------

ITERS = 12
K = 4


@pytest.mark.parametrize("point,expect", [
    ("device.call", "device_error"),
    ("device.lost", "device_lost"),
])
def test_fault_mid_stream_resumes_bit_exact(tiers, point, expect):
    t = tiers["f32"]
    ref, _, _ = ST.pagerank_streamed(t, max_iterations=ITERS, tol=-1.0,
                                     checkpoint_every=K, **CPU)
    FI.arm(point, "raise", at=2)
    report = RunReport()
    out, _, iters = ST.pagerank_streamed(t, max_iterations=ITERS, tol=-1.0,
                                         checkpoint_every=K, report=report,
                                         **CPU)
    assert iters == ITERS
    assert ref.tobytes() == out.tobytes()
    assert report.resumes == 1 and report.faults == [expect]
    assert report.lost_spans and max(report.lost_spans) <= K
    assert report.rebuilds == (1 if expect == "device_lost" else 0)


@pytest.mark.parametrize("algo", ["pagerank", "katz", "wcc"])
def test_checkpointed_stream_matches_monolithic(tiers, algo):
    run = {"pagerank": lambda **k: ST.pagerank_streamed(
               tiers["f32"], tol=-1.0, **k),
           "katz": lambda **k: ST.katz_streamed(
               tiers["f32"], alpha=0.05, tol=-1.0, **k),
           "wcc": lambda **k: ST.wcc_streamed(tiers["f32"], **k)}[algo]
    mono, _, im = run(max_iterations=ITERS, **CPU)
    chunked, _, ic = run(max_iterations=ITERS, checkpoint_every=3, **CPU)
    assert im == ic
    assert mono.tobytes() == chunked.tobytes()


# --------------------------------------------------------------------------
# the kernel server's third verdict
# --------------------------------------------------------------------------


def _est(coo):
    src, dst, w = coo
    return 3 * (src.nbytes + dst.nbytes + w.nbytes) + N * 32


def test_server_flips_resident_to_streamed_and_sheds(coo, tmp_path):
    src, dst, w = coo
    arrays = {"src": src, "dst": dst, "weights": w}
    header = {"graph_version": 1, "n_nodes": N, "max_iterations": 60}
    fat = KernelServer(socket_path=str(tmp_path / "fat.sock"),
                       hbm_budget_bytes=1 << 30, **CPU)
    reply_r, out_r = fat._supervised(
        "pagerank", {**header, "graph_key": "tr"}, dict(arrays))
    assert reply_r["outcome"] == "completed"
    assert reply_r["tier"] == "resident"

    streamed = ttier.streamed_request_bytes(N, M)
    before = global_metrics.value("tier.admission_streamed_total")
    thin = KernelServer(socket_path=str(tmp_path / "thin.sock"),
                        hbm_budget_bytes=streamed + 1, **CPU)
    reply_s, out_s = thin._supervised(
        "pagerank", {**header, "graph_key": "ts"}, dict(arrays))
    assert reply_s["outcome"] == "completed"
    assert reply_s["tier"] == "streamed"
    assert global_metrics.value("tier.admission_streamed_total") \
        == before + 1
    np.testing.assert_allclose(out_s["ranks"], out_r["ranks"], atol=1e-6)
    gen = thin._graphs.peek("ts")
    assert gen._graph.device is None          # nothing placed
    # the same bytes as the in-process streamed run
    want, _, _ = ST.pagerank_streamed(gen.ensure_tier("f32"),
                                      max_iterations=60, **CPU)
    assert out_s["ranks"].tobytes() == want.tobytes()
    # a key-only repeat: the generation's result cache answers
    again, out_a = thin._supervised(
        "pagerank", {**header, "graph_key": "ts"}, {})
    assert again.get("cache") == "hit"
    assert out_a["ranks"].tobytes() == out_s["ranks"].tobytes()

    tiny = KernelServer(socket_path=str(tmp_path / "tiny.sock"),
                        hbm_budget_bytes=streamed - 1, **CPU)
    reply_x, _ = tiny._supervised(
        "pagerank", {**header, "graph_key": "tx"}, dict(arrays))
    assert reply_x["outcome"] == "shed" and not reply_x["retryable"]


def test_server_streamed_semiring_and_warm_start(coo, tmp_path):
    src, dst, w = coo
    arrays = {"src": src, "dst": dst, "weights": w}
    thin = KernelServer(socket_path=str(tmp_path / "w.sock"),
                        hbm_budget_bytes=ttier.streamed_request_bytes(
                            N, M) + 1, **CPU)
    reply, out = thin._supervised(
        "semiring", {"graph_key": "w1", "graph_version": 1, "n_nodes": N,
                     "algorithm": "wcc"}, dict(arrays))
    assert reply["outcome"] == "completed" and reply["tier"] == "streamed"
    j, _, _ = jdist.wcc_streamed(jtier.plan_tier(src, dst, w, N))
    assert np.array_equal(out["components"], np.asarray(j))
    reply_k, out_k = thin._supervised(
        "semiring", {"graph_key": "w1", "graph_version": 1, "n_nodes": N,
                     "algorithm": "katz", "alpha": 0.05}, {})
    assert reply_k["tier"] == "streamed"
    jk, _, _ = jdist.katz_streamed(jtier.plan_tier(src, dst, w, N),
                                   alpha=0.05)
    jk = np.asarray(jk)
    assert np.abs(out_k["ranks"] - jk).max() <= REL * np.abs(jk).max()
    # labelprop has no streamed run: over the budget it is shed
    reply2, _ = thin._supervised(
        "semiring", {"graph_key": "w2", "graph_version": 1, "n_nodes": N,
                     "algorithm": "labelprop"}, dict(arrays))
    assert reply2["outcome"] == "shed"
    # a commit's delta moves the generation's plan; PageRank warm-starts
    h = {"graph_key": "w1", "n_nodes": N, "max_iterations": 100}
    cold, _ = thin._supervised("pagerank", {**h, "graph_version": 1}, {})
    assert cold["tier"] == "streamed" and not cold["warm_started"]
    changed = np.array([0, 3], dtype=np.int32)
    inc = np.flatnonzero(np.isin(src, changed) | np.isin(dst, changed))
    inc_src = np.concatenate([src[inc], [0]])
    inc_dst = np.concatenate([dst[inc], [3]])
    inc_w = np.concatenate([w[inc], [1.0]]).astype(np.float32)
    warm, out_w = thin._supervised(
        "pagerank", {**h, "graph_version": 2, "base_version": 1,
                     "has_delta": True},
        {"changed": changed, "inc_src": inc_src, "inc_dst": inc_dst,
         "inc_w": inc_w})
    assert warm["tier"] == "streamed" and warm["warm_started"]
    assert warm["iters"] < cold["iters"]
    fresh = ttier.plan_tier(np.concatenate([src, [0]]),
                            np.concatenate([dst, [3]]),
                            np.concatenate([w, [1.0]]).astype(np.float32),
                            N)
    ref, _, _ = ST.pagerank_streamed(fresh, **CPU)
    assert np.abs(out_w["ranks"] - ref).max() <= 1e-5
