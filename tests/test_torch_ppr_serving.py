"""The port's PPR serving plane (memgraph_tpu_torch/server/
kernel_server.py: ``PprServingPlane``, ``PprResultCache``) on a daemon
on the CPU, against the port's in-process PPR and the JAX package's.

Models: tests/test_ppr_serving.py's serving-plane and routing cases
(coalescing, mixed parameter groups, a hit with no stale read across a
version bump, targeted invalidation, an unknowable delta, a bad member
and an oversized request, a saturated queue, the counters on the health
reply, the ops-level route against in-process, the loud fallback on a
dead socket, a device fault mid-batch answering every rider typed), and
the routed legs of ``vector_search.ppr_search`` and
``graphrag.retrieve``.

One daemon serves the file (``--device cpu``, a 30 ms window so that
concurrent threads coalesce); the saturation and the fault case run an
in-process server whose knobs the test sets.  Tolerances: a cold reply
is bit-equal to the port's in-process ``personalized_pagerank`` (the
lanes of a batch are independent, ops/pagerank.py), and within 1e-6 of
the largest entry of the JAX package's (tests/test_torch_ppr.py's
bound); a warm reply within tol of a cold in-process run.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops.csr import GraphCache
from memgraph_tpu_torch.procedures import graph_algorithms as P
from memgraph_tpu_torch.procedures import graphrag, vector_search
from memgraph_tpu_torch.server import kernel_server as ks
from memgraph_tpu_torch.utils import faultinject as FI
from memgraph_tpu_torch.utils.metrics import global_metrics

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-8
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("ppr") / "ks.sock")
    env = dict(os.environ)
    env.pop("MEMGRAPH_TPU_FAULTS", None)
    env["MEMGRAPH_TPU_PPR_BATCH_WINDOW_MS"] = "30"
    client = ks.ensure_server(sock, spawn_timeout_s=TIMEOUT,
                              idle_timeout_s=120, device="cpu", env=env)
    assert client is not None, ks.log_tail(sock)
    yield client, sock
    client.shutdown()
    client.close()
    client.process.wait(timeout=TIMEOUT)


@pytest.fixture(autouse=True)
def _clean_faults():
    FI.reset()
    yield
    FI.reset()


def _graph(seed=0, n=300, e=1800):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return tcsr.from_coo(src, dst, n_nodes=n), (src, dst, n)


def _in_process(g, sources, **kw):
    ranks, _, iters = tpr.personalized_pagerank(g, sources, device="cpu",
                                                **kw)
    return ranks.numpy(), int(iters)


def _concurrently(sock, calls):
    """Run ``calls[i](client)`` on threads released together; {i:
    ("ok", result) | ("exc", exception)}."""
    out = {}
    barrier = threading.Barrier(len(calls))

    def worker(i):
        c = ks.KernelClient(sock, timeout=TIMEOUT)
        try:
            barrier.wait(timeout=TIMEOUT)
            out[i] = ("ok", calls[i](c))
        except Exception as e:  # noqa: BLE001 — recorded for the test
            out[i] = ("exc", e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(out) == len(calls)
    return out


def test_coalescing_concurrent_requests(daemon):
    """Concurrent requests ride one batch; each answer is bit-equal to
    the port's in-process PPR, and close to the JAX package's."""
    client, sock = daemon
    g, (src, dst, n) = _graph(seed=2)
    client.ppr([0], src=src, dst=dst, n_nodes=n, graph_key="co",
               graph_version=1, tol=TOL)
    before = client.health()["counters"].get("ppr.coalesced_total", 0)
    results = _concurrently(sock, [
        lambda c, i=i: c.ppr([i + 1], graph_key="co", graph_version=1,
                             n_nodes=n, tol=TOL) for i in range(8)])
    replies = [r for kind, r in results.values() if kind == "ok"]
    assert len(replies) == 8
    assert max(h["batch_size"] for h, _ in replies) > 1
    assert client.health()["counters"]["ppr.coalesced_total"] > before
    jg = jcsr.from_coo(src, dst, n_nodes=n)
    for i, (kind, (h, out)) in results.items():
        want, iters = _in_process(g, [i + 1], tol=TOL)
        assert out["ranks"].tobytes() == want.tobytes()
        assert h["iters"] == iters and h["outcome"] == "completed"
        jw, _, _ = jpr.personalized_pagerank(jg, [i + 1], tol=TOL)
        np.testing.assert_allclose(out["ranks"], np.asarray(jw),
                                   atol=1e-6 * float(np.max(jw)))


def test_mixed_parameter_groups_never_share_a_fixpoint(daemon):
    client, sock = daemon
    g, (src, dst, n) = _graph(seed=3)
    client.ppr([0], src=src, dst=dst, n_nodes=n, graph_key="mix",
               graph_version=1, tol=TOL)
    params = [(0.85, TOL), (0.7, TOL), (0.85, 1e-4), (0.7, 1e-4)]
    results = _concurrently(sock, [
        lambda c, d=d, t=t: c.ppr([5], graph_key="mix", graph_version=1,
                                  n_nodes=n, damping=d, tol=t)
        for d, t in params])
    for i, (damping, tol) in enumerate(params):
        kind, (h, out) = results[i]
        want, iters = _in_process(g, [5], damping=damping, tol=tol)
        assert out["ranks"].tobytes() == want.tobytes()
        assert h["iters"] == iters


def test_cache_hit_on_repeat_and_no_stale_read(daemon):
    """A repeat is a hit (the same bytes); a commit touching the source's
    neighbourhood makes the old vector a warm seed, never an answer."""
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=4)
    h1, out1 = client.ppr([3], src=src, dst=dst, n_nodes=n,
                          graph_key="inv", graph_version=1, tol=TOL)
    assert h1["cache"] == "miss"
    h2, out2 = client.ppr([3], graph_key="inv", graph_version=1,
                          n_nodes=n, tol=TOL)
    assert h2["cache"] == "hit"
    assert out1["ranks"].tobytes() == out2["ranks"].tobytes()
    src2, dst2 = src.copy(), dst.copy()
    edge = np.flatnonzero(src2 == 3)[0]
    dst2[edge] = (dst2[edge] + 7) % n
    h3, out3 = client.ppr([3], src=src2, dst=dst2, n_nodes=n,
                          graph_key="inv", graph_version=2, base_version=1,
                          changed=[3, int(dst2[edge]), int(dst[edge])],
                          tol=TOL)
    assert h3["cache"] == "warm"
    assert out3["ranks"].tobytes() != out1["ranks"].tobytes()
    want, _ = _in_process(tcsr.from_coo(src2, dst2, n_nodes=n), [3],
                          tol=TOL)
    np.testing.assert_allclose(out3["ranks"], want, atol=TOL)


def test_targeted_invalidation_keeps_untouched_sources_hot(daemon):
    """A change outside the source's neighbourhood, on nodes that hold
    none of its PPR mass (two isolated nodes), keeps the entry a hit."""
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=5)
    n_all = n + 2
    client.ppr([100], src=src, dst=dst, n_nodes=n_all, graph_key="tgt",
               graph_version=1, tol=TOL)
    h, _ = client.ppr([100], graph_key="tgt", graph_version=1,
                      n_nodes=n_all, tol=TOL)
    assert h["cache"] == "hit"
    far = [n, n + 1]
    h, _ = client.ppr([100], src=src, dst=dst, n_nodes=n_all,
                      graph_key="tgt", graph_version=2, base_version=1,
                      changed=far, tol=TOL)
    assert h["cache"] == "hit"            # provably untouched: still hot


def _ppr64(src, dst, n, source, damping=0.85, iterations=400):
    """Float64 PPR restarting on ``source`` (dangling mass restarts)."""
    deg = np.bincount(src, minlength=n).astype(np.float64)
    p = np.zeros(n)
    p[source] = 1.0
    x = p.copy()
    for _ in range(iterations):
        spread = np.zeros(n)
        np.add.at(spread, dst, x[src] / deg[src])
        x = (1 - damping) * p + damping * (spread + x[deg == 0].sum() * p)
    return x


def test_a_commit_two_hops_out_does_not_leave_a_stale_hit(daemon):
    """A commit that rewires the out-edges of the node, outside the
    source's one-hop neighbourhood, with the most of its PPR mass: the
    reply after it holds to a float64 PPR of the new graph within 1e-4 of
    its largest entry.  The first-hop rule alone (the reference's) keeps
    the old vector as a hit here, off by more than that."""
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=21)
    s = 11
    h1, out1 = client.ppr([s], src=src, dst=dst, n_nodes=n,
                          graph_key="hop2", graph_version=1, tol=TOL)
    assert h1["cache"] == "miss"
    near = set(dst[src == s].tolist()) | {s}
    ranks = out1["ranks"].copy()
    ranks[list(near)] = -1.0
    v = int(np.argmax(ranks))
    rows = np.flatnonzero(src == v)
    far = next(int(x) for x in np.argsort(out1["ranks"])
               if int(x) not in near and int(x) != v)
    src2, dst2 = src.copy(), dst.copy()
    dst2[rows] = far
    changed = sorted({v, far} | set(dst[rows].tolist()))
    h2, out2 = client.ppr([s], src=src2, dst=dst2, n_nodes=n,
                          graph_key="hop2", graph_version=2, base_version=1,
                          changed=changed, tol=TOL)
    want = _ppr64(src2, dst2, n, s)
    stale = float(np.abs(out1["ranks"] - want).max() / want.max())
    assert stale > 1e-4                 # the old vector is out of bounds
    assert float(np.abs(out2["ranks"] - want).max() / want.max()) <= 1e-4
    assert h2["cache"] == "warm"


def test_drift_carries_a_small_commit_and_adds_up_to_a_demotion(daemon):
    """A commit outside the source's one-hop neighbourhood whose nodes
    hold a little of its PPR mass (a shortcut deep in a chain hanging off
    the graph) stays a hit, within 1e-4 of its largest entry of a
    float64 PPR of the new graph.  The bound of that commit is kept as
    the entry's drift: a second commit on two isolated nodes (no mass,
    which a fresh entry carries, see the test above) then passes the
    bound with the drift added, and the reply is a warm one."""
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=22)
    s, length = 11, 80
    chain = np.arange(n, n + length)
    u = next(int(x) for x in range(n) if x != s and x not in set(
        dst[src == s].tolist()))
    src1 = np.concatenate([src, [u], chain[:-1], [chain[-1]]])
    dst1 = np.concatenate([dst, [chain[0]], chain[1:], [0]])
    n_all = n + length + 2
    h1, out1 = client.ppr([s], src=src1, dst=dst1, n_nodes=n_all,
                          graph_key="drift", graph_version=1, tol=TOL)
    assert h1["cache"] == "miss"
    ranks = out1["ranks"].astype(np.float64)
    factor = 2 * 0.85 / (1 - 0.85)
    bound = ks.PPR_HIT_BOUND * ranks.max()
    # the shortcut c_k -> c_{k+2} whose bound sits nearest the geometric
    # middle of (bound / (1 + factor), bound]: it carries, and a second
    # commit of any mass no longer does
    target = bound / np.sqrt(1 + factor)
    live = [i for i in range(length - 2) if ranks[chain[i + 2]] > 0]
    k = min(live, key=lambda i: abs(np.log(
        factor * (ranks[chain[i]] + ranks[chain[i + 2]]) / target)))
    pair = [int(chain[k]), int(chain[k + 2])]
    m1 = factor * ranks[pair].sum()
    assert bound / (1 + factor) < m1 <= bound
    src2 = np.concatenate([src1, [pair[0]]])
    dst2 = np.concatenate([dst1, [pair[1]]])
    h2, out2 = client.ppr([s], src=src2, dst=dst2, n_nodes=n_all,
                          graph_key="drift", graph_version=2, base_version=1,
                          changed=pair, tol=TOL)
    assert h2["cache"] == "hit"
    assert out2["ranks"].tobytes() == out1["ranks"].tobytes()
    want2 = _ppr64(src2, dst2, n_all, s)
    assert float(np.abs(out2["ranks"] - want2).max() / want2.max()) <= 1e-4
    iso = [n_all - 2, n_all - 1]
    src3 = np.concatenate([src2, [iso[0]]])
    dst3 = np.concatenate([dst2, [iso[1]]])
    h3, out3 = client.ppr([s], src=src3, dst=dst3, n_nodes=n_all,
                          graph_key="drift", graph_version=3, base_version=2,
                          changed=iso, tol=TOL)
    assert h3["cache"] == "warm"
    want3 = _ppr64(src3, dst3, n_all, s)
    assert float(np.abs(out3["ranks"] - want3).max() / want3.max()) <= 1e-4


def test_a_hit_that_carries_a_delta_moves_the_generation(daemon):
    """``pagerank.personalized`` of s at v0, a commit far from s, s again
    at v1 (a hit whose request carries the delta payload), then t at v1
    (a key-only request): the hit applies its payload before it is
    answered, so t runs on v1 with no fallback.  The commit joins two
    isolated nodes, which hold none of s's PPR mass.  t's cold reply is
    within 1e-6 of the in-process answer (the resident COO's edge order
    differs from the snapshot's after a splice)."""
    client, sock = daemon
    n, e = 400, 2400
    rng = np.random.default_rng(18)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    source = CooSource(src, dst, n + 2)
    kw = {"cache": GraphCache(), "device": "cpu"}
    fallbacks = global_metrics.value("analytics.kernel_route_fallback_total")
    s, t = 5, 6
    far = [n, n + 1]
    P.pagerank_personalized(source, [s], kernel=sock, **kw)
    source.commit([far[0]], [far[1]])
    hits = client.health()["counters"].get("ppr.cache_hit_total", 0.0)
    P.pagerank_personalized(source, [s], kernel=sock, **kw)
    assert client.health()["counters"]["ppr.cache_hit_total"] == hits + 1
    got = P.pagerank_personalized(source, [t], kernel=sock, **kw)
    want = P.pagerank_personalized(source, [t], **kw)
    np.testing.assert_allclose(got["rank"], want["rank"], atol=1e-6)
    assert global_metrics.value(
        "analytics.kernel_route_fallback_total") == fallbacks


def test_unknowable_delta_invalidates_the_whole_key(daemon):
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=6)
    client.ppr([9], src=src, dst=dst, n_nodes=n, graph_key="flush",
               graph_version=1, tol=TOL)
    h, _ = client.ppr([9], src=src, dst=dst, n_nodes=n, graph_key="flush",
                      graph_version=2, tol=TOL)
    assert h["cache"] in ("warm", "miss")


def test_one_bad_request_does_not_poison_the_batch(daemon):
    client, sock = daemon
    g, (src, dst, n) = _graph(seed=7)
    client.ppr([0], src=src, dst=dst, n_nodes=n, graph_key="mixed",
               graph_version=1, tol=TOL)
    results = _concurrently(sock, [
        lambda c: c.ppr([1], graph_key="mixed", graph_version=1,
                        n_nodes=n, tol=TOL),
        lambda c: c.ppr([2], graph_key="mixed", graph_version=1,
                        n_nodes=n, tol=TOL),
        lambda c: c.ppr([n + 50], graph_key="mixed", graph_version=1,
                        n_nodes=n, tol=TOL)])
    kind, err = results[2]
    assert kind == "exc" and isinstance(err, ks.KernelServerError)
    assert err.outcome == "invalid" and "out of range" in str(err)
    for i in (0, 1):
        kind, (h, out) = results[i]
        assert kind == "ok" and h["outcome"] == "completed"
        want, _ = _in_process(g, [i + 1], tol=TOL)
        assert out["ranks"].tobytes() == want.tobytes()


def test_oversized_request_sheds_typed(daemon):
    client, _ = daemon
    before = client.health()["counters"].get("ppr.shed_total", 0)
    with pytest.raises(ks.AdmissionRejected) as ei:
        client.ppr([1], n_nodes=1 << 31, graph_key="shed", graph_version=1)
    assert ei.value.outcome == "shed" and not ei.value.retryable
    assert client.health()["counters"]["ppr.shed_total"] == before + 1


def test_ppr_counters_ride_the_health_reply(daemon):
    """The plane's counters on the health reply, after a request of this
    test's own (under xdist the daemon may have served nothing yet)."""
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=8)
    client.ppr([1], src=src, dst=dst, n_nodes=n, graph_key="counters",
               graph_version=1, tol=TOL)
    h = client.health()
    names = set(h["counters"])
    for name in ("ppr.requests_total", "ppr.batches_total",
                 "ppr.batch_size.count", "ppr.drain_s.sum",
                 "ppr.neighborhood_s.sum"):
        assert name in names, name
    assert h["launches"]["csr_spmm_sum"] == 0   # the CPU's plain versions


def test_topk_on_the_wire_matches_jax(daemon):
    client, _ = daemon
    _, (src, dst, n) = _graph(seed=12)
    h, out = client.ppr([4, 8], src=src, dst=dst, n_nodes=n,
                        graph_key="topk", graph_version=1, tol=TOL,
                        top_k=10)
    jg = jcsr.from_coo(src, dst, n_nodes=n)
    ranks, _, _ = jpr.personalized_pagerank_batch(jg, [[4, 8]], tol=TOL)
    vals, idx = jpr.ppr_topk(ranks, n, 10)
    np.testing.assert_allclose(out["topk_val"], np.asarray(vals)[0],
                               atol=1e-6 * float(ranks.max()))
    assert np.array_equal(out["topk_idx"], np.asarray(idx)[0])
    # a hit's top-k comes from the cached vector, with the same order
    h2, out2 = client.ppr([4, 8], graph_key="topk", graph_version=1,
                          n_nodes=n, tol=TOL, top_k=10)
    assert h2["cache"] == "hit"
    assert out2["topk_idx"].tobytes() == out["topk_idx"].tobytes()
    assert out2["topk_val"].tobytes() == out["topk_val"].tobytes()


def test_ops_level_kernel_route_matches_in_process(daemon):
    _, sock = daemon
    g, _ = _graph(seed=13)
    want, werr, witers = tpr.personalized_pagerank(g, [4, 8], tol=TOL,
                                                   device="cpu")
    sup = ks.SupervisedKernelClient(sock, spawn=False)
    routed = global_metrics.value("analytics.kernel_routed_total")
    try:
        got, gerr, giters = tpr.personalized_pagerank(
            g, [4, 8], tol=TOL, kernel=sup, device="cpu")
    finally:
        sup.close()
    assert isinstance(got, torch.Tensor)
    assert torch.equal(got, want) and giters == witers
    assert global_metrics.value("analytics.kernel_routed_total") \
        == routed + 1


def test_kernel_route_falls_back_loudly_on_a_dead_socket(tmp_path, caplog):
    g, _ = _graph(seed=14)
    before = global_metrics.value("analytics.kernel_route_fallback_total")
    with caplog.at_level("WARNING"):
        got, _, _ = tpr.personalized_pagerank(
            g, [3], tol=TOL, kernel=str(tmp_path / "nothing.sock"),
            device="cpu")
    want, _, _ = tpr.personalized_pagerank(g, [3], tol=TOL, device="cpu")
    assert torch.equal(got, want)
    assert global_metrics.value("analytics.kernel_route_fallback_total") \
        == before + 1
    assert any("falling back" in r.getMessage() for r in caplog.records)


def _in_thread_server(path, **kw):
    srv = ks.KernelServer(str(path), device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    deadline = time.monotonic() + TIMEOUT
    while True:
        try:
            return srv, ks.KernelClient(str(path), timeout=TIMEOUT)
        except OSError:
            assert time.monotonic() < deadline
            time.sleep(0.05)


def test_queue_saturation_sheds_typed(tmp_path):
    srv, client = _in_thread_server(tmp_path / "sat.sock")
    try:
        _, (src, dst, n) = _graph(seed=9)
        client.ppr([0], src=src, dst=dst, n_nodes=n, graph_key="sat",
                   graph_version=1, tol=TOL)
        srv._ppr.max_queue = 0
        with pytest.raises(ks.AdmissionRejected) as ei:
            client.ppr([1], graph_key="sat", graph_version=1, n_nodes=n,
                       tol=TOL)
        assert "queue saturated" in str(ei.value)
    finally:
        client.shutdown()
        client.close()


def test_device_fault_mid_batch_fails_every_rider_typed(tmp_path):
    """A lost card during a coalesced batch: every rider of that batch
    gets the same typed, retryable failure; the next batch completes."""
    srv, client = _in_thread_server(tmp_path / "chaos.sock")
    srv._ppr.window_s = 0.03
    try:
        g, (src, dst, n) = _graph(seed=15)
        client.ppr([0], src=src, dst=dst, n_nodes=n, graph_key="chaos",
                   graph_version=1, tol=TOL)
        FI.arm("device.lost", "raise", at=FI.hit_count("device.lost") + 1)
        results = _concurrently(str(tmp_path / "chaos.sock"), [
            lambda c, i=i: c.ppr([i + 1], graph_key="chaos",
                                 graph_version=1, n_nodes=n, tol=TOL)
            for i in range(4)])
        FI.reset()
        kinds = set()
        for kind, payload in results.values():
            if kind == "exc":
                assert isinstance(payload, ks.KernelDeviceError)
                kinds.add("typed")
            else:
                assert payload[0]["outcome"] == "completed"
                kinds.add("ok")
        assert "typed" in kinds
        h, out = client.ppr([1], graph_key="chaos", graph_version=1,
                            n_nodes=n, tol=TOL)
        want, _ = _in_process(g, [1], tol=TOL)
        assert out["ranks"].tobytes() == want.tobytes()
    finally:
        client.shutdown()
        client.close()


def test_routed_rag_legs_are_the_ppr_top_k(daemon):
    """``ppr_search`` and ``graphrag.retrieve`` with ``kernel=``: one
    coalesced round trip whose records are the PPR's top ``limit`` from
    the seeds (the reference's routed leg: no k-hop mask), equal to the
    in-process PPR's; ``ppr_search``'s routed records equal its
    in-process ones."""
    _, sock = daemon
    n, e, dim = 400, 2400, 8
    rng = np.random.default_rng(16)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    source = CooSource(src, dst, n, properties={"embedding": emb})
    kw = {"cache": GraphCache(), "index_cache": vector_search.IndexCache(),
          "device": "cpu"}
    query = emb[5] + 0.1
    got = vector_search.ppr_search(source, "embedding", query, 3, 10,
                                   kernel=sock, **kw)
    want = vector_search.ppr_search(source, "embedding", query, 3, 10, **kw)
    assert np.array_equal(got["node_gids"], want["node_gids"])
    assert got["score"].tobytes() == want["score"].astype(
        np.float32).tobytes()
    assert np.array_equal(got["seed_similarity"], want["seed_similarity"])
    rag = graphrag.retrieve(source, "embedding", query, 3, hops=2,
                            limit=10, kernel=sock, **kw)
    assert np.array_equal(rag["node_gids"], got["node_gids"])
    assert rag["score"].tobytes() == got["score"].tobytes()
