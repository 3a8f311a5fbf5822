"""The port's resident kernel server (memgraph_tpu_torch/server/
kernel_server.py) as a daemon on the CPU, against the JAX package's
in-process functions on the same numpy-seeded graphs.

Models: tests/test_kernel_server.py (ping, remote PageRank against
scipy, graph_key caching across clients, an unknown key, a garbage
header), tests/test_delta.py:521-610 (the delta refresh and the warm
start, the WCC monotone gate, a stale generation never served) and
tests/test_device_resilience.py (typed outcomes through
``MEMGRAPH_TPU_FAULTS``, ``SupervisedKernelClient``'s retry and restart).
The JAX package's own ``KernelClient`` drives the daemon once (the
wire is the reference's).  The reference's resumable route fails on jax
0.9.0; one test pins that, beside the port's answer.

One daemon serves the file (``--device cpu``; the MXU route forced for
graphs of 5,000 edges or more, ``MEMGRAPH_TPU_FORCE_MXU`` and
``MEMGRAPH_TPU_MXU_MIN_EDGES`` in its environment); the fault tests
spawn their own.  Every client has a timeout and every daemon is shut
down.  Tolerances: PageRank within rtol 3e-4 of scipy and of the JAX
package (tests/test_kernel_server.py's bound); katz within rtol 1e-5 of
JAX's; WCC, label propagation and BFS exact; a warm start within 10 tol
of a cold in-process run (tests/test_delta.py's bound).
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from memgraph_tpu.ops import components as jcomp
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import katz as jkatz
from memgraph_tpu.ops import labelprop as jlp
from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu.ops import pipeline as jpl
from memgraph_tpu.ops import traversal as jtr
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.ops.csr import GraphCache
from memgraph_tpu_torch.ops import pipeline as tpl
from memgraph_tpu_torch.ops.csr import shard_edges
from memgraph_tpu_torch.ops.delta import LocalWarmPool
from memgraph_tpu_torch.parallel import analytics as TA
from memgraph_tpu_torch.parallel.distributed import \
    pagerank_partition_centric
from memgraph_tpu_torch.parallel.mesh import get_mesh_context
from memgraph_tpu_torch.procedures import graph_algorithms as P
from memgraph_tpu_torch.server import kernel_server as ks
from memgraph_tpu_torch.utils.metrics import global_metrics
from memgraph_tpu_torch.utils.retry import RetryPolicy

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TOL = 1e-6
RTOL = 3e-4
TIMEOUT = 60.0
MXU_MIN_EDGES = 5000


def _env(**extra):
    env = dict(os.environ)
    env.pop("MEMGRAPH_TPU_FAULTS", None)
    env.update({"MEMGRAPH_TPU_FORCE_MXU": "1",
                "MEMGRAPH_TPU_MXU_MIN_EDGES": str(MXU_MIN_EDGES)})
    env.update(extra)
    return env


def _spawn(path, **extra):
    client = ks.ensure_server(path, spawn_timeout_s=TIMEOUT,
                              idle_timeout_s=120, device="cpu",
                              env=_env(**extra))
    assert client is not None, ks.log_tail(path)
    return client


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("ks") / "ks.sock")
    client = _spawn(sock)
    yield client, sock
    client.shutdown()
    client.close()
    client.process.wait(timeout=TIMEOUT)


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def _scipy_pagerank(src, dst, n, iters=100, damping=0.85, tol=TOL):
    import scipy.sparse as sp
    w = np.ones(len(src))
    wsum = np.bincount(src, weights=w, minlength=n)
    inv = np.where(wsum > 0, 1.0 / np.maximum(wsum, 1e-300), 0.0)
    m = sp.csr_matrix((w * inv[src], (dst, src)), shape=(n, n))
    dang = wsum <= 0
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        new = (1 - damping) / n + damping * (m @ rank + rank[dang].sum() / n)
        if np.abs(new - rank).sum() <= tol:
            return new
        rank = new
    return rank


def _jax_pagerank(src, dst, n, **kw):
    ranks, _, iters = jpr.pagerank(jcsr.from_coo(src, dst, n_nodes=n), **kw)
    return np.asarray(ranks), int(iters)


def _incident_payload(src, dst, changed, n):
    bitmap = np.zeros(n, dtype=bool)
    bitmap[np.asarray(changed, dtype=np.int64)] = True
    sel = bitmap[src] | bitmap[dst]
    return (src[sel].astype(np.int64), dst[sel].astype(np.int64),
            np.ones(int(sel.sum()), dtype=np.float32))


def test_ping_is_another_process(daemon):
    client, _ = daemon
    assert client.ping()
    h, _ = client.call({"op": "ping"})
    assert h["pid"] != os.getpid()
    probe = client.probe()
    assert probe["outcome"] == "completed" and probe["platform"] == "cpu"
    assert probe["sum"] == 128.0 ** 3


def test_remote_pagerank_matches_scipy_and_jax(daemon):
    client, _ = daemon
    n, e = 2000, 12000
    src, dst = _graph(0, n, e)
    h, out = client.call_pagerank(src=src, dst=dst, n_nodes=n)
    assert h["outcome"] == "completed" and h["tier"] == "resident"
    np.testing.assert_allclose(out["ranks"], _scipy_pagerank(src, dst, n),
                               rtol=RTOL, atol=1e-8)
    want, _ = _jax_pagerank(src, dst, n)
    np.testing.assert_allclose(out["ranks"], want, rtol=RTOL, atol=1e-8)


def test_graph_key_caching_across_clients(daemon):
    """A key-only repeat is a hit with the same bytes, from another
    client too."""
    client, sock = daemon
    n, e = 1000, 6000
    src, dst = _graph(1, n, e)
    r1, _, _ = client.pagerank(src=src, dst=dst, n_nodes=n, graph_key="g1")
    h, out = client.call_pagerank(graph_key="g1")
    assert h["cache"] == "hit"
    assert out["ranks"].tobytes() == r1.tobytes()
    c2 = ks.KernelClient(sock, timeout=TIMEOUT)
    try:
        r3, _, _ = c2.pagerank(graph_key="g1")
    finally:
        c2.close()
    assert r3.tobytes() == r1.tobytes()


def test_unknown_key_without_arrays_is_invalid(daemon):
    client, _ = daemon
    with pytest.raises(ks.KernelServerError) as ei:
        client.pagerank(graph_key="never-seen")
    assert ei.value.outcome == "invalid" and not ei.value.retryable
    assert client.ping()


def test_garbage_header_drops_the_connection_not_the_server(daemon):
    client, sock = daemon
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    raw.settimeout(TIMEOUT)
    try:
        raw.connect(sock)
        raw.sendall(struct.pack("<I", 8) + b"\xff" * 8)
        assert raw.recv(4096) == b""           # dropped, nothing shipped
    finally:
        raw.close()
    assert client.ping()


def test_semiring_algorithms_match_jax(daemon):
    client, _ = daemon
    n, e = 2000, 12000
    src, dst = _graph(2, n, e)
    jg = jcsr.from_coo(src, dst, n_nodes=n)
    client.semiring("pagerank", src=src, dst=dst, n_nodes=n,
                    graph_key="alg", graph_version=1)
    kw = {"graph_key": "alg", "graph_version": 1}
    h, out = client.semiring("katz", alpha=0.05, tol=1e-8, **kw)
    want, _, iters = jkatz.katz_centrality(jg, alpha=0.05, tol=1e-8)
    np.testing.assert_allclose(out["ranks"], np.asarray(want), rtol=1e-5)
    h, out = client.semiring("wcc", **kw)
    want, _ = jcomp.weakly_connected_components(jg, max_iterations=100)
    assert np.array_equal(out["components"], np.asarray(want))
    h, out = client.semiring("labelprop", **kw)
    want, _ = jlp.label_propagation(jg, max_iterations=100)
    assert np.array_equal(out["labels"], np.asarray(want))
    h, out = client.semiring("bfs", source=7, **kw)
    want, _ = jtr.bfs_levels(jg, 7, max_iterations=100)
    assert np.array_equal(out["levels"], np.asarray(want))
    with pytest.raises(ks.KernelServerError, match="unknown semiring"):
        client.semiring("nope", **kw)
    # the lane op is served (below); a request without its arrays is
    # answered invalid, naming what it lacks
    with pytest.raises(ks.KernelServerError, match="lane op needs array"):
        h, _ = client.call({"op": "lane"})
        ks._raise_for_reply(h)


def test_delta_refresh_and_warm_start(daemon):
    """Full import at v1 (``semiring``'s pagerank takes the MXU route: a
    full plan; the ``pagerank`` op the mesh's, on the generation's sharded
    variant); the commit ships only the delta payload at v2: the
    generation moves O(delta), the ``pagerank`` op's warm reply builds no
    plan and matches a cold in-process run on the new graph, in no more
    iterations, and ``semiring``'s snapshot refreshes through a DeltaPlan
    (no plan build)."""
    client, _ = daemon
    n, e = 1000, 8000
    src, dst = _graph(30, n, e)
    client.semiring("pagerank", src=src, dst=dst, n_nodes=n,
                    graph_key="dg1", graph_version=1, tol=TOL)
    h1, _ = client.call_pagerank(n_nodes=n, graph_key="dg1",
                                 graph_version=1, tol=TOL)
    plans = client.health()["plans"]
    rng = np.random.default_rng(31)
    add_src, add_dst = rng.integers(0, n, 20), rng.integers(0, n, 20)
    src2, dst2 = np.concatenate([src, add_src]), np.concatenate([dst, add_dst])
    changed = np.unique(np.concatenate([add_src, add_dst])).astype(np.int32)
    inc = _incident_payload(src2, dst2, changed, n)
    h2, out2 = client.call_pagerank(
        n_nodes=n, graph_key="dg1", graph_version=2, base_version=1,
        changed=changed, inc_src=inc[0], inc_dst=inc[1], inc_w=inc[2],
        tol=TOL)
    assert h2["warm_started"] and h2["graph_version"] == 2
    assert h2["err"] <= TOL and h2["iters"] <= h1["iters"]
    after = client.health()
    assert after["plans"] == plans
    assert after["counters"]["delta.applied_total"] >= 1
    want, it_ref = _jax_pagerank(src2, dst2, n, tol=TOL)
    assert np.abs(want - out2["ranks"]).max() < 10 * TOL
    assert h2["iters"] <= it_ref
    _, out3 = client.semiring("pagerank", n_nodes=n, graph_key="dg1",
                              tol=TOL)
    after = client.health()
    assert after["plans"]["build_plan"] == plans["build_plan"]
    assert after["plans"]["build_delta_plan"] == \
        plans["build_delta_plan"] + 1
    assert np.abs(want - out3["ranks"]).max() < 10 * TOL


def test_wcc_monotone_gate(daemon):
    client, _ = daemon
    n, e = 300, 1600
    src, dst = _graph(31, n, e)
    h1, out1 = client.semiring("wcc", src=src, dst=dst, n_nodes=n,
                               graph_key="dg2", graph_version=1)
    assert h1["warm_started"] is False
    h2, out2 = client.semiring("wcc", graph_key="dg2", graph_version=1)
    assert h2["warm_started"] is True and h2["cache"] == "hit"
    assert out1["components"].tobytes() == out2["components"].tobytes()
    src3, dst3 = np.delete(src, [0, 1]), np.delete(dst, [0, 1])
    changed = np.unique(np.concatenate([src[:2], dst[:2]])).astype(np.int32)
    inc = _incident_payload(src3, dst3, changed, n)
    before = client.health()["counters"].get("delta.cold_start_total", 0)
    h3, out3 = client.semiring(
        "wcc", graph_key="dg2", graph_version=2, base_version=1,
        changed=changed, inc_src=inc[0], inc_dst=inc[1], inc_w=inc[2])
    assert h3["warm_started"] is False
    assert client.health()["counters"]["delta.cold_start_total"] \
        == before + 1
    want, _ = jcomp.weakly_connected_components(
        jcsr.from_coo(src3, dst3, n_nodes=n))
    assert np.array_equal(out3["components"], np.asarray(want))


def test_stale_generation_is_never_served(daemon):
    client, _ = daemon
    n, e = 100, 500
    src, dst = _graph(32, n, e)
    client.pagerank(src=src, dst=dst, n_nodes=n, graph_key="dg3",
                    graph_version=1, tol=TOL)
    with pytest.raises(ks.KernelServerError):
        client.pagerank(n_nodes=n, graph_key="dg3", graph_version=2,
                        tol=TOL)


def test_typed_outcomes_through_fault_env(tmp_path):
    """``MEMGRAPH_TPU_FAULTS`` armed at the daemon's start: each point
    counts its own hits, and hit 1 of every point is the start-up probe.
    Dispatch 2 completes (the import), 3 raises device_error, 4 oom,
    5 stalls past its deadline (the health op reports it in flight),
    then the daemon serves again.  The requests are ``semiring``'s
    pagerank, one fault point a dispatch (the ``pagerank`` op checkpoints
    and resumes a device fault itself: test_device_lost_mid_run_resumes_
    bit_equal)."""
    sock = str(tmp_path / "ks.sock")
    client = _spawn(sock, MEMGRAPH_TPU_FAULTS=(
        "device.call=raise@3,device.oom=raise@4,device.hang=delay:1.5@5"))

    def pagerank(**kw):
        return client.semiring("pagerank", **kw)[1]["ranks"]

    try:
        n, e = 200, 1200
        src, dst = _graph(3, n, e)
        ref = pagerank(src=src, dst=dst, n_nodes=n, graph_key="f", tol=1e-9)
        with pytest.raises(ks.KernelDeviceError) as ei:
            pagerank(graph_key="f", tol=1e-8)
        assert ei.value.outcome == "device_error" and ei.value.retryable
        with pytest.raises(ks.KernelOom) as ei:
            pagerank(graph_key="f", tol=1e-8)
        assert ei.value.outcome == "oom" and not ei.value.retryable
        t0 = time.monotonic()
        with pytest.raises(ks.KernelDeadlineExceeded):
            pagerank(graph_key="f", tol=1e-8, deadline_s=0.2)
        assert time.monotonic() - t0 < 1.2
        h = client.health()
        assert h["in_flight"] >= 1
        counters = h["counters"]
        for outcome in ("device_error", "oom", "deadline_exceeded"):
            assert counters[f"kernel_server.dispatch.{outcome}_total"] >= 1
        time.sleep(1.5)
        again = pagerank(graph_key="f", tol=1e-9)
        assert again.tobytes() == ref.tobytes()    # the stored solution
    finally:
        client.shutdown()
        client.close()
        client.process.wait(timeout=TIMEOUT)


def test_supervised_client_retries_and_restarts(tmp_path):
    sock = str(tmp_path / "ks.sock")
    first = _spawn(sock, MEMGRAPH_TPU_FAULTS="device.call=raise@2")
    first.close()
    sup = ks.SupervisedKernelClient(
        sock, spawn=True, device="cpu", spawn_timeout_s=TIMEOUT,
        idle_timeout_s=120,
        retry=RetryPolicy(base_delay=0.05, max_retries=3,
                          attempt_timeout=TIMEOUT))
    n, e = 200, 1200
    src, dst = _graph(4, n, e)
    try:
        retries = global_metrics.value("kernel_server.client.retries_total")
        ranks, _, _ = sup.pagerank(src=src, dst=dst, n_nodes=n,
                                   graph_key="s")
        assert global_metrics.value("kernel_server.client.retries_total") \
            == retries + 1                       # dispatch 2 failed once
        want, _ = _jax_pagerank(src, dst, n)
        np.testing.assert_allclose(ranks, want, rtol=RTOL, atol=1e-8)
        # shed is not retried
        t0 = time.monotonic()
        with pytest.raises(ks.AdmissionRejected):
            sup.pagerank(src=src, dst=dst, n_nodes=1 << 31)
        assert time.monotonic() - t0 < 1.0
        old_pid = sup.health()["pid"]
        assert sup.check_once() == "ok"
        sup.restart_server(reason="test")        # SIGKILL; the next call
        again, _, _ = sup.pagerank(src=src, dst=dst, n_nodes=n)  # respawns
        assert sup.health()["pid"] != old_pid
        np.testing.assert_allclose(again, want, rtol=RTOL, atol=1e-8)
    finally:
        c = ks.KernelClient(sock, timeout=TIMEOUT)
        c.shutdown()
        c.close()
        sup.close()


def test_jax_client_drives_the_port_daemon(daemon):
    """The JAX package's own KernelClient on the port's daemon: ping,
    ``pagerank``, ``ppr`` (full ranks and top-k) and ``semiring``."""
    from memgraph_tpu.server.kernel_server import KernelClient as JClient
    _, sock = daemon
    n, e = 2000, 12000
    src, dst = _graph(5, n, e)
    jg = jcsr.from_coo(src, dst, n_nodes=n)
    jc = JClient(sock, timeout=TIMEOUT)
    try:
        assert jc.ping()
        ranks, err, iters = jc.pagerank(src=src, dst=dst, n_nodes=n,
                                        graph_key="jax", graph_version=1)
        want, _ = _jax_pagerank(src, dst, n)
        np.testing.assert_allclose(ranks, want, rtol=RTOL, atol=1e-8)
        h, out = jc.ppr([3, 9], graph_key="jax", graph_version=1,
                        n_nodes=n, tol=1e-8)
        pw, _, _ = jpr.personalized_pagerank_batch(jg, [[3, 9]], tol=1e-8)
        np.testing.assert_allclose(out["ranks"], pw[0],
                                   atol=1e-6 * float(pw[0].max()))
        h, out = jc.ppr([3, 9], graph_key="jax", graph_version=1,
                        n_nodes=n, tol=1e-8, top_k=10)
        assert h["cache"] == "hit"
        vals, idx = jpr.ppr_topk(pw, n, 10)
        np.testing.assert_allclose(out["topk_val"], vals[0],
                                   atol=1e-6 * float(pw[0].max()))
        assert len(set(out["topk_idx"].tolist())
                   & set(np.asarray(idx[0]).tolist())) >= 9
        h, out = jc.semiring(algorithm="wcc", graph_key="jax",
                             graph_version=1)
        want, _ = jcomp.weakly_connected_components(jg, max_iterations=100)
        assert np.array_equal(out["components"], np.asarray(want))
        h, out = jc.semiring(algorithm="bfs", graph_key="jax",
                             graph_version=1, source=11)
        want, _ = jtr.bfs_levels(jg, 11, max_iterations=100)
        assert np.array_equal(out["levels"], np.asarray(want))
    finally:
        jc.close()


def test_jax_resumable_route_fails_and_the_port_serves(tmp_path):
    """Pins a reference-side defect on jax 0.9.0: the JAX
    package's in-process KernelServer with ``checkpoint_every`` fails its
    ``pagerank`` op (the partition-centric loop's while_loop carries
    differ in varying manual axes).  The port's server, in process too,
    answers the same request."""
    from memgraph_tpu.server import kernel_server as jks
    n, e = 300, 1800
    src, dst = _graph(6, n, e)
    servers = (jks.KernelServer(str(tmp_path / "j.sock"),
                                checkpoint_every=4),
               ks.KernelServer(str(tmp_path / "t.sock"), device="cpu"))
    outcomes = []
    for srv, client_cls in zip(servers, (jks.KernelClient, ks.KernelClient)):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                c = client_cls(srv.socket_path, timeout=TIMEOUT)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        try:
            outcomes.append(c.pagerank(src=src, dst=dst, n_nodes=n))
        except RuntimeError as e:
            outcomes.append(e)
        finally:
            c.shutdown()
            c.close()
    assert isinstance(outcomes[0], jks.KernelServerError)
    assert "varying manual axes" in str(outcomes[0])
    ranks, _, _ = outcomes[1]
    np.testing.assert_allclose(ranks, _scipy_pagerank(src, dst, n),
                               rtol=RTOL, atol=1e-8)


def test_procedures_route_gives_the_in_process_answers(daemon):
    """``pagerank.get`` and ``pagerank.personalized`` with ``kernel=``:
    the first call ships the edges, a call after a commit ships the delta
    payload only.  The daemon's ``pagerank`` runs the mesh's
    partition-centric loop, so a cold routed ``pagerank.get`` is bit for
    bit an in-process ``pagerank_partition_centric`` on the same
    snapshot (mesh of 1, same tolerance), and within pagerank.get's L1
    bound (10 stop_epsilon) of the in-process call; a warm one within
    that bound too; PPR as the in-process answers; the routed calls
    counted and no fallback."""
    _, sock = daemon
    n, e = 500, 3000
    src, dst = _graph(7, n, e)
    source = CooSource(src, dst, n)
    cache = GraphCache()
    kw = {"cache": cache, "device": "cpu"}
    routed = global_metrics.value("analytics.kernel_routed_total")
    fallbacks = global_metrics.value("analytics.kernel_route_fallback_total")
    got = P.pagerank_get(source, kernel=sock, **kw)
    graph = cache.get(source, device="cpu")
    ctx = get_mesh_context(1, device="cpu")
    mesh_ranks, _, _ = pagerank_partition_centric(
        shard_edges(*graph.host_coo, graph.n_nodes, 1).to_device(ctx), ctx,
        damping=0.85, max_iterations=100, tol=1e-5)
    want = P._rows(graph, rank=mesh_ranks.numpy())
    assert got["rank"].tobytes() == want["rank"].tobytes()
    want = P.pagerank_get(source, pool=LocalWarmPool(), **kw)
    assert np.abs(got["rank"] - want["rank"]).sum() < 10 * 1e-5
    got = P.pagerank_personalized(source, [3, 4], kernel=sock, **kw)
    want = P.pagerank_personalized(source, [3, 4], **kw)
    assert got["rank"].tobytes() == want["rank"].tobytes()
    rng = np.random.default_rng(8)
    source.commit(rng.integers(0, n, 30), rng.integers(0, n, 30))
    graph = cache.get(source, device="cpu")
    meta = P._serving_delta_meta(source, graph, sock,
                                 P._graph_key(source, "analytics"))
    assert meta["send_graph"] is False and len(meta["changed"]) > 0
    got = P.pagerank_get(source, kernel=sock, **kw)
    want = P.pagerank_get(source, pool=LocalWarmPool(), **kw)
    assert np.abs(got["rank"] - want["rank"]).sum() < 10 * 1e-5
    got = P.pagerank_personalized(source, [3, 4], kernel=sock, **kw)
    want = P.pagerank_personalized(source, [3, 4], **kw)
    np.testing.assert_allclose(got["rank"], want["rank"], atol=1e-6)
    assert global_metrics.value("analytics.kernel_routed_total") \
        == routed + 4
    assert global_metrics.value(
        "analytics.kernel_route_fallback_total") == fallbacks


def test_supervisor_restarts_a_wedged_or_unreachable_daemon(monkeypatch):
    """``check_once`` restarts an unreachable or wedged daemon and leaves
    a healthy one; the health loop runs it in the background."""
    sup = ks.SupervisedKernelClient("/nonexistent.sock", spawn=False)
    restarts = []
    monkeypatch.setattr(sup, "restart_server",
                        lambda reason, pid=None: restarts.append(reason))
    monkeypatch.setattr(sup, "health", lambda timeout=5.0: None)
    assert sup.check_once() == "restarted"
    monkeypatch.setattr(sup, "health",
                        lambda timeout=5.0: {"wedged": True, "pid": 4242})
    assert sup.check_once() == "restarted"
    monkeypatch.setattr(sup, "health",
                        lambda timeout=5.0: {"wedged": False, "pid": 7})
    assert sup.check_once() == "ok"
    assert restarts == ["unreachable", "wedged"]
    checks = []
    monkeypatch.setattr(sup, "check_once", lambda: checks.append(1))
    sup.start_health_loop(interval_s=0.01)
    deadline = time.monotonic() + TIMEOUT
    while len(checks) < 3:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    sup.close()


def test_daemon_without_a_card_exits_naming_the_cause(tmp_path):
    """Without a card and without ``--device cpu`` the daemon exits
    non-zero, and ``ensure_server`` raises with the log's tail."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the daemon would serve on it")
    sock = str(tmp_path / "ks.sock")
    with pytest.raises(RuntimeError) as ei:
        ks.ensure_server(sock, spawn_timeout_s=TIMEOUT, device="cuda",
                         env=_env())
    assert "rc=2" in str(ei.value)
    assert "no CUDA device is available" in str(ei.value)
    assert "--device cpu" in ks.log_tail(sock)
    assert not os.path.exists(sock)


def test_retry_attempts_budget_and_deadline():
    p = RetryPolicy(base_delay=0.01, jitter=0.0, max_retries=3)
    assert list(p.attempts()) == [0, 1, 2, 3]
    p = RetryPolicy(base_delay=10.0, jitter=0.0, max_retries=5,
                    deadline=0.05)
    t0 = time.monotonic()
    assert list(p.attempts()) == [0]          # the next backoff would cross
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("exc,kind", [
    ("oom", "oom"), ("lost", "device_lost"), ("call", "device_error"),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device_error"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "device_error"),
    (RuntimeError("benes_mid launch failed: CUDA error 719 (unspecified "
                  "launch failure)"), "device_error"),
    (RuntimeError("Found no NVIDIA driver on your system"), "device_lost"),
    (RuntimeError("CUDA error: no CUDA-capable device is detected"),
     "device_lost"),
    (ValueError("bad header"), None),
    (RuntimeError("shape mismatch"), None)])
def test_classify_device_error_taxonomy(exc, kind):
    """Injected faults (``device_fault_point``) and what torch raises on
    the card map to the typed outcomes; anything else is no device
    failure."""
    from memgraph_tpu_torch.utils import faultinject as FI
    from memgraph_tpu_torch.utils.devicefault import (classify_device_error,
                                                      device_fault_point)
    if isinstance(exc, str):
        FI.reset()
        FI.arm(f"device.{exc}", "raise", at=1)
        try:
            with pytest.raises(Exception) as ei:
                device_fault_point()
        finally:
            FI.reset()
        exc = ei.value
    assert classify_device_error(exc) == kind


def test_classify_torch_oom_type():
    import torch
    from memgraph_tpu_torch.utils.devicefault import classify_device_error
    assert classify_device_error(torch.cuda.OutOfMemoryError("x")) == "oom"


# --------------------------------------------------------------------------
# the read lane's op
# --------------------------------------------------------------------------


def _lane_case(seed, n=600, e=5000):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), np.arange(20)])
    dst = np.concatenate([(rng.random(e) ** 2 * n).astype(np.int64),
                          np.arange(20)])
    return (src.astype(np.int32), dst.astype(np.int32),
            rng.random(len(src)) > 0.1, rng.random(n) > 0.5,
            (rng.random(n) > 0.3).astype(np.float32),
            (rng.random(n) > 0.2).astype(np.float32)), n


#: 5000 parallel 0 -> 1 and 1 -> 2 edges: 25M two-hop paths into node 2,
#: past f32's 2^24 (both packages refuse it)
_OVER = (np.repeat(np.array([0, 1], np.int32), 5000),
         np.repeat(np.array([1, 2], np.int32), 5000),
         np.ones(10_000, bool), np.array([True, False, False]),
         np.ones(3, np.float32), np.ones(3, np.float32))


@pytest.mark.parametrize("hops,include_lower,edge_unique", [
    (1, False, True), (2, False, True), (2, True, False)])
def test_lane_op_equals_the_in_process_lane_and_jax(daemon, hops,
                                                    include_lower,
                                                    edge_unique):
    client, _ = daemon
    arrays, n = _lane_case(hops * 3 + include_lower)
    kw = dict(hops=hops, include_lower=include_lower,
              edge_unique=edge_unique, need_rows=True, need_distinct=True)
    got = client.lane_hops(*arrays, n_nodes=n, **kw)
    assert got == tpl.hop_counts(*arrays, n, device="cpu", **kw) \
        == jpl.hop_counts(*arrays, n, **kw)
    h = client.health()["counters"]
    assert h["lane.remote_dispatch_total"] >= 1


def test_lane_op_refusal_and_bad_requests_are_typed(daemon):
    client, sock = daemon
    with pytest.raises(tpl.LaneRefused) as e:
        client.lane_hops(*_OVER, n_nodes=3, hops=2)
    assert e.value.reason == "precision_overflow"
    h, _ = client.call({"op": "lane", "n_nodes": 3},
                       {"src": np.zeros(1, np.int32)})
    assert not h["ok"] and h["outcome"] == "invalid" \
        and "needs array" in h["error"]
    sup = ks.SupervisedKernelClient(sock, spawn=False, deadline_s=TIMEOUT)
    try:
        arrays, n = _lane_case(11)
        assert sup.lane_hops(*arrays, n_nodes=n, hops=2) \
            == jpl.hop_counts(*arrays, n, hops=2)
        with pytest.raises(tpl.LaneRefused):
            sup.lane_hops(*_OVER, n_nodes=3, hops=2)
    finally:
        sup.close()


def test_lane_op_failed_launch_is_a_device_error(tmp_path, monkeypatch):
    """A kernel's failure inside the lane is its typed device outcome,
    never a refusal of the lane's witness."""
    srv = ks.KernelServer(str(tmp_path / "f.sock"), device="cpu")
    from memgraph_tpu_torch.ops import segment_cuda as SC

    def broken(*a, **k):
        raise RuntimeError("csr_spmm_sum launch failed: CUDA error 719")

    monkeypatch.setattr(SC, "csr_spmm_sum", broken)
    arrays, n = _lane_case(2)
    names = ("src", "dst", "emask", "smask", "midmask", "tmask")
    reply, _ = srv._supervised("lane", {"n_nodes": n, "hops": 1},
                               dict(zip(names, arrays)))
    assert reply["outcome"] == "device_error" and reply["retryable"]
    assert "lane_refused" not in reply


def test_jax_client_lane_hops_on_an_in_process_port_server(tmp_path):
    """The JAX package's KernelClient.lane_hops answered by the port's
    server in this process: the totals of JAX's in-process hop_counts,
    and the reference's typed refusal."""
    from memgraph_tpu.server.kernel_server import KernelClient as JClient
    sock = str(tmp_path / "inproc.sock")
    srv = ks.KernelServer(sock, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(sock) and time.monotonic() < deadline:
        time.sleep(0.05)
    jc = JClient(sock, timeout=TIMEOUT)
    try:
        for seed in (1, 2):
            arrays, n = _lane_case(seed)
            kw = dict(hops=2, include_lower=bool(seed % 2),
                      need_distinct=True)
            assert jc.lane_hops(*arrays, n_nodes=n, **kw) \
                == jpl.hop_counts(*arrays, n, **kw)
        with pytest.raises(jpl.LaneRefused) as e:
            jc.lane_hops(*_OVER, n_nodes=3, hops=2)
        assert e.value.reason == "precision_overflow"
    finally:
        jc.call({"op": "shutdown"})
        jc.close()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()


def test_reference_cypher_lane_runs_on_the_port_daemon(daemon):
    """The reference's own ``TestHopParity`` queries (tests/test_lane.py)
    through its Cypher interpreter with MEMGRAPH_TPU_LANE_REMOTE set and
    its kernel-server socket at the port's daemon: every answer equals the
    host path's and the lane served it (no ``remote_error`` fallback, or
    the test's hit check fails); the daemon counts the dispatches."""
    client, sock = daemon
    before = client.health()["counters"].get("lane.remote_dispatch_total",
                                              0.0)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               MEMGRAPH_TPU_LANE_REMOTE="1",
               MEMGRAPH_TPU_KERNEL_SERVER_SOCKET=sock)
    env.pop("MEMGRAPH_TPU_FAULTS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_lane.py", "-q",
         "-k", "TestHopParity", "-p", "no:randomly", "-p",
         "no:cacheprovider"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "9 passed" in run.stdout
    after = client.health()["counters"]["lane.remote_dispatch_total"]
    assert after - before == 8      # the self-target query is not a lane


# --------------------------------------------------------------------------
# the mesh route of the pagerank op and of semiring's bfs
# --------------------------------------------------------------------------

def test_pagerank_op_runs_the_mesh_route(daemon):
    """The ``pagerank`` op answers, bit for bit, what an in-process
    ``pagerank_partition_centric`` gives on the same snapshot over a mesh
    of 1 (the generation's variant keeps row slack; the answer does not
    depend on it), f32 and bf16; a repeat is the stored bytes."""
    client, _ = daemon
    n, e = 700, 5000
    src, dst = _graph(40, n, e)
    ctx = get_mesh_context(1, device="cpu")
    scsr = shard_edges(src, dst, None, n, 1).to_device(ctx)
    for precision in ("f32", "bf16"):
        h, out = client.call_pagerank(src=src, dst=dst, n_nodes=n,
                                      graph_key="mesh1", graph_version=1,
                                      tol=TOL, precision=precision)
        want, err, iters = pagerank_partition_centric(
            scsr, ctx, tol=TOL, precision=precision)
        assert h["tier"] == "resident" and h["iters"] == iters
        assert out["ranks"].tobytes() == want.numpy().tobytes()
        h, again = client.call_pagerank(n_nodes=n, graph_key="mesh1",
                                        graph_version=1, tol=TOL,
                                        precision=precision)
        assert h["cache"] == "hit"
        assert again["ranks"].tobytes() == out["ranks"].tobytes()


def test_semiring_bfs_runs_the_mesh_and_its_pagerank_stays(daemon):
    """``semiring``'s bfs is ``bfs_mesh`` on a mesh of 1; its pagerank
    stays the ops-level one (the MXU route here), bit for bit the
    in-process ``ops.pagerank.pagerank`` of the same snapshot."""
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.pagerank import pagerank
    client, _ = daemon
    n, e = 700, 6000
    src, dst = _graph(41, n, e)
    g = from_coo(src, dst, n_nodes=n)
    h, out = client.semiring("bfs", src=src, dst=dst, n_nodes=n, source=5)
    want, iters = TA.bfs_mesh(g, get_mesh_context(1, device="cpu"), 5)
    assert h["iters"] == iters
    assert np.array_equal(out["levels"], want)
    h, out = client.semiring("pagerank", src=src, dst=dst, n_nodes=n,
                             tol=TOL)
    want, _, iters = pagerank(g, tol=TOL, device="cpu")
    assert h["iters"] == iters
    assert out["ranks"].tobytes() == want.numpy().tobytes()


def test_pagerank_op_and_semiring_pagerank_keep_their_own_solutions(daemon):
    """At equal parameters on one generation, the ``semiring`` op's
    pagerank (the ops-level route) and the ``pagerank`` op (the mesh
    loop) each answer their own route's bytes: neither is a hit nor a
    seed of the other's stored solution."""
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.pagerank import pagerank
    client, _ = daemon
    n, e = 700, 6000
    src, dst = _graph(43, n, e)
    ctx = get_mesh_context(1, device="cpu")
    mesh, _, mesh_iters = pagerank_partition_centric(
        shard_edges(src, dst, None, n, 1).to_device(ctx), ctx, tol=TOL)
    ops, _, ops_iters = pagerank(from_coo(src, dst, n_nodes=n), tol=TOL,
                                 device="cpu")
    mesh, ops = mesh.numpy().tobytes(), ops.numpy().tobytes()
    assert mesh != ops           # two summation orders
    kw = dict(n_nodes=n, graph_key="routes", graph_version=1, tol=TOL)
    for _ in range(2):
        h, out = client.semiring("pagerank", src=src, dst=dst, **kw)
        assert h.get("cache") != "hit" and not h["warm_started"]
        assert out["ranks"].tobytes() == ops and h["iters"] == ops_iters
        h, out = client.call_pagerank(**kw)
        assert h.get("cache") != "hit" and not h["warm_started"]
        assert out["ranks"].tobytes() == mesh and h["iters"] == mesh_iters
    h, out = client.call_pagerank(**kw)
    assert h["cache"] == "hit" and out["ranks"].tobytes() == mesh


def test_mesh_routes_place_no_snapshot_and_are_priced_on_the_mesh(tmp_path):
    """A generation imported by the ``pagerank`` op or ``semiring``'s bfs
    keeps its snapshot on the host (both run over the sharded variant);
    a later ops-level request places it once.  Admission prices both mesh
    routes on ``_MESH_FOOTPRINT``, the ops-level pagerank on its own."""
    n, e = 400, 2500
    src, dst = _graph(44, n, e)
    srv = ks.KernelServer(str(tmp_path / "p.sock"), device="cpu")
    arrays = {"src": src, "dst": dst}
    for key, op, header in (("pr", "pagerank", {}),
                            ("bfs", "semiring",
                             {"algorithm": "bfs", "source": 3})):
        reply, _ = srv._supervised(op, {"graph_key": key, "n_nodes": n,
                                        "graph_version": 1, **header},
                                   dict(arrays))
        assert reply["outcome"] == "completed"
        gen = srv._graphs.peek(key)
        assert gen._graph.device is None
        assert list(gen.host_variants) == [("src", False)]
    reply, _ = srv._supervised("semiring", {
        "graph_key": "pr", "n_nodes": n, "graph_version": 1,
        "algorithm": "wcc"}, {})
    assert reply["outcome"] == "completed"
    placed = srv._graphs.peek("pr")._graph
    assert placed.device is not None and srv._graphs.peek("pr").graph \
        is placed
    n_pad, e_pad = ks._padded_graph_dims(n, e)
    wire = src.nbytes + dst.nbytes
    for op, header, row in (
            ("pagerank", {}, ks._MESH_FOOTPRINT["pagerank"]),
            ("semiring", {"algorithm": "bfs"}, ks._MESH_FOOTPRINT["bfs"]),
            ("semiring", {"algorithm": "pagerank"},
             ks._ALGO_FOOTPRINT["pagerank"])):
        assert ks._estimate_request_bytes({"n_nodes": n, **header}, arrays,
                                          srv.device, op) \
            == wire + n_pad * row[0] + e_pad * row[1]


@pytest.mark.parametrize("moved", ["version", "damping", "max_iterations"])
def test_failed_run_checkpoint_resumes_only_its_own_request(tmp_path,
                                                            moved):
    """A ``pagerank`` op run whose retries run out leaves its checkpoint;
    a request on another generation version, another damping or another
    iteration budget does not restore it: it answers what a server that
    never failed answers, bit for bit."""
    from memgraph_tpu_torch.utils import faultinject as FI
    n, e = 500, 3000
    src, dst = _graph(45, n, e)
    header = {"graph_key": "stale", "n_nodes": n, "graph_version": 1,
              "tol": 0.0, "max_iterations": 20}
    arrays = {"src": src, "dst": dst}
    faulty = ks.KernelServer(str(tmp_path / "f.sock"), device="cpu",
                             checkpoint_every=3)
    FI.reset()
    # hit 1 is the dispatch's own point, then one a chunk: the first
    # chunk checkpoints, every later one (and each retry) is lost
    FI.arm("device.lost", "raise", at=list(range(3, 40)))
    try:
        reply, _ = faulty._supervised("pagerank", dict(header),
                                      dict(arrays))
    finally:
        FI.reset()
    assert reply["outcome"] != "completed"
    nxt = dict(header, **{"version": {"graph_version": 2},
                          "damping": {"damping": 0.8},
                          "max_iterations": {"max_iterations": 9}}[moved])
    answers = []
    for srv in (faulty, ks.KernelServer(str(tmp_path / "c.sock"),
                                        device="cpu", checkpoint_every=3)):
        restored = global_metrics.value("analytics.checkpoint.restored_total")
        reply, out = srv._supervised("pagerank", dict(nxt), dict(arrays))
        assert reply["outcome"] == "completed"
        assert reply["iters"] == nxt["max_iterations"]
        assert global_metrics.value(
            "analytics.checkpoint.restored_total") == restored
        answers.append(out["ranks"].tobytes())
    assert answers[0] == answers[1]


def test_device_lost_mid_run_resumes_bit_equal(tmp_path):
    """An in-process server with ``checkpoint_every=3``: a device.lost at
    the third chunk of the resident PageRank resumes from the checkpoint
    (the rows placed again) and answers what an unfaulted run answers,
    bit for bit; the resume is counted."""
    from memgraph_tpu_torch.utils import faultinject as FI
    n, e = 500, 3000
    src, dst = _graph(42, n, e)
    answers = []
    for fault in (False, True):
        srv = ks.KernelServer(str(tmp_path / f"r{int(fault)}.sock"),
                              device="cpu", checkpoint_every=3)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                c = ks.KernelClient(srv.socket_path, timeout=TIMEOUT)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        resumes = global_metrics.value("analytics.resume_total")
        FI.reset()
        if fault:
            # hit 1 is the dispatch's own point, then one a chunk
            FI.arm("device.lost", "raise", at=4)
        try:
            h, out = c.call_pagerank(src=src, dst=dst, n_nodes=n,
                                     graph_key="r", tol=0.0,
                                     max_iterations=20)
        finally:
            FI.reset()
            c.shutdown()
            c.close()
        assert h["iters"] == 20
        assert global_metrics.value("analytics.resume_total") \
            == resumes + int(fault)
        answers.append(out["ranks"])
    assert answers[0].tobytes() == answers[1].tobytes()
