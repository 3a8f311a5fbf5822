"""The port's spans and stage extents (memgraph_tpu_torch/observability/
trace.py and stats.py) against the JAX package's (memgraph_tpu/
observability/trace.py and stats.py).

Both tracers run the same sequence of spans; span and trace ids are
random, so the trees are compared by name, parent link, attributes and
status.  The exporters (``chrome_trace``, ``to_jsonl``) and the
exposition helpers take the same input in both packages and must give the
same output exactly; fingerprints and the space-saving registry's
snapshots must be equal; the saturation verdict equal on the same gauges.
Then the port's own paths: a traced routed request through the port's
daemon (``--device cpu``, tracing armed in both processes) comes home as
one connected trace, every name in ``SPAN_NAMES``, the spans nested, the
stage seconds within the request's wall time; disarmed, every hook is a
no-op.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from memgraph_tpu.observability import metrics as jmetrics
from memgraph_tpu.observability import stats as jstats
from memgraph_tpu.observability import trace as jtrace
from memgraph_tpu_torch.observability import stats as tstats
from memgraph_tpu_torch.observability import trace as ttrace
from memgraph_tpu_torch.ops import csr as tcsr
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.server import kernel_server as ks
from memgraph_tpu_torch.utils import metrics as tmetrics

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TIMEOUT = 60.0


@pytest.fixture
def armed():
    """Both tracers armed (sample 1, slow 250 ms), emptied, and disarmed
    after."""
    for t in (jtrace, ttrace):
        t.TRACER.reset()
        t.enable(sample=1.0, slow_ms=250.0)
    yield
    for t in (jtrace, ttrace):
        t.disable()
        t.TRACER.reset()
        t.TRACER.sample_rate = 1.0
        t.TRACER.ring_cap = 256


def _script(T, fail=False):
    """One request's spans: a root, two children, a grandchild, a span
    recorded after the fact, an errored span when ``fail``."""
    root = T.begin_trace("query", carrier=None)
    with T.activate(root.ctx):
        with T.span("kernel.request", op="ppr", attempt=0) as sp:
            sp.set(batch=3)
            with T.span("device.chunk", backend="segment", iterations=7):
                pass
            T.record_span("kernel.dispatch", time.time(), 0.001, op="ppr",
                          cache="hit")
        with T.span("device.transfer", n_shards=2):
            pass
        if fail:
            with pytest.raises(ValueError):
                with T.span("device.chunk"):
                    raise ValueError("boom")
    root.finish(rows=4)
    return root.trace_id


def _shape(spans):
    """The tree of a trace: (name, parent's name, attrs, status) a span,
    sorted."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"]),
                   json.dumps(s["attrs"], sort_keys=True), s["status"],
                   s["error"]) for s in spans)


def test_span_trees_match(armed):
    for fail in (False, True):
        jid, tid = _script(jtrace, fail), _script(ttrace, fail)
        (jspans,), (tspans,) = (jtrace.traces_json(jid),
                                ttrace.traces_json(tid))
        assert _shape(tspans) == _shape(jspans)
        assert {s["trace_id"] for s in tspans} == {tid}
        assert all(s["name"] in ttrace.SPAN_NAMES for s in tspans)
    assert ttrace.SPAN_NAMES == jtrace.SPAN_NAMES
    assert ttrace.TRACER.counts() == jtrace.TRACER.counts()


def test_sampling_slow_and_error_retention(armed):
    ids = [os.urandom(16).hex() for _ in range(200)]
    for rate in (0.0, 0.25, 0.5, 1.0):
        assert [ttrace._sample_decision(i, rate) for i in ids] == \
            [jtrace._sample_decision(i, rate) for i in ids]
    for t in (jtrace, ttrace):
        t.TRACER.sample_rate = 0.0
        _script(t)                     # dropped: unsampled, fast, clean
        _script(t, fail=True)          # kept: an errored span
        root = t.begin_trace("query")
        root.finish(force_keep=False)
        t.TRACER.slow_ms = 0.0
        t.begin_trace("query").finish()          # kept: slow
        t.TRACER.slow_ms = 250.0
    assert ttrace.TRACER.counts() == jtrace.TRACER.counts() == \
        {"started": 4, "kept": 2, "dropped": 2}


def test_the_ring_keeps_the_newest(armed):
    for t in (jtrace, ttrace):
        t.TRACER.ring_cap = 3
        for _ in range(5):
            _script(t)
    assert len(ttrace.traces_json()) == len(jtrace.traces_json()) == 3
    assert ttrace.TRACER.counts() == jtrace.TRACER.counts()


def test_exporters_give_the_reference_output(armed):
    _script(jtrace)
    _script(jtrace, fail=True)
    traces = jtrace.traces_json()
    assert ttrace.chrome_trace(traces) == jtrace.chrome_trace(traces)
    assert ttrace.to_jsonl(traces) == jtrace.to_jsonl(traces)
    assert ttrace.to_jsonl([]) == jtrace.to_jsonl([]) == ""


def test_carrier_adopt_take_and_adopt_spans(armed):
    """The server side adopts the client's carrier, records, and ships
    its spans back; the client adopts them into its open trace."""
    for T in (jtrace, ttrace):
        root = T.begin_trace("query")
        with T.activate(root.ctx):
            carrier = T.inject()
            assert carrier["trace_id"] == root.trace_id
            with T.adopt(dict(carrier)):
                with T.span("kernel.dispatch", op="pagerank"):
                    with T.span("device.chunk"):
                        pass
            shipped = T.take_trace(carrier["trace_id"])
            assert [s["name"] for s in shipped] == ["device.chunk",
                                                    "kernel.dispatch"]
            T.adopt_spans(shipped)
        root.finish()
        (spans,) = T.traces_json(root.trace_id)
        by_id = {s["span_id"]: s for s in spans}
        chunk = next(s for s in spans if s["name"] == "device.chunk")
        assert by_id[chunk["parent_id"]]["name"] == "kernel.dispatch"
        assert by_id[by_id[chunk["parent_id"]]["parent_id"]]["name"] == \
            "query"


def test_disarmed_hooks_are_no_ops():
    ttrace.disable()
    assert ttrace.span("device.chunk") is ttrace._NOOP
    assert not ttrace.span("device.chunk")
    assert ttrace.inject() is None and ttrace.begin_trace("query") is None
    assert ttrace.adopt({"trace_id": "ab"}) is ttrace._NULL_ACTIVATION
    before = ttrace.TRACER.counts()
    ttrace.record_span("kernel.dispatch", time.time(), 0.1)
    assert tstats.current_stages() is None
    tstats.record_stage("device_iterate", 1.0)          # nowhere to go
    assert tstats.current_stages() is None and not tstats.stages_active()
    g = tcsr.from_coo(np.asarray([0, 1, 2]), np.asarray([1, 2, 0]),
                      n_nodes=3)
    tpr.pagerank(g, device="cpu")
    assert ttrace.TRACER.counts() == before
    assert ttrace.traces_json() == []


def test_stage_sums_match():
    def run(S):
        outer = S.StageAccumulator()
        with S.collecting_stages(outer):
            S.record_stage("device_iterate", 0.25)
            S.record_stage("device_iterate", 0.5, count=2)
            inner = S.StageAccumulator()
            with S.collecting_stages(inner):
                S.record_stage("lane_compile", 1.0)
                assert S.stages_active()
            S.merge_stages(inner.snapshot())
            S.merge_stages({"kernel_dispatch": {"seconds": 2.0,
                                                "count": 3}})
            S.merge_stages(None)
        assert not S.stages_active()
        return outer.snapshot()

    assert run(tstats) == run(jstats) == {
        "device_iterate": {"seconds": 0.75, "count": 3},
        "lane_compile": {"seconds": 1.0, "count": 1},
        "kernel_dispatch": {"seconds": 2.0, "count": 3}}
    assert tstats.STAGE_NAMES == jstats.STAGE_NAMES


def test_the_ops_record_their_extents():
    """The segment fixpoint records ``device_iterate`` and
    ``semiring_segment`` and opens one ``device.chunk`` span; the PPR
    batch its backend extent."""
    rng = np.random.default_rng(0)
    g = tcsr.from_coo(rng.integers(0, 50, 300), rng.integers(0, 50, 300),
                      n_nodes=50)
    acc = tstats.StageAccumulator()
    t0 = time.perf_counter()
    with tstats.collecting_stages(acc):
        tpr.pagerank(g, device="cpu")
        tpr.personalized_pagerank_batch(g, [[1], [2]], device="cpu")
    wall = time.perf_counter() - t0
    snap = acc.snapshot()
    assert snap["semiring_segment"]["count"] == 2
    assert snap["device_iterate"]["count"] == 2
    assert 0 < snap["device_iterate"]["seconds"] <= wall


QUERIES = [
    "MATCH (n:Person {name: 'Ada'}) RETURN n",
    "MATCH (n:Person {name: \"Bob\"}) RETURN n",
    "MATCH (n) WHERE n.age > 42 AND n.x = 3.5e2 RETURN n LIMIT 10",
    "PROFILE MATCH (n) WHERE n.age > $min RETURN n",
    "EXPLAIN   MATCH (n)\n WHERE n.age > $other RETURN n",
    "CALL pagerank.get() YIELD node, rank RETURN node, rank",
    "CREATE (:L {v: 'it\\'s'})", "RETURN 1", "profile",
]


def test_fingerprints_and_the_registry_match():
    assert [tstats.fingerprint_text(q) for q in QUERIES] == \
        [jstats.fingerprint_text(q) for q in QUERIES]
    regs = (tstats.QueryStatsRegistry(capacity=3),
            jstats.QueryStatsRegistry(capacity=3))
    rng = np.random.default_rng(4)
    for k in range(60):
        q = QUERIES[int(rng.integers(0, len(QUERIES)))]
        lat = float(rng.random() * 0.05)
        for reg in regs:
            reg.record_text(q, lat, rows=k % 5, error=k % 7 == 0,
                            plan_cache_hit=k % 2 == 0,
                            trace_id=f"t{k}" if k % 3 == 0 else None)
    (ts, js) = (r.snapshot() for r in regs)
    strip = ("first_seen", "last_seen")
    assert [{k: v for k, v in e.items() if k not in strip} for e in ts] == \
        [{k: v for k, v in e.items() if k not in strip} for e in js]
    assert tstats.QUERY_STATS_COLUMNS == jstats.QUERY_STATS_COLUMNS


EXPO = ("# TYPE a_total counter\na_total 3.0\n"
        "# TYPE lat histogram\nlat_bucket{le=\"0.1\"} 1 # {trace_id=\"x\"} "
        "0.05 1.0\nlat_bucket{le=\"+Inf\"} 2\nlat_count 2\nlat_sum 0.3\n"
        "b{k=\"v\"} 7\n")


def test_expositions_match():
    parts = {"main": EXPO, "replica-1": "# TYPE a_total counter\n"
                                        "a_total 1.0\n"}
    assert tstats.label_exposition(EXPO, 'in"st') == \
        jstats.label_exposition(EXPO, 'in"st')
    assert tstats.federate_expositions(parts) == \
        jstats.federate_expositions(parts)
    counters = {"ppr.requests_total": 4.0, "kernel_server.in-flight": 1}
    assert tstats.counters_exposition(counters, {"g": 2}) == \
        jstats.counters_exposition(counters, {"g": 2})


def test_histogram_matches():
    a, b = tmetrics.Histogram(), jmetrics.Histogram()
    for v in np.random.default_rng(1).random(100) * 3.0:
        a.observe(float(v), "t")
        b.observe(float(v), "t")
    assert [a.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)] == \
        [b.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)]
    assert a.cumulative() == b.cumulative()


GAUGES = {"bolt.sessions_live": 8.0, "bolt.sessions_max": 8.0,
          "ppr.queue_depth": 500.0, "ppr.window_occupancy": 1.0,
          "replication.replica_lag.r1": 5000.0}


def test_saturation_verdicts_match():
    planes = (tstats.SaturationPlane(), jstats.SaturationPlane())
    regs = (tmetrics.global_metrics, jmetrics.global_metrics)
    before = [{k: r._gauges.get(k) for k in GAUGES} for r in regs]
    try:
        for reg in regs:
            for k, v in GAUGES.items():
                reg.set_gauge(k, v)
        got = [p.evaluate() for p in planes]
        assert got[0]["ready"] is got[1]["ready"] is False
        assert got[0]["checks"] == got[1]["checks"]
        assert sorted(r["check"] for r in got[0]["reasons"]) == \
            sorted(r["check"] for r in got[1]["reasons"]) == \
            ["bolt_sessions", "ppr_queue", "ppr_window", "replication_lag"]
        assert planes[0].ingest_pressure() == "replication_lag"
    finally:                     # the registries as they were
        for reg, old in zip(regs, before):
            with reg._lock:
                for k, v in old.items():
                    if v is None:
                        reg._gauges.pop(k, None)
                    else:
                        reg._gauges[k] = v


def test_profiler_range_bridge(armed):
    """``MEMGRAPH_TPU_TRACE_XLA``'s bridge opens each span as a
    ``torch.profiler.record_function`` range."""
    ttrace.TRACER.xla_bridge = True
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            with ttrace.span("device.chunk"):
                torch.ones(4).sum()
    finally:
        ttrace.TRACER.xla_bridge = False
    assert "mgtrace:device.chunk" in {e.key for e in prof.key_averages()}


@pytest.fixture(scope="module")
def traced_daemon(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("trace") / "ks.sock")
    env = dict(os.environ)
    env.pop("MEMGRAPH_TPU_FAULTS", None)
    env["MEMGRAPH_TPU_TRACE"] = "1"
    client = ks.ensure_server(sock, spawn_timeout_s=TIMEOUT,
                              idle_timeout_s=120, device="cpu", env=env)
    assert client is not None, ks.log_tail(sock)
    yield client, sock
    client.shutdown()
    client.close()
    client.process.wait(timeout=TIMEOUT)


def _check_tree(spans, root_id):
    by_id = {s["span_id"]: s for s in spans}
    assert all(s["name"] in ttrace.SPAN_NAMES for s in spans)
    assert {s["trace_id"] for s in spans} == {root_id}
    for s in spans:                     # every parent is in the trace
        assert s["parent_id"] is None or s["parent_id"] in by_id, s
    return by_id


def test_a_traced_request_through_the_daemon(armed, traced_daemon):
    """A ``pagerank`` request and a PPR request, each under a root span:
    the daemon's ``kernel.dispatch`` (and, for the pagerank op, the
    segment fixpoint's ``device.chunk`` under it) come home through the
    carrier, nested under the client's ``kernel.request``; the stage
    extents merged into the caller's accumulator sum to at most the
    request's wall time."""
    _, sock = traced_daemon
    rng = np.random.default_rng(3)
    n, e = 300, 1800
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    sup = ks.SupervisedKernelClient(sock, spawn=False, deadline_s=TIMEOUT)
    try:
        for call in (lambda: sup.pagerank(src=src, dst=dst, n_nodes=n,
                                          graph_key="traced",
                                          graph_version=1, tol=1e-8),
                     lambda: sup.ppr([3], src=src, dst=dst, n_nodes=n,
                                     graph_key="traced-ppr",
                                     graph_version=1, tol=1e-8)):
            acc = tstats.StageAccumulator()
            root = ttrace.begin_trace("query")
            t0 = time.perf_counter()
            with ttrace.activate(root.ctx), tstats.collecting_stages(acc):
                call()
            wall = time.perf_counter() - t0
            root.finish()
            (spans,) = ttrace.traces_json(root.trace_id)
            by_id = _check_tree(spans, root.trace_id)
            names = [s["name"] for s in spans]
            assert names.count("kernel.request") == 1
            disp = next(s for s in spans if s["name"] == "kernel.dispatch")
            assert by_id[disp["parent_id"]]["name"] == "kernel.request"
            assert disp["pid"] != os.getpid()         # the daemon's
            stages = acc.snapshot()
            assert "kernel_dispatch" in stages and len(stages) > 1
            assert all(s["seconds"] <= stages["kernel_dispatch"]["seconds"]
                       for s in stages.values())
            assert stages["kernel_dispatch"]["seconds"] <= wall
        # the pagerank op's chunks ran inside the daemon's dispatch span
        first = ttrace.traces_json()[0]
        ids = {s["span_id"]: s for s in first}
        chunks = [s for s in first if s["name"] == "device.chunk"]
        assert chunks and all(
            ids[c["parent_id"]]["name"] == "kernel.dispatch" for c in chunks)
    finally:
        sup.close()
