"""The port's snapshot refresh: ``spmv_mxu.DeltaPlan`` side-nets, the delta
branch of the MXU kernel and the delta path of ``pagerank``, against the
JAX package.

Tolerances: ``build_delta_plan`` is the same numpy code in both packages,
so its fields are equal.  The kernels differ only by the order of f32
sums: rtol 1e-5 with atol 1e-9, as tests/test_torch_spmv_mxu.py.  A bf16
route is held within ``PRECISION_BOUNDS["bf16"]`` of the JAX package's f32
run (the two frameworks round contributions to bf16 at places that
differ, and a removal's negative multiplier can cancel most of a sum).
Fixed-length runs pass tol=-1, so both packages run exactly
max_iterations.

The delta net never has fewer than 2^15 slots (the scatter layout gives
each dst row of the base's whole 256-row windows at least one row), so
the reference's roll branch for nets under 2^12 never runs: the cases
cover a delta net of one f32 tile (2^15, no outer pass) and nets past
one tile (outer passes on the f32 route).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import pagerank as jpr
from memgraph_tpu.ops import spmv_mxu as J
from memgraph_tpu.ops.csr import GraphCache
from memgraph_tpu.storage import InMemoryStorage, StorageConfig, StorageMode
from memgraph_tpu.storage.storage import EdgeAccessor
from memgraph_tpu_torch.ops import pagerank as tpr
from memgraph_tpu_torch.ops import spmv_mxu as T
from memgraph_tpu_torch.ops.csr import from_coo
from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

RTOL, ATOL = 1e-5, 1e-9
ITERS = 25


def _edges(n, e, seed, weighted=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    w = rng.random(e).astype(np.float32) + 0.1 if weighted else None
    return src, dst, w


def _delta_case(name):
    """(n, src, dst, w, add (s, d, w), remove (s, d, w)) in original ids."""
    n, e = {"big": (40000, 120000)}.get(name, (3000, 30000))
    weighted = name == "weighted"
    src, dst, w = _edges(n, e, 11, weighted)
    src %= n - n // 10                  # a tail of dangling nodes
    rng = np.random.default_rng(12)
    w_all = np.ones(e, np.float32) if w is None else w
    none = np.zeros(0, np.int64)
    add, rem = (none, none, None), (none, none, None)

    def adds(k):
        a_w = (rng.random(k).astype(np.float32) + 0.1) if weighted else None
        return rng.integers(0, n, k), rng.integers(0, n, k), a_w

    def removes(idx):
        return src[idx], dst[idx], (w_all[idx] if weighted else None)

    if name == "additions":
        add = adds(300)
    elif name in ("removals_and_additions", "weighted", "big"):
        add = adds(400 if name == "big" else 300)
        rem = removes(rng.choice(e, 200, replace=False))
    elif name == "to_dangling":
        # every out-edge of five nodes goes: they become dangling
        nodes = np.unique(src)[:5]
        rem = removes(np.flatnonzero(np.isin(src, nodes)))
    elif name == "from_dangling":
        # five nodes without out-edges gain one each
        sinks = np.setdiff1d(np.arange(n), src)[:5]
        assert len(sinks) == 5
        add = (sinks, rng.integers(0, n, 5), None)
    return n, src, dst, w, add, rem


CASES = ["additions", "removals_and_additions", "to_dangling",
         "from_dangling", "empty", "weighted", "big"]


def _plans(name):
    n, src, dst, w, (a_s, a_d, a_w), (r_s, r_d, r_w) = _delta_case(name)
    jplan = J.build_plan(src, dst, w, n)
    tplan = T.plan_from_arrays(dataclasses.asdict(jplan))
    jd = J.build_delta_plan(jplan, a_s, a_d, a_w, r_s, r_d, r_w)
    td = T.build_delta_plan(tplan, a_s, a_d, a_w, r_s, r_d, r_w)
    return jplan, tplan, jd, td


@pytest.mark.parametrize("name", CASES)
def test_build_delta_plan_matches_the_jax_package(name):
    _, _, jd, td = _plans(name)
    for f in dataclasses.fields(J.DeltaPlan):
        a, b = getattr(jd, f.name), getattr(td, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    # power-of-two buckets; dead chunks extract nothing
    assert td.R_G & (td.R_G - 1) == 0 and td.C & (td.C - 1) == 0
    assert td.net_log2 >= 15


def test_delta_plan_keeps_the_reference_details():
    """Untouched nodes scale by exactly 1.0; a wsum within 1e-9 of 0
    becomes 0; padded chunks carry run_k = -1 and no window."""
    n, src, dst, w, _, _ = _delta_case("weighted")
    plan = T.build_plan(src, dst, w, n)
    i = int(np.flatnonzero(plan.wsum > 0)[0])
    out_i = np.flatnonzero(src == i)
    # remove node i's edges with weights 1e-11 heavier: dust below 0
    gone = T.build_delta_plan(plan, [], [], None, src[out_i], dst[out_i],
                              w[out_i].astype(np.float64) + 1e-11)
    assert gone.wsum[i] == 0.0
    assert gone.dangling_out[plan.out_relabel[i]] == 1.0
    others = np.setdiff1d(np.arange(n), [i])
    assert (gone.scale_out[plan.out_relabel[others]] == 1.0).all()
    assert gone.scale_out[plan.out_relabel[i]] == 0.0
    live = gone.win_oh.sum(axis=1) > 0
    assert (gone.run_k[~live] == -1).all()


@functools.lru_cache(maxsize=None)
def _jax_delta_run(name):
    """The JAX package's f32 delta run of a case (ranks, iterations)."""
    jplan, _, jd, _ = _plans(name)
    jrank, _, jit = J.make_pagerank_kernel(jplan, route_dtype=jnp.float32,
                                           delta=jd)(
        None, jnp.float32(0.85), ITERS, jnp.float32(-1.0))
    return np.asarray(jrank), int(jit)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_delta_kernel_matches_the_jax_package(name, precision):
    """f32 against the JAX package's f32 delta run within rtol 1e-5; the
    bf16 route against the same run within PRECISION_BOUNDS["bf16"]."""
    _, tplan, _, td = _plans(name)
    want, jit = _jax_delta_run(name)
    tdt = torch.bfloat16 if precision == "bf16" else torch.float32
    run = T.make_pagerank_kernel(tplan, route_dtype=tdt, delta=td,
                                 device="cpu")
    trank, _, tit = run(None, 0.85, ITERS, -1.0)
    got = trank.numpy()
    assert tit == jit == ITERS
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        b = PRECISION_BOUNDS["bf16"]
        diff = np.abs(got - want)
        assert diff.max() <= b["pagerank_linf"]
        assert diff.sum() <= b["pagerank_l1"]
        k = b["topk_order"]
        assert np.array_equal(np.argsort(-got)[:k], np.argsort(-want)[:k])
    spec = run.routes["delta"][2]
    assert spec.net_log2 == td.net_log2
    # one f32 tile (K = 15) holds the smallest delta net; "big" spans tiles
    if name == "big":
        assert td.net_log2 > 15 and (precision == "bf16"
                                     or run.routes["delta"][1] is not None)
    elif name in ("from_dangling", "empty"):
        assert td.net_log2 == 15 and run.routes["delta"][1] is None


def test_delta_kernel_matches_a_fresh_plan_of_the_mutated_graph():
    """The refresh is exact: the delta run equals a full plan of the
    mutated edges (f32 sums in another order)."""
    n, src, dst, w, (a_s, a_d, _), (r_s, r_d, _) = _delta_case(
        "removals_and_additions")
    plan = T.build_plan(src, dst, w, n)
    delta = T.build_delta_plan(plan, a_s, a_d, None, r_s, r_d, None)
    got, _, _ = T.make_pagerank_kernel(plan, delta=delta, device="cpu")(
        None, 0.85, ITERS, -1.0)
    keep = np.ones(len(src), bool)
    pairs = {}
    for s, d in zip(r_s, r_d):
        pairs[(s, d)] = pairs.get((s, d), 0) + 1
    for i, (s, d) in enumerate(zip(src, dst)):
        if pairs.get((s, d), 0):
            pairs[(s, d)] -= 1
            keep[i] = False
    s2 = np.concatenate([src[keep], a_s])
    d2 = np.concatenate([dst[keep], a_d])
    fresh = T.build_plan(s2, d2, None, n)
    want, _, _ = T.make_pagerank_kernel(fresh, device="cpu")(
        None, 0.85, ITERS, -1.0)
    np.testing.assert_allclose(got[torch.from_numpy(plan.out_relabel)],
                               want[torch.from_numpy(fresh.out_relabel)],
                               rtol=1e-4, atol=1e-9)


def test_delta_rejects_new_nodes_in_both_packages():
    n, src, dst, w, _, _ = _delta_case("additions")
    jplan = J.build_plan(src, dst, w, n)
    tplan = T.plan_from_arrays(dataclasses.asdict(jplan))
    for mod, plan in ((J, jplan), (T, tplan)):
        with pytest.raises(ValueError, match="outside the base plan"):
            mod.build_delta_plan(plan, [0, n], [1, 2])
        with pytest.raises(ValueError, match="outside the base plan"):
            mod.build_delta_plan(plan, [], [], None, [0], [-1])


def test_shared_base_routes_give_the_same_answer():
    """A delta run on the base plan's placed state equals one that places
    the base plan again, bit for bit, and places only its delta."""
    _, tplan, _, td = _plans("removals_and_additions")
    placed = T.place_plan(tplan, device="cpu")
    base = T.make_pagerank_kernel(tplan, device="cpu", placed=placed)
    shared = T.make_pagerank_kernel(tplan, delta=td, device="cpu",
                                    placed=placed)
    again = T.make_pagerank_kernel(tplan, delta=td, device="cpu")
    for name in ("edge", "node"):
        assert base.routes[name] is placed[name]
        assert shared.routes[name] is placed[name]
        assert again.routes[name] is not placed[name]
    assert shared.routes["delta"] is not again.routes["delta"]
    a, _, _ = shared(None, 0.85, ITERS, -1.0)
    b, _, _ = again(None, 0.85, ITERS, -1.0)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError, match="another plan"):
        T.make_pagerank_kernel(tplan, route_dtype=torch.bfloat16,
                               device="cpu", placed=placed)


# ---------------------------------------------------------------------------
# pagerank() on successor snapshots
# ---------------------------------------------------------------------------

@pytest.fixture
def force_mxu(monkeypatch):
    monkeypatch.setattr(tpr, "MXU_MIN_EDGES", 0)
    monkeypatch.setattr(jpr, "MXU_MIN_EDGES", 1)
    monkeypatch.setenv("MEMGRAPH_TPU_FORCE_MXU", "1")
    monkeypatch.delenv("MEMGRAPH_TPU_MESH_DEVICES", raising=False)
    monkeypatch.delenv("MEMGRAPH_TPU_ROUTE_DTYPE", raising=False)


@pytest.fixture
def no_build_plan(monkeypatch):
    """Stubs the port's build_plan to raise, once armed."""
    real = T.build_plan
    armed = []

    def build_plan(*args, **kw):
        if armed:
            raise AssertionError("build_plan ran for a delta snapshot")
        return real(*args, **kw)

    monkeypatch.setattr(T, "build_plan", build_plan)
    return armed


def _storage(n=1000, e=6000, seed=3):
    """A committed storage graph, as tests/test_plan_delta_e2e.py builds
    it."""
    storage = InMemoryStorage(StorageConfig(
        storage_mode=StorageMode.IN_MEMORY_TRANSACTIONAL))
    rng = np.random.default_rng(seed)
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    vs = [acc.create_vertex() for _ in range(n)]
    for s, d in zip(rng.integers(0, n, e), rng.integers(0, n, e)):
        acc.create_edge(vs[s], vs[d], et)
    acc.commit()
    return storage, vs, et


def _commit(storage, vs, et, seed, n_add=40, n_remove=10, into=None):
    """Add n_add edges (into node `into` when given) and remove n_remove."""
    acc = storage.access()
    rng = np.random.default_rng(seed)
    n = len(vs)
    for _ in range(n_add):
        d = into if into is not None else int(rng.integers(0, n))
        acc.create_edge(vs[int(rng.integers(0, n))], vs[d], et)
    for ve in list(storage._edges.values())[:n_remove]:
        acc.delete_edge(EdgeAccessor(ve, acc))
    acc.commit()


def _jax_snapshot(storage, cache, precision="f32"):
    acc = storage.access()
    g = cache.get(acc)
    r, _, it = jpr.pagerank(g, max_iterations=ITERS, tol=-1.0,
                            precision=precision)
    acc.abort()
    assert int(it) == ITERS
    return g, np.asarray(r)


def _port_twin(jg, base=None):
    """The port's graph of a JAX snapshot: from_coo of its host_coo and
    node_gids, with the JAX snapshot's _delta_ctx carried over onto the
    port's base graph."""
    g = from_coo(*jg.host_coo, n_nodes=jg.n_nodes,
                 node_gids=jg.node_gids).to_device("cpu")
    if base is not None:
        object.__setattr__(g, "_delta_ctx", (base, jg._delta_ctx[1]))
    return g


def _port_rank(g, precision="f32"):
    r, _, it = tpr.pagerank(g, max_iterations=ITERS, tol=-1.0,
                            precision=precision)
    assert it == ITERS
    return r.numpy()


def test_refresh_matches_the_jax_graph_cache(force_mxu, no_build_plan):
    storage, vs, et = _storage()
    cache = GraphCache()
    j1, jr1 = _jax_snapshot(storage, cache)
    t1 = _port_twin(j1)
    np.testing.assert_allclose(_port_rank(t1), jr1, rtol=RTOL, atol=ATOL)
    assert t1._mxu_base_self and "delta" not in t1._mxu_state
    no_build_plan.append(True)

    _commit(storage, vs, et, seed=7)
    j2, jr2 = _jax_snapshot(storage, cache)
    assert j2._delta_ctx[0] is j1 and j2._mxu_state[0] is j1._mxu_state[0]
    t2 = _port_twin(j2, base=t1)
    np.testing.assert_allclose(_port_rank(t2), jr2, rtol=RTOL, atol=ATOL)
    state = t2._mxu_state
    assert state["plan"] is t1._mxu_state["plan"]
    assert 0 < state["delta"].n_delta <= 50
    assert not getattr(t2, "_mxu_base_self", False)
    assert not np.allclose(jr1, jr2, rtol=1e-3)

    # a chained commit refreshes from the original base
    _commit(storage, vs, et, seed=8)
    j3, jr3 = _jax_snapshot(storage, cache)
    assert j3._delta_ctx[0] is j1
    t3 = _port_twin(j3, base=t1)
    np.testing.assert_allclose(_port_rank(t3), jr3, rtol=RTOL, atol=ATOL)
    assert t3._mxu_state["base"] is t1._mxu_state


def test_bf16_refresh_routes_the_delta(force_mxu, no_build_plan):
    """The port's bf16 run of a delta snapshot stays within
    PRECISION_BOUNDS["bf16"] of the JAX package's f32 delta run, and sits
    nearer it than the base snapshot's ranks (the JAX package's bf16 run
    of such a snapshot serves the base plan without the delta)."""
    storage, vs, et = _storage()
    cache = GraphCache()
    j1, jr1 = _jax_snapshot(storage, cache)
    t1 = _port_twin(j1)
    _port_rank(t1, "bf16")
    no_build_plan.append(True)
    _commit(storage, vs, et, seed=7, n_add=150, into=0)
    j2, jr2 = _jax_snapshot(storage, cache)
    t2 = _port_twin(j2, base=t1)
    got = _port_rank(t2, "bf16")
    b = PRECISION_BOUNDS["bf16"]
    diff = np.abs(got - jr2)
    assert diff.max() <= b["pagerank_linf"] and diff.sum() <= b["pagerank_l1"]
    k = b["topk_order"]
    assert np.array_equal(np.argsort(-got)[:k], np.argsort(-jr2)[:k])
    assert np.abs(got - jr2).max() < np.abs(got - jr1).max()
    # the run placed for bf16 shares the base's bf16 routes
    key = (torch.device("cpu"), torch.bfloat16)
    run = t2._mxu_state["runs"][key]
    assert run.routes["edge"] is t1._mxu_state["placed"][key]["edge"]
    assert run.routes["node"] is t1._mxu_state["placed"][key]["node"]
    assert list(t1._mxu_state["placed"]) == [key]


def test_base_routes_placed_once_whatever_the_order(force_mxu,
                                                     no_build_plan,
                                                     monkeypatch):
    """A dtype first asked of the successor places the base routes on the
    base's state, once: the base snapshot's later run of that dtype takes
    them from there, and the answers equal runs on routes placed apart."""
    storage, vs, et = _storage()
    cache = GraphCache()
    j1, _ = _jax_snapshot(storage, cache)
    t1 = _port_twin(j1)
    _port_rank(t1, "f32")
    no_build_plan.append(True)
    _commit(storage, vs, et, seed=9, n_add=120, into=3)
    j2, _ = _jax_snapshot(storage, cache)
    t2 = _port_twin(j2, base=t1)
    places = []
    real = T.place_plan

    def counted(*args, **kw):
        places.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(T, "place_plan", counted)
    key = (torch.device("cpu"), torch.bfloat16)
    got2 = _port_rank(t2, "bf16")          # the successor asks first
    assert len(places) == 1 and list(t1._mxu_state["placed"]) == [
        (torch.device("cpu"), torch.float32), key]
    got1 = _port_rank(t1, "bf16")          # the base takes the same routes
    assert len(places) == 1
    placed = t1._mxu_state["placed"][key]
    for t in (t1, t2):
        assert t._mxu_state["runs"][key].routes["edge"] is placed["edge"]
    plan, delta = t2._mxu_state["plan"], t2._mxu_state["delta"]
    for d, got in ((None, got1), (delta, got2)):
        apart = real(plan, torch.bfloat16, "cpu")
        assert apart["edge"] is not placed["edge"]
        run = T.make_pagerank_kernel(plan, route_dtype=torch.bfloat16,
                                     device="cpu", delta=d, placed=apart)
        want, _, _ = run(None, 0.85, ITERS, -1.0)
        want = want[torch.from_numpy(plan.out_relabel)]
        assert np.array_equal(got, want.numpy())


def _twins(n=2000, e=15000, seed=21):
    src, dst, _ = _edges(n, e, seed)
    return src, dst, from_coo(src, dst, n_nodes=n).to_device("cpu")


def _successor(base, src, dst, changed, n=None, gids=None):
    g = from_coo(src, dst, n_nodes=n or base.n_nodes,
                 node_gids=gids).to_device("cpu")
    object.__setattr__(g, "_delta_ctx", (base, frozenset(changed)))
    return g


def test_large_delta_recompacts(force_mxu):
    src, dst, base = _twins()
    _port_rank(base)
    rng = np.random.default_rng(1)
    add_s = rng.integers(0, base.n_nodes, 1600)      # > max(10% E, 1024)
    s2 = np.concatenate([src, add_s])
    d2 = np.concatenate([dst, rng.integers(0, base.n_nodes, 1600)])
    g = _successor(base, s2, d2, add_s.tolist())
    _port_rank(g)
    assert "delta" not in g._mxu_state and g._mxu_base_self
    assert g._mxu_state["plan"] is not base._mxu_state["plan"]


def test_changed_node_set_does_a_full_build(force_mxu):
    src, dst, base = _twins()
    _port_rank(base)
    n = base.n_nodes + 1                              # one new node
    s2 = np.concatenate([src, [n - 1]])
    d2 = np.concatenate([dst, [0]])
    g = _successor(base, s2, d2, [n - 1], n=n)
    _port_rank(g)
    assert "delta" not in g._mxu_state and g._mxu_base_self
    # same count, other gids: dense ids shifted, full build too
    gids = np.arange(base.n_nodes, dtype=np.int64) + 1
    g2 = _successor(base, src, dst, [1], gids=gids)
    _port_rank(g2)
    assert "delta" not in g2._mxu_state


def test_no_edge_change_reuses_the_base_state(force_mxu, no_build_plan):
    src, dst, base = _twins()
    want = _port_rank(base)
    no_build_plan.append(True)
    # a property-only bump: the changed node's edges are the same multiset
    perm = np.random.default_rng(2).permutation(len(src))
    g = _successor(base, src[perm], dst[perm], [int(src[0]), 5])
    got = _port_rank(g)
    assert g._mxu_state is base._mxu_state
    assert np.array_equal(got, want)


def test_delta_snapshot_anchors_nothing(force_mxu, no_build_plan):
    """A successor whose context names a delta-derived snapshot as its
    base gets a full build: that snapshot's plan is its own base's."""
    src, dst, base = _twins()
    _port_rank(base)
    no_build_plan.append(True)
    s2, d2 = np.concatenate([src, [3]]), np.concatenate([dst, [4]])
    mid = _successor(base, s2, d2, [3])
    _port_rank(mid)
    assert mid._mxu_state["delta"].n_delta == 1
    no_build_plan.clear()
    s3, d3 = np.concatenate([s2, [5]]), np.concatenate([d2, [6]])
    g = _successor(mid, s3, d3, [5])
    _port_rank(g)
    assert "delta" not in g._mxu_state


def test_edge_diff_follows_the_reference_rules():
    src, dst, base = _twins(n=300, e=2000)
    w = base.host_coo[2].copy()
    w[0] = np.float32(2.5)                   # one weight changes
    g = from_coo(src, dst, w, n_nodes=base.n_nodes)
    (a_s, a_d, a_w), (r_s, r_d, r_w) = tpr._edge_diff(base, g,
                                                      {int(src[0])})
    assert (a_s.tolist(), a_d.tolist(), a_w.tolist()) == (
        [src[0]], [dst[0]], [2.5])
    assert (r_s.tolist(), r_d.tolist(), r_w.tolist()) == (
        [src[0]], [dst[0]], [1.0])
    # unchanged vertices are not diffed
    (a, _, _), (r, _, _) = tpr._edge_diff(base, g, {int(src[0]) + 1})
    assert len(a) == len(r) == 0
    # no host arrays: no diff
    bare = dataclasses.replace(g, host_coo=None)
    assert tpr._edge_diff(base, bare, {int(src[0])}) is None


def _defect_case():
    """The JAX package's bf16-on-delta defect on a small storage graph:
    1,500 nodes, 9,000 edges (tests/test_plan_delta_e2e.py's setup), then
    200 edges into node 0 by one commit.  Returns the JAX package's f32
    and bf16 ranks of the successor, its base bf16 ranks, and the port's
    bf16 ranks of the successor."""
    storage, vs, et = _storage(n=1500, e=9000)
    cache = GraphCache()
    j1, _ = _jax_snapshot(storage, cache)
    _, jb1 = _jax_snapshot(storage, cache, "bf16")
    t1 = _port_twin(j1)
    _port_rank(t1, "bf16")
    _commit(storage, vs, et, seed=7, n_add=200, n_remove=0, into=0)
    j2, jr2 = _jax_snapshot(storage, cache)
    _, jb2 = _jax_snapshot(storage, cache, "bf16")
    return jr2, jb2, jb1, _port_rank(_port_twin(j2, base=t1), "bf16")


def test_jax_bf16_refresh_serves_the_base_plan_and_the_port_does_not(
        force_mxu):
    """The JAX package builds its bf16 run of a refreshed snapshot from
    the bare base plan (memgraph_tpu/ops/pagerank.py:_pagerank_via_mxu),
    so its bf16 ranks stay the base's; the port routes the delta."""
    f32, jax_bf16, jax_base_bf16, port_bf16 = _defect_case()
    assert np.abs(jax_bf16 - jax_base_bf16).max() < 1e-6
    assert np.abs(jax_bf16 - f32).max() > 1e-2       # node 0 is off
    b = PRECISION_BOUNDS["bf16"]
    assert np.abs(port_bf16 - f32).max() <= b["pagerank_linf"]
    assert np.abs(port_bf16 - f32).sum() <= b["pagerank_l1"]


# --------------------------------------------------------------------------
# the resident generation's sharded variants (ResidentGraph.ensure_sharded)
# --------------------------------------------------------------------------

def _resident_case(n=400, e=3000, seed=5):
    from memgraph_tpu_torch.ops import delta as TD
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    gen = TD.ResidentGraph("k", 1, from_coo(src, dst, w, n_nodes=n))
    return gen, rng, n


def _a_delta(gen, rng, n, n_add=40, n_rem=25):
    from memgraph_tpu_torch.ops import delta as TD
    s, d, w = gen.coo
    rem = rng.choice(len(s), n_rem, replace=False)
    return TD.EdgeDelta(
        base_version=gen.version, version=gen.version + 1,
        add_src=rng.integers(0, n, n_add), add_dst=rng.integers(0, n, n_add),
        add_w=rng.uniform(0.5, 2.0, n_add).astype(np.float32),
        rem_src=s[rem].astype(np.int64), rem_dst=d[rem].astype(np.int64),
        rem_w=w[rem])


@pytest.mark.parametrize("by,doubled", [("src", False), ("dst", True)])
def test_ensure_sharded_after_apply_equals_a_fresh_sharding(by, doubled):
    """A commit moves the placed variant through ``apply_edge_delta``
    (no re-shard: ``delta.compacted_total`` unchanged) and places it
    again; its rows equal a fresh ``shard_edges`` of the spliced COO
    (with the generation's row slack), array for array, on the host and
    on the mesh."""
    from memgraph_tpu_torch.ops import delta as TD
    from memgraph_tpu_torch.ops.csr import shard_edges
    from memgraph_tpu_torch.parallel.mesh import get_mesh_context
    from memgraph_tpu_torch.utils.metrics import global_metrics
    ctx = get_mesh_context(devices=("cpu",) * 4)
    gen, rng, n = _resident_case()
    placed0 = gen.ensure_sharded(ctx, by=by, doubled=doubled)
    assert gen.ensure_sharded(ctx, by=by, doubled=doubled) is placed0
    compacted = global_metrics.value("delta.compacted_total")
    assert gen.apply(_a_delta(gen, rng, n), ctx)
    assert global_metrics.value("delta.compacted_total") == compacted
    got = gen.ensure_sharded(ctx, by=by, doubled=doubled)
    assert got is not placed0 and got.ctx_key == ctx.cache_key
    s, d, w = gen.coo
    s, d = s.astype(np.int64), d.astype(np.int64)
    if doubled:
        s, d, w = (np.concatenate([s, d]), np.concatenate([d, s]),
                   np.concatenate([w, w]))
    want = shard_edges(s, d, w, n, 4, by=by, slack=TD.TIER_ROW_SLACK)
    assert got.n_edges == want.n_edges and got.block == want.block
    # the splice keeps the row capacity it was planned with; a fresh
    # sharding plans from the new fullest row: the rows are equal up to
    # the shorter capacity, and padding past it (the last block's run
    # holds the sink's padding, so it ends at the row's capacity)
    np.testing.assert_array_equal(got.block_ptr[:, :-1],
                                  want.block_ptr[:, :-1])
    assert np.all(got.block_ptr[:, -1] == got.per)
    per = min(got.per, want.per)
    pad = {"src": (np.arange(4, dtype=np.int32) * got.block)[:, None],
           "dst": np.int32(n), "weights": np.float32(0.0)}
    got_rows, want_rows = {}, {}
    for f in ("src", "dst", "weights"):
        rows = np.stack([t.numpy() for t in getattr(got, f)])
        assert rows.tobytes() == getattr(got.host, f).tobytes(), f
        for a in (rows, getattr(want, f)):
            assert np.all(a[:, per:] == pad[f]), f
        got_rows[f], want_rows[f] = rows[:, :per], getattr(want, f)[:, :per]
    for f in ("src", "dst"):
        assert got_rows[f].tobytes() == \
            np.ascontiguousarray(want_rows[f]).tobytes(), f
    # within a run of equal (dst, src) keys (parallel edges) the splice
    # inserts an added edge first and a fresh sort keeps the COO's order:
    # the weights are equal as a multiset of each run
    for p in range(4):
        keys = (got_rows["src"][p], got_rows["dst"][p])
        a = got_rows["weights"][p][np.lexsort((got_rows["weights"][p],)
                                              + keys)]
        b = want_rows["weights"][p][np.lexsort((want_rows["weights"][p],)
                                               + keys)]
        assert a.tobytes() == b.tobytes()


def test_compaction_reshards_and_the_mesh_answer_follows():
    """Deltas past the compaction fraction re-shard the variants from the
    COO; the resident mesh PageRank on the moved generation equals a run
    on a fresh sharding of its COO, bit for bit."""
    from memgraph_tpu_torch.ops import delta as TD
    from memgraph_tpu_torch.ops.csr import shard_edges
    from memgraph_tpu_torch.parallel.distributed import \
        pagerank_partition_centric
    from memgraph_tpu_torch.parallel.mesh import get_mesh_context
    from memgraph_tpu_torch.utils.metrics import global_metrics
    ctx = get_mesh_context(devices=("cpu",) * 4)
    gen, rng, n = _resident_case()
    gen.ensure_sharded(ctx)
    compacted = global_metrics.value("delta.compacted_total")
    for _ in range(3):
        assert gen.apply(_a_delta(gen, rng, n, n_add=300, n_rem=10), ctx)
    assert global_metrics.value("delta.compacted_total") > compacted
    got, _, it = pagerank_partition_centric(gen.ensure_sharded(ctx), ctx,
                                            tol=0.0, max_iterations=20)
    s, d, w = gen.coo
    fresh = shard_edges(s, d, w, n, 4, slack=TD.TIER_ROW_SLACK)
    want, _, _ = pagerank_partition_centric(fresh, ctx, tol=0.0,
                                            max_iterations=20)
    assert it == 20 and got.numpy().tobytes() == want.numpy().tobytes()
