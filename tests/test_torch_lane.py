"""The port's read lane (memgraph_tpu_torch/ops/pipeline.py) against the
JAX package's (memgraph_tpu/ops/pipeline.py) on the same seeded numpy
columns and graphs, on the CPU.

Every program is held EXACTLY equal to the reference: aggregates, hop
counts (and a scipy int64 count of the same paths), top-k orders and
included counts, refusals and their reasons.  The inputs stay away from
the f32 witness boundaries (mass 2^30, multiplicity 2^24); one case a
boundary is clearly over it, and both packages refuse it.  The program
caches count the same compiles for the same calls.  The top-k of the
reference pads its rows to a power of two, and with no predicate its
padded rows count as included (null) rows: its callers keep the rows
under n (query/plan/lane.py), so a row count that is not a power of two
is compared on those rows; at 2048 rows the arrays are equal whole.

The read lane served by the port's kernel server (the ``lane`` op) is in
tests/test_torch_kernel_server.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from memgraph_tpu.ops import pipeline as jpl
from memgraph_tpu_torch.ops import columnar as tcol
from memgraph_tpu_torch.ops import pipeline as tpl

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N_ROWS = 3000
N_NODES = 700
N_EDGES = 6000


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    vals = np.stack([rng.integers(-100, 100, n),
                     rng.integers(0, 1000, n),
                     rng.integers(-(2**20), 2**20, n)]).astype(np.int32)
    present = rng.random((3, n)) > 0.1
    return vals, present, rng


AGG_CASES = [
    ((), (("count", None),)),
    (((0, ">"),), (("count", None), ("sum", 0), ("min", 0), ("max", 0))),
    (((0, ">="), (0, "<=")), (("sum", 1), ("count", 2))),
    (((1, "="),), (("count", None), ("min", 2), ("max", 2))),
    (((1, "<>"), (2, "<")), (("sum", 2), ("count", 1))),
    (((0, "present"),), (("count", 0), ("sum", 0))),
    # nothing selected: min / max over nothing is None
    (((0, ">"),), (("min", 1), ("max", 1), ("sum", 1), ("count", None))),
]
AGG_RHS = {1: [10], 2: [-5, 5], 3: [17], 4: [400, 0], 5: [0], 6: [10_000]}


@pytest.mark.parametrize("case", range(len(AGG_CASES)))
def test_masked_aggregate_equals_the_reference(case):
    preds, aggs = AGG_CASES[case]
    vals, present, rng = _columns(N_ROWS, case)
    base = rng.random(N_ROWS) > 0.05
    rhs = AGG_RHS.get(case, [])
    want = jpl.masked_aggregate(preds, aggs, vals, present, base, rhs)
    got = tpl.masked_aggregate(preds, aggs, vals, present, base, rhs,
                               device="cpu")
    assert got == want
    assert all(type(g) is type(w) for g, w in zip(got, want))
    if case == 6:
        assert got[:2] == [None, None]


def test_aggregate_over_the_mass_bound_is_refused_by_both():
    vals = np.full((1, 64), 2**25, dtype=np.int32)    # mass 2^31 > 2^30
    present = np.ones((1, 64), bool)
    base = np.ones(64, bool)
    args = ((), (("sum", 0),), vals, present, base, [])
    with pytest.raises(jpl.LaneRefused) as jr:
        jpl.masked_aggregate(*args)
    with pytest.raises(tpl.LaneRefused) as tr:
        tpl.masked_aggregate(*args, device="cpu")
    assert tr.value.reason == jr.value.reason == "precision_overflow"
    # just under the bound: answered, and equal
    vals = np.full((1, 64), 2**23, dtype=np.int32)     # mass 2^29
    args = ((), (("sum", 0),), vals, present, base, [])
    assert tpl.masked_aggregate(*args, device="cpu") \
        == jpl.masked_aggregate(*args) == [2**29]


def _graph(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_NODES, N_EDGES)
    dst = (rng.random(N_EDGES) ** 2 * N_NODES).astype(np.int64)
    loops = rng.choice(N_NODES, 40, replace=False)
    src = np.concatenate([src, loops]).astype(np.int32)
    dst = np.concatenate([dst, loops]).astype(np.int32)
    emask = rng.random(len(src)) > 0.1
    smask = rng.random(N_NODES) > 0.6
    midmask = (rng.random(N_NODES) > 0.3).astype(np.float32)
    tmask = (rng.random(N_NODES) > 0.2).astype(np.float32)
    return src, dst, emask, smask, midmask, tmask


def _scipy_counts(src, dst, emask, smask, midmask, tmask, hops,
                  include_lower, edge_unique):
    """The same path counts in int64 by scipy."""
    s, d = src[emask], dst[emask]
    a = sp.csr_matrix((np.ones(len(s), np.int64), (d, s)),
                      shape=(N_NODES, N_NODES))
    x0 = smask.astype(np.int64)
    x1 = a @ x0
    p = np.zeros(N_NODES, np.int64)
    if hops == 2:
        x2 = a @ (x1 * midmask.astype(np.int64))
        p2 = x2 * tmask.astype(np.int64)
        if edge_unique:
            lp = s == d
            sl = np.zeros(N_NODES, np.int64)
            np.add.at(sl, d[lp], (x0 * midmask.astype(np.int64))[s[lp]])
            p2 = p2 - sl * tmask.astype(np.int64)
        p += p2
    if hops == 1 or include_lower:
        p += x1 * tmask.astype(np.int64)
    return {"rows": int(p.sum()), "distinct": int((p > 0).sum())}


HOP_CASES = [(1, False, True), (2, False, True), (2, True, True),
             (2, False, False), (2, True, False)]


@pytest.mark.parametrize("hops,include_lower,edge_unique", HOP_CASES)
def test_hop_counts_equal_the_reference_and_scipy(hops, include_lower,
                                                  edge_unique):
    g = _graph(hops * 10 + include_lower * 2 + edge_unique)
    kw = dict(hops=hops, include_lower=include_lower,
              edge_unique=edge_unique, need_rows=True, need_distinct=True)
    want = jpl.hop_counts(*g, N_NODES, **kw)
    got = tpl.hop_counts(*g, N_NODES, **kw, device="cpu")
    staged = tpl.stage_edges(*g[:3], device="cpu")
    again = tpl.hop_counts(staged, None, None, *g[3:], N_NODES, **kw)
    assert got == want == again
    assert got == _scipy_counts(*g, hops, include_lower, edge_unique)


def test_staged_edges_launch_no_sort_on_a_repeat(monkeypatch):
    g = _graph(5)
    staged = tpl.stage_edges(*g[:3], device="cpu")
    kw = dict(hops=2, need_rows=True, need_distinct=True)
    first = tpl.hop_counts(staged, None, None, *g[3:], N_NODES, **kw)
    sorts = []
    for name in ("sort", "argsort"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k:
                            sorts.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(9)
    smask = rng.random(N_NODES) > 0.5
    got = tpl.hop_counts(staged, None, None, smask, *g[4:], N_NODES, **kw)
    monkeypatch.undo()
    assert sorts == []
    assert got == jpl.hop_counts(*g[:3], smask, *g[4:], N_NODES, **kw)
    assert first != got


def test_hop_multiplicity_over_2_24_is_refused_by_both():
    # 5000 parallel a->b edges and 5000 b->c: 25M two-hop paths into c
    k = 5000
    src = np.concatenate([np.zeros(k), np.ones(k)]).astype(np.int32)
    dst = np.concatenate([np.ones(k), np.full(k, 2)]).astype(np.int32)
    emask = np.ones(2 * k, bool)
    smask = np.array([True, False, False])
    ones = np.ones(3, np.float32)
    args = (src, dst, emask, smask, ones, ones, 3)
    with pytest.raises(jpl.LaneRefused) as jr:
        jpl.hop_counts(*args, hops=2)
    with pytest.raises(tpl.LaneRefused) as tr:
        tpl.hop_counts(*args, hops=2, device="cpu")
    assert tr.value.reason == jr.value.reason == "precision_overflow"
    # one hop stays under every bound: answered, and equal
    assert tpl.hop_counts(*args, hops=1, device="cpu") \
        == jpl.hop_counts(*args, hops=1) == {"rows": k}


@pytest.mark.parametrize("n", [2048, 3000])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("preds", [(), ((0, ">"),), ((1, "<"), (0, "<>"))])
def test_masked_topk_equals_the_reference(n, ascending, preds):
    vals, present, rng = _columns(n, 7)
    keyv = rng.integers(-30, 30, n).astype(np.int32)     # many ties
    keyp = rng.random(n) > 0.2                           # nulls
    rhs = {(): [], ((0, ">"),): [-20]}.get(preds, [600, 3])
    jo, jc = jpl.masked_topk(preds, ascending, vals, present, keyv, keyp,
                             rhs)
    to, tc = tpl.masked_topk(preds, ascending, vals, present, keyv, keyp,
                             rhs, device="cpu")
    jo = np.asarray(jo)
    if n == 2048:
        assert tc == jc and np.array_equal(to, jo)
    assert np.array_equal(to[:tc], jo[jo < n][:tc])
    if preds:
        assert tc == jc
    # a numpy stable lexsort of the same keys
    mask = np.ones(n, bool)
    for i, (ci, op) in enumerate(preds):
        cmp = {">": np.greater, "<": np.less, "<>": np.not_equal}[op]
        mask &= cmp(vals[ci], rhs[i]) & present[ci]
    kf = keyv.astype(np.float32) * (1 if ascending else -1)
    kf = np.where(keyp, kf, np.float32(3e38 if ascending else -3e38))
    kf = np.where(mask, kf, np.float32(np.inf))
    assert np.array_equal(to, np.argsort(kf, kind="stable"))
    assert tc == int(mask.sum())


def test_i32_column_admission_equals_the_reference():
    from memgraph_tpu.ops import columnar as jcol
    present = np.array([True, True, False])
    cases = [np.array([1, -5, 0]), np.array([2**31 - 1, 0, 0]),
             np.array([-(2**31) + 1, 3, 2**40]),
             np.array([-(2**31), 0, 0])]
    for v in cases:
        jc = jcol.Column("int", v.astype(np.int64), present)
        tc = tcol.Column("int", v.astype(np.int64), present)
        a, b = jpl.i32_column(jc), tpl.i32_column(tc)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    s = tcol.Column("str", np.array([0, 1, 0], np.int32), present,
                    {"a": 0, "b": 1})
    assert tpl.i32_column(s).dtype == np.int32
    assert tpl.i32_column(tcol.Column("float", np.zeros(3), present)) is None


def test_program_caches_count_the_same_compiles():
    for m in (jpl, tpl):
        m.drop_programs()
        m.LANE_REGISTRY.reset()
    vals, present, _ = _columns(2000, 3)
    g = _graph(4)
    for m, extra in ((jpl, {}), (tpl, {"device": "cpu"})):
        for n in (500, 900, 2000):         # 500 and 900 share a bucket
            m.masked_aggregate(((0, ">"),), (("count", None),),
                               vals[:, :n], present[:, :n],
                               np.ones(n, bool), [1], fingerprint="fp-a",
                               **extra)
        m.masked_aggregate(((0, "<"),), (("count", None),), vals, present,
                           np.ones(2000, bool), [1], fingerprint="fp-b",
                           **extra)
        for _ in range(2):
            m.hop_counts(*g, N_NODES, hops=2, fingerprint="fp-h", **extra)
        m.masked_topk((), True, vals, present, vals[0], present[0], [],
                      fingerprint="fp-t", **extra)
    assert tpl.resident_programs() == jpl.resident_programs() == 5
    assert tpl.LANE_REGISTRY.snapshot() == jpl.LANE_REGISTRY.snapshot()
    assert tpl.lane_stats()["resident_programs"] == 5
