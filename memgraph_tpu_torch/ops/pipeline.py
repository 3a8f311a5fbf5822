"""The read lane's device programs: masked aggregates, hop counts and
top-k over columnar snapshots.

Port of memgraph_tpu/ops/pipeline.py.  Three program families:

  * ``masked_aggregate``: predicate masks over stacked int32 property
    columns, AND-folded into count / sum / min / max epilogues with
    ``where(mask, v, identity)`` (never a gathered intermediate).
  * ``hop_counts``: 1-2 hop expansion counts from a masked source
    frontier, ``x1 = A^T ⊕.⊗ s`` over the **plus_first** semiring (path
    multiplicities), chained for the second hop, with the self-loop
    edge-uniqueness correction and an optional distinct-target count.
    It rides ``semiring.spmv(..., mask=)`` and so K1 (``csr_spmm_sum``):
    ``stage_edges`` sorts the edges by dst stably ONCE and keeps them on
    the device with their runs, so a query moves only its O(n) masks and
    launches K1 without a sort (the reference's residency contract).
  * ``masked_topk``: ORDER BY <int key> LIMIT k as one mask and a stable
    argsort (nulls last ascending, first descending, per openCypher).

Exactness (the reference's discipline): columns are admitted only when
every value fits int32 (``i32_column``); compares run on int32; count and
sum accumulate exactly (torch sums integers in int64; a sum is wrapped to
int32 as the reference's accumulator is), and beside each sum runs the
reference's f32 absolute-mass shadow, summed by K2 (``lane_sum``) in its
fixed order.  The result is refused (``LaneRefused("precision_overflow")``,
the caller's typed fallback to the host path) unless the shadow proves no
int32 partial could have wrapped (mass < 2^30), and path counts also that
every node's multiplicity stayed under f32's 2^24 integer range.  The
refusal reads the shadow, never the exact total, so it falls where the
reference's falls (up to the f32 rounding of the shadow itself, at the
boundary).

Programs are built closures cached under the reference's structural keys
(power-of-two buckets of the row and edge counts included), so
``lane.compiled_total`` and the registry's ``compiled`` / ``hits`` count
what the reference counts for the same calls; nothing is padded.
Metrics go to ``utils.metrics.global_metrics`` under the reference's
``lane.*`` names.  Entry points run on ``cuda`` unless ``device=`` asks
for the CPU.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..observability import stats as mgstats
from ..utils.metrics import global_metrics
from . import segment_cuda as SC
from . import semiring as S

#: f32 integer-exactness ceiling for per-node path multiplicities
_F24 = float(1 << 24)
#: int32 no-partial-wrap ceiling for the f32 mass shadows
_I30 = float(1 << 30)

#: int32 identities for masked min/max
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31) + 1

#: null ordering sentinels: finite, so they sort between real keys
#: (|v| < 2^24 admitted) and the +inf "predicate excluded" sentinel
_NULL_LAST = np.float32(3.0e38)
_NULL_FIRST = np.float32(-3.0e38)


class LaneRefused(Exception):
    """Typed device-lane refusal; ``reason`` feeds
    ``lane.fallback_total.<reason>`` and the per-fingerprint registry."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(detail or reason)
        self.reason = reason


def _bucket(n: int, floor: int = 1024) -> int:
    """The reference's power-of-two padding bucket (a program key here)."""
    b = floor
    while b < n:
        b <<= 1
    return b


# --------------------------------------------------------------------------
# program cache (keyed structurally, as the reference's)
# --------------------------------------------------------------------------

_PROGRAM_CACHE: dict = {}
_program_lock = threading.Lock()


def _get_program(key, build, *build_args):
    """Get, or build and store under one lock, with the reference's
    accounting (``lane.compiled_total``, ``lane.compile_latency_sec``,
    the ``lane.resident`` gauge, the ``lane_compile`` stage)."""
    fn = _PROGRAM_CACHE.get(key)
    if fn is not None:
        return fn
    with _program_lock:
        fn = _PROGRAM_CACHE.get(key)
        if fn is None:
            t0 = time.perf_counter()
            fn = build(*build_args)
            _PROGRAM_CACHE[key] = fn
            dt = time.perf_counter() - t0
            global_metrics.increment("lane.compiled_total")
            global_metrics.observe("lane.compile_latency_sec", dt)
            global_metrics.set_gauge("lane.resident",
                                     float(len(_PROGRAM_CACHE)))
            mgstats.record_stage("lane_compile", dt)
    return fn


def _program(key, fingerprint, build, *build_args):
    was = key in _PROGRAM_CACHE
    fn = _get_program(key, build, *build_args)
    if not was:
        LANE_REGISTRY.note_compiled(fingerprint)
    return fn


def resident_programs() -> int:
    return len(_PROGRAM_CACHE)


def drop_programs() -> None:
    """Schema-change invalidation: drop every cached lane program."""
    with _program_lock:
        _PROGRAM_CACHE.clear()
    global_metrics.set_gauge("lane.resident", 0.0)


# --------------------------------------------------------------------------
# per-fingerprint lane registry (compiles / hits / typed fallbacks)
# --------------------------------------------------------------------------


class LaneRegistry:
    """Per-plan-cache-fingerprint lane accounting (the ``lane`` section
    of a stats reply).  Plan-time refusals (a shape never built) land
    under the ``"<plan>"`` pseudo-fingerprint."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_fp: dict[str, dict] = {}

    def _entry(self, fp: str | None) -> dict:
        key = fp or "<plan>"
        e = self._by_fp.get(key)
        if e is None:
            e = self._by_fp[key] = {"compiled": 0, "hits": 0,
                                    "fallbacks": {}}
        return e

    def note_compiled(self, fp: str | None) -> None:
        with self._lock:
            self._entry(fp)["compiled"] += 1

    def note_hit(self, fp: str | None) -> None:
        global_metrics.increment("lane.hit_total")
        with self._lock:
            self._entry(fp)["hits"] += 1

    def note_fallback(self, fp: str | None, reason: str) -> None:
        global_metrics.increment(f"lane.fallback_total.{reason}")
        with self._lock:
            fb = self._entry(fp)["fallbacks"]
            fb[reason] = fb.get(reason, 0) + 1

    def compiles_for(self, fp: str | None) -> int:
        with self._lock:
            return self._entry(fp)["compiled"]

    def reset(self) -> None:
        with self._lock:
            self._by_fp.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {fp: {"compiled": e["compiled"], "hits": e["hits"],
                         "fallbacks": dict(e["fallbacks"])}
                    for fp, e in self._by_fp.items()}


LANE_REGISTRY = LaneRegistry()


def lane_stats() -> dict:
    """The ``lane`` section of a stats reply."""
    return {"resident_programs": resident_programs(),
            "fingerprints": LANE_REGISTRY.snapshot()}


# --------------------------------------------------------------------------
# masked aggregate program (scan tail + one-hop edge tail)
# --------------------------------------------------------------------------


def _compare(v, r: int, op: str):
    if op == "=":
        return v == r
    if op == "<>":
        return v != r
    if op == "<":
        return v < r
    if op == "<=":
        return v <= r
    if op == ">":
        return v > r
    if op == ">=":
        return v >= r
    return torch.ones_like(v, dtype=torch.bool)     # "present": presence


def _pred_mask(mask, preds, vals, present, rhs):
    for i, (ci, op) in enumerate(preds):
        mask = mask & _compare(vals[ci], rhs[i], op) & present[ci]
    return mask


def _tensor(a, dtype, device) -> torch.Tensor:
    """A host array on ``device`` (a read-only one, such as a wire
    frame's, copied first: torch tensors are writable)."""
    a = np.asarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def _wrap_i32(total: int) -> int:
    """An exact integer sum as the reference's int32 accumulator holds
    it (the two differ only past the refusal's bound)."""
    return (total + 2**31) % 2**32 - 2**31


def _build_agg_program(preds: tuple, aggs: tuple):
    """One program: the predicate masks AND-folded into every
    aggregate's reduction.  Returns python values laid out as the
    reference's flat tuple: count; (sum, mass); (min or max, count)."""

    def run(vals, present, base, rhs):
        mask = _pred_mask(base, preds, vals, present, rhs)
        outs = []
        for kind, ci in aggs:
            if ci is None:                    # count(*) / count(sym)
                outs.append(mask.sum())
                continue
            sel = mask & present[ci]
            v = vals[ci]
            if kind == "count":
                outs.append(sel.sum())
            elif kind == "sum":
                outs.append(torch.where(sel, v.long(), 0).sum())
                outs.append(SC.lane_sum(v.to(torch.float32).abs(),
                                        m=sel.to(torch.float32)))
            elif kind == "min":
                outs.append(torch.where(sel, v, _I32_MAX).min())
                outs.append(sel.sum())
            else:                             # max
                outs.append(torch.where(sel, v, _I32_MIN).max())
                outs.append(sel.sum())
        # one host transfer: float64 holds every scalar exactly (counts,
        # int32 extremes, a sum the refusal lets through: |sum| < 2^30)
        return torch.stack([o.to(torch.float64) for o in outs]).tolist()

    return run


def _rhs(rhs) -> list:
    """The per-predicate right-hand sides as int32 values (the
    reference's traced int32 array; numpy refuses an out-of-range one)."""
    return [int(r) for r in np.asarray(rhs if rhs else [], dtype=np.int32)]


def masked_aggregate(preds: tuple, aggs: tuple, vals: np.ndarray,
                     present: np.ndarray, base: np.ndarray,
                     rhs: list, fingerprint: str | None = None, *,
                     device=None) -> list:
    """Run one scan/expand aggregate.

    ``vals``/``present`` are (C, n) int32 / bool stacks; ``preds`` is a
    tuple of (col_idx, op); ``aggs`` a tuple of (kind, col_idx|None);
    ``rhs`` the per-predicate int32 right-hand sides.  Returns python
    aggregate values in ``aggs`` order; raises :class:`LaneRefused` when
    the exactness witness cannot prove the int32 accumulation safe."""
    dev = resolve_device(device)
    n = vals.shape[1] if vals.size else len(base)
    key = ("agg", tuple(preds), tuple(aggs), vals.shape[0],
           _bucket(max(n, 1)))
    fn = _program(key, fingerprint, _build_agg_program, tuple(preds),
                  tuple(aggs))
    t0 = time.perf_counter()
    args = (_tensor(vals, np.int32, dev), _tensor(present, bool, dev),
            _tensor(base, bool, dev), _rhs(rhs))
    mgstats.record_stage("lane_dispatch", time.perf_counter() - t0)
    t0 = time.perf_counter()
    raw = fn(*args)                      # host values: the read is inside
    mgstats.record_stage("lane_iterate", time.perf_counter() - t0)
    out = []
    i = 0
    for kind, ci in aggs:
        if ci is None or kind == "count":
            out.append(int(raw[i]))
            i += 1
        elif kind == "sum":
            total, mass = int(raw[i]), float(raw[i + 1])
            i += 2
            if mass >= _I30:
                raise LaneRefused("precision_overflow",
                                  f"sum mass {mass:.3g} >= 2^30")
            out.append(_wrap_i32(total))
        else:                                  # min / max
            val, cnt = int(raw[i]), int(raw[i + 1])
            i += 2
            out.append(val if cnt else None)
    return out


# --------------------------------------------------------------------------
# hop-count program (1-2 hop expansion from a masked frontier)
# --------------------------------------------------------------------------


@dataclass
class StagedEdges:
    """An edge set on the device, sorted by dst (stably) once: ``src``,
    ``dst``, the edge mask ``emask`` and the self-loop mask ``loops``
    (``emask & (src == dst)``, the edge-uniqueness correction's), with
    the runs of dst for each node count asked (``runs``: n -> (ptr,
    longest run))."""
    src: torch.Tensor
    dst: torch.Tensor
    emask: torch.Tensor
    loops: torch.Tensor
    eb: int                        # the reference's edge bucket
    runs: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.src.device

    def runs_for(self, n: int):
        got = self.runs.get(n)
        if got is None:
            ptr = SC.segment_runs(self.dst, n)
            longest = int((ptr[1:] - ptr[:-1]).max()) if n else 0
            got = self.runs[n] = (ptr, longest)
        return got


def stage_edges(src: np.ndarray, dst: np.ndarray, emask: np.ndarray, *,
                device=None) -> StagedEdges:
    """Ship an edge set to the device ONCE, sorted by dst.  Callers cache
    the staged edges per (topology version, edge types, direction): a
    hop query then moves only the O(n) node masks, which is what makes
    the lane's per-query export cost zero on an unchanged graph."""
    dev = resolve_device(device)
    d = _tensor(dst, np.int32, dev)
    s = _tensor(src, np.int32, dev)
    m = _tensor(emask, bool, dev)
    order = torch.sort(d, stable=True).indices
    s, d, m = s[order], d[order], m[order]
    e = len(d)
    return StagedEdges(src=s, dst=d, emask=m, loops=m & (s == d),
                       eb=_bucket(max(e, 1)))


def _build_hops_program(hops: int, include_lower: bool, edge_unique: bool,
                        need_rows: bool, need_distinct: bool):
    """Masked plus_first SpMV chain on K1; every mask is data, so one
    program serves every predicate and parameter of the shape."""

    def spmv(x, st, ptr, longest, n, mask):
        return S.spmv("plus_first", x, st.src, st.dst, n_out=n,
                      sorted=True, mask=mask, ptr=ptr, longest=longest)

    def run(st, smask, midmask, tmask, n):
        ptr, longest = st.runs_for(n)
        x0 = smask.to(torch.float32)
        x1 = spmv(x0, st, ptr, longest, n, st.emask)
        p = torch.zeros(n, dtype=torch.float32, device=x0.device)
        max1 = x1.max() if n else torch.zeros((), device=x0.device)
        max2 = torch.zeros((), dtype=torch.float32, device=x0.device)
        if hops == 2:
            x2 = spmv(x1 * midmask, st, ptr, longest, n, st.emask)
            p2 = x2 * tmask
            if edge_unique:
                # the ONLY length-2 path reusing its edge is a source
                # self-loop traversed twice: subtract one per such edge
                sl = spmv(x0 * midmask, st, ptr, longest, n, st.loops)
                p2 = p2 - sl * tmask
            p = p + p2
            if n:
                max2 = x2.max()
        if hops == 1 or include_lower:
            p = p + x1 * tmask
        outs = [max1.to(torch.float64), max2.to(torch.float64),
                SC.lane_sum(p).to(torch.float64)]
        if need_rows:
            outs.append(p.to(torch.int32).sum().to(torch.float64))
        if need_distinct:
            outs.append((p > 0.5).sum().to(torch.float64))
        return torch.stack(outs).cpu().tolist()

    return run


def hop_counts(src, dst, emask, smask: np.ndarray,
               midmask: np.ndarray, tmask: np.ndarray, n_nodes: int, *,
               hops: int, include_lower: bool = False,
               edge_unique: bool = True, need_rows: bool = True,
               need_distinct: bool = False,
               fingerprint: str | None = None, device=None) -> dict:
    """Run a 1-2 hop count.  ``src`` may be a :func:`stage_edges` result
    (``dst`` and ``emask`` are then ignored: the staged edges hold them)
    or raw host arrays.  Returns {"rows": int, "distinct": int} (keys per
    request); raises :class:`LaneRefused` when the f32 multiplicity
    witness trips."""
    t0 = time.perf_counter()
    if isinstance(src, StagedEdges):
        st = src
    else:
        st = stage_edges(src, dst, emask, device=device)
    dev = st.device
    n = int(n_nodes)
    key = ("hops", hops, include_lower, edge_unique, need_rows,
           need_distinct, st.eb, _bucket(max(n, 1)))
    fn = _program(key, fingerprint, _build_hops_program, hops,
                  include_lower, edge_unique, need_rows, need_distinct)

    def node_mask(a, dtype):
        a = np.asarray(a, dtype=dtype)[:n]
        if len(a) < n:
            a = np.concatenate([a, np.zeros(n - len(a), dtype=dtype)])
        return _tensor(a, dtype, dev)

    masks = (node_mask(smask, bool), node_mask(midmask, np.float32),
             node_mask(tmask, np.float32))
    mgstats.record_stage("lane_dispatch", time.perf_counter() - t0)
    t0 = time.perf_counter()
    raw = fn(st, *masks, n)              # host values: the read is inside
    mgstats.record_stage("lane_iterate", time.perf_counter() - t0)
    max1, max2, total_f = raw[0], raw[1], raw[2]
    if max1 >= _F24 or max2 >= _F24:
        raise LaneRefused("precision_overflow",
                          "per-node path multiplicity >= 2^24")
    if total_f >= _I30:
        raise LaneRefused("precision_overflow",
                          f"path total {total_f:.3g} >= 2^30")
    out: dict = {}
    i = 3
    if need_rows:
        out["rows"] = int(raw[i])
        i += 1
    if need_distinct:
        out["distinct"] = int(raw[i])
    return out


# --------------------------------------------------------------------------
# top-k ORDER BY program
# --------------------------------------------------------------------------


def _build_topk_program(preds: tuple, ascending: bool):
    """Mask and stable ascending argsort.  Nulls rank last under ASC and
    first under DESC (openCypher orderability); rows excluded by a
    predicate sort to the very end, past every included row."""

    def run(vals, present, keyv, keyp, rhs):
        mask = _pred_mask(torch.ones_like(keyp), preds, vals, present, rhs)
        kf = keyv.to(torch.float32)
        if not ascending:
            kf = -kf
        null_rank = float(_NULL_LAST if ascending else _NULL_FIRST)
        kf = torch.where(keyp, kf, null_rank)
        kf = torch.where(mask, kf, float("inf"))
        order = torch.argsort(kf, stable=True)   # ties keep row order
        return order, mask.sum()

    return run


def masked_topk(preds: tuple, ascending: bool, vals: np.ndarray,
                present: np.ndarray, keyv: np.ndarray, keyp: np.ndarray,
                rhs: list, fingerprint: str | None = None, *,
                device=None):
    """Returns (order, n_included): row indices in final ORDER BY order
    (callers take the first min(k, n_included))."""
    dev = resolve_device(device)
    n = len(keyv)
    key = ("topk", tuple(preds), ascending, vals.shape[0],
           _bucket(max(n, 1)))
    fn = _program(key, fingerprint, _build_topk_program, tuple(preds),
                  ascending)
    t0 = time.perf_counter()
    args = (_tensor(vals, np.int32, dev), _tensor(present, bool, dev),
            _tensor(keyv, np.int32, dev), _tensor(keyp, bool, dev),
            _rhs(rhs))
    mgstats.record_stage("lane_dispatch", time.perf_counter() - t0)
    t0 = time.perf_counter()
    order, count = fn(*args)
    order, count = order.to(torch.int32).cpu().numpy(), int(count)
    mgstats.record_stage("lane_iterate", time.perf_counter() - t0)
    return order, count


# --------------------------------------------------------------------------
# host-side column admission (the exactness gate)
# --------------------------------------------------------------------------


def i32_column(col) -> np.ndarray | None:
    """An ops/columnar.py Column as an int32 value array, or None when
    the lane's exactness discipline cannot admit it (float columns, ints
    beyond int32, "other" kinds).  The verdict is cached on the column:
    snapshots live per version, so this runs once per (version, column)."""
    cached = getattr(col, "_lane_i32", False)
    if cached is not False:
        return cached
    out = None
    if col.kind in ("int", "bool", "str") and col.values is not None:
        if col.kind == "int":
            v = col.values
            sel = v[col.present] if col.present.any() else v[:0]
            if sel.size == 0 or (int(sel.min()) > -(2**31)
                                 and int(sel.max()) < 2**31):
                out = v.astype(np.int32)
        else:
            out = col.values.astype(np.int32)
    try:
        col._lane_i32 = out
    except AttributeError:
        pass
    return out
