"""The semiring core that every SpMV-shaped algorithm of the port rides,
in PyTorch.

Port of memgraph_tpu/ops/semiring.py: the (⊕, ⊗) algebra (``SEMIRINGS``),
the per-edge building blocks (``edge_combine``, ``edge_reduce``), the
semiring matvec ``spmv`` (masks, ``mask_fill``, push ``frontier``s,
(n, B) lanes), direction-optimizing ``select_pull``, the fused
``fixpoint`` loop and the MXU plan's ``mxu_fixpoint``.  Three backends sit
behind ``route_backend``:

  * ``mesh``    — the partition-centric kernels of parallel/distributed.py
    over a MeshContext, when a mesh is asked for (``mesh=`` or
    MEMGRAPH_TPU_MESH_DEVICES); see parallel/analytics.py.

  * ``mxu``     — the gather-free plan of ops/spmv_mxu.py (expand matmul,
    Benes route on the CUDA kernels of ops/benes_cuda.py, one-hot extract
    matmul, node relabel).  ⊕ = sum fixpoints on graphs of at least
    ``MXU_MIN_EDGES`` edges on the card take it.
  * ``segment`` — per-edge gather, ⊗-combine and segment-⊕ reduction,
    with the fused epilogue in a host-driven loop (``fixpoint``; a
    ``step`` hook replaces the matvec).  It answers every other case.

How each ⊕ reduces: a float32 sum goes through the deterministic run sum
of ops/segment_cuda.py (``csr_spmm_sum``, a hand-written kernel on the
card, ``index_add_`` in edge order on the CPU: the same bits), its runs
given (``ptr=``: a graph's ``csc_runs()`` or ``row_ptr``) or found in the
sorted keys by ``torch.searchsorted``; unsorted keys are stably sorted
first, so no float atomics ever reduce a sum.  Integer sums use
``index_add_`` (exact in any order); min, max and or use
``scatter_reduce_`` (exact in any order), with jax.ops.segment_min/max's
values for empty segments.

Mixed precision (``precision=``): ``f32`` is the exact path; ``bf16``
rounds each per-edge contribution to bfloat16 before the f32
accumulation; ``int8`` (segment backend only) quantizes the streamed
vector symmetrically per iteration.  The documented error bounds live in
:data:`PRECISION_BOUNDS`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import segment_cuda as SC

# ---------------------------------------------------------------------------
# semiring algebra
# ---------------------------------------------------------------------------

#: ⊕ kinds understood by :func:`edge_reduce`
_ADD_KINDS = ("sum", "min", "max", "or")
#: ⊗ kinds understood by :func:`edge_combine`
_MUL_KINDS = ("times", "plus", "first", "min", "and")


@dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair: ``y[j] = ⊕_{(i,j) ∈ E} (x[i] ⊗ w[i,j])``."""
    name: str
    add: str            # one of _ADD_KINDS
    mul: str            # one of _MUL_KINDS

    def __post_init__(self):
        if self.add not in _ADD_KINDS:
            raise ValueError(f"unknown ⊕ {self.add!r}")
        if self.mul not in _MUL_KINDS:
            raise ValueError(f"unknown ⊗ {self.mul!r}")


#: the semiring table (a copy of memgraph_tpu.ops.semiring.SEMIRINGS)
SEMIRINGS = {
    "plus_times": Semiring("plus_times", "sum", "times"),   # pagerank/katz
    "min_plus": Semiring("min_plus", "min", "plus"),        # sssp/bfs
    "max_min": Semiring("max_min", "max", "min"),           # bottleneck path
    "or_and": Semiring("or_and", "or", "and"),              # reachability
    "plus_first": Semiring("plus_first", "sum", "first"),   # sigma/gnn agg
    "min_first": Semiring("min_first", "min", "first"),     # wcc/scc labels
}


def resolve_semiring(sr) -> Semiring:
    if isinstance(sr, Semiring):
        return sr
    got = SEMIRINGS.get(sr)
    if got is None:
        raise KeyError(f"unknown semiring {sr!r}; have {sorted(SEMIRINGS)}")
    return got


#: Documented error bounds of the reduced-precision paths (a copy of
#: memgraph_tpu.ops.semiring.PRECISION_BOUNDS, plus ``katz_rel``).
#: Derivation sketch:
#:   bf16 — each contribution carries one rounding of relative size
#:          2^-9..2^-8; with damping d the fixpoint error is bounded by
#:          d/(1-d) · 2^-8 · max(rank) per component.  Budgeted 4x.
#:   int8 — symmetric per-iteration quantization of the streamed vector:
#:          |x - dq(x)| ≤ max|x|/254 per element, amplified d/(1-d) at
#:          the fixpoint.  Budgeted 4x.
#:   bf16 katz (``katz_rel``, the port's own) — x = αAᵀx + β with each
#:          round's contributions rounded to bf16 (2^-8 relative at most):
#:          a round's rounding adds ≤ 2^-8 of α·Aᵀx ≤ x, and its image
#:          after k more rounds shrinks as (αλ)^k, λ the spectral radius
#:          of Aᵀ; so the fixpoint's max relative error is ≤ 2^-8 (1 +
#:          αλ/(1 - αλ)) — at αλ ≤ 1/2 (the north star at α = 0.05, λ ≈
#:          10.0), 2 · 2^-8.  Budgeted 4x.  Holds for αλ ≤ 1/2 only.
PRECISION_BOUNDS = {
    "bf16": {"pagerank_linf": 4 * (0.85 / 0.15) * 2.0 ** -8 * 0.05,
             "pagerank_l1": 2.5e-2, "topk_order": 5,
             "katz_rel": 4 * 2.0 ** -8 * (1 + 0.5 / (1 - 0.5))},
    "int8": {"pagerank_linf": 4 * (0.85 / 0.15) * (0.05 / 254.0),
             "pagerank_l1": 2.5e-2, "topk_order": 5},
}

_PRECISIONS = ("f32", "bf16", "int8")

#: Above this edge count the gather-free MXU plan (ops/spmv_mxu.py) runs
#: despite its host-side plan build; below it the segment path's zero
#: setup cost wins.
MXU_MIN_EDGES = int(os.environ.get("MEMGRAPH_TPU_MXU_MIN_EDGES", 500_000))


def _check_precision(precision: str) -> str:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {_PRECISIONS}, got {precision!r}")
    return precision


def quantize_int8(x):
    """Symmetric per-vector int8 quantization: (q int8, scale f32) with
    x ≈ q * scale, |x - q·scale| ≤ max|x|/254 per element."""
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def edge_combine(sr, xe, w=None):
    """Per-edge ⊗ of the gathered entries with the edge values; an (e,) w
    broadcasts over the lanes of an (e, d) xe."""
    sr = resolve_semiring(sr)
    if sr.mul == "first":
        return xe
    if w is None:
        raise ValueError(f"⊗ = {sr.mul!r} needs edge values")
    if xe.dim() > 1 and w.dim() == 1:
        w = w.view((-1,) + (1,) * (xe.dim() - 1))
    if sr.mul == "times":
        return xe * w
    if sr.mul == "plus":
        return xe + w
    if sr.mul == "min":
        return torch.minimum(xe, w)
    return torch.logical_and(xe, w)


def _limits(dtype):
    return (torch.finfo(dtype) if dtype.is_floating_point
            else torch.iinfo(dtype))


def _empty_value(kind: str, dtype):
    """What jax.ops.segment_min / segment_max give an empty segment."""
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = _limits(dtype)
    return info.max if kind == "min" else info.min


def _float_sum(vals, ids, num_segments: int, sorted: bool, ptr, longest):
    """A float32 segment sum through the deterministic run sum: runs from
    ``ptr`` (``longest`` its longest run, when known), else from the
    sorted ids (stably sorted first when they are not), so each segment
    adds in edge order from 0.0."""
    if vals.dtype != torch.float32:
        raise TypeError(f"float segment sums run in float32, not "
                        f"{vals.dtype}")
    if ptr is None:
        if not sorted:
            order = torch.sort(ids, stable=True).indices
            vals, ids = vals[order], ids[order]
        ptr, longest = SC.segment_runs(ids, num_segments), None
    return SC.csr_spmm_sum(vals, ptr, mul="first", longest=longest)


def edge_reduce(kind, vals, ids, num_segments: int, sorted: bool = False,
                *, ptr=None, longest=None):
    """⊕ segment reduction of per-edge ``vals`` ((e,) or (e, d)) by their
    segment ``ids``.  ``sorted``: the ids are non-decreasing.  ``ptr``
    (port only): the sum's run offsets when a graph has them at hand
    (``csc_runs()`` for CSC keys, ``row_ptr`` for CSR keys), and
    ``longest`` their longest run (the graph's ``longest_csc_run`` /
    ``longest_csr_run``), which shapes the sum's launch.  Empty segments
    get 0 (sum), the dtype's extreme (+inf / -inf for floats, the integer
    limits otherwise) for min / max, and False for or."""
    shape = (num_segments,) + tuple(vals.shape[1:])
    if kind == "sum":
        if vals.dtype.is_floating_point:
            return _float_sum(vals, ids, num_segments, sorted, ptr,
                              longest)
        # integer sums are exact in any order
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, ids, vals)
    if kind == "or":
        got = torch.zeros(shape, dtype=torch.int32, device=vals.device)
        return _scatter(got, "max", vals.to(torch.int32), ids) > 0
    if kind not in ("min", "max"):
        raise ValueError(f"unknown ⊕ {kind!r}")
    out = torch.full(shape, _empty_value(kind, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    return _scatter(out, kind, vals, ids)


def _scatter(out, kind, vals, ids):
    """min / max by scatter_reduce_: exact, so the order does not matter."""
    idx = ids.long()
    if vals.dim() > 1:
        idx = idx.view((-1,) + (1,) * (vals.dim() - 1)).expand(vals.shape)
    return out.scatter_reduce_(0, idx, vals, reduce="a" + kind,
                               include_self=True)


def reduce_identity(sr, dtype, device=None):
    """The ⊕ identity (what masked-out edges contribute), as a 0-d tensor:
    0, False, or the dtype's largest (min) or smallest (max) value."""
    sr = resolve_semiring(sr)
    if sr.add == "sum":
        return torch.zeros((), dtype=dtype, device=device)
    if sr.add == "or":
        return torch.zeros((), dtype=torch.bool, device=device)
    info = _limits(dtype)
    return torch.tensor(info.max if sr.add == "min" else info.min,
                        dtype=dtype, device=device)


def combine_accumulators(sr, a, b):
    """⊕-combine two partial accumulators (e.g. fwd + bwd direction)."""
    sr = resolve_semiring(sr)
    if sr.add == "sum":
        return a + b
    if sr.add == "min":
        return torch.minimum(a, b)
    if sr.add == "max":
        return torch.maximum(a, b)
    return torch.logical_or(a, b)


def spmv(sr, x, src, dst, w=None, *, n_out: int, sorted: bool = False,
         mask=None, mask_fill=None, precision: str = "f32", frontier=None,
         ptr=None, longest=None):
    """One semiring matvec ``y = A^T ⊕.⊗ x`` over COO edge arrays.

      sr         semiring name or Semiring
      x          (n,) or (n, d) vector/matrix (SpMM: d lanes)
      src, dst   (e,) gather / reduce-key edge endpoints
      w          (e,) edge values (required unless ⊗ = first)
      sorted     dst is non-decreasing (CSC keys)
      mask       (e,) bool — edges where False contribute the ⊕ identity
                 (or ``mask_fill`` when given)
      precision  f32 | bf16 (contributions rounded to bfloat16, f32
                 accumulation) | int8 (x quantized per vector and
                 dequantized per node before the gather: the value the
                 reference dequantizes per edge)
      frontier   (n,) bool — push-mode source masking: only edges whose
                 src is in the frontier contribute
      ptr        (port only) the run offsets of dst for a sum, and
      longest    its longest run (``edge_reduce``)

    An unmasked float32 plus-times or plus-first sum over sorted keys (or
    given runs) is one launch of the run sum with the gather fused in;
    every other form combines per edge first.
    """
    sr = resolve_semiring(sr)
    _check_precision(precision)
    if precision == "int8":
        q, scale = quantize_int8(x)
        x = q.to(x.dtype) * scale
    sel = mask
    if frontier is not None:
        fsel = frontier[src]
        sel = fsel if sel is None else (sel & fsel)
    if (sr.add == "sum" and sr.mul in ("times", "first") and sel is None
            and x.dtype == torch.float32 and (sorted or ptr is not None)
            and (w is None or w.dtype == torch.float32)):
        if ptr is None:
            ptr, longest = SC.segment_runs(dst, n_out), None
        return SC.csr_spmm_sum(
            x, ptr, src, w if sr.mul == "times" else None, mul=sr.mul,
            precision="bf16" if precision == "bf16" else "f32",
            longest=longest)
    vals = edge_combine(sr, x[src], w)
    if precision == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    if sel is not None:
        fill = (reduce_identity(sr, vals.dtype, vals.device)
                if mask_fill is None else torch.as_tensor(
                    mask_fill, dtype=vals.dtype, device=vals.device))
        if vals.dim() > 1:
            sel = sel.view((-1,) + (1,) * (vals.dim() - 1))
        vals = torch.where(sel, vals, fill)
    return edge_reduce(sr.add, vals, dst, n_out, sorted=sorted, ptr=ptr,
                       longest=longest)


# ---------------------------------------------------------------------------
# direction-optimizing push/pull
# ---------------------------------------------------------------------------

#: Beamer's alpha: pull once the frontier's out-edge mass exceeds
#: n_edges / alpha (the classic DO-BFS threshold; env-overridable)
DIRECTION_ALPHA = float(os.environ.get("MEMGRAPH_TPU_DO_ALPHA", 14.0))


def select_pull(frontier, out_degree, n_edges, alpha: float | None = None):
    """Push/pull decision from frontier density, as a 0-d bool tensor:
    True → pull (reduce over every edge), False → push (frontier-masked
    contributions).  The frontier's out-edge mass is compared with
    n_edges / alpha in float32, as the reference compares them."""
    a = DIRECTION_ALPHA if alpha is None else alpha
    zero = torch.zeros((), dtype=out_degree.dtype, device=out_degree.device)
    m_f = torch.sum(torch.where(frontier, out_degree, zero))
    return m_f > float(np.float32(n_edges) / np.float32(a))


# ---------------------------------------------------------------------------
# the fused fixpoint loop (segment backend)
# ---------------------------------------------------------------------------


def _default_step(sr, A, env, x, P, *, n_out, sorted, sorted_backward,
                  direction, precision):
    w = env.get("w", A.get("w"))
    acc = spmv(sr, x, A["src"], A["dst"], w, n_out=n_out, sorted=sorted,
               precision=precision, ptr=A.get("dst_ptr"),
               longest=A.get("dst_longest"))
    if direction == "both":
        acc_b = spmv(sr, x, A["dst"], A["src"], w, n_out=n_out,
                     sorted=sorted_backward, precision=precision,
                     ptr=A.get("src_ptr"), longest=A.get("src_longest"))
        acc = combine_accumulators(sr, acc, acc_b)
    return acc


def fixpoint(sr, *, arrays, params=None, x0=None, n_out: int, epilogue,
             setup=None, step=None, max_iterations: int, metric="err",
             precision: str = "f32", sorted: bool = False,
             sorted_backward: bool = False, direction: str = "fwd"):
    """Run a fused semiring fixpoint on the segment backend.

    ``arrays``/``params`` are dicts of edge tensors / scalars;
    ``setup(A, P, n_out) -> env`` precomputes loop invariants (and may
    give ``env["x0"]`` when ``x0`` is None); ``step(x, A, env, P, n_out)
    -> acc`` overrides the default matvec (multi-matvec bodies such as
    HITS's); ``epilogue(x, acc, env, P) -> (new_x, metric)`` is the fused
    update + convergence partial.  ``metric="err"`` iterates while
    ``metric > P["tol"]`` (starting from +inf); ``metric="changed"`` while
    the bool metric holds (starting from True); either stops after
    ``max_iterations``.  The host reads the metric once an iteration.
    ``direction="both"`` ⊕-combines the matvec over the reversed edges
    (``sorted_backward``: src is non-decreasing).  A ⊕ = sum default step
    walks the runs the arrays carry (``dst_ptr``, ``src_ptr``: a graph's
    ``csc_runs()`` or ``row_ptr``, with their longest runs ``dst_longest``
    and ``src_longest``), else finds them in the sorted keys each
    iteration.

    Returns (x, metric as a float or bool, iterations).
    """
    sr = resolve_semiring(sr)
    _check_precision(precision)
    if metric not in ("err", "changed"):
        raise ValueError(f"metric must be 'err' or 'changed', not {metric!r}")
    if direction not in ("fwd", "both"):
        raise ValueError(f"direction must be 'fwd' or 'both', not "
                         f"{direction!r}")
    params = params or {}
    A = arrays
    env = dict(setup(A, params, n_out)) if setup is not None else {}
    x = env.pop("x0") if x0 is None else x0
    if metric == "err":
        tol = float(params["tol"])
        m, go = float("inf"), (lambda m: m > tol)
    else:
        m, go = True, bool
    it = 0
    while go(m) and it < max_iterations:
        if step is not None:
            acc = step(x, A, env, params, n_out)
        else:
            acc = _default_step(
                sr, A, env, x, params, n_out=n_out, sorted=sorted,
                sorted_backward=sorted_backward, direction=direction,
                precision=precision)
        x, m_t = epilogue(x, acc, env, params)
        m = float(m_t) if metric == "err" else bool(m_t)
        it += 1
    return x, m, it


def mxu_fixpoint(graph, *, epilogue, params, max_iterations, tol,
                 normalize: bool = True, precision: str = "f32",
                 cache_tag: str = "generic", x0_default: str = "zeros",
                 x0=None, device=None):
    """Run a ⊕ = sum fixpoint on the gather-free MXU backend.

    The plan (``normalize=True``: w / out-weight-sum multipliers, the
    matrix PageRank iterates; ``False``: plain w, katz's Aᵀ) and the
    placed kernel are cached per graph snapshot and per (cache_tag,
    normalize, precision, epilogue, x0_default, device), under the
    graph's own lock (``pagerank.semiring_run``): on a graph whose
    PageRank plan exists, or that has no other, the run shares that
    plan's placed routes.  ``epilogue(x, acc, env, P) -> (new_x, err)``
    is the fused update on the out-labeled accumulator; ``params`` are
    its scalars.  int8 is refused: the route moves f32 or bf16.

    ``x0`` — optional (n_nodes,) warm start in ORIGINAL node ids, mapped
    into the plan's OUT labeling as it is; None starts from
    ``x0_default`` ("zeros" or "uniform") on the device.

    Returns (x in original ids as a tensor on the device, err, iters).
    """
    from . import pagerank as PR
    _check_precision(precision)
    if precision == "int8":
        raise ValueError("the MXU backend routes f32/bf16 only; int8 "
                         "streaming rides the segment backend")
    dev = PR.graph_device(graph, device)
    run = PR.semiring_run(graph, dev, epilogue=epilogue, normalize=normalize,
                          precision=precision, cache_tag=cache_tag,
                          x0_default=x0_default)
    x0_flat = None
    if x0 is not None:
        plan = run.plan
        x0_flat = np.zeros(len(plan.valid_out), dtype=np.float32)
        x0_flat[plan.out_relabel] = \
            np.asarray(x0, dtype=np.float32)[:graph.n_nodes]
    x, err, iters = run(x0_flat, params, int(max_iterations),
                        np.float32(tol))
    return x[run.out_relabel], float(err), int(iters)


def pagerank_update(acc, dangling_mass, valid, n_f, damping):
    """THE PageRank damping update — shared by the segment and MXU
    backends."""
    return valid * ((1.0 - damping) / n_f
                    + damping * (acc + dangling_mass / n_f))


def route_backend(graph, device: torch.device, mesh=None, *,
                  semiring="plus_times", precision: str = "f32",
                  min_edges: int | None = None):
    """Which backend a semiring fixpoint on ``device`` runs on:
    ("mesh", MeshContext) | ("mxu", None) | ("segment", None).

    A mesh (``mesh=``: a MeshContext, a shard count on ``device``'s type
    or a tuple of devices; None: MEMGRAPH_TPU_MESH_DEVICES, unset for no
    mesh; parallel/mesh.py ``resolve_mesh``) takes every algorithm.  The
    MXU plan's reduce/extract phase is a one-hot matmul — a SUM — so only
    ⊕ = sum semirings ride it, and its route moves f32/bf16, so int8
    stays on the segment backend.  On the CPU the segment backend serves
    unless MEMGRAPH_TPU_FORCE_MXU is set (the JAX package asks its
    default backend the same question)."""
    from ..parallel.mesh import resolve_mesh
    _check_precision(precision)
    ctx = resolve_mesh(mesh, device)
    if ctx is not None:
        return "mesh", ctx
    sr = resolve_semiring(semiring)
    if min_edges is None:
        min_edges = MXU_MIN_EDGES
    if (sr.add == "sum" and precision != "int8"
            and graph.n_edges >= min_edges
            and (device.type != "cpu"
                 or os.environ.get("MEMGRAPH_TPU_FORCE_MXU"))):
        return "mxu", None
    return "segment", None
