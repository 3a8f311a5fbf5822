"""The plus-times semiring core that PageRank, katz and HITS ride, in
PyTorch.

Port of the plus-times part of memgraph_tpu/ops/semiring.py: PageRank's,
and katz's and HITS's (ops/katz.py).  Two backends sit behind
``route_backend``:

  * ``mxu``     — the gather-free plan of ops/spmv_mxu.py (expand matmul,
    Benes route on the CUDA kernels of ops/benes_cuda.py, one-hot extract
    matmul, node relabel).  Graphs of at least ``MXU_MIN_EDGES`` edges on
    the card take it.
  * ``segment`` — per-edge gather, ⊗-combine and segment-⊕ reduction
    (``index_add_``), with the fused epilogue in a host-driven loop
    (``fixpoint``; a ``step`` hook replaces the matvec).  The
    JAX package has no Pallas kernel on this path, so it stays plain
    torch; it answers graphs under the threshold.

Mixed precision (``precision=``): ``f32`` is the exact path; ``bf16``
rounds each per-edge contribution to bfloat16 before the f32
accumulation; ``int8`` (segment backend only) quantizes the streamed
vector symmetrically per iteration.  The documented error bounds live in
:data:`PRECISION_BOUNDS`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

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


def edge_combine(xe, w):
    """Per-edge ⊗ = times."""
    return xe * w


def edge_reduce(kind, vals, ids, num_segments: int):
    """⊕ = sum segment reduction."""
    if kind != "sum":
        raise ValueError(f"unsupported ⊕ {kind!r}")
    out = torch.zeros(num_segments, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids.long(), vals)


def spmv(x, src, dst, w, *, n_out: int, precision: str = "f32"):
    """One plus-times matvec ``y[j] = Σ_{(i,j)} x[i]·w``, COO edges."""
    _check_precision(precision)
    if precision == "int8":
        q, scale = quantize_int8(x)
        xe = q[src].to(x.dtype) * scale
    else:
        xe = x[src]
    vals = edge_combine(xe, w)
    if precision == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return edge_reduce("sum", vals, dst, n_out)


def _default_step(x, A, env, P, n_out, precision):
    """One plus-times matvec over the arrays' edges, with the setup's
    hoisted multipliers where it made them (``env["w"]``), else the
    edge weights."""
    w = env.get("w", A.get("w"))
    return spmv(x, A["src"], A["dst"], w, n_out=n_out, precision=precision)


def fixpoint(*, arrays, params, x0=None, n_out: int, epilogue, setup=None,
             step=None, max_iterations: int, precision: str = "f32"):
    """Run a fused plus-times fixpoint on the segment backend.

    ``setup(A, P, n_out) -> env`` precomputes loop invariants (and gives
    ``env["x0"]`` when ``x0`` is None); ``step(x, A, env, P, n_out) ->
    acc`` overrides the default matvec (multi-matvec bodies such as
    HITS's, over a tuple state); ``epilogue(x, acc, env, P) -> (new_x,
    err)`` is the fused update + convergence partial.  Iterates while
    ``err > P["tol"]`` and fewer than ``max_iterations`` ran, with ``err``
    starting at +inf — the JAX package's rule, read on the host once per
    iteration.  Returns (x, err, iterations).
    """
    _check_precision(precision)
    env = dict(setup(arrays, params, n_out)) if setup is not None else {}
    x = env.pop("x0") if x0 is None else x0
    tol = float(params["tol"])
    err, it = float("inf"), 0
    while err > tol and it < max_iterations:
        if step is not None:
            acc = step(x, arrays, env, params, n_out)
        else:
            acc = _default_step(x, arrays, env, params, n_out, precision)
        x, err_t = epilogue(x, acc, env, params)
        err = float(err_t)
        it += 1
    return x, err, it


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


def route_backend(graph, device: torch.device, *, precision: str = "f32",
                  min_edges: int | None = None):
    """"mxu" or "segment" for a plus-times fixpoint on ``device``.

    The MXU plan's reduce/extract phase is a one-hot matmul — a SUM — and
    its route moves f32/bf16, so int8 stays on the segment backend.  On
    the CPU the segment backend serves unless MEMGRAPH_TPU_FORCE_MXU is
    set (the JAX package asks its default backend the same question)."""
    _check_precision(precision)
    if min_edges is None:
        min_edges = MXU_MIN_EDGES
    if (precision != "int8" and graph.n_edges >= min_edges
            and (device.type != "cpu"
                 or os.environ.get("MEMGRAPH_TPU_FORCE_MXU"))):
        return "mxu"
    return "segment"
