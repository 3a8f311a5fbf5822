"""Sharded whole-graph kernels over a mesh of torch devices.

Port of the mesh half of memgraph_tpu/parallel/distributed.py (the
streamed half is parallel/streamed.py).  One process drives every shard
(parallel/mesh.py): a shard's step runs on its own device, a collective
combines the shards' payloads in a fixed shard order, and the host reads
one scalar an iteration to decide whether to go on.

Every float sum is deterministic, as on one card: a shard's contributions
are K1 (ops/segment_cuda.py ``csr_spmm_sum``) over its row's dst runs, the
per-vertex weight sums K1 over a stable sort of the row's src, the
dangling mass and the L1 error K2 (``lane_sum``).  Min, max and integer
reductions use ``scatter_reduce_`` / ``index_add_`` (exact in any order).
So two runs give the same bits.

The edge-blocked family (``ShardedGraph``): each shard owns a contiguous
block of the CSC edge list, vertex vectors are replicated, and one
``psum`` / ``pmin`` a round combines the shards' full-size partials
(``pagerank_sharded``, ``sssp_sharded``, ``wcc_sharded``);
``pagerank_sharded_15d`` blocks the rank vector over src-owned edges and
takes the reference's three collectives an iteration.

The partition-centric family (over a placed ``ops.csr.ShardedCSR``), one
collective an iteration each:

  pagerank   rank blocked over vertex blocks; a shard's contributions
             land in the (dst block, local dst) layout and ONE
             ``psum_scatter`` both scatters them to their owners and
             carries the dangling mass and the trailing L1 error in two
             extra lanes (``_PC_EXTRA``)
  katz       x replicated, one ``psum`` of the partial Aᵀx
  labelprop  dst-owned edges, labels replicated: each shard elects its
             own block (ops/labelprop.py's election) and one
             ``all_gather`` concatenates the disjoint blocks (the
             reference's psum of zero-filled blocks)
  wcc        comp replicated, one ``pmin`` a round, then pointer jumping
  semiring   a (semiring, x0, epilogue) triple: one ⊕-matched collective

The convergence check that needs a global reduction trails by one
iteration (its partial rides the next iteration's collective), so a tol
run does at most one extra iteration.

Resumability: every partition-centric kernel runs in chunks through
parallel/checkpoint.py ``run_resumable`` (``checkpoint_every``, ``job``,
``store``); a device fault resumes bit-exact from the last checkpoint, a
``device_lost`` re-places the rows first (``ShardedCSR.refresh``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import segment_cuda as SC
from ..ops import semiring as S
from ..ops.csr import ShardedCSR
from .checkpoint import run_resumable
from .mesh import (MeshContext, all_gather, pmax, pmin, psum, psum_scatter,
                   replicated, resolve_mesh)
from .streamed import _warm_vertex_vector as _padded_seed

_INF = float(np.float32(3.4e38))


def _round(precision: str) -> str:
    """The contribution rounding of a mesh kernel: f32 or bf16 (int8
    streaming is a segment-backend feature; the collectives stay f32)."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"mesh kernels route f32/bf16 only, got "
                         f"{precision!r}")
    return precision


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=dev)


def _valid(lo: int, n: int, n_nodes: int, dev) -> torch.Tensor:
    return ((torch.arange(lo, lo + n, device=dev) < n_nodes)
            .to(torch.float32))


def _src_sums(w, local, n_seg: int, longest):
    """Σ w over each local src (K1 over a stable sort of local)."""
    order = torch.sort(local, stable=True).indices
    ptr = SC.segment_runs(local[order], n_seg)
    return SC.csr_spmm_sum(w, ptr, order, mul="first", longest=longest)


def _inv(wsum):
    return torch.where(wsum > 0, 1.0 / torch.clamp(wsum, min=1e-30),
                       torch.zeros_like(wsum))


# ==========================================================================
# edge-blocked family
# ==========================================================================


@dataclass(frozen=True)
class ShardedGraph:
    """Edge-sharded COO graph on a mesh: one contiguous edge block a shard
    (dst sorted within it), vertex state replicated.  ``runs`` holds each
    block's dst runs over its real edges (``dst_ptr``, ``dst_longest``,
    ``rc``)."""
    src: tuple
    dst: tuple
    weights: tuple
    n_nodes: int
    n_edges: int     # true edges; padding edges are inert
    n_pad: int
    e_pad: int
    ctx: MeshContext
    runs: tuple = field(default=None, repr=False)


def _place_graph(ctx, src, dst, w, graph, e_pad) -> ShardedGraph:
    sink = graph.n_nodes
    bounds = np.arange(graph.n_pad + 1, dtype=np.int64)
    runs, ptrs = [], []
    for p in range(ctx.n_shards):
        rc = int(np.searchsorted(dst[p], sink, side="left"))
        ptr = np.searchsorted(dst[p][:rc], bounds).astype(np.int32)
        runs.append({"rc": rc,
                     "dst_longest": int(np.diff(ptr).max(initial=0))})
        ptrs.append(ptr)
    on = ctx.put_edge_blocks(np.stack(ptrs))
    for p, r in enumerate(runs):
        r["dst_ptr"] = on[p]
    sg = ShardedGraph(
        src=ctx.put_edge_blocks(src), dst=ctx.put_edge_blocks(dst),
        weights=ctx.put_edge_blocks(w), n_nodes=graph.n_nodes,
        n_edges=graph.n_edges, n_pad=graph.n_pad, e_pad=e_pad, ctx=ctx,
        runs=tuple(runs))
    ctx.synchronize()
    return sg


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_graph(graph, mesh) -> ShardedGraph:
    """The graph's CSC edges in contiguous blocks, one a shard of
    ``mesh`` (a MeshContext, or what ``resolve_mesh`` takes), padded to a
    multiple of the shard count (padding edges: weight 0 into the sink
    row, inert)."""
    ctx = resolve_mesh(mesh)
    P = ctx.n_shards
    new_e = -(-graph.e_pad // P) * P
    sink = graph.n_nodes

    def pad_to(arr, fill):
        arr = _host(arr)
        if len(arr) < new_e:
            arr = np.concatenate(
                [arr, np.full(new_e - len(arr), fill, dtype=arr.dtype)])
        return arr.reshape(P, -1)

    return _place_graph(ctx, pad_to(graph.csc_src, sink),
                        pad_to(graph.csc_dst, sink),
                        pad_to(graph.csc_weights, 0.0), graph, new_e)


def shard_graph_by_src(graph, mesh) -> ShardedGraph:
    """Edges partitioned by SOURCE block (edge e goes to the shard owning
    floor(src / (n_pad / P))), dst order kept within a shard: the layout
    of ``pagerank_sharded_15d``, whose rank gathers are then local."""
    ctx = resolve_mesh(mesh)
    P = ctx.n_shards
    if graph.n_pad % P:
        raise ValueError("n_pad must divide the mesh size")
    block = graph.n_pad // P
    n = graph.n_edges
    src = _host(graph.csc_src)[:n]
    dst = _host(graph.csc_dst)[:n]
    w = _host(graph.csc_weights)[:n]
    owner = src // block
    order = np.argsort(owner, kind="stable")
    src, dst, w, owner = src[order], dst[order], w[order], owner[order]
    counts = np.bincount(owner, minlength=P)
    per = max(int(counts.max()) if len(counts) else 1, 1)
    sink = graph.n_nodes
    src_b = np.full((P, per), sink, dtype=np.int32)
    dst_b = np.full((P, per), sink, dtype=np.int32)
    w_b = np.zeros((P, per), dtype=np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(P):
        lo, hi = offsets[s], offsets[s + 1]
        src_b[s, :hi - lo] = src[lo:hi]
        dst_b[s, :hi - lo] = dst[lo:hi]
        w_b[s, :hi - lo] = w[lo:hi]
    return _place_graph(ctx, src_b, dst_b, w_b, graph, per * P)


def pagerank_sharded(sg: ShardedGraph, damping: float = 0.85,
                     max_iterations: int = 100, tol: float = 1e-6):
    """PageRank over edge blocks: the weight sums and each iteration's
    partial Aᵀx combined by one ``psum`` each.  Returns
    (ranks[:n] on the first shard's device, err, iters)."""
    ctx, P, n_pad = sg.ctx, sg.ctx.n_shards, sg.n_pad
    wsum = psum(ctx, [
        S.edge_reduce("sum", sg.weights[p], sg.src[p], n_pad)
        for p in range(P)])
    env = replicated(ctx, lambda ws: {
        "inv": _inv(ws), "valid": _valid(0, n_pad, sg.n_nodes, ws.device),
        "n_f": _f32(sg.n_nodes, ws.device), "d": _f32(damping, ws.device)},
        wsum)
    for e, ws in zip(env, wsum):
        e["dangling"] = e["valid"] * (ws <= 0)
    mult = [sg.weights[p] * env[p]["inv"][sg.src[p].long()]
            for p in range(P)]
    rank = replicated(ctx, lambda e: e["valid"] / e["n_f"], env)
    err, it = float("inf"), 0
    while err > tol and it < max_iterations:
        acc = psum(ctx, [
            SC.csr_spmm_sum(rank[p], sg.runs[p]["dst_ptr"], sg.src[p],
                            mult[p], longest=sg.runs[p]["dst_longest"])
            for p in range(P)])

        def update(r, a, e):
            dm = SC.lane_sum(r, m=e["dangling"])
            new = S.pagerank_update(a, dm, e["valid"], e["n_f"], e["d"])
            return new, SC.lane_sum(new, r)

        out = replicated(ctx, update, rank, acc, env)
        rank = [o[0] for o in out]
        err = float(out[0][1])
        it += 1
    return rank[0][:sg.n_nodes], err, it


def pagerank_sharded_15d(sg: ShardedGraph, damping: float = 0.85,
                         max_iterations: int = 100, tol: float = 1e-6):
    """1.5D PageRank over src-owned edge blocks (``shard_graph_by_src``):
    the rank vector blocked over the shards, partial destination sums
    scattered to their owners by a ``psum_scatter``, the dangling mass and
    the error by a ``psum`` each (the reference's three collectives).
    Returns (ranks[:n] on the first shard's device, err, iters)."""
    ctx, P, n_pad = sg.ctx, sg.ctx.n_shards, sg.n_pad
    block = n_pad // P
    sh = []
    for p, dev in enumerate(ctx.devices):
        base = p * block
        src = sg.src[p]
        mine = (src >= base) & (src < base + block)
        local = torch.clamp(src - base, 0, block - 1)
        w_eff = torch.where(mine, sg.weights[p],
                            torch.zeros_like(sg.weights[p]))
        wsum = _src_sums(w_eff, local, block, None)
        valid = _valid(base, block, sg.n_nodes, dev)
        inv = _inv(wsum)
        sh.append({"local": local, "mult": w_eff * inv[local.long()],
                   "valid": valid, "dangling": valid * (wsum <= 0),
                   "n_f": _f32(sg.n_nodes, dev), "d": _f32(damping, dev)})
    rank = [e["valid"] / e["n_f"] for e in sh]
    err, it = float("inf"), 0
    while err > tol and it < max_iterations:
        acc = psum_scatter(ctx, [
            SC.csr_spmm_sum(rank[p], sg.runs[p]["dst_ptr"], sh[p]["local"],
                            sh[p]["mult"], longest=sg.runs[p]["dst_longest"]
                            ).view(P, block) for p in range(P)])
        dm = psum(ctx, [SC.lane_sum(rank[p], m=sh[p]["dangling"])
                        for p in range(P)])
        new = [S.pagerank_update(acc[p], dm[p], sh[p]["valid"],
                                 sh[p]["n_f"], sh[p]["d"]) for p in range(P)]
        e_all = psum(ctx, [SC.lane_sum(new[p], rank[p]) for p in range(P)])
        rank, err = new, float(e_all[0])
        it += 1
    dev0 = ctx.devices[0]
    full = torch.cat([r.to(dev0) for r in rank])
    return full[:sg.n_nodes], err, it


def sssp_sharded(sg: ShardedGraph, source: int,
                 max_iterations: int = 10_000):
    """Bellman-Ford over edge blocks (weighted, directed): one ``pmin`` a
    round.  Returns (dist[:n] with inf for the unreachable, on the first
    shard's device, iters)."""
    ctx, P, n_pad = sg.ctx, sg.ctx.n_shards, sg.n_pad
    w = []
    for p in range(P):
        real = torch.arange(sg.weights[p].numel(),
                            device=sg.weights[p].device) < sg.runs[p]["rc"]
        w.append(torch.where(real, sg.weights[p],
                             torch.full_like(sg.weights[p], _INF)))

    def init(d):
        v = torch.full((n_pad,), _INF, dtype=torch.float32, device=d)
        v[source] = 0.0
        return v

    val = replicated(ctx, init, list(ctx.devices))
    changed, it = True, 0
    while changed and it < max_iterations:
        cand = pmin(ctx, [S.edge_reduce(
            "min", val[p][sg.src[p].long()] + w[p], sg.dst[p], n_pad)
            for p in range(P)])
        out = replicated(ctx, _relax, val, cand)
        val = [o[0] for o in out]
        changed = bool(out[0][1])
        it += 1
    d = val[0][:sg.n_nodes]
    return torch.where(d >= _INF / 2, torch.full_like(d, float("inf")),
                       d), it


def wcc_sharded(sg: ShardedGraph, max_iterations: int = 200):
    """Weakly connected components over edge blocks: integer min labels
    both ways, one ``pmin`` a round, pointer jumping.  Returns
    (comp[:n] on the first shard's device, iters)."""
    ctx, P, n_pad = sg.ctx, sg.ctx.n_shards, sg.n_pad
    comp = replicated(ctx, lambda d: torch.arange(
        n_pad, dtype=torch.int32, device=d), list(ctx.devices))
    changed, it = True, 0
    while changed and it < max_iterations:
        parts = []
        for p in range(P):
            src, dst = sg.src[p].long(), sg.dst[p].long()
            c = comp[p]
            cand = torch.full((n_pad,), n_pad, dtype=torch.int32,
                              device=c.device)
            cand.scatter_reduce_(0, dst, c[src], reduce="amin")
            cand.scatter_reduce_(0, src, c[dst], reduce="amin")
            parts.append(cand)
        cand = pmin(ctx, parts)

        def update(c, m):
            new = torch.minimum(c, m)
            new = new[new.long()]
            return new, torch.any(new < c)

        out = replicated(ctx, update, comp, cand)
        comp = [o[0] for o in out]
        changed = bool(out[0][1])
        it += 1
    return comp[0][:sg.n_nodes], it


# ==========================================================================
# partition-centric kernels over a placed ShardedCSR
# ==========================================================================

_PC_EXTRA = 2          # piggyback lanes: [dangling_mass, prev_local_err]


def _placed(scsr: ShardedCSR, ctx: MeshContext) -> ShardedCSR:
    if not scsr.placed:
        return scsr.to_device(ctx)
    if scsr.ctx_key != ctx.cache_key:
        raise ValueError("the ShardedCSR is placed on another mesh")
    return scsr


def _run_pc_resumable(*, algo, scsr, ctx, chunk_of, carry0, to_host,
                      iter_index, max_iterations, checkpoint_every=0,
                      job=None, store=None, retry=None,
                      chunk_deadline_s=None, report=None):
    """Wire a partition-centric chunk into the checkpoint layer.
    ``chunk_of(scsr)`` binds the (possibly re-placed) layout into a
    ``chunk(carry, it_stop)``; after a device_lost the rebuild hook
    re-places the rows and re-binds."""
    holder = {"scsr": scsr}

    def rebuild():
        holder["scsr"] = holder["scsr"].refresh(ctx)
        return chunk_of(holder["scsr"])

    return run_resumable(
        algo=algo, chunk=chunk_of(scsr), carry=carry0,
        carry_to_host=to_host, carry_from_host=lambda c: c,
        iter_of=lambda c: int(c[iter_index]),
        max_iterations=max_iterations, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry, rebuild=rebuild,
        chunk_deadline_s=chunk_deadline_s, report=report)


def _warm_vertex_vector(x0, scsr: ShardedCSR, dtype, pad_value=None):
    """A warm start padded to the layout's n_pad2 vertices (the streamed
    plane's rule: ``pad_value`` None fills padding rows with their own
    index); a fresh host array."""
    return _padded_seed(x0, scsr.n_pad2, scsr.n_nodes, dtype, pad_value)


def _host_vec(parts) -> np.ndarray:
    """A vertex vector as one host array: a host array as it is, a
    replicated list by its first shard's copy."""
    if isinstance(parts, np.ndarray):
        return parts
    return parts[0].cpu().numpy()


def _rep_on(ctx, x) -> list:
    """A vertex vector replicated over the shards (a host array is put;
    a replicated list is kept)."""
    if isinstance(x, np.ndarray):
        return list(ctx.put_replicated(x))
    return x


def _blocks_on(ctx, x, block: int) -> list:
    """A vertex vector blocked over the shards (block p on shard p)."""
    if isinstance(x, np.ndarray):
        return list(ctx.put_edge_blocks(x.reshape(ctx.n_shards, block)))
    return x


def _pagerank_env(s: ShardedCSR, ctx, damping):
    """Per shard: the valid and dangling masks of its block and the
    per-edge multipliers w / wsum[src] (the weight sums are local:
    edges are src-owned)."""
    env = []
    for p, dev in enumerate(ctx.devices):
        r = s.runs[p]
        local = r["local_src"]
        wsum = _src_sums(s.weights[p][:r["rc"]], local[:r["rc"]], s.block,
                         r["src_longest"])
        valid = _valid(p * s.block, s.block, s.n_nodes, dev)
        env.append({"valid": valid, "dangling": valid * (wsum <= 0),
                    "mult": s.weights[p] * _inv(wsum)[local.long()],
                    "n_f": _f32(s.n_nodes, dev), "d": _f32(damping, dev)})
    return env


def pagerank_partition_centric(scsr: ShardedCSR, ctx: MeshContext,
                               damping: float = 0.85,
                               max_iterations: int = 100,
                               tol: float = 1e-6, *,
                               precision: str = "f32", x0=None,
                               checkpoint_every: int = 0,
                               job: str | None = None, store=None,
                               retry=None, chunk_deadline_s=None,
                               report=None):
    """PageRank over a src-owned ShardedCSR: rank blocked over the
    shards, exactly one collective (a ``psum_scatter`` with two extra
    lanes) an iteration.  Returns (ranks[:n_nodes] on the first shard's
    device, err, iters).

    The convergence check trails by one iteration, so a tol run may do
    one extra iteration; fixed-iteration runs (tol=0) are unchanged.
    ``precision="bf16"`` rounds each per-edge contribution to bfloat16
    before the f32 accumulation; the payload stays f32; int8 is refused.
    ``x0`` (n_nodes,) warm-starts from a previous solution, renormalized
    to unit mass (PageRank is a contraction: the seed changes the
    iteration count, not the fixpoint).  ``checkpoint_every=k`` copies
    the carry to the host every k iterations and resumes from it after a
    device fault, bit-exact; ``job`` keys the checkpoint in ``store``."""
    if scsr.by != "src":
        raise ValueError("pagerank needs a src-owned ShardedCSR")
    rnd = _round(precision)
    scsr = _placed(scsr, ctx)
    P, block, n = ctx.n_shards, scsr.block, scsr.n_nodes
    uniform = (np.arange(scsr.n_pad2) < n).astype(np.float32) \
        / np.float32(n)
    if x0 is None:
        rank0 = uniform
    else:
        rank0 = _warm_vertex_vector(x0, scsr, np.float32, pad_value=0.0)
        total = float(rank0.sum())
        rank0 = uniform if not np.isfinite(total) or total <= 0.0 \
            else rank0 / np.float32(total)
    carry0 = (rank0, np.full(P, np.inf, dtype=np.float32),
              np.float32(np.inf), 0)

    def chunk_of(s):
        env = _pagerank_env(s, ctx, damping)

        def chunk(carry, it_stop):
            rank, local_err, g_err, it = carry
            rank = _blocks_on(ctx, rank, block)
            if isinstance(local_err, np.ndarray):
                local_err = [_f32(local_err[p], d)
                             for p, d in enumerate(ctx.devices)]
            g_err = float(g_err)
            while g_err > tol and it < it_stop:
                payloads = []
                for p in range(P):
                    r, e = s.runs[p], env[p]
                    acc = SC.csr_spmm_sum(
                        rank[p], r["dst_ptr"], r["local_src"], e["mult"],
                        precision=rnd, longest=r["dst_longest"])
                    dm = SC.lane_sum(rank[p], m=e["dangling"])
                    extras = torch.stack([dm, local_err[p]])
                    payloads.append(torch.cat(
                        [acc.view(P, block),
                         extras.expand(P, _PC_EXTRA)], dim=1))
                # THE collective: row q of the payload sum lands on shard q
                got = psum_scatter(ctx, payloads)
                new = []
                for p in range(P):
                    e = env[p]
                    new.append(S.pagerank_update(
                        got[p][:block], got[p][block], e["valid"], e["n_f"],
                        e["d"]))
                local_err = [SC.lane_sum(new[p], rank[p]) for p in range(P)]
                rank = new
                g_err = float(got[0][block + 1])
                it += 1
            return rank, local_err, g_err, it
        return chunk

    def to_host(c):
        rank, local_err, g_err, it = c
        if not isinstance(rank, np.ndarray):
            rank = torch.cat([r.cpu() for r in rank]).numpy()
        if not isinstance(local_err, np.ndarray):
            local_err = np.array([float(e) for e in local_err],
                                 dtype=np.float32)
        return rank, local_err, np.float32(g_err), int(it)

    rank, _, err, iters = _run_pc_resumable(
        algo="pagerank", scsr=scsr, ctx=ctx, chunk_of=chunk_of,
        carry0=carry0, to_host=to_host, iter_index=3,
        max_iterations=max_iterations, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    dev0 = ctx.devices[0]
    if isinstance(rank, np.ndarray):
        full = torch.from_numpy(rank).to(dev0)
    else:
        full = torch.cat([r.to(dev0) for r in rank])
    return full[:n], float(err), int(iters)


def _replicated_chunk(ctx, step, epilogue, metric_go, cast):
    """A chunk over a replicated state: each shard's partial by
    ``step(p, x_p) -> (collective, partial)``, the one collective, then
    ``epilogue(p, x, acc) -> (new_x, metric)`` once a distinct device and
    the host's read of the metric."""
    shards = list(range(ctx.n_shards))

    def chunk(carry, it_stop):
        x, m, it = carry
        x = _rep_on(ctx, x)
        m = cast(m)
        while metric_go(m) and it < it_stop:
            parts = [step(p, x[p]) for p in shards]
            acc = parts[0][0](ctx, [q[1] for q in parts])
            out = replicated(ctx, epilogue, shards, x, acc)
            x = [o[0] for o in out]
            m = cast(out[0][1])
            it += 1
        return x, m, it
    return chunk


def _rep_to_host(cast):
    def to_host(c):
        x, m, it = c
        return _host_vec(x), cast(m), int(it)
    return to_host


def _finish_rep(x, ctx, n: int) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x[:n]).to(ctx.devices[0])
    return x[0][:n]


def katz_partition_centric(scsr: ShardedCSR, ctx: MeshContext,
                           alpha: float = 0.2, beta: float = 1.0,
                           max_iterations: int = 100, tol: float = 1e-6,
                           normalized: bool = False, *,
                           precision: str = "f32", x0=None,
                           checkpoint_every: int = 0,
                           job: str | None = None, store=None,
                           retry=None, chunk_deadline_s=None,
                           report=None):
    """Katz centrality over the mesh: x replicated, one ``psum`` an
    iteration.  ``x0`` warm-starts from a previous (unnormalized)
    solution.  Returns (x[:n_nodes] on the first shard's device, err,
    iters); checkpoint/resume as in ``pagerank_partition_centric``."""
    rnd = _round(precision)
    scsr = _placed(scsr, ctx)
    start = (np.zeros(scsr.n_pad2, dtype=np.float32) if x0 is None
             else _warm_vertex_vector(x0, scsr, np.float32, pad_value=0.0))

    def chunk_of(s):
        env = replicated(ctx, lambda d: {
            "valid": _valid(0, s.n_pad2, s.n_nodes, d),
            "a": _f32(alpha, d), "b": _f32(beta, d)},
            list(ctx.devices))

        def step(p, x):
            r = s.runs[p]
            return psum, SC.csr_spmm_sum(
                x, r["dst_ptr"], s.src[p], s.weights[p], precision=rnd,
                longest=r["dst_longest"])

        def epilogue(p, x, acc):
            e = env[p]
            new = e["valid"] * (e["a"] * acc + e["b"])
            return new, torch.max(torch.abs(new - x))

        return _replicated_chunk(ctx, step, epilogue, lambda m: m > tol,
                                 float)

    x, err, iters = _run_pc_resumable(
        algo="katz", scsr=scsr, ctx=ctx, chunk_of=chunk_of,
        carry0=(start, float("inf"), 0), to_host=_rep_to_host(float),
        iter_index=2, max_iterations=max_iterations,
        checkpoint_every=checkpoint_every, job=job, store=store,
        retry=retry, chunk_deadline_s=chunk_deadline_s, report=report)
    x = _finish_rep(x, ctx, scsr.n_pad2)
    if normalized:
        x = x / torch.clamp(torch.sqrt(torch.sum(x * x)), min=1e-30)
    return x[:scsr.n_nodes], float(err), int(iters)


def labelprop_partition_centric(scsr: ShardedCSR, ctx: MeshContext,
                                max_iterations: int = 30,
                                self_weight: float = 0.0, *,
                                labels0=None, checkpoint_every: int = 0,
                                job: str | None = None, store=None,
                                retry=None, chunk_deadline_s=None,
                                report=None):
    """Synchronous label propagation over a dst-owned ShardedCSR (both
    directions already concatenated for the undirected view): labels
    replicated, each shard elects its own block by ops/labelprop.py's
    election (K1's no-gather form over its sorted runs), one
    ``all_gather`` a round.  ``labels0`` warm-starts from a previous
    labeling (adds-only deltas only).  Returns (labels[:n_nodes] as a host
    int32 array, iters)."""
    from ..ops.labelprop import _labelprop_step
    if scsr.by != "dst":
        raise ValueError("labelprop needs a dst-owned ShardedCSR")
    scsr = _placed(scsr, ctx)
    start = (np.arange(scsr.n_pad2, dtype=np.int32) if labels0 is None
             else _warm_vertex_vector(labels0, scsr, np.int32))
    block, n_pad2 = scsr.block, scsr.n_pad2

    def chunk_of(s):
        A = [{"src": s.src[p].long(), "dst": s.dst[p], "w": s.weights[p]}
             for p in range(ctx.n_shards)]
        prm = [{"self_weight": _f32(self_weight, d),
                "n_true": s.runs[p]["rc"]}
               for p, d in enumerate(ctx.devices)]

        def step(p, labels):
            own = _labelprop_step(labels, A[p], {}, prm[p], n_pad2)
            return all_gather, own[p * block:(p + 1) * block]

        def epilogue(p, labels, new):
            return new, torch.any(new != labels)

        return _replicated_chunk(ctx, step, epilogue, bool, bool)

    labels, _, iters = _run_pc_resumable(
        algo="labelprop", scsr=scsr, ctx=ctx, chunk_of=chunk_of,
        carry0=(start, True, 0), to_host=_rep_to_host(bool), iter_index=2,
        max_iterations=max_iterations, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    return _host_vec(labels)[:scsr.n_nodes].astype(np.int32), int(iters)


def wcc_partition_centric(scsr: ShardedCSR, ctx: MeshContext,
                          max_iterations: int = 200, *, comp0=None,
                          checkpoint_every: int = 0,
                          job: str | None = None, store=None,
                          retry=None, chunk_deadline_s=None,
                          report=None):
    """Weakly connected components over the mesh: comp replicated, one
    ``pmin`` a round, then pointer jumping.  A row's padding edges (the
    block base toward the sink row) are masked: unmasked, the sink would
    join the bases of every padded row into one component on the
    backward pass.  ``comp0`` warm-starts (adds-only deltas only).
    Returns (comp[:n_nodes] as a host int32 array, iters)."""
    scsr = _placed(scsr, ctx)
    start = (np.arange(scsr.n_pad2, dtype=np.int32) if comp0 is None
             else _warm_vertex_vector(comp0, scsr, np.int32))
    n_pad2 = scsr.n_pad2

    def chunk_of(s):
        real = [torch.arange(s.per, device=d) < s.runs[p]["rc"]
                for p, d in enumerate(ctx.devices)]
        src = [t.long() for t in s.src]
        dst = [t.long() for t in s.dst]

        def step(p, comp):
            cand = torch.full((n_pad2,), n_pad2, dtype=torch.int32,
                              device=comp.device)
            big = torch.full_like(s.src[p], n_pad2)
            cand.scatter_reduce_(0, dst[p], torch.where(
                real[p], comp[src[p]], big), reduce="amin")
            cand.scatter_reduce_(0, src[p], torch.where(
                real[p], comp[dst[p]], big), reduce="amin")
            return pmin, cand

        def epilogue(p, comp, cand):
            new = torch.minimum(comp, cand)
            new = new[new.long()]                 # pointer jump
            return new, torch.any(new != comp)

        return _replicated_chunk(ctx, step, epilogue, bool, bool)

    comp, _, iters = _run_pc_resumable(
        algo="wcc", scsr=scsr, ctx=ctx, chunk_of=chunk_of,
        carry0=(start, True, 0), to_host=_rep_to_host(bool), iter_index=2,
        max_iterations=max_iterations, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    return _host_vec(comp)[:scsr.n_nodes].astype(np.int32), int(iters)


# ==========================================================================
# the generic semiring kernel (ops/semiring.py's mesh backend)
# ==========================================================================

_PC_COLLECTIVE = {"sum": psum, "min": pmin, "max": pmax, "or": pmax}


def semiring_partition_centric(scsr: ShardedCSR, ctx: MeshContext,
                               semiring, x0, epilogue, params=None,
                               max_iterations: int = 100,
                               metric: str = "changed",
                               precision: str = "f32", *,
                               algo: str = "semiring",
                               checkpoint_every: int = 0,
                               job: str | None = None, store=None,
                               retry=None, chunk_deadline_s=None,
                               report=None):
    """A (semiring, x0, epilogue) fixpoint over the mesh: x replicated, a
    shard's ⊗-combine and ⊕-reduce over its row (a float sum by K1 over
    the row's dst runs), ONE ⊕-matched collective an iteration, then
    ``epilogue(x, acc, env, params) -> (new_x, metric)`` replicated.
    ``metric`` "changed" iterates while the bool holds, "err" while it
    exceeds ``params["tol"]``.  Returns (x[:n_nodes] on the first shard's
    device, metric, iters)."""
    sr = S.resolve_semiring(semiring)
    rnd = _round(precision)
    params = params or {}
    scsr = _placed(scsr, ctx)
    collective = _PC_COLLECTIVE[sr.add]
    x0 = np.asarray(x0)
    if metric == "changed":
        m0, cast, go = True, bool, bool
    else:
        tol = float(params["tol"])
        m0, cast, go = float("inf"), float, (lambda m: m > tol)

    def chunk_of(s):
        src = [t.long() for t in s.src]

        def step(p, x):
            r = s.runs[p]
            return collective, S.spmv(
                sr, x, src[p], s.dst[p],
                None if sr.mul == "first" else s.weights[p],
                n_out=s.n_pad2, sorted=True,
                precision=rnd if x.dtype.is_floating_point else "f32",
                ptr=r["dst_ptr"], longest=r["dst_longest"])

        def ep(p, x, acc):
            return epilogue(x, acc, {}, params)

        return _replicated_chunk(ctx, step, ep, go, cast)

    x, m, iters = _run_pc_resumable(
        algo=algo, scsr=scsr, ctx=ctx, chunk_of=chunk_of,
        carry0=(x0, m0, 0), to_host=_rep_to_host(cast), iter_index=2,
        max_iterations=max_iterations, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    return _finish_rep(x, ctx, scsr.n_nodes), m, int(iters)


def _relax(x, acc):
    new = torch.minimum(x, acc)
    return new, torch.any(new < x)


def _minplus_relax_epilogue(x, acc, env, P):
    """min-plus relaxation epilogue (BFS / SSSP over the mesh)."""
    return _relax(x, acc)
