"""Algorithm-level mesh entry points: a DeviceGraph in, results out.

Port of memgraph_tpu/parallel/analytics.py, the seam between ``ops/``
(single-card algorithms over DeviceGraph snapshots) and
parallel/distributed.py (partition-centric kernels over a placed
ShardedCSR).  Each ``*_mesh`` function

  1. blocks the snapshot's edges partition-centrically for the given
     MeshContext and places them (cached on the immutable snapshot, so
     repeated calls pay the blocking and the transfer once),
  2. runs the sharded kernel (one collective an iteration), and
  3. returns what the single-card entry point it mirrors returns.

A mesh of 1 runs the same code: its collectives return their one
payload.  ``ops/pagerank.py`` (and katz, labelprop, components) route
here whenever a mesh is asked for: an explicit ``mesh=`` argument or
MEMGRAPH_TPU_MESH_DEVICES (parallel/mesh.py).

Every iterative entry point takes ``checkpoint_every=k`` (with ``job``,
``store``, ``report``, ``retry``) through parallel/checkpoint.py
``run_resumable``: the carry is copied to the host every k iterations and
a device fault resumes from the last checkpoint, bit-exact.
MEMGRAPH_TPU_CHECKPOINT_EVERY sets the default k of callers that pass
none (0: one full-budget chunk).  The reference's ``device.transfer``
trace span around the blocking is left out (the port has no
``observability/trace.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..observability import stats as mgstats
from ..observability import trace as mgtrace
from ..ops.csr import DeviceGraph, shard_csr
from .mesh import MeshContext


def _shard_traced(graph: DeviceGraph, ctx: MeshContext, by: str = "src",
                  doubled: bool = False):
    """The snapshot's placed ShardedCSR on ``ctx`` (cached), under a
    ``device.transfer`` span; the same extent goes to the active stage
    accumulator's ``device_transfer``.  A cache hit shows as a near-zero
    extent; the uploads are asynchronous, so the extent is the host's."""
    t0 = time.perf_counter()
    with mgtrace.span("device.transfer") as sp:
        scsr = shard_csr(graph, ctx, by=by, doubled=doubled)
        if sp:
            sp.set(n_shards=ctx.n_shards, by=by,
                   n_nodes=int(graph.n_nodes))
    mgstats.record_stage("device_transfer", time.perf_counter() - t0)
    return scsr


def default_checkpoint_every() -> int:
    """Process-default checkpoint interval of the mesh analytics
    (MEMGRAPH_TPU_CHECKPOINT_EVERY; 0 runs one full-budget chunk)."""
    try:
        return max(0, int(os.environ.get(
            "MEMGRAPH_TPU_CHECKPOINT_EVERY", "0")))
    except ValueError:
        return 0


def _resume_kw(checkpoint_every, job, store, report, retry):
    if checkpoint_every is None:
        checkpoint_every = default_checkpoint_every()
    return {"checkpoint_every": checkpoint_every, "job": job,
            "store": store, "report": report, "retry": retry}


def pagerank_mesh(graph: DeviceGraph, ctx: MeshContext,
                  damping: float = 0.85, max_iterations: int = 100,
                  tol: float = 1e-6, *, precision: str = "f32", x0=None,
                  checkpoint_every: int | None = None,
                  job: str | None = None, store=None, report=None,
                  retry=None):
    """Sharded PageRank; ops.pagerank.pagerank's contract (ranks as a
    tensor on the mesh's first device)."""
    from .distributed import pagerank_partition_centric
    scsr = _shard_traced(graph, ctx, by="src")
    return pagerank_partition_centric(
        scsr, ctx, damping=damping, max_iterations=max_iterations,
        tol=tol, precision=precision, x0=x0,
        **_resume_kw(checkpoint_every, job, store, report, retry))


def katz_mesh(graph: DeviceGraph, ctx: MeshContext, alpha: float = 0.2,
              beta: float = 1.0, max_iterations: int = 100,
              tol: float = 1e-6, normalized: bool = False, *,
              precision: str = "f32", x0=None,
              checkpoint_every: int | None = None, job: str | None = None,
              store=None, report=None, retry=None):
    """Sharded Katz centrality; ops.katz.katz_centrality's contract."""
    from .distributed import katz_partition_centric
    scsr = _shard_traced(graph, ctx, by="src")
    return katz_partition_centric(
        scsr, ctx, alpha=alpha, beta=beta, max_iterations=max_iterations,
        tol=tol, normalized=normalized, precision=precision, x0=x0,
        **_resume_kw(checkpoint_every, job, store, report, retry))


def label_propagation_mesh(graph: DeviceGraph, ctx: MeshContext,
                           max_iterations: int = 30,
                           self_weight: float = 0.0,
                           directed: bool = False, *, labels0=None,
                           checkpoint_every: int | None = None,
                           job: str | None = None, store=None,
                           report=None, retry=None):
    """Sharded label propagation; ops.labelprop.label_propagation's
    contract.  ``labels0`` warm-starts (adds-only deltas only)."""
    from .distributed import labelprop_partition_centric
    scsr = _shard_traced(graph, ctx, by="dst", doubled=not directed)
    return labelprop_partition_centric(
        scsr, ctx, max_iterations=max_iterations, self_weight=self_weight,
        labels0=labels0,
        **_resume_kw(checkpoint_every, job, store, report, retry))


def components_mesh(graph: DeviceGraph, ctx: MeshContext,
                    max_iterations: int = 200, *, comp0=None,
                    checkpoint_every: int | None = None,
                    job: str | None = None, store=None, report=None,
                    retry=None):
    """Sharded WCC; ops.components.weakly_connected_components's
    contract.  ``comp0`` warm-starts (adds-only deltas only)."""
    from .distributed import wcc_partition_centric
    scsr = _shard_traced(graph, ctx, by="src")
    return wcc_partition_centric(
        scsr, ctx, max_iterations=max_iterations, comp0=comp0,
        **_resume_kw(checkpoint_every, job, store, report, retry))


def sssp_mesh(graph: DeviceGraph, ctx: MeshContext, source: int,
              max_iterations: int = 10_000):
    """Sharded Bellman-Ford (weighted, directed) over the edge-blocked
    layout; ops.traversal.sssp's weighted directed result as a host
    array, inf for the unreachable."""
    from .distributed import shard_graph, sssp_sharded
    sg = shard_graph(graph, ctx)
    dist, iters = sssp_sharded(sg, source, max_iterations=max_iterations)
    return dist.cpu().numpy(), iters


def bfs_mesh(graph: DeviceGraph, ctx: MeshContext, source: int,
             max_iterations: int = 10_000, *, precision: str = "f32",
             checkpoint_every: int | None = None, job: str | None = None,
             store=None, report=None, retry=None):
    """BFS levels over the mesh by the generic semiring kernel: min-plus
    over unit hop weights (the padding edges' weight inf keeps them
    inert), one ``pmin`` a level.  Returns (levels[:n_nodes] int32, -1
    for the unreachable, iterations): ops.traversal.bfs_levels' directed
    result."""
    return bfs_partition_centric(
        _shard_traced(graph, ctx, by="src"), ctx, source, max_iterations,
        precision=precision, checkpoint_every=checkpoint_every, job=job,
        store=store, report=report, retry=retry)


def bfs_partition_centric(scsr, ctx: MeshContext, source: int,
                          max_iterations: int = 10_000, *,
                          precision: str = "f32",
                          checkpoint_every: int | None = None,
                          job: str | None = None, store=None, report=None,
                          retry=None):
    """``bfs_mesh`` over a src-owned ShardedCSR placed on ``ctx`` (a
    resident generation's ``ensure_sharded`` variant, whose rows keep
    slack: the padding edges carry no hop)."""
    from .distributed import (_minplus_relax_epilogue,
                              semiring_partition_centric)
    inf = np.float32(3.4e38)
    # unit hop weights; the padding edges (dst = the sink row) stay inert.
    # The host layout carries them too, so that a re-placement after a
    # device loss places the hop weights
    unit_w = tuple(torch.where(d == scsr.n_nodes,
                               torch.full_like(w, float(inf)),
                               torch.ones_like(w))
                   for d, w in zip(scsr.dst, scsr.weights))
    host = scsr.host
    hop = dataclasses.replace(scsr, weights=unit_w, host=dataclasses.replace(
        host, weights=np.where(host.dst == scsr.n_nodes, inf,
                               np.float32(1.0)).astype(np.float32)))
    x0 = np.full(scsr.n_pad2, inf, dtype=np.float32)
    x0[source] = 0.0
    dist, _, iters = semiring_partition_centric(
        hop, ctx, "min_plus", x0, _minplus_relax_epilogue,
        max_iterations=max_iterations, metric="changed",
        precision=precision, algo="bfs",
        **_resume_kw(checkpoint_every, job, store, report, retry))
    dist = dist.cpu().numpy()
    reached = dist < inf / 2
    levels = np.full(len(dist), -1, dtype=np.int32)
    levels[reached] = dist[reached].astype(np.int32)
    return levels, iters
