"""Host results of the graph-algorithm procedures, from a storage
snapshot.

Port of the compute half of memgraph_tpu/procedures/graph_algorithms.py
(``pagerank.get``, ``pagerank.personalized``, ``katz_centrality.get``,
``community_detection.get``, ``weakly_connected_components.get``,
``strongly_connected_components.get``, ``degree_centrality.get``,
``hits.get``, ``bfs.get``, ``sssp.get``, ``graph_util.khop``) and of
memgraph_tpu/procedures/structure_modules.py's
``betweenness_centrality.get`` (the registration that serves).  Each
function takes a source (ops/csr.py), the procedure's arguments with its
defaults, the snapshot ``cache`` and the ``device``; it snapshots the
source's graph through the cache (``GraphCache.get``: delta export and
refresh lineage included) and returns what the procedure yields as host
arrays: ``node_gids`` (int64) and one numpy column per result field, a
row per yielded record.  An empty graph yields no row.  Vertices are
named by gid where the procedure takes nodes.

``pagerank.get``, ``katz_centrality.get``, ``community_detection.get``
and ``weakly_connected_components.get`` consult a warm pool
(``pool=``, ops/delta.py's ``GLOBAL_WARM_POOL`` by default) as the
reference's ``_warm_prepare`` does, with its parameter keys: a repeated
call on an unchanged graph returns the stored host array (the same
bytes, read-only), and a call after a commit seeds the fixpoint (``x0``,
``labels0``, ``comp0``) from the previous answer under the warm-start
contract (WCC and label propagation only over adds-only deltas, else a
counted cold start).  The reference demotes a hit to a warm seed under
PROFILE (its stage accounting); the port has no such accounting, so a
hit is always served as it is.

``pagerank.get`` and ``pagerank.personalized`` take the reference's
kernel-server route first (``_kernel_server_pagerank``,
``_kernel_server_ppr``) when ``kernel=`` names a daemon (a socket path,
True / "1" / "default" for the port's default socket, or a client), or
else ``MEMGRAPH_TPU_ANALYTICS_KERNEL_SERVER`` does (the port has no
interpreter config to read it from).  The graph key is stable per
storage (and weight property); the first call ships the edges, later
ones at a newer version ship the change log's delta payload (the
changed dense ids and those vertices' current incident edges, from the
snapshot), so the daemon moves its resident generation O(delta) and
warm-starts; an unknowable log re-ships the edges.  A failure of the
plane falls back to the in-process path, logged and counted
(``analytics.kernel_route_fallback_total``; ``kernel_routed_total``
counts the routed calls).

The Cypher surface (the end of this module) registers each function
under the reference's procedure names, aliases, arguments, defaults and
result fields (memgraph_tpu/procedures/graph_algorithms.py's
``mgp.read_proc`` blocks, and structure_modules.py's
``betweenness_centrality.get``, the registration that serves there).
Each is a thin wrapper: it calls the function on a ``StorageSource`` of
the call's accessor on the interpreter's device, and turns the gid
column into the storage's vertices at the call's view (a vertex gone
from the view yields no record, as the reference's ``vertex_by_index``
does).  The kernel-server route reads the interpreter's
``kernel_server_socket`` setting, then the environment, as the
reference does.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np
import torch

from ..ops.betweenness import betweenness_centrality
from ..ops.components import (strongly_connected_components,
                              weakly_connected_components)
from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.delta import (GLOBAL_WARM_POOL, incident_edges,
                         record_warm_start)
from ..ops.katz import degree_centrality, hits, katz_centrality
from ..ops.labelprop import label_propagation
from ..ops.pagerank import pagerank, personalized_pagerank
from ..observability import stats as mgstats
from ..ops.traversal import bfs_levels, khop_neighborhood, sssp
from ..utils.metrics import global_metrics

log = logging.getLogger(__name__)

#: per (socket, graph_key): the (version, node_gids) this process last
#: pushed to the daemon, so the next request ships the delta of the gap
_PUSHED: dict = {}
_PUSHED_LOCK = threading.Lock()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(graph, select=None, **columns) -> dict:
    """The records: ``node_gids`` and each column, every node's or the
    selected ones'."""
    out = {"node_gids": np.asarray(graph.node_gids, dtype=np.int64)}
    out.update({k: _host(v) for k, v in columns.items()})
    if select is not None:
        out = {k: v[select] for k, v in out.items()}
    return out


def _none(*fields) -> dict:
    """No record."""
    return {"node_gids": np.zeros(0, dtype=np.int64),
            **{f: np.zeros(0) for f in fields}}


def _indices(graph, gids) -> list:
    """The dense indices of the gids the snapshot holds."""
    return [graph.gid_to_idx[g] for g in gids
            if g is not None and g in graph.gid_to_idx]


def _warm(pool, source, graph, algo: str, params_key: tuple, compute):
    """The answer of ``algo`` on ``graph`` through the warm pool: the
    stored host array on a hit (read-only), else ``compute(seed)`` (seed
    None: cold) as a host array, of which the pool stores a copy for the
    next call.  ``compute`` returns (answer, iterations).  Under an
    active stage accumulator (a profiled call, observability/stats.py)
    a hit is demoted to a warm seed, as the reference does: the call
    exists to measure the device path; the re-iterated answer is not
    stored, so unprofiled repeats keep returning the stored bytes."""
    version = source.version
    cached, seed = pool.prepare(source, graph, version, algo, params_key)
    if cached is not None and mgstats.stages_active():
        return _host(compute(np.asarray(cached))[0])
    if cached is not None:
        return cached
    x, iters = compute(seed)
    x = _host(x)
    pool.store(source, graph, version, algo, params_key, x, iters)
    if seed is not None:
        record_warm_start(algo, iters)
    return x


# --- the kernel-server route -------------------------------------------------


def _kernel_route(kernel):
    """(socket, client) a call routes through, or None for the in-process
    path: ``kernel`` (a socket path; True, "1" or "default" the port's
    default socket; or a client with a ``socket_path``), else
    ``MEMGRAPH_TPU_ANALYTICS_KERNEL_SERVER``."""
    if kernel is None:
        kernel = os.environ.get("MEMGRAPH_TPU_ANALYTICS_KERNEL_SERVER")
    if not kernel:
        return None
    from ..server.kernel_server import route_client
    return route_client(kernel)


def _graph_key(source, kind: str, weight_property=None) -> str:
    """The daemon's key of a storage's graph: ``kind`` "analytics" or
    "ppr", as the reference names them, and the weight property (a
    weighted graph is another generation)."""
    key = f"{kind}:{hex(id(source.storage))}"
    return key if weight_property is None else f"{key}:{weight_property}"


def _graph_coo(graph):
    """Host COO arrays of the snapshot's true edges."""
    src, dst, w = graph.host_coo if graph.host_coo is not None \
        else graph.host_edges()
    return (np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64),
            np.asarray(w, dtype=np.float32))


def _serving_delta_meta(source, graph, sock: str, graph_key: str) -> dict:
    """The request's serving fields: the key, the source's version and,
    when this process pushed an earlier version of the key, the change
    log's delta payload covering the gap (dense changed ids and those
    vertices' current incident edges, from the snapshot).  ``send_graph``
    says whether the edges must ride along: never pushed, the dense ids
    moved, or the log cannot say what changed."""
    version = source.version
    meta = {"graph_key": graph_key, "graph_version": version,
            "base_version": None, "ids_stable": True, "send_graph": True}
    with _PUSHED_LOCK:
        prev = _PUSHED.get((sock, graph_key))
    if prev is None:
        return meta
    prev_version, prev_gids = prev
    ids_stable = prev_gids is graph.node_gids or \
        np.array_equal(prev_gids, graph.node_gids)
    meta["ids_stable"] = ids_stable
    if not ids_stable:
        return meta
    if prev_version == version:
        meta.update(send_graph=False, base_version=version)
        return meta
    if prev_version < version and graph.host_coo is not None:
        gids = source.changes_between(prev_version, version)
        # an unknowable gap re-ships the edges: a partial delta would
        # corrupt the resident generation
        if isinstance(gids, frozenset):
            changed = [graph.gid_to_idx[g] for g in gids
                       if g in graph.gid_to_idx]
            bitmap = np.zeros(graph.n_nodes, dtype=bool)
            bitmap[np.asarray(changed, dtype=np.int64)] = True
            inc_src, inc_dst, inc_w = incident_edges(*graph.host_coo, bitmap)
            meta.update(base_version=prev_version, changed=changed,
                        inc_src=inc_src, inc_dst=inc_dst, inc_w=inc_w,
                        send_graph=False)
    return meta


def _routed(route, graph, graph_key, meta, call, what: str):
    """``call(client, **meta, **edges)`` on the daemon, the push noted
    and counted; None after a failure of the plane (the push forgotten,
    so the next call re-ships the edges; logged and counted)."""
    from ..server.kernel_server import KernelServerError
    sock, client = route
    kwargs = {}
    if meta.pop("send_graph"):
        src, dst, w = _graph_coo(graph)
        kwargs.update(src=src, dst=dst, weights=w)
    try:
        out = call(client, **meta, **kwargs)
    except (KernelServerError, ConnectionError, OSError) as e:
        with _PUSHED_LOCK:
            _PUSHED.pop((sock, graph_key), None)
        global_metrics.increment("analytics.kernel_route_fallback_total")
        log.warning("kernel-server %s route failed (%s: %s); falling back "
                    "to the in-process path", what, type(e).__name__, e)
        return None
    with _PUSHED_LOCK:
        _PUSHED[(sock, graph_key)] = (meta["graph_version"], graph.node_gids)
    global_metrics.increment("analytics.kernel_routed_total")
    return out


def _kernel_server_pagerank(source, graph, damping, max_iterations, tol,
                            kernel=None, weight_property=None):
    """PageRank on the daemon (host ranks), or None: no route, or the
    plane failed (the caller runs in process)."""
    route = _kernel_route(kernel)
    if route is None:
        return None
    key = _graph_key(source, "analytics", weight_property)
    meta = _serving_delta_meta(source, graph, route[0], key)
    out = _routed(route, graph, key, meta, lambda c, **kw: c.pagerank(
        n_nodes=graph.n_nodes, damping=float(damping),
        max_iterations=int(max_iterations), tol=float(tol), **kw),
        "pagerank")
    return None if out is None else np.asarray(out[0])[:graph.n_nodes]


def _kernel_server_ppr(source, graph, sources, damping, max_iterations,
                       tol, kernel=None, top_k=0):
    """One PPR through the daemon's coalescing plane: its (reply header,
    arrays), the arrays ``ranks`` (top_k 0) or ``topk_val`` /
    ``topk_idx``; or None: no route, or the plane failed."""
    route = _kernel_route(kernel)
    if route is None:
        return None
    key = _graph_key(source, "ppr")
    meta = _serving_delta_meta(source, graph, route[0], key)
    return _routed(route, graph, key, meta, lambda c, **kw: c.ppr(
        sources=np.asarray(sources, dtype=np.int32), n_nodes=graph.n_nodes,
        damping=float(damping), max_iterations=int(max_iterations),
        tol=float(tol), top_k=int(top_k), **kw), "PPR")


def pagerank_get(source, max_iterations=100, damping_factor=0.85,
                 stop_epsilon=1e-5, weight_property=None, *,
                 cache=GLOBAL_GRAPH_CACHE, pool=GLOBAL_WARM_POOL,
                 device=None, kernel=None) -> dict:
    """``pagerank.get``: node, rank; the kernel-server route first, then
    the warm pool."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    if graph.n_nodes == 0:
        return _none("rank")
    ranks = _kernel_server_pagerank(source, graph, damping_factor,
                                    max_iterations, stop_epsilon, kernel,
                                    weight_property)
    if ranks is not None:
        return _rows(graph, rank=ranks)

    def compute(x0):
        ranks, _, iters = pagerank(graph, damping=float(damping_factor),
                                   max_iterations=int(max_iterations),
                                   tol=float(stop_epsilon), x0=x0)
        return ranks, iters

    ranks = _warm(pool, source, graph, "pagerank",
                  ("pagerank", float(damping_factor), float(stop_epsilon),
                   int(max_iterations), weight_property), compute)
    return _rows(graph, rank=ranks)


def pagerank_personalized(source, source_nodes, max_iterations=100,
                          damping_factor=0.85, *, cache=GLOBAL_GRAPH_CACHE,
                          device=None, kernel=None) -> dict:
    """``pagerank.personalized``: node, rank, restarting on the vertices
    with gids ``source_nodes`` (those outside the snapshot are dropped;
    none left: no record); the kernel server's coalescing plane first.
    Routed, the answer may be the plane's cache hit of an earlier version
    when the commits since touched nothing within one hop of the sources
    and moved the vector by at most 1e-4 of its largest entry
    (``kernel_server.PPR_HIT_BOUND``; ``chip_smoke.py``'s
    ``kernel_server`` phase holds such hits to a float64 PPR)."""
    graph = cache.get(source, device=device)
    sources = _indices(graph, source_nodes) if graph.n_nodes else []
    if not sources:
        return _none("rank")
    served = _kernel_server_ppr(source, graph, sources,
                                float(damping_factor), int(max_iterations),
                                1e-6, kernel)
    if served is not None:
        return _rows(graph, rank=np.asarray(served[1]["ranks"])[
            :graph.n_nodes])
    ranks, _, _ = personalized_pagerank(
        graph, sources, damping=float(damping_factor),
        max_iterations=int(max_iterations))
    return _rows(graph, rank=ranks)


def katz_centrality_get(source, alpha=0.2, epsilon=1e-2, *,
                        cache=GLOBAL_GRAPH_CACHE, pool=GLOBAL_WARM_POOL,
                        device=None) -> dict:
    """``katz_centrality.get``: node, rank (500 iterations at most)."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("rank")

    def compute(x0):
        xs, _, iters = katz_centrality(graph, alpha=float(alpha),
                                       tol=float(epsilon),
                                       max_iterations=500, x0=x0)
        return xs, iters

    xs = _warm(pool, source, graph, "katz",
               ("katz", float(alpha), float(epsilon)), compute)
    return _rows(graph, rank=xs)


def community_detection_get(source, max_iterations=30, weight_property=None,
                            *, cache=GLOBAL_GRAPH_CACHE,
                            pool=GLOBAL_WARM_POOL, device=None) -> dict:
    """``community_detection.get``: node, community_id, the labels
    compacted to 1..k in label order."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    if graph.n_nodes == 0:
        return _none("community_id")

    def compute(labels0):
        return label_propagation(graph, max_iterations=int(max_iterations),
                                 labels0=labels0)

    labels = _warm(pool, source, graph, "labelprop",
                   ("labelprop", int(max_iterations), weight_property),
                   compute)
    uniq = np.unique(labels)
    return _rows(graph, community_id=np.searchsorted(uniq, labels) + 1)


def weakly_connected_components_get(source, *, cache=GLOBAL_GRAPH_CACHE,
                                    pool=GLOBAL_WARM_POOL,
                                    device=None) -> dict:
    """``weakly_connected_components.get`` (``wcc.get``): node,
    component_id."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("component_id")

    def compute(comp0):
        return weakly_connected_components(graph, comp0=comp0)

    comp = _warm(pool, source, graph, "wcc", ("wcc",), compute)
    return _rows(graph, component_id=comp)


def strongly_connected_components_get(source, *, cache=GLOBAL_GRAPH_CACHE,
                                      device=None) -> dict:
    """``strongly_connected_components.get``: node, component_id."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("component_id")
    return _rows(graph, component_id=strongly_connected_components(graph))


def degree_centrality_get(source, type="undirected", *,
                          cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``degree_centrality.get``: node, degree; ``type`` "in" or "out"
    (any case), anything else the total."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("degree")
    direction = {"in": "in", "out": "out"}.get(str(type).lower(), "total")
    return _rows(graph, degree=degree_centrality(graph, direction))


def hits_get(source, max_iterations=100, tolerance=1e-6, *,
             cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``hits.get``: node, hub, authority."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("hub", "authority")
    hub, auth, _, _ = hits(graph, max_iterations=int(max_iterations),
                           tol=float(tolerance))
    return _rows(graph, hub=hub, authority=auth)


def betweenness_centrality_get(source, directed=True, normalized=True,
                               samples=0, *, cache=GLOBAL_GRAPH_CACHE,
                               device=None) -> dict:
    """``betweenness_centrality.get``: node, betweenness_centrality;
    exact when ``samples`` is 0, else that many sampled sources."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return _none("betweenness_centrality")
    bc = betweenness_centrality(graph, directed=bool(directed),
                                normalized=bool(normalized),
                                samples=int(samples) or None)
    return _rows(graph, betweenness_centrality=bc)


def bfs_get(source, start, directed=True, *, cache=GLOBAL_GRAPH_CACHE,
            device=None) -> dict:
    """``bfs.get``: node, level, for the vertices reached from the vertex
    with gid ``start``."""
    graph = cache.get(source, device=device)
    sidx = graph.gid_to_idx.get(start) if graph.n_nodes else None
    if sidx is None:
        return _none("level")
    levels, _ = bfs_levels(graph, sidx, directed=bool(directed))
    levels = _host(levels)
    return _rows(graph, levels >= 0, level=levels)


def sssp_get(source, start, weight_property="weight", *,
             cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``sssp.get``: node, distance, for the vertices reached from the
    vertex with gid ``start`` over the edges' ``weight_property``."""
    graph = cache.get(source, weight_property=weight_property, device=device)
    sidx = graph.gid_to_idx.get(start) if graph.n_nodes else None
    if sidx is None:
        return _none("distance")
    dist, _ = sssp(graph, sidx, weighted=True, directed=True)
    dist = _host(dist)
    return _rows(graph, np.isfinite(dist), distance=dist)


def graph_util_khop(source, sources, hops, directed=False, *,
                    cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``graph_util.khop``: node, for the vertices within ``hops`` hops
    of the vertices with gids ``sources``."""
    graph = cache.get(source, device=device)
    idxs = _indices(graph, sources) if graph.n_nodes else []
    if not idxs:
        return _none()
    mask = _host(khop_neighborhood(graph, idxs, int(hops),
                                   directed=bool(directed)))
    return _rows(graph, mask)


#: the procedure each function answers
PROCEDURES = {
    "pagerank.get": pagerank_get,
    "pagerank.personalized": pagerank_personalized,
    "katz_centrality.get": katz_centrality_get,
    "community_detection.get": community_detection_get,
    "weakly_connected_components.get": weakly_connected_components_get,
    "strongly_connected_components.get": strongly_connected_components_get,
    "degree_centrality.get": degree_centrality_get,
    "hits.get": hits_get,
    "betweenness_centrality.get": betweenness_centrality_get,
    "bfs.get": bfs_get,
    "sssp.get": sssp_get,
    "graph_util.khop": graph_util_khop,
}


# --- the Cypher surface --------------------------------------------------------


from . import mgp  # noqa: E402 — the registrations below need the functions


def _records(pctx, out: dict, fields: dict):
    """The records of a function's columns: ``fields`` maps each result
    field (its column's name) to its host type; vertices by gid at the
    view."""
    find, view = pctx.accessor.find_vertex, pctx.view
    cols = [(name, out[name], cast) for name, cast in fields.items()]
    for i, gid in enumerate(out["node_gids"]):
        node = find(int(gid), view)
        if node is not None:
            rec = {"node": node}
            for name, col, cast in cols:
                rec[name] = cast(col[i])
            yield rec


def _kernel(pctx):
    """The interpreter's kernel-server socket setting, or None."""
    ictx = getattr(pctx.exec_ctx, "interpreter_context", None)
    cfg = getattr(ictx, "config", None) or {}
    return cfg.get("kernel_server_socket")


def _gids(nodes) -> list:
    return [v.gid for v in nodes if v is not None]


_RANK = {"rank": float}


def _pagerank_proc(ctx, max_iterations=100, damping_factor=0.85,
                   stop_epsilon=1e-5, weight_property=None):
    out = pagerank_get(ctx.source(), max_iterations, damping_factor,
                       stop_epsilon, weight_property, device=ctx.device,
                       kernel=_kernel(ctx))
    yield from _records(ctx, out, _RANK)


for _name in ("pagerank.get", "pagerank_tpu.get", "pagerank_online.get"):
    mgp.read_proc(_name,
                  opt_args=[("max_iterations", "INTEGER", 100),
                            ("damping_factor", "FLOAT", 0.85),
                            ("stop_epsilon", "FLOAT", 1e-5),
                            ("weight_property", "STRING", None)],
                  results=[("node", "NODE"), ("rank", "FLOAT")])(
                      _pagerank_proc)


@mgp.read_proc("pagerank.personalized",
               args=[("source_nodes", "LIST")],
               opt_args=[("max_iterations", "INTEGER", 100),
                         ("damping_factor", "FLOAT", 0.85)],
               results=[("node", "NODE"), ("rank", "FLOAT")])
def _personalized_proc(ctx, source_nodes, max_iterations=100,
                       damping_factor=0.85):
    out = pagerank_personalized(ctx.source(), _gids(source_nodes),
                                max_iterations, damping_factor,
                                device=ctx.device, kernel=_kernel(ctx))
    yield from _records(ctx, out, _RANK)


def _katz_proc(ctx, alpha=0.2, epsilon=1e-2):
    out = katz_centrality_get(ctx.source(), alpha, epsilon,
                              device=ctx.device)
    yield from _records(ctx, out, _RANK)


for _name in ("katz_centrality.get", "katz_centrality_tpu.get",
              "katz_centrality_online.get"):
    mgp.read_proc(_name,
                  opt_args=[("alpha", "FLOAT", 0.2),
                            ("epsilon", "FLOAT", 1e-2)],
                  results=[("node", "NODE"), ("rank", "FLOAT")])(_katz_proc)


def _community_proc(ctx, max_iterations=30, weight_property=None):
    out = community_detection_get(ctx.source(), max_iterations,
                                  weight_property, device=ctx.device)
    yield from _records(ctx, out, {"community_id": int})


for _name in ("community_detection.get", "community_detection_tpu.get",
              "community_detection_online.get", "label_propagation.get"):
    mgp.read_proc(_name,
                  opt_args=[("max_iterations", "INTEGER", 30),
                            ("weight_property", "STRING", None)],
                  results=[("node", "NODE"),
                           ("community_id", "INTEGER")])(_community_proc)


def _wcc_proc(ctx):
    out = weakly_connected_components_get(ctx.source(), device=ctx.device)
    yield from _records(ctx, out, {"component_id": int})


for _name in ("weakly_connected_components.get", "wcc.get",
              "connectivity.get", "wcc_tpu.get"):
    mgp.read_proc(_name,
                  results=[("node", "NODE"),
                           ("component_id", "INTEGER")])(_wcc_proc)


@mgp.read_proc("strongly_connected_components.get",
               results=[("node", "NODE"), ("component_id", "INTEGER")])
def _scc_proc(ctx):
    out = strongly_connected_components_get(ctx.source(),
                                            device=ctx.device)
    yield from _records(ctx, out, {"component_id": int})


@mgp.read_proc("degree_centrality.get",
               opt_args=[("type", "STRING", "undirected")],
               results=[("node", "NODE"), ("degree", "FLOAT")])
def _degree_proc(ctx, type="undirected"):
    out = degree_centrality_get(ctx.source(), type, device=ctx.device)
    yield from _records(ctx, out, {"degree": float})


@mgp.read_proc("hits.get",
               opt_args=[("max_iterations", "INTEGER", 100),
                         ("tolerance", "FLOAT", 1e-6)],
               results=[("node", "NODE"), ("hub", "FLOAT"),
                        ("authority", "FLOAT")])
def _hits_proc(ctx, max_iterations=100, tolerance=1e-6):
    out = hits_get(ctx.source(), max_iterations, tolerance,
                   device=ctx.device)
    yield from _records(ctx, out, {"hub": float, "authority": float})


@mgp.read_proc("betweenness_centrality.get",
               opt_args=[("directed", "BOOLEAN", True),
                         ("normalized", "BOOLEAN", True),
                         ("samples", "INTEGER", 0)],
               results=[("node", "NODE"),
                        ("betweenness_centrality", "FLOAT")])
def _betweenness_proc(ctx, directed=True, normalized=True, samples=0):
    out = betweenness_centrality_get(ctx.source(), directed, normalized,
                                     samples, device=ctx.device)
    yield from _records(ctx, out, {"betweenness_centrality": float})


@mgp.read_proc("bfs.get",
               args=[("source", "NODE")],
               opt_args=[("directed", "BOOLEAN", True)],
               results=[("node", "NODE"), ("level", "INTEGER")])
def _bfs_proc(ctx, source, directed=True):
    if source is None:
        return
    out = bfs_get(ctx.source(), source.gid, directed, device=ctx.device)
    yield from _records(ctx, out, {"level": int})


@mgp.read_proc("sssp.get",
               args=[("source", "NODE")],
               opt_args=[("weight_property", "STRING", "weight")],
               results=[("node", "NODE"), ("distance", "FLOAT")])
def _sssp_proc(ctx, source, weight_property="weight"):
    if source is None:
        return
    out = sssp_get(ctx.source(), source.gid, weight_property,
                   device=ctx.device)
    yield from _records(ctx, out, {"distance": float})


@mgp.read_proc("graph_util.khop",
               args=[("sources", "LIST"), ("hops", "INTEGER")],
               opt_args=[("directed", "BOOLEAN", False)],
               results=[("node", "NODE")])
def _khop_proc(ctx, sources, hops, directed=False):
    out = graph_util_khop(ctx.source(), _gids(sources), hops, directed,
                          device=ctx.device)
    yield from _records(ctx, out, {})
