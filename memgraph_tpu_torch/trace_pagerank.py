"""Where a PageRank iteration's time goes on the card.

    python -m memgraph_tpu_torch.trace_pagerank [--nodes N] [--edges E]
        [--iterations I] [--refresh] [--out DIR]

Builds the skewed north-star digraph (``northstar.generate_graph``, seed
7; 1,000,000 nodes and 10,000,000 edges by default), runs ``pagerank``
once per precision to build the plan and the kernels, then traces a warm
run of ``--iterations`` iterations per precision with ``torch.profiler``.
The snapshots come as a query gets them: ``GraphCache.get`` of a
``northstar.CooSource``.  With ``--refresh`` the source then commits
``northstar.mutation`` (seed 11) and the successor is the cache's delta
export, refreshed from the base's plan (its ``_delta_ctx``); it is
traced the same way.
Prints one JSON line per snapshot and precision: wall ms per iteration,
device-busy share of the window (the union of kernel intervals over the
window's span), device time per kernel name, largest first, and the
host side of the window: host ms per iteration in each route's
expand/route/extract (``spmv_mxu._route_acc``, labelled by its net's
size), kernel-launch calls per iteration and their mean host time.
First a ``csr`` line: ``from_coo`` of the graph (native builder) and the
numpy path on the same edges, timed one after the other.  Chrome traces
go to ``--out`` (default ``memgraph_tpu_torch/_build/trace``,
git-ignored).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from .northstar import CooSource, generate_graph, mutation
from .ops import spmv_mxu
from .ops.csr import GraphCache, _csr_csc_numpy, from_coo
from .ops.native import build_csr_csc_native
from .ops.pagerank import pagerank

# the host-side span around each route's _route_acc (its GPU-side shadow
# is no kernel and is left out of the device times)
ROUTE_LABEL = "_route_acc net 2^"


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0][:120]


def _busy_us(events) -> tuple[float, float]:
    """(union of the device intervals, their span) in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--edges", type=int, default=10_000_000)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--refresh", action="store_true",
                    help="also trace a mutated successor (delta path)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build", "trace"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_pagerank needs a CUDA device")

    src, dst = generate_graph(args.nodes, args.edges)
    served = build_csr_csc_native.served
    t0 = time.perf_counter()
    host = from_coo(src, dst, n_nodes=args.nodes)
    from_coo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _csr_csc_numpy(src, dst, host.host_coo[2], args.nodes, host.n_pad,
                   host.e_pad)
    print(json.dumps({
        "csr": {"from_coo_s": from_coo_s,
                "native": build_csr_csc_native.served == served + 1,
                "numpy_path_s": time.perf_counter() - t0}}), flush=True)
    del host
    source = CooSource(src, dst, args.nodes)
    cache = GraphCache()
    graph = cache.get(source, device="cuda")
    os.makedirs(args.out, exist_ok=True)
    snapshots = [("base", graph)]
    if args.refresh:
        # the base's plan first: the successor's delta export anchors on it
        pagerank(graph, max_iterations=2, tol=-1.0)
        drop, add_src, add_dst = mutation(src, dst, args.nodes)
        source.commit(add_src, add_dst, remove=np.flatnonzero(drop))
        succ = cache.get(source, device="cuda")
        ctx = getattr(succ, "_delta_ctx", None)
        if ctx is None or ctx[0] is not graph:
            raise SystemExit("the successor is not a delta of the base")
        snapshots.append(("refresh", succ))
    route_acc = spmv_mxu._route_acc

    def labelled_route_acc(rank_planes, layout, route, route_dtype):
        with torch.profiler.record_function(
                f"{ROUTE_LABEL}{route[2].net_log2}"):
            return route_acc(rank_planes, layout, route, route_dtype)

    spmv_mxu._route_acc = labelled_route_acc
    try:
        # base and refresh windows alternate, so that each pair of one
        # precision is read in the same minute
        for precision in ("f32", "bf16"):
            for label, g in snapshots:
                _trace(g, label, precision, args)
    finally:
        spmv_mxu._route_acc = route_acc


def _trace(graph, label, precision, args):
    from torch.profiler import ProfilerActivity, profile

    pagerank(graph, max_iterations=2, tol=-1.0, precision=precision)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, iters = pagerank(graph, max_iterations=args.iterations,
                               tol=-1.0, precision=precision)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(
        os.path.join(args.out, f"pagerank_{label}_{precision}.json"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(ROUTE_LABEL)]
    busy, span = _busy_us(kernels)
    by_name: dict = {}
    for e in kernels:
        name = _short(e.name)
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    route_acc: dict = {}
    for e in host:
        if e.name.startswith(ROUTE_LABEL):
            route_acc[e.name] = route_acc.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    launch_us = [e.time_range.end - e.time_range.start for e in host
                 if e.name.startswith("cudaLaunchKernel")]
    print(json.dumps({
        "snapshot": label, "precision": precision, "iterations": iters,
        "wall_ms_per_iteration": wall / iters * 1e3,
        "device_busy_share": busy / span if span else None,
        "device_ms_per_iteration": busy / iters / 1e3,
        "kernels_ms_per_iteration": {
            name: us / iters / 1e3 for name, us in top[:14]},
        "host_route_acc_ms_per_iteration": {
            name: us / iters / 1e3 for name, us in sorted(route_acc.items())},
        "launch_calls_per_iteration": len(launch_us) / iters,
        "launch_call_us_mean": (sum(launch_us) / len(launch_us)
                                if launch_us else None),
        "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
