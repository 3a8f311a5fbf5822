"""Where a PageRank iteration's time goes on the card.

    python -m memgraph_tpu_torch.trace_pagerank [--nodes N] [--edges E]
        [--iterations I] [--out DIR]

Builds the skewed north-star digraph (seed 7, ``dst = rand**2 * n``;
1,000,000 nodes and 10,000,000 edges by default), runs ``pagerank`` once
per precision to build the plan and the kernels, then traces a warm run
of ``--iterations`` iterations per precision with ``torch.profiler``.
Prints one JSON line per precision: wall ms per iteration, device-busy
share of the window (the union of kernel intervals over the window's
span), and device time per kernel name, largest first.  Chrome traces go
to ``--out`` (default ``memgraph_tpu_torch/_build/trace``, git-ignored).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from .ops.csr import from_coo
from .ops.pagerank import pagerank


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
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build", "trace"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_pagerank needs a CUDA device")

    rng = np.random.default_rng(7)
    src = rng.integers(0, args.nodes, args.edges, dtype=np.int64)
    dst = (rng.random(args.edges) ** 2 * args.nodes).astype(np.int64)
    graph = from_coo(src, dst, n_nodes=args.nodes).to_device("cuda")
    os.makedirs(args.out, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile

    for precision in ("f32", "bf16"):
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
            os.path.join(args.out, f"pagerank_{precision}.json"))
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, span = _busy_us(kernels)
        by_name: dict = {}
        for e in kernels:
            name = _short(e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        print(json.dumps({
            "precision": precision, "iterations": iters,
            "wall_ms_per_iteration": wall / iters * 1e3,
            "device_busy_share": busy / span if span else None,
            "device_ms_per_iteration": busy / iters / 1e3,
            "kernels_ms_per_iteration": {
                name: us / iters / 1e3 for name, us in top[:12]},
            "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
