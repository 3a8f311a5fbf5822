#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of memgraph_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (any failed check exits nonzero):

1. Card: print ``nvidia-smi``'s name and power limit; build the CUDA
   kernels (``memgraph_tpu_torch/ops/csrc/*.cu``, nvcc, in parallel) and
   the host Benes router (g++), timed.
2. Benes kernels against their plain PyTorch versions on the card:
   random permutations routed by the port's router at n = 7, 12, 16, 20,
   24 slots (log2), in f32 and bf16, plus the identity permutation (every
   stage dead).  Bit-exact; the launch counters must move.  At n = 20 and
   24: kernel, plain-version, bound and gather (``x[perm]``) times.
3. Main path at the north-star size: a skewed digraph of 1,000,000 nodes
   and 10,000,000 edges from seed 7 (``dst = rand**2 * n``), ``from_coo``
   -> ``to_device("cuda")`` -> ``ops.pagerank.pagerank`` with 50
   iterations at damping 0.85 and tol 0, in f32 and in bf16 (one MXU
   plan serves both).  Launch counts are reset just before and read just
   after, and must equal what the plan's networks imply.  f32 ranks
   against a float64 scipy power iteration; bf16 against f32 inside
   ``PRECISION_BOUNDS["bf16"]``.  Each kernel is then held against its
   plain version on the main path's own networks and timed there.
4. A JSON line of kernels ({"kernels": [...]}), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Times are CUDA-event times (kernels) or host wall time around work that
ends in ``torch.cuda.synchronize()`` (PageRank runs).  ``bound_ms`` is the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (H100 SXM
data-sheet peaks), counting each input read once and each output written
once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores

N_NODES = 1_000_000
N_EDGES = 10_000_000
ITERATIONS = 50
DAMPING = 0.85
BENES_SIZES = (7, 12, 16, 20, 24)
TIMED_SIZES = (20, 24)

# f32 against float64 after 50 iterations: each rank is a sum of up to
# ~thousands of f32 products per iteration, whose rounding (2^-24
# relative) compounds over the iterations to ~1e-6 relative (measured
# 8.8e-7 on a 1M-edge graph of the same family); budgeted 100x.
F32_REL_TOL = 1e-4
F32_L1_TOL = 1e-5


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def generate_graph(n_nodes=N_NODES, n_edges=N_EDGES, seed=7):
    """Skewed random digraph (bench.py:78-85): heavy-tail in-degree via
    squared sampling of destinations."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    dst = (rng.random(n_edges) ** 2 * n_nodes).astype(np.int64)
    return src, dst


def reference_pagerank(src, dst, n_nodes, iterations=ITERATIONS,
                       damping=DAMPING):
    """float64 scipy CSR power iteration (bench.py:88-109)."""
    import scipy.sparse as sp
    deg = np.bincount(src, minlength=n_nodes).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    mat = sp.csr_matrix((inv_deg[src], (dst, src)),
                        shape=(n_nodes, n_nodes))
    dangling = deg == 0
    rank = np.full(n_nodes, 1.0 / n_nodes)
    for _ in range(iterations):
        dm = rank[dangling].sum()
        rank = (1 - damping) / n_nodes + damping * (mat @ rank
                                                    + dm / n_nodes)
    return rank


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn over reps launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t):
    """A bit view for exact comparison of f32 / bf16 tensors."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(a, b) -> bool:
    import torch
    return torch.equal(bits(a), bits(b))


def place(masks_packed, n, dtype):
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    spec, mid, out = BC.build_masks(masks_packed, n, BC.K_BY_DTYPE[dtype])
    return (torch.from_numpy(mid).cuda(),
            None if out is None else torch.from_numpy(out).cuda(), spec)


def random_values(N, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, device="cuda", generator=gen).to(dtype)
    return x.view(-1, 128) if N >= 128 else x


def measure_kernels(x, route, reps: int) -> dict:
    """Each kernel of one network against its plain version on x: exact
    check, then kernel / plain / bound / gather times per launch."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    mid, out, spec = route
    N, e = x.numel(), x.element_size()
    iota = torch.arange(N, device="cuda", dtype=torch.int64)
    res = {}
    cases = [("benes_mid", lambda v: BC.benes_mid(v, mid, spec),
              lambda v: BC.benes_mid_reference(v, mid, spec),
              2 * N * e + spec.mid_planes * N * 4,
              len(spec.mid_stages) * N, bool(spec.mid_stages))]
    if spec.outer_down:
        cases.append(("benes_outer",
                      lambda v: BC.benes_outer(v, out, spec.outer_down,
                                               spec),
                      lambda v: BC.benes_outer_reference(
                          v, out, spec.outer_down),
                      2 * N * e + N * 4, len(spec.outer_down) * N, True))
    for name, kern, plain, n_bytes, n_ops, live in cases:
        if not live:
            continue
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        check(same_bits(got, want),
              f"{name} disagrees with its plain version at N={N} {x.dtype}")
        err = float((got.float() - want.float()).abs().max())
        perm = plain(iota)          # the same function as one gather
        flat = x.view(-1)
        b, by = bound_ms(n_bytes, n_ops)
        res[name] = {
            "net_log2": spec.net_log2, "K": spec.K, "dtype": str(x.dtype),
            "stages": n_ops // N, "max_abs_err": err,
            "ms": cuda_ms(lambda: kern(x), reps),
            "plain_ms": cuda_ms(lambda: plain(x), max(1, reps // 4)),
            "bound_ms": b, "bound_by": by,
            "library_ms": cuda_ms(lambda: flat[perm], reps)}
    return res


def phase_benes():
    """Random and identity permutations through both kernels."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.benes import route_packed
    for n in BENES_SIZES:
        N = 1 << n
        t0 = time.perf_counter()
        packed = route_packed(np.random.default_rng(100 + n).permutation(N))
        route_s = time.perf_counter() - t0
        for dtype in (torch.float32, torch.bfloat16):
            mid, out, spec = place(packed, n, dtype)
            x = random_values(N, dtype, seed=n)
            before = (BC.benes_mid.launches, BC.benes_outer.launches)
            got = BC.benes_apply(x, mid, out, spec)
            want = BC.benes_apply_reference(x, mid, out, spec)
            torch.cuda.synchronize()
            moved = (BC.benes_mid.launches - before[0],
                     BC.benes_outer.launches - before[1])
            per = BC.launches_per_apply(spec)
            check(same_bits(got, want),
                  f"benes_apply != plain at n={n} {dtype}")
            check(moved == (per["benes_mid"], per["benes_outer"])
                  and moved[0] == 1,
                  f"launch counters moved {moved} at n={n} {dtype}")
            line = {"n": n, "dtype": str(dtype), "K": spec.K,
                    "route_s": route_s, "exact": True,
                    "launches": {"benes_mid": moved[0],
                                 "benes_outer": moved[1]}}
            if n in TIMED_SIZES:
                apply_bytes = (2 * N * x.element_size()
                               + spec.mid_planes * N * 4
                               + (N * 4 if out is not None else 0))
                line["apply_ms"] = cuda_ms(
                    lambda: BC.benes_apply(x, mid, out, spec), 20)
                line["apply_plain_ms"] = cuda_ms(
                    lambda: BC.benes_apply_reference(x, mid, out, spec), 3)
                line["apply_bound_ms"] = apply_bytes / PEAK_BYTES_PER_S * 1e3
                perm = BC.benes_apply_reference(
                    torch.arange(N, device="cuda"), mid, out, spec)
                flat = x.view(-1)
                line["apply_library_ms"] = cuda_ms(lambda: flat[perm], 20)
                line["kernels"] = measure_kernels(x, (mid, out, spec), 20)
            print("benes", json.dumps(line), flush=True)
    # identity: every stage dead, nothing launched, x comes back as is
    n = 16
    packed = route_packed(np.arange(1 << n))
    for dtype in (torch.float32, torch.bfloat16):
        mid, out, spec = place(packed, n, dtype)
        check(not (spec.mid_stages or spec.outer_down or spec.outer_up),
              "identity permutation left live stages")
        x = random_values(1 << n, dtype, seed=1)
        before = (BC.benes_mid.launches, BC.benes_outer.launches)
        got = BC.benes_apply(x, mid, out, spec)
        check(same_bits(got, x)
              and before == (BC.benes_mid.launches, BC.benes_outer.launches),
              f"identity route changed x or launched at {dtype}")
    print("benes identity exact, no launches", flush=True)


def phase_main_path():
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    t0 = time.perf_counter()
    src, dst = generate_graph()
    host = from_coo(src, dst, n_nodes=N_NODES)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = host.to_device("cuda")
    torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0

    def drive(precision):
        t0 = time.perf_counter()
        ranks, err, iters = pagerank(graph, damping=DAMPING,
                                     max_iterations=ITERATIONS, tol=0.0,
                                     precision=precision)
        torch.cuda.synchronize()
        return ranks, iters, time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    BC.reset_launch_counts()
    r32, it32, cold32 = drive("f32")
    r16, it16, cold16 = drive("bf16")
    _, it32w, warm32 = drive("f32")
    _, it16w, warm16 = drive("bf16")
    launches = {"benes_mid": BC.benes_mid.launches,
                "benes_outer": BC.benes_outer.launches}

    state = graph._mxu_state
    plan = state["plan"]
    runs = {p: run for (_, p), run in state["runs"].items()}
    expected = {"benes_mid": 0, "benes_outer": 0}
    for run in runs.values():
        for route in run.routes.values():
            for k, v in BC.launches_per_apply(route[2]).items():
                expected[k] += 2 * ITERATIONS * v   # cold + warm run
    check(it32 == it16 == it32w == it16w == ITERATIONS,
          f"iterations {it32}/{it16}/{it32w}/{it16w} != {ITERATIONS}")
    check(launches == expected,
          f"launch counts {launches} != expected {expected}")

    ref = reference_pagerank(src, dst, N_NODES)
    a32 = r32.double().cpu().numpy()
    a16 = r16.double().cpu().numpy()
    check(bool(np.isfinite(a32).all() and np.isfinite(a16).all())
          and a32.shape == a16.shape == (N_NODES,), "non-finite or misshaped")
    rel = float((np.abs(a32 - ref) / ref).max())
    l1 = float(np.abs(a32 - ref).sum())
    top = len(set(np.argsort(-a32)[:100]) & set(np.argsort(-ref)[:100]))
    check(rel <= F32_REL_TOL and l1 <= F32_L1_TOL,
          f"f32 ranks off the float64 reference: rel {rel} l1 {l1}")
    check(top == 100, f"f32 top-100 overlap {top}/100")
    bounds = PRECISION_BOUNDS["bf16"]
    linf16 = float(np.abs(a16 - a32).max())
    l1_16 = float(np.abs(a16 - a32).sum())
    k = bounds["topk_order"]
    top_order = bool((np.argsort(-a16)[:k] == np.argsort(-a32)[:k]).all())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"]
          and top_order, f"bf16 outside PRECISION_BOUNDS: linf {linf16} "
          f"l1 {l1_16} top-{k} order {top_order}")

    summary = {
        "n_nodes": N_NODES, "n_edges": N_EDGES, "iterations": ITERATIONS,
        "from_coo_s": host_s, "to_device_s": to_device_s,
        "plan_build_s": state["plan_build_s"],
        "placement_s": {p: r.placement_s for p, r in runs.items()},
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "warm_run_s": {"f32": warm32, "bf16": warm16},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "edges_per_s": {"f32": N_EDGES * ITERATIONS / warm32,
                        "bf16": N_EDGES * ITERATIONS / warm16},
        "plan": {"G": plan.G, "R_G": plan.R_G, "C": plan.C, "W": plan.W,
                 "net_log2": plan.net_log2,
                 "node_net_log2": plan.node_net_log2},
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": {"max_rel": rel, "l1": l1, "top100": top},
        "bf16_vs_f32": {"linf": linf16, "l1": l1_16,
                        f"top{k}_order": top_order}}
    print("main_path", json.dumps(summary), flush=True)

    # each kernel on the main path's own networks, against its plain
    # version (these launches are not the main path's)
    shapes = {}
    for label, route in (("edge_f32", runs["f32"].routes["edge"]),
                         ("edge_bf16", runs["bf16"].routes["edge"]),
                         ("node_f32", runs["f32"].routes["node"])):
        dtype = torch.bfloat16 if label == "edge_bf16" else torch.float32
        x = random_values(1 << route[2].net_log2, dtype, seed=3)
        shapes[label] = measure_kernels(x, route, 20)
        print("main_path_kernels", label, json.dumps(shapes[label]),
              flush=True)
    return launches, shapes


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops._build import load_kernels
    from memgraph_tpu_torch.ops.native import get_router

    card = card_line()
    print("card", card, flush=True)
    t0 = time.perf_counter()
    load_kernels()
    check(get_router() is not None, "host Benes router did not build")
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    phase_benes()
    launches, shapes = phase_main_path()

    replaces = {"benes_mid": "memgraph_tpu/ops/benes_pallas.py:225",
                "benes_outer": "memgraph_tpu/ops/benes_pallas.py:208"}
    kernels = []
    for name in ("benes_mid", "benes_outer"):
        main = shapes["edge_f32"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/benes.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(s[name]["max_abs_err"]
                               for s in shapes.values() if name in s),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "at": "edge net, f32",
            "shapes": {k: s[name] for k, s in shapes.items() if name in s}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
