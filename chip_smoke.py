#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of memgraph_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (any failed check exits nonzero):

1. Card: print ``nvidia-smi``'s name and power limit; build the CUDA
   kernels (``memgraph_tpu_torch/ops/csrc/*.cu``, nvcc, in parallel), the
   host Benes router and the native CSR builder (g++), timed.
2. Benes kernels against their plain PyTorch versions on the card:
   random permutations routed by the port's router at n = 7, 10, 12, 14,
   16, 17, 20, 24 slots (log2), in f32 and bf16, plus two small-K
   networks (n = 20, K = 8: 4096 rows; n = 16, K = 1: 2^15 rows) and the
   identity permutation (every stage dead).  Each network is placed on
   the card from the router's packed mask rows (``build_masks`` selects
   the live rows; nothing is unpacked): its middle stages composed
   (``compose_mid``: one ``benes_mid`` launch on the iota) into the index
   that ``benes_mid_gather`` applies, each outer side (``compose_outer``:
   one ``benes_outer`` launch per live side) into the row index that
   ``benes_outer_gather`` applies; both indices must equal the CPU
   composition, and the kernels' ``benes_apply`` the stage-by-stage
   plain network.  Bit-exact; the launch counters must move.  Every
   network's four kernels are also held alone against their plain
   versions on values; at n = 20 and 24 they are timed too (kernel,
   plain-version, bound and gather ``x[perm]`` times; the stage kernels
   also on the 16-bit iota that placement feeds them).
3. Microbenchmark kernels (``memgraph_tpu_torch/benchmarks/micro*.py``,
   ``ops/csrc/micro.cu``): the three entry points run at the JAX module's
   sizes with the launch counters reset just before and read just after
   (each counter must move by what its entry point's timing implies).
   Then each of the ten kernels is held against its plain version on the
   card (bit-exact, or within its stated tolerance), transpose_loop and
   sandwich also on random values at an odd iteration count,
   lane_gather_loop also at R = 100 (a ragged last block) x 501 on random
   values, gather_loop also at R = 256 x 51 and at its largest R = 16384
   x 3, big_matmul also at (64, 32, 32) x 3 and (256, 512, 96) x 7 (its
   smaller tiles).  The five looping kernels fail if their time is under
   0.95 x their on-chip bound, which would mean work was skipped (a
   hoisted product, passes merged, gathers composed); their lines print
   the launch design (blocks, cluster size, threads, shared memory, SMs
   occupied) and the share of the bound reached; gather_loop's and
   lane_gather_loop's also their ``split``: the time at several iteration
   counts, t(0) (entry, exit, launch) and the time an iteration.  Each
   kernel is timed: warm device time (``ms``: launches queued behind a
   device spin, so the Python wrapper's cost hides), cold (a 128 MB
   scratch write between launches, where the inputs fit in the 50 MB L2),
   back to back from Python (``host_ms``), plain, one PyTorch call (or the
   loop of calls a looping kernel stands for), the bound, and for kernels
   that loop on chip the on-chip bound (shared-memory or shuffle bytes
   over 128 B/clock/SM on every SM of the card, at ``clocks.max.sm``:
   lane_gather_loop 4 B a value an iteration, one shuffle's or one
   read's, gather_loop 8 B, a read and a write; sandwich 24 B, the
   fewest its five passes need with each gather folded into the round
   trip of the transpose after it; for big_matmul its FMAs over 256
   flop/clock on every SM).  One ``micro`` line per kernel and size.
4. Main path at the north-star size: a skewed digraph of 1,000,000 nodes
   and 10,000,000 edges from seed 7 (``dst = rand**2 * n``), ``from_coo``
   (which must go through the native CSR builder) ->
   ``to_device("cuda")`` -> ``ops.pagerank.pagerank`` with 50
   iterations at damping 0.85 and tol 0, in f32 and in bf16 (one MXU
   plan serves both).  Launch counts are reset just before and read just
   after, and must equal what the plan's networks imply.  f32 ranks
   against a float64 scipy power iteration; bf16 against f32 inside
   ``PRECISION_BOUNDS["bf16"]``.  Placement must not call
   ``np.unpackbits``; the line gives each route's placement split (host
   mask selection, upload, CUDA-event compose time).  Each kernel is then
   held against its plain version on the main path's own networks and
   timed there (the stage kernels ``benes_mid`` and ``benes_outer``,
   which run only at placement, fed the same packed rows that were
   composed).
5. Snapshot refresh: the main path's graph mutated from seed 11 (5,000
   edges removed, 5,000 added on the graph's skew, 8 nodes emptied of
   out-edges, 8 dangling nodes given one), ``from_coo`` of the successor
   with the same node gids (native builder), placed on the card and
   marked with ``_delta_ctx`` as ``GraphCache.get`` marks it; PageRank at
   f32 and bf16, cold and warm, with launch counts reset just before and
   read just after.  It fails if ``build_plan`` ran, if the runs did not
   share the base plan's placed routes, if the launches are not base +
   delta per iteration plus the delta's placement, if f32 leaves the
   main path's bounds against float64 on the mutated graph, if bf16
   leaves ``PRECISION_BOUNDS["bf16"]`` against the f32 delta run, or if
   the bf16 run did not move with the mutation (it sits nearer the base
   snapshot's ranks, or its change from the base's bf16 ranks misses the
   f32 change by half of it).  One ``refresh`` line;
   each kernel held and timed on the delta nets.
6. Katz on the main path's placed graph (after the main path, before
   the refresh): ``ops.katz.katz_centrality`` at α = 0.05 (about 0.5 / λ
   for the north star's Aᵀ), β = 1, 50 iterations, tol -1, f32 and
   bf16, cold and warm, launch counts reset just before and read just
   after.  The line prints λ of Aᵀ (a float64 power iteration) and α λ.
   It rides PageRank's plan and placed routes: it fails if
   ``build_plan`` ran, if any route was placed, if a stage kernel ran, or
   if a run made other than 2 x 50 ``benes_mid_gather`` and 4 x 50
   ``benes_outer_gather`` launches.  f32 against a float64 scipy run of
   the recurrence (max relative 1e-4, top-100 100/100), bf16 against f32
   inside ``PRECISION_BOUNDS["bf16"]["katz_rel"]``.  One ``katz`` line:
   the unnormalized plan's derivation and the multipliers' placement
   (seconds), iteration ms beside PageRank's in the same minute.
7. (after the refresh) The segment backend on the card: a graph of
   100,000 nodes and 450,000 edges from the north star's generator (under
   ``MXU_MIN_EDGES``); PageRank (damping 0.85) and katz (α = 0.05) at f32
   against float64 with the main path's bounds, HITS against a float64
   run of the same steps (``HITS_TOL`` of the largest entry), 50
   iterations each, cold and warm.  Degree centrality, in, out and total,
   on this graph and on the north star, bit-equal to numpy's float32
   counts over n - 1.  ``segment`` and ``degree`` lines.
   Both runs of each are bit-equal (the segment sums are the
   deterministic ``csr_spmm_sum``); its launches are counted: one an
   iteration (two for HITS) and one for PageRank's setup.
8. (after the refresh, before the segment backend) The deterministic
   segment sums (``ops/csrc/segment.cu``) on the north star:
   ``csr_spmm_sum`` over the CSC runs (the pull matvec) and the CSR runs
   (the reversed one), f32 and bf16, 1, 3 and 32 lanes, and
   ``lane_sum`` in its three forms at 1, 3 and 32 lanes; then K1 where
   its design can break: run lengths around its short/long bound T
   (T - 1, T, T + 1, 2T, 32T + 1, and empty runs), a star of 2^20 + 5
   in-edges, the no-gather form (``g=None``, first, as
   ``semiring._float_sum`` launches it) and int64 offsets and indices.
   K1 is given the longest run as the main path gives it (a graph's
   ``longest_csc_run`` / ``longest_csr_run``); where no run is long (the
   CSR runs) the two-role launch is held to the same bits and timed
   beside it (``two_role_ms``).  Each bit-equal to the plain version on
   CPU copies, a column alone bit-equal to itself inside B lanes, two
   launches bit-equal.  Timed with the plain version on the card, the
   byte bound (K1: each distinct gathered row of x read once) and
   library calls (a ``torch.sparse_csr_tensor`` product and
   ``index_add_`` for K1, ``torch.sum`` for K2), the previous design's
   time beside this run's where it was measured (``previous_ms``, on the
   ``segment_kernels`` lines only).  ``segment_kernels`` lines.
9. PPR on the north star (``ppr`` line), counts reset just before and
   read just after: one PPR (3 seeded sources, 50 iterations) against a
   float64 scipy power iteration (max error 1e-4 of the largest entry,
   top-100 100/100); a 32-lane batch (1-5 seeded sources a lane, tol
   1e-6) whose lanes 0, 7, 19 and 31 are bit-equal to sequential runs
   with equal iterations; a 3-lane batch (bucket 4, padding dropped)
   bit-equal to the big batch's first lanes; bf16 within
   ``PRECISION_BOUNDS["bf16"]``; a warm start from the converged batch
   in at most 2 iterations; ``ppr_topk`` equal to the sorted vectors,
   ties to the lower index; iteration ms single and batched; launches
   equal to one K1 and one K2 a setup, one K1 and two K2 an iteration.
10. Components and traversal on the north star (``traversal`` line):
   WCC and SCC against ``scipy.sparse.csgraph.connected_components``
   (weak, strong; labels the minimum index), SCC's rounds; SSSP with
   weights uniform in [0.5, 1.5) from seed 17 against Dijkstra (same
   unreachable set, max relative error 1e-5); BFS levels exact against
   unweighted shortest paths with push and pull levels both run;
   ``multi_source_sssp`` (8 sources) and ``khop_neighborhood`` (k = 2)
   exact; seconds a call.  No hand-written kernel is on this path (min
   is exact: ``scatter_reduce_``).
11. A JSON line of kernels ({"kernels": [...]}: the Benes four, the ten
   micro kernels, ``csr_spmm_sum`` and ``lane_sum``, each with its
   launches by path), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Times are CUDA-event times (kernels: launches queued behind a device
spin, ``device_ms``, so a short kernel's time is not its Python
wrapper's) or host wall time around work that ends in
``torch.cuda.synchronize()`` (PageRank runs).  ``bound_ms`` is the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (H100 SXM
data-sheet peaks), counting each input read once and each output written
once.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores

ITERATIONS = 50
DAMPING = 0.85
BENES_SIZES = (7, 10, 12, 14, 16, 17, 20, 24)
TIMED_SIZES = (20, 24)
# networks of n slots (log2) placed at a small K besides their dtype's K:
# many more rows (2^(n-K)) than the main path's for the outer gather
SMALL_K = {16: 1, 20: 8}

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


def sm_clock_hz() -> float:
    """The SM clock ceiling ``nvidia-smi`` reports (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def place(masks_packed, n, dtype, K=None):
    """(mid rows, outer rows, spec) on the card, at the dtype's K or K:
    the live stages' packed mask rows, as placement uploads them."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    spec, mid, out = BC.build_masks(masks_packed, n,
                                    K or BC.K_BY_DTYPE[dtype])
    return (torch.from_numpy(mid).cuda(),
            None if out is None else torch.from_numpy(out).cuda(), spec)


def composed(mid_rows, spec):
    """compose_mid on the card (the stage kernel on the iota, once), held
    against the CPU composition (the plain ``_apply_stages``)."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    before = BC.benes_mid.launches
    mid_idx = BC.compose_mid(mid_rows, spec)
    want = BC.compose_mid(mid_rows.cpu(), spec)
    check(torch.equal(mid_idx.cpu(), want)
          and BC.benes_mid.launches - before == int(bool(spec.mid_stages)),
          f"compose_mid on the card != CPU composition at "
          f"n={spec.net_log2} K={spec.K}")
    return mid_idx


def composed_outer(outer_rows, spec):
    """compose_outer on the card (the stage kernel on the row iota, once
    per live side), held against the CPU composition; None where the net
    fits one tile."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    if outer_rows is None:
        return None
    before = BC.benes_outer.launches
    outer_idx = BC.compose_outer(outer_rows, spec)
    want = BC.compose_outer(outer_rows.cpu(), spec)
    check(torch.equal(outer_idx.cpu(), want)
          and BC.benes_outer.launches - before
          == BC.launches_per_placement(spec)["benes_outer"],
          f"compose_outer on the card != CPU composition at "
          f"n={spec.net_log2} K={spec.K}")
    return outer_idx


def random_values(N, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, device="cuda", generator=gen).to(dtype)
    return x.view(-1, 128) if N >= 128 else x


def measure_kernels(x, masks, route, reps: int = 20,
                    timed: bool = True) -> dict:
    """Each kernel of one network against its plain version on x: exact
    check, then (timed) kernel / plain / bound / gather times per launch.
    route: (mid_idx, outer_idx, spec); masks: (mid rows, outer rows), the
    packed rows the indices were composed from, which feed the stage
    kernels benes_mid and benes_outer (placement).  The stage kernels are
    also held, and timed, on the 16-bit iota placement feeds them
    (``iota_*``)."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    mid_idx, outer_idx, spec = route
    mid_rows, outer_rows = masks
    N, e = x.numel(), x.element_size()
    row_bytes = -(-N // 8)
    iota = torch.arange(N, device="cuda", dtype=torch.int64)
    iota16 = iota.to(torch.int16).view(torch.bfloat16).view(x.shape)
    res = {}
    live = bool(spec.mid_stages)
    # bytes: values in and out, plus each live stage's packed row once
    cases = [("benes_mid_gather",
              lambda v: BC.benes_mid_gather(v, mid_idx, spec),
              lambda v: BC.benes_mid_gather_reference(v, mid_idx, spec),
              2 * N, N, live),
             ("benes_mid", lambda v: BC.benes_mid(v, mid_rows, spec),
              lambda v: BC.benes_mid_reference(v, mid_rows, spec),
              len(spec.mid_stages) * row_bytes,
              len(spec.mid_stages) * N, live)]
    if spec.outer_down:
        down = outer_idx[0]
        cases += [("benes_outer_gather",
                   lambda v: BC.benes_outer_gather(v, down, spec),
                   lambda v: BC.benes_outer_gather_reference(v, down, spec),
                   2 * N, N, True),
                  ("benes_outer",
                   lambda v: BC.benes_outer(v, outer_rows, spec.outer_down,
                                            spec),
                   lambda v: BC.benes_outer_reference(
                       v, outer_rows, spec.outer_down),
                   len(spec.outer_down) * row_bytes,
                   len(spec.outer_down) * N, True)]
    for name, kern, plain, extra_bytes, n_ops, live in cases:
        if not live:
            continue
        stage = name in ("benes_mid", "benes_outer")
        for v in (iota16, x) if stage else (x,):
            got, want = kern(v), plain(v)
            torch.cuda.synchronize()
            check(same_bits(got, want),
                  f"{name} disagrees with its plain version at N={N} "
                  f"{'16-bit iota' if v is iota16 else v.dtype}")
        err = float((got.float() - want.float()).abs().max())   # on x
        res[name] = {"net_log2": spec.net_log2, "K": spec.K,
                     "dtype": str(x.dtype), "max_abs_err": err,
                     "held_on": ["values", "iota"] if stage else ["values"]}
        if not timed:
            continue
        perm = plain(iota)          # the same function as one gather
        flat = x.view(-1)
        n_bytes = 2 * N * e + extra_bytes
        b, by = bound_ms(n_bytes, n_ops)
        res[name].update({
            "ops_per_slot": n_ops // N,
            "ms": device_ms(lambda: kern(x), reps),
            "host_ms": cuda_ms(lambda: kern(x), reps),
            "plain_ms": device_ms(lambda: plain(x), max(1, reps // 4)),
            "bound_ms": b, "bound_by": by, "n_bytes": n_bytes,
            "library_ms": device_ms(lambda: flat[perm], reps)})
        if stage:
            iota_bytes = 2 * N * 2 + extra_bytes
            ib, iby = bound_ms(iota_bytes, n_ops)
            res[name].update({
                "iota_ms": device_ms(lambda: kern(iota16), reps),
                "iota_bound_ms": ib, "iota_bound_by": iby,
                "iota_n_bytes": iota_bytes})
    return res


def counts() -> dict:
    from memgraph_tpu_torch.ops import benes_cuda as BC
    return {"benes_mid": BC.benes_mid.launches,
            "benes_mid_gather": BC.benes_mid_gather.launches,
            "benes_outer": BC.benes_outer.launches,
            "benes_outer_gather": BC.benes_outer_gather.launches}


def hold_network(packed, n, dtype, K=None, timed=False, route_s=0.0):
    """Place one routed network on the card (both indices held against
    the CPU composition), apply it with the kernels against the
    stage-by-stage plain network, check the counters, optionally time."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    N = 1 << n
    mid, out, spec = place(packed, n, dtype, K)
    mid_idx = composed(mid, spec)
    outer_idx = composed_outer(out, spec)
    x = random_values(N, dtype, seed=n)
    before = counts()
    got = BC.benes_apply(x, mid_idx, outer_idx, spec)
    want = BC.benes_apply_reference(x, mid, out, spec)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in counts().items()}
    per = BC.launches_per_apply(spec)
    check(same_bits(got, want),
          f"benes_apply != plain at n={n} K={spec.K} {dtype}")
    check(moved == dict(per, benes_mid=0, benes_outer=0)
          and moved["benes_mid_gather"] == 1
          and moved["benes_outer_gather"] == (2 if n > spec.K else 0),
          f"launch counters moved {moved} at n={n} K={spec.K} {dtype}")
    line = {"n": n, "dtype": str(dtype), "K": spec.K,
            "route_s": route_s, "exact": True, "launches": moved}
    if not timed:
        held = measure_kernels(x, (mid, out), (mid_idx, outer_idx, spec),
                               timed=False)
        line["kernels_exact"] = sorted(held)
    else:
        # values in and out, plus each pass's 2-byte index
        apply_bytes = 2 * N * x.element_size() + 2 * N * sum(per.values())
        line["apply_ms"] = device_ms(
            lambda: BC.benes_apply(x, mid_idx, outer_idx, spec), 20)
        line["apply_plain_ms"] = device_ms(
            lambda: BC.benes_apply_reference(x, mid, out, spec), 3)
        line["apply_bound_ms"] = apply_bytes / PEAK_BYTES_PER_S * 1e3
        perm = BC.benes_apply_reference(
            torch.arange(N, device="cuda"), mid, out, spec)
        flat = x.view(-1)
        line["apply_library_ms"] = device_ms(lambda: flat[perm], 20)
        line["kernels"] = measure_kernels(x, (mid, out),
                                          (mid_idx, outer_idx, spec))
    print("benes", json.dumps(line), flush=True)


def phase_benes():
    """Random and identity permutations through the kernels."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.benes import route_packed
    for n in BENES_SIZES:
        t0 = time.perf_counter()
        packed = route_packed(np.random.default_rng(100 + n).permutation(
            1 << n))
        route_s = time.perf_counter() - t0
        for dtype in (torch.float32, torch.bfloat16):
            hold_network(packed, n, dtype, timed=n in TIMED_SIZES,
                         route_s=route_s)
            if n in SMALL_K:
                hold_network(packed, n, dtype, K=SMALL_K[n])
    # identity: every stage dead, nothing launched, x comes back as is
    n = 16
    packed = route_packed(np.arange(1 << n))
    for dtype in (torch.float32, torch.bfloat16):
        mid, out, spec = place(packed, n, dtype)
        check(not (spec.mid_stages or spec.outer_down or spec.outer_up),
              "identity permutation left live stages")
        x = random_values(1 << n, dtype, seed=1)
        before = counts()
        mid_idx = composed(mid, spec)
        outer_idx = composed_outer(out, spec)
        rows = torch.arange(1 << n, device="cuda") >> spec.K
        check(outer_idx is None or bool((outer_idx == rows).all()),
              f"identity route's outer index is not the iota at {dtype}")
        got = BC.benes_apply(x, mid_idx, outer_idx, spec)
        check(same_bits(got, x) and before == counts(),
              f"identity route changed x or launched at {dtype}")
    print("benes identity exact, no launches", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the microbenchmark kernels
# ---------------------------------------------------------------------------

L2_BYTES = 50 * 2**20                 # H100 L2
SMEM_BYTES_PER_CLOCK = 128            # shared memory per SM per clock
FP32_FLOP_PER_CLOCK = 256             # 128 FMA lanes per SM per clock
SKIPPED_BELOW = 0.95                  # under 0.95 x the on-chip bound
# kernels whose time under SKIPPED_BELOW x their on-chip bound means work
# was skipped
WORK_CHECKED = ("gather_loop", "lane_gather_loop", "transpose_loop",
                "sandwich", "big_matmul")
MICRO_REPLACES = {
    "col_gather": "benchmarks/pallas_micro.py:46",
    "lane_gather": "benchmarks/pallas_micro.py:78",
    "stream": "benchmarks/pallas_micro.py:111",
    "gather_loop": "benchmarks/pallas_micro.py:138",
    "dynslice_gather": "benchmarks/pallas_micro2.py:83",
    "onehot_scatter": "benchmarks/pallas_micro2.py:149",
    "lane_gather_loop": "benchmarks/pallas_micro3.py:49",
    "transpose_loop": "benchmarks/pallas_micro3.py:84",
    "sandwich": "benchmarks/pallas_micro3.py:124",
    "big_matmul": "benchmarks/pallas_micro3.py:156",
}


# ~10 ms of device spin at 1.98 GHz: the host queues the timed launches
# meanwhile, so a small kernel's time is not its Python wrapper's
QUEUE_AHEAD_CYCLES = 20_000_000


def device_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn over reps launches queued behind a spin
    of the device (``torch.cuda._sleep``), after a warm-up: device time
    wherever the host queues all reps within the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean CUDA-event time of fn with the L2 flushed before each launch
    (a 128 MB scratch write, outside the event pair), each launch queued
    behind a short device spin as in ``device_ms``."""
    import torch
    scratch = torch.empty(32 * 2**20, device="cuda")
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        scratch.fill_(1.0)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES // 20)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def expected_micro_launches() -> dict:
    """Launches one run of each entry point makes at its default sizes:
    each bench times n calls after one warm-up call."""
    from memgraph_tpu_torch.benchmarks import micro, micro2, micro3
    n1, n2, n3 = (micro.TIMED_CALLS + 1, micro2.TIMED_CALLS + 1,
                  micro3.TIMED_CALLS + 1)
    return {"col_gather": 5 * n1, "lane_gather": 3 * n1, "stream": 2 * n1,
            "gather_loop": micro.LOOP_TIMED_CALLS + 1,
            "dynslice_gather": n2, "onehot_scatter": n2,
            "lane_gather_loop": n3, "transpose_loop": n3, "sandwich": n3,
            "big_matmul": n3}


def _library_loops():
    """One PyTorch call per iteration (or the few a step needs), looped as
    the kernel loops: the yardsticks of the looping kernels."""
    import torch

    def gather_loop(tab, idx, iters):
        for _ in range(iters):
            tab = torch.gather(tab, 0, idx)
        return tab

    def lane_gather_loop(x, idx, iters):
        for _ in range(iters):
            x = torch.gather(x, 1, idx).add_(1.0)
        return x

    def tiles(a):
        return a.view(-1, 128, 128)

    def transpose_loop(x, iters):
        bufs = (torch.empty_like(x), torch.empty_like(x))
        for it in range(iters):
            torch.add(tiles(x).transpose(1, 2), 1.0, out=tiles(bufs[it % 2]))
            x = bufs[it % 2]
        return x

    def sandwich(x, s1, s2, s3, iters):
        for _ in range(iters):
            a = torch.gather(x, 1, s1)
            a = tiles(a).transpose(1, 2).reshape(x.shape)
            a = torch.gather(a, 1, s2)
            a = tiles(a).transpose(1, 2).reshape(x.shape)
            x = torch.gather(a, 1, s3)
        return x

    def big_matmul(a, b, iters):
        acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
        for _ in range(iters):
            acc.addmm_(a, b)
        return acc

    return (gather_loop, lane_gather_loop, transpose_loop, sandwich,
            big_matmul)


def micro_cases(sm_hz: float, n_sms: int):
    """One case per kernel and size, built as it is used (the largest
    inputs are 256 MB)."""
    from functools import partial

    import torch
    from memgraph_tpu_torch.benchmarks import micro as M1
    from memgraph_tpu_torch.benchmarks import micro2 as M2
    from memgraph_tpu_torch.benchmarks import micro3 as M3
    from memgraph_tpu_torch.benchmarks.loop_split import SPLITS
    lib_gl, lib_lgl, lib_tl, lib_sw, lib_mm = _library_loops()

    def put(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    def onchip(n_bytes, tiling=None):
        # on every SM of the card, whatever share of them a kernel's
        # design occupies; with the design's launch, also on the SMs it
        # occupies
        out = {"onchip_bound_ms": n_bytes / (SMEM_BYTES_PER_CLOCK * n_sms
                                             * sm_hz) * 1e3,
               "onchip_by": f"{n_bytes} B of shared memory or shuffle "
                            f"traffic at {SMEM_BYTES_PER_CLOCK} B/clock on "
                            f"{n_sms} SMs at {sm_hz / 1e6:.0f} MHz"}
        if tiling is not None:
            out["design"] = {k: tiling[k] for k in (
                "blocks", "cluster", "threads", "smem_bytes", "sms")}
            out["onchip_bound_occupied_ms"] = (
                out["onchip_bound_ms"] * n_sms / tiling["sms"])
        return out

    def case(name, size, kern, plain, library, library_call, n_bytes,
             n_ops, rtol=0.0, timed=True, split=None, **extra):
        # split: (iteration counts, the kernel at a count) of a loop
        return dict(name=name, size=size, kern=kern, plain=plain,
                    library=library, library_call=library_call,
                    n_bytes=n_bytes, n_ops=n_ops, rtol=rtol, timed=timed,
                    split=split, extra=extra)

    for R in (8, 64, 512, 2048, 8192):
        tab, idx = put(*M1.gather_inputs(R, R))
        yield case("col_gather", f"R={R}", partial(M1.col_gather, tab, idx),
                   partial(M1.col_gather_reference, tab, idx),
                   partial(torch.gather, tab, 0, idx.long()),
                   "torch.gather(tab, 0, idx)", 12 * R * 128, 0)
    for R in (8, 512, 8192):
        tab, idx = put(*M1.gather_inputs(R, 128))
        yield case("lane_gather", f"R={R}",
                   partial(M1.lane_gather, tab, idx),
                   partial(M1.lane_gather_reference, tab, idx),
                   partial(torch.gather, tab, 1, idx.long()),
                   "torch.gather(tab, 1, idx)", 12 * R * 128, 0)
    for MB in (64, 256):
        R = MB * 2**20 // 512
        gen = torch.Generator(device="cuda").manual_seed(MB)
        x = torch.randn((R, 128), device="cuda", generator=gen)
        one, two = (torch.full((1,), v, device="cuda") for v in (1.0, 2.0))
        yield case("stream", f"{MB} MB", partial(M1.stream, x),
                   partial(M1.stream_reference, x),
                   partial(torch.addcmul, one, x, two),
                   "torch.addcmul(one, x, two)", 8 * R * 128, 2 * R * 128)
        del x
    # the largest R the wrapper takes and a small one, then the main shape
    for R, it, timed in ((M1.MAX_LOOP_ROWS, 3, False), (256, 51, False),
                         (8192, 50, True)):
        tab, idx = put(*M1.gather_inputs(R, R))
        yield case("gather_loop", f"R={R} x{it}",
                   partial(M1.gather_loop, tab, idx, it),
                   partial(M1.gather_loop_reference, tab, idx, it),
                   partial(lib_gl, tab, idx.long(), it),
                   f"loop of {it} x torch.gather(acc, 0, idx)", 12 * R * 128,
                   0, timed=timed,
                   split=(SPLITS["gather_loop"],
                          partial(M1.gather_loop, tab, idx)),
                   **onchip(8 * R * 128 * it,
                            M1.gather_loop_tiling(R, n_sms)))

    grp, row3, rank = put(*M2.dynslice_inputs())
    R = row3.shape[0]
    full = (8 * grp.long().repeat_interleave(8, 0) + row3.long())
    yield case("dynslice_gather", f"E={R * 128}",
               partial(M2.dynslice_gather, grp, row3, rank),
               partial(M2.dynslice_gather_reference, grp, row3, rank),
               partial(torch.gather, rank, 0, full),
               "torch.gather(rank, 0, full_idx)",
               4 * (R // 8) + 8 * R * 128 + rank.numel() * 4, 0)
    del grp, row3, rank, full
    dblk, lanes, vals = put(*M2.onehot_inputs())
    bins = (dblk.long().repeat_interleave(8, 0) * 128 + lanes.long()).view(-1)

    def index_add():
        acc = torch.zeros((M2.RANK_R, 128), device="cuda")
        return acc.view(-1).index_add_(0, bins, vals.view(-1))

    yield case("onehot_scatter", f"E={R * 128}",
               partial(M2.onehot_scatter, dblk, lanes, vals),
               partial(M2.onehot_scatter_reference, dblk, lanes, vals),
               index_add, "torch.zeros + acc.view(-1).index_add_(0, bins, "
               "vals.view(-1))",
               4 * (R // 8) + 8 * R * 128 + M2.RANK_R * 128 * 4, R * 128,
               rtol=M2.ONEHOT_RTOL)
    del dblk, lanes, vals, bins

    gen = torch.Generator(device="cuda").manual_seed(9)
    for R, it, timed in ((100, 501, False), (4096, 500, True)):
        x, idx = put(*M3.lane_loop_inputs(R))
        label = ""
        if not timed:       # a ragged last block, on random values
            x, label = torch.randn((R, 128), device="cuda",
                                   generator=gen), " random x"
        yield case("lane_gather_loop", f"R={R} x{it}{label}",
                   partial(M3.lane_gather_loop, x, idx, it),
                   partial(M3.lane_gather_loop_reference, x, idx, it),
                   partial(lib_lgl, x, idx.long(), it),
                   f"loop of {it} x torch.gather(acc, 1, idx).add_(1)",
                   12 * R * 128, it * R * 128, timed=timed,
                   split=(SPLITS["lane_gather_loop"],
                          partial(M3.lane_gather_loop, x, idx)),
                   # 4 B a value an iteration, a shuffle's or a read's
                   **onchip(4 * R * 128 * it,
                            M3.lane_gather_loop_tiling(R, n_sms)))
    R = 8192
    gen = torch.Generator(device="cuda").manual_seed(10)
    for label, x, it, timed in (
            ("ones", torch.ones((R, 128), device="cuda"), 500, True),
            ("random x", torch.randn((R, 128), device="cuda",
                                     generator=gen), 501, False)):
        yield case("transpose_loop", f"R={R} x{it} {label}",
                   partial(M3.transpose_loop, x, it),
                   partial(M3.transpose_loop_reference, x, it),
                   partial(lib_tl, x, it),
                   f"loop of {it} x torch.add(tiles(acc).transpose(1, 2), "
                   "1, out=...)", 8 * R * 128, it * R * 128, timed=timed,
                   **onchip(8 * R * 128 * it,
                            M3.transpose_loop_tiling(R, n_sms)))
    R = 4096
    x, s1, s2, s3 = put(*M3.lane_loop_inputs(R, 3))
    longs = [s.long() for s in (s1, s2, s3)]
    for it, timed in ((200, True), (201, False)):
        yield case("sandwich", f"R={R} x{it}",
                   partial(M3.sandwich, x, s1, s2, s3, it),
                   partial(M3.sandwich_reference, x, s1, s2, s3, it),
                   partial(lib_sw, x, *longs, it),
                   f"loop of {it} x (3 torch.gather + 2 tile transposes)",
                   20 * R * 128, 0, timed=timed,
                   **onchip(24 * R * 128 * it, M3.sandwich_tiling(R, n_sms)))
    # shapes the 128 x 128 tile does not fit take the kernel's smaller
    # tiles; then the main shape, timed
    rng = np.random.default_rng(6)
    for (M, K, N), it, timed in (((64, 32, 32), 3, False),
                                 ((256, 512, 96), 7, False),
                                 (M3.MATMUL_SHAPE, 500, True)):
        a, b = (put(*M3.matmul_inputs()) if timed else
                put(rng.random((M, K), dtype=np.float32),
                    rng.random((K, N), dtype=np.float32)))
        flops = 2 * M * N * K * it
        # the work on every SM of the card, whatever kernel does it
        yield case("big_matmul", f"{M}x{K}x{N} x{it}",
                   partial(M3.big_matmul, a, b, it),
                   partial(M3.big_matmul_reference, a, b, it),
                   partial(lib_mm, a, b, it),
                   f"loop of {it} x acc.addmm_(a, b)",
                   4 * (M * K + K * N + M * N), flops + M * N * it,
                   rtol=M3.MATMUL_RTOL, timed=timed,
                   tiling=M3.big_matmul_tiling(M, K, N, n_sms),
                   onchip_bound_ms=flops / (FP32_FLOP_PER_CLOCK * n_sms
                                            * sm_hz) * 1e3,
                   onchip_by=f"f32 FMA pipes ({FP32_FLOP_PER_CLOCK} "
                             f"flop/clock) on {n_sms} SMs at "
                             f"{sm_hz / 1e6:.0f} MHz")


def phase_micro(sm_hz: float):
    """The three microbenchmark entry points, then each kernel against its
    plain version, timed."""
    from functools import partial

    import torch
    from memgraph_tpu_torch.benchmarks import micro, micro2, micro3
    from memgraph_tpu_torch.benchmarks._common import compare
    from memgraph_tpu_torch.benchmarks.loop_split import split_of
    mods = (micro, micro2, micro3)
    t0 = time.perf_counter()
    # the entry points: counts set to 0 just before, read just after
    for mod in mods:
        mod.reset_launch_counts()
    results = [r for mod in mods for r in mod.main(["--device", "cuda"])]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for mod in mods
                for fn in mod.KERNELS}
    expected = expected_micro_launches()
    check(launches == expected,
          f"micro launch counts {launches} != expected {expected}")
    bad = [r["bench"] for r in results if not r["ok"]]
    check(not bad, f"micro entry points disagree with plain versions: {bad}")
    entry_s = time.perf_counter() - t0

    lines = {}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in micro_cases(sm_hz, n_sms):
        got, want = c["kern"](), c["plain"]()
        torch.cuda.synchronize()
        ok, err = compare(got, want, c["rtol"])
        check(ok, f"{c['name']} {c['size']} disagrees with its plain "
                  f"version (max abs err {err}, rtol {c['rtol']})")
        del got, want
        line = {"kernel": c["name"], "size": c["size"], "max_abs_err": err,
                "rtol": c["rtol"], "exact": c["rtol"] == 0.0}
        if c["timed"]:
            loops = "onchip_bound_ms" in c["extra"]
            reps = 5 if loops else 20
            b, by = bound_ms(c["n_bytes"], c["n_ops"])
            line.update(
                ms=device_ms(c["kern"], reps),
                cold_ms=(cuda_ms_cold(c["kern"], reps)
                         if c["n_bytes"] < L2_BYTES else None),
                host_ms=cuda_ms(c["kern"], reps),
                plain_ms=device_ms(c["plain"], 3),
                library_ms=device_ms(c["library"], 3 if loops else reps),
                library_call=c["library_call"], bound_ms=b, bound_by=by,
                **c["extra"])
            if loops:
                line["onchip_share"] = line["onchip_bound_ms"] / line["ms"]
            if c["split"] is not None:
                counts, at = c["split"]
                line["split"] = split_of(
                    {k: device_ms(partial(at, k), reps) for k in counts},
                    counts)
            if c["name"] in WORK_CHECKED:
                # quicker than shared memory or the FMA pipes allow: a
                # loop-invariant product hoisted, or passes merged
                check(line["ms"] >= SKIPPED_BELOW * line["onchip_bound_ms"],
                      f"{c['name']} {c['size']} took {line['ms']} ms, under "
                      f"{SKIPPED_BELOW} x its on-chip bound "
                      f"{line['onchip_bound_ms']} ms: work was skipped")
        lines.setdefault(c["name"], []).append(line)
        print("micro", json.dumps(line), flush=True)
    print(f"micro_phase entry_points_s {entry_s:.3f} total_s "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    return launches, lines


def micro_kernel_entries(launches: dict, lines: dict) -> list:
    """The micro kernels' entries of the {"kernels": [...]} line: numbers
    at the largest size the entry point runs, every size under shapes."""
    out = []
    for name, replaces in MICRO_REPLACES.items():
        timed = [ln for ln in lines[name] if "ms" in ln]
        main = timed[-1]
        out.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/micro.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(ln["max_abs_err"] for ln in lines[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": main["size"],
            "shapes": lines[name]})
    return out


def route_kernels(label, route, packed, dtype) -> dict:
    """Each kernel of one placed network of a PageRank run against its
    plain version, timed (these launches are not the run's).  The placed
    indices are held against the composition of the network's masks (the
    placement kept only the indices)."""
    import torch
    spec = route[2]
    mid, out, spec2 = place(packed, spec.net_log2, dtype)
    check(spec2 == spec and torch.equal(route[0], composed(mid, spec))
          and (route[1] is None if out is None
               else torch.equal(route[1], composed_outer(out, spec))),
          f"placed indices of the {label} net != its masks' composition")
    x = random_values(1 << spec.net_log2, dtype, seed=3)
    res = measure_kernels(x, (mid, out), route)
    print("route_kernels", label, json.dumps(res), flush=True)
    return res


def expected_run_launches(run, calls: int, placed_base: bool) -> dict:
    """The launches `calls` runs of ITERATIONS iterations of one placed
    PageRank run make, its placement included: per iteration one
    benes_apply of every route (edge, node and, on a delta run, delta),
    per placement the stage kernels of the delta route (placed by the
    run) and, where `placed_base`, of the base plan's edge and node
    routes (placed once per device and route dtype on the base state)."""
    from memgraph_tpu_torch.ops import benes_cuda as BC
    out = dict.fromkeys(("benes_mid", "benes_mid_gather", "benes_outer",
                         "benes_outer_gather"), 0)
    for name, route in run.routes.items():
        for k, v in BC.launches_per_apply(route[2]).items():
            out[k] += calls * ITERATIONS * v
        if name == "delta" or placed_base:
            for k, v in BC.launches_per_placement(route[2]).items():
                out[k] += v
    return out


@contextlib.contextmanager
def placement_guard():
    """Count the routes placed (``spmv_mxu._put_route`` calls) and fail if
    any of them calls ``np.unpackbits``: placement hands the router's
    packed rows to the card as they are.  Yields the list of calls."""
    from memgraph_tpu_torch.ops import spmv_mxu
    real_put, real_unpack, calls = spmv_mxu._put_route, np.unpackbits, []

    def refuse(*args, **kw):
        fail("np.unpackbits ran during placement on the card")

    def guarded(*args, **kw):
        calls.append(args[1])           # the net's log2 size
        np.unpackbits = refuse
        try:
            return real_put(*args, **kw)
        finally:
            np.unpackbits = real_unpack

    spmv_mxu._put_route = guarded
    try:
        yield calls
    finally:
        spmv_mxu._put_route = real_put


def phase_main_path():
    import torch
    from memgraph_tpu_torch.northstar import N_EDGES, N_NODES, generate_graph
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.native import build_csr_csc_native
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    src, dst = generate_graph()
    served = build_csr_csc_native.served
    t0 = time.perf_counter()
    host = from_coo(src, dst, n_nodes=N_NODES)
    host_s = time.perf_counter() - t0
    check(build_csr_csc_native.served == served + 1,
          "the native CSR builder did not serve the north-star graph")
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
    with placement_guard() as placed_nets:
        BC.reset_launch_counts()
        r32, it32, cold32 = drive("f32")
        r16, it16, cold16 = drive("bf16")
        _, it32w, warm32 = drive("f32")
        _, it16w, warm16 = drive("bf16")
        launches = counts()

    state = graph._mxu_state
    plan = state["plan"]
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    runs = {precisions[dt]: run for (_, dt), run in state["runs"].items()}
    expected = dict.fromkeys(launches, 0)
    for p, run in runs.items():
        # per plan: 2 mid / 4 outer gathers an iteration (edge + node
        # nets), 2 benes_mid / 4 benes_outer at its placement (cold run)
        one = expected_run_launches(run, 1, placed_base=True)
        check(one == {"benes_mid": 2, "benes_mid_gather": 2 * ITERATIONS,
                      "benes_outer": 4, "benes_outer_gather": 4 * ITERATIONS},
              f"{p} plan launches {one} over one run and its placement")
        for k, v in expected_run_launches(run, 2, placed_base=True).items():
            expected[k] += v
    check(set(state["placed"]) == set(state["runs"]),
          "the base routes were not placed once per run's device and dtype")
    check(len(placed_nets) == 2 * len(state["placed"]),
          f"{len(placed_nets)} routes placed, not edge + node per dtype")
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
        "from_coo_s": host_s, "from_coo_builder": "native",
        "to_device_s": to_device_s,
        "plan_build_s": state["plan_build_s"],
        "placement_s": {precisions[key[1]]: placed["placement_s"]
                        + state["runs"][key].placement_s
                        for key, placed in state["placed"].items()},
        "placement_split": {precisions[key[1]]: placed["route_split"]
                            for key, placed in state["placed"].items()},
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
    for label, route, packed in (
            ("edge_f32", runs["f32"].routes["edge"], plan.masks_packed),
            ("edge_bf16", runs["bf16"].routes["edge"], plan.masks_packed),
            ("node_f32", runs["f32"].routes["node"],
             plan.node_masks_packed)):
        dtype = torch.bfloat16 if label == "edge_bf16" else torch.float32
        shapes[label] = route_kernels(label, route, packed, dtype)
    base = {"src": src, "dst": dst, "host": host, "graph": graph,
            "ranks": {"f32": a32, "bf16": a16}, "summary": summary,
            "placed_keys": list(state["placed"])}
    return launches, shapes, base


def phase_refresh(base: dict):
    """A mutated successor of the main path's graph through the delta
    path: no second plan build, the base routes shared, only the delta
    net placed; f32 against float64 on the mutated graph, bf16 against
    the f32 delta run."""
    import torch
    from memgraph_tpu_torch.northstar import N_NODES, mutate
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import spmv_mxu
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.native import build_csr_csc_native
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph, host = base["graph"], base["host"]
    t0 = time.perf_counter()
    src2, dst2, changed = mutate(base["src"], base["dst"], N_NODES)
    mutate_s = time.perf_counter() - t0
    served = build_csr_csc_native.served
    t0 = time.perf_counter()
    succ_host = from_coo(src2, dst2, n_nodes=N_NODES,
                         node_gids=host.node_gids)
    from_coo_s = time.perf_counter() - t0
    check(build_csr_csc_native.served == served + 1,
          "the native CSR builder did not serve the mutated graph")
    t0 = time.perf_counter()
    succ = succ_host.to_device("cuda")
    torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0
    # as GraphCache.get marks a successor snapshot of a planned base
    object.__setattr__(succ, "_delta_ctx", (graph, frozenset(
        int(g) for g in host.node_gids[changed])))

    real_build_plan, plan_builds = spmv_mxu.build_plan, []

    def counted_build_plan(*args, **kw):
        plan_builds.append(1)
        return real_build_plan(*args, **kw)

    def drive(precision):
        t0 = time.perf_counter()
        ranks, err, iters = pagerank(succ, damping=DAMPING,
                                     max_iterations=ITERATIONS, tol=0.0,
                                     precision=precision)
        torch.cuda.synchronize()
        check(iters == ITERATIONS, f"refresh {precision} ran {iters} "
                                   f"iterations, not {ITERATIONS}")
        return ranks, time.perf_counter() - t0

    spmv_mxu.build_plan = counted_build_plan
    try:
        # the refresh path: counts set to 0 just before, read just after
        with placement_guard() as placed_nets:
            BC.reset_launch_counts()
            r32, cold32 = drive("f32")
            r16, cold16 = drive("bf16")
            _, warm32 = drive("f32")
            _, warm16 = drive("bf16")
            launches = counts()
    finally:
        spmv_mxu.build_plan = real_build_plan
    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) "
                           "for the successor snapshot")

    state = succ._mxu_state
    delta = state.get("delta")
    check(delta is not None and state["plan"] is graph._mxu_state["plan"],
          "the successor did not take the delta path on the base plan")
    check(placed_nets == [delta.net_log2] * 2,
          f"the refresh placed nets {placed_nets}, not the delta net once "
          "per dtype")
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    runs = {precisions[dt]: run for (_, dt), run in state["runs"].items()}
    base_placed = graph._mxu_state["placed"]
    check(list(base_placed) == base["placed_keys"],
          f"the refresh placed base routes: {list(base_placed)} against "
          f"{base['placed_keys']} after the main path")
    expected = dict.fromkeys(launches, 0)
    for key, run in state["runs"].items():
        check(all(run.routes[r] is base_placed[key][r]
                  for r in ("edge", "node")),
              f"the {precisions[key[1]]} delta run does not share the base "
              "routes")
        for k, v in expected_run_launches(run, 2, placed_base=False).items():
            expected[k] += v
    check(launches == expected,
          f"refresh launch counts {launches} != expected {expected}")

    # base iterations again, in the same minute as the delta's
    # (not counted: the refresh counts were read above)
    base_warm = {}
    for p in ("f32", "bf16"):
        t0 = time.perf_counter()
        pagerank(graph, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0,
                 precision=p)
        torch.cuda.synchronize()
        base_warm[p] = time.perf_counter() - t0

    ref = reference_pagerank(src2, dst2, N_NODES)
    a32 = r32.double().cpu().numpy()
    a16 = r16.double().cpu().numpy()
    check(bool(np.isfinite(a32).all() and np.isfinite(a16).all())
          and a32.shape == a16.shape == (N_NODES,),
          "refresh ranks non-finite or misshaped")
    rel = float((np.abs(a32 - ref) / ref).max())
    l1 = float(np.abs(a32 - ref).sum())
    top = len(set(np.argsort(-a32)[:100]) & set(np.argsort(-ref)[:100]))
    check(rel <= F32_REL_TOL and l1 <= F32_L1_TOL and top == 100,
          f"refresh f32 off the float64 reference of the mutated graph: "
          f"rel {rel} l1 {l1} top-100 {top}")
    bounds = PRECISION_BOUNDS["bf16"]
    linf16 = float(np.abs(a16 - a32).max())
    l1_16 = float(np.abs(a16 - a32).sum())
    k = bounds["topk_order"]
    top_order = bool((np.argsort(-a16)[:k] == np.argsort(-a32)[:k]).all())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"]
          and top_order, f"refresh bf16 outside PRECISION_BOUNDS: linf "
          f"{linf16} l1 {l1_16} top-{k} order {top_order}")
    # the bf16 run must have moved with the mutation: its change from the
    # base's bf16 ranks tracks the f32 change (the common rounding of the
    # base contributions cancels); a bf16 run served by the bare base plan
    # (the JAX package's defect) has no change at all
    moved32 = a32 - base["ranks"]["f32"]
    moved16 = a16 - base["ranks"]["bf16"]
    moved_l1 = float(np.abs(moved32).sum())
    miss_l1 = float(np.abs(moved16 - moved32).sum())
    check(moved_l1 > 0 and miss_l1 < 0.5 * moved_l1,
          f"refresh bf16 did not move with the mutation: |bf16 change - "
          f"f32 change| {miss_l1} against |f32 change| {moved_l1}")
    to_base_l1 = float(np.abs(a16 - base["ranks"]["f32"]).sum())
    check(l1_16 < to_base_l1,
          f"refresh bf16 sits closer to the base snapshot's ranks (L1 "
          f"{to_base_l1}) than to the f32 delta run's (L1 {l1_16})")

    placement = {p: r.placement_s for p, r in runs.items()}
    first = state["diff_s"] + state["delta_build_s"]
    summary = {
        "n_delta": delta.n_delta, "changed_nodes": int(len(changed)),
        "delta": {"net_log2": delta.net_log2, "R_G": delta.R_G,
                  "C": delta.C},
        "mutate_s": mutate_s, "from_coo_s": from_coo_s,
        "from_coo_builder": "native", "to_device_s": to_device_s,
        "diff_s": state["diff_s"], "delta_build_s": state["delta_build_s"],
        "placement_s": placement,
        "placement_split": {p: r.route_split for p, r in runs.items()},
        "refresh_cold_s": {"f32": first + placement["f32"],
                           "bf16": placement["bf16"]},
        "base_plan_build_s": base["summary"]["plan_build_s"],
        "base_placement_s": base["summary"]["placement_s"],
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "warm_run_s": {"f32": warm32, "bf16": warm16},
        "cold_iteration_ms": {
            "f32": (cold32 - first - placement["f32"]) / ITERATIONS * 1e3,
            "bf16": (cold16 - placement["bf16"]) / ITERATIONS * 1e3},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "base_iteration_ms": {p: t / ITERATIONS * 1e3
                              for p, t in base_warm.items()},
        "base_iteration_ms_main_path": base["summary"]["iteration_ms"],
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": {"max_rel": rel, "l1": l1, "top100": top},
        "bf16_vs_f32": {"linf": linf16, "l1": l1_16,
                        f"top{k}_order": top_order},
        "bf16_moved": {"f32_change_l1": moved_l1,
                       "bf16_change_miss_l1": miss_l1,
                       "bf16_vs_base_f32_l1": to_base_l1}}
    print("refresh", json.dumps(summary), flush=True)

    shapes = {}
    for p, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        shapes[f"delta_{p}"] = route_kernels(
            f"delta_{p}", runs[p].routes["delta"], delta.masks_packed, dtype)
    return launches, shapes


# ---------------------------------------------------------------------------
# phases 6-8: katz on PageRank's routes, the segment backend, degree
# ---------------------------------------------------------------------------

KATZ_ALPHA = 0.05       # about 0.5 / λ, λ of the north star's Aᵀ (katz line)
KATZ_BETA = 1.0
SEGMENT_NODES, SEGMENT_EDGES = 100_000, 450_000
# HITS against a float64 run of the same steps, relative to the largest
# entry: the CPU rehearsal at this size reads 1.2e-7 (hubs) and 1.1e-8
# (authorities); the card sums in the same order (csr_spmm_sum);
# budgeted ~100x
HITS_TOL = 1e-5


def transposed_adjacency(src, dst, n_nodes):
    """Aᵀ as a float64 scipy matrix (row v: the edges into v)."""
    import scipy.sparse as sp
    return sp.csr_matrix((np.ones(len(src)), (dst, src)),
                         shape=(n_nodes, n_nodes))


def reference_katz(a_t, alpha, beta=KATZ_BETA, iterations=ITERATIONS):
    """float64 scipy run of x <- alpha Aᵀx + beta from zeros."""
    x = np.zeros(a_t.shape[0])
    for _ in range(iterations):
        x = alpha * (a_t @ x) + beta
    return x


def spectral_radius(a_t, iterations=100) -> float:
    """λ of Aᵀ by a float64 power iteration (||Aᵀx|| / ||x||): katz
    contracts for α λ < 1, and ``katz_rel`` holds for α λ <= 1/2."""
    n_nodes = a_t.shape[0]
    x = np.ones(n_nodes) / np.sqrt(n_nodes)
    lam = 0.0
    for _ in range(iterations):
        y = a_t @ x
        lam = float(np.linalg.norm(y))
        x = y / max(lam, 1e-300)
    return lam


def reference_hits(a_t, iterations=ITERATIONS):
    """float64 scipy run of HITS's steps (ops/katz.py:_hits_step): the
    authorities from the hubs, then the hubs from the new authorities,
    each L2-normalized, from ones."""
    a = a_t.T.tocsr()
    hub = np.ones(a_t.shape[0])
    auth = hub
    for _ in range(iterations):
        auth = a_t @ hub
        auth = auth / max(np.linalg.norm(auth), 1e-30)
        hub = a @ auth
        hub = hub / max(np.linalg.norm(hub), 1e-30)
    return hub, auth


def vs_float64(got, ref) -> dict:
    """max relative error, and the overlap of the top 100."""
    a = got.double().cpu().numpy()
    check(bool(np.isfinite(a).all()) and a.shape == ref.shape,
          "non-finite or misshaped centralities")
    return {"max_rel": float((np.abs(a - ref) / ref).max()),
            "top100": len(set(np.argsort(-a)[:100])
                          & set(np.argsort(-ref)[:100]))}


def timed_run(fn):
    """(fn's result, host seconds to the end of its device work)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_katz(base: dict):
    """Katz on the main path's placed graph, riding PageRank's plan and
    routes: no build_plan, no route placed, no stage kernel, the gathers
    of two nets an iteration; f32 against float64, bf16 against f32."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import spmv_mxu
    from memgraph_tpu_torch.ops.katz import katz_centrality
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph = base["graph"]
    state = graph._mxu_state
    real_build_plan, plan_builds = spmv_mxu.build_plan, []

    def counted_build_plan(*args, **kw):
        plan_builds.append(1)
        return real_build_plan(*args, **kw)

    def katz(precision):
        return timed_run(lambda: katz_centrality(
            graph, alpha=KATZ_ALPHA, beta=KATZ_BETA,
            max_iterations=ITERATIONS, tol=-1.0, precision=precision))

    spmv_mxu.build_plan = counted_build_plan
    try:
        # the katz path: counts set to 0 just before, read just after
        with placement_guard() as placed_nets:
            BC.reset_launch_counts()
            (k32, _, it32), cold32 = katz("f32")
            (k16, _, it16), cold16 = katz("bf16")
            (_, _, it32w), warm32 = katz("f32")
            (_, _, it16w), warm16 = katz("bf16")
            launches = counts()
    finally:
        spmv_mxu.build_plan = real_build_plan
    # PageRank in the same minute (not counted)
    pr_warm = {p: timed_run(lambda p=p: pagerank(
        graph, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0,
        precision=p))[1] for p in ("f32", "bf16")}

    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) for "
                           "katz on a planned graph")
    check(not placed_nets, f"katz placed routes {placed_nets}")
    check(it32 == it16 == it32w == it16w == ITERATIONS,
          f"katz iterations {it32}/{it16}/{it32w}/{it16w} != {ITERATIONS}")
    per_run = {"benes_mid": 0, "benes_mid_gather": 2 * ITERATIONS,
               "benes_outer": 0, "benes_outer_gather": 4 * ITERATIONS}
    expected = {k: 4 * v for k, v in per_run.items()}
    check(launches == expected,
          f"katz launch counts {launches} != expected {expected} (4 runs)")
    cache = state["semiring"]
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for (_, dev, dt), placed in cache["placed"].items():
        shared = state["placed"][(dev, dt)]
        check(placed["shares"] is shared
              and all(placed[r] is shared[r] for r in ("edge", "node")),
              f"katz {precisions[dt]} does not ride PageRank's routes")

    a_t = transposed_adjacency(base["src"], base["dst"], graph.n_nodes)
    f32 = vs_float64(k32, reference_katz(a_t, KATZ_ALPHA))
    check(f32["max_rel"] <= F32_REL_TOL and f32["top100"] == 100,
          f"katz f32 off the float64 reference: {f32}")
    # katz_rel is derived for α λ <= 1/2 (ops/semiring.py)
    lam = spectral_radius(a_t)
    check(KATZ_ALPHA * lam <= 0.5,
          f"α λ = {KATZ_ALPHA * lam} > 1/2: katz_rel does not hold there")
    bound = PRECISION_BOUNDS["bf16"]["katz_rel"]
    rel16 = float(((k16 - k32).abs() / k32).max())
    check(rel16 <= bound, f"katz bf16 off f32 by {rel16} > {bound}")
    summary = {
        "alpha": KATZ_ALPHA, "beta": KATZ_BETA, "iterations": ITERATIONS,
        "lambda": lam, "alpha_lambda": KATZ_ALPHA * lam,
        "plan_builds": len(plan_builds), "routes_placed": len(placed_nets),
        "derive_s": cache["plan_s"][False],
        "placement_s": {precisions[dt]: p["placement_s"]
                        for (_, _, dt), p in cache["placed"].items()},
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "pagerank_iteration_ms": {p: t / ITERATIONS * 1e3
                                  for p, t in pr_warm.items()},
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": f32, "bf16_vs_f32": {"max_rel": rel16,
                                           "bound": bound}}
    print("katz", json.dumps(summary), flush=True)
    return launches


def degree_line(label, graph, src, dst) -> dict:
    """Degree centrality in each direction, bit-equal to numpy's float32
    counts over n - 1; with its device time."""
    import torch
    from memgraph_tpu_torch.ops.katz import degree_centrality
    n = graph.n_nodes
    plain = {"in": np.bincount(dst, minlength=n),
             "out": np.bincount(src, minlength=n)}
    plain["total"] = plain["in"] + plain["out"]
    out = {}
    for direction, count in plain.items():
        got = degree_centrality(graph, direction)
        want = torch.from_numpy(count.astype(np.float32)
                                / np.float32(max(n - 1, 1)))
        check(got.dtype == torch.float32
              and torch.equal(got.cpu().view(torch.int32),
                              want.view(torch.int32)),
              f"degree_centrality {direction} on the {label} graph is not "
              "numpy's")
        out[direction] = cuda_ms(lambda d=direction: degree_centrality(
            graph, d), 10)
    return {"graph": label, "ms": out, "bit_equal": True}


def phase_segment(base: dict):
    """The segment backend on the card: PageRank, katz and HITS on a graph
    under MXU_MIN_EDGES, against float64; degree centrality on it and on
    the north star."""
    import torch
    from memgraph_tpu_torch.northstar import generate_graph
    from memgraph_tpu_torch.ops import semiring as S
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.katz import hits, katz_centrality
    from memgraph_tpu_torch.ops.pagerank import pagerank

    n = SEGMENT_NODES
    src, dst = generate_graph(n_nodes=n, n_edges=SEGMENT_EDGES)
    check(SEGMENT_EDGES < S.MXU_MIN_EDGES,
          "the segment graph is not under MXU_MIN_EDGES")
    graph = from_coo(src, dst, n_nodes=n).to_device("cuda")
    runs = {}
    # the segment path: counts set to 0 just before, read just after
    reset_all_counts()
    for name, fn in (
            ("pagerank", lambda: pagerank(graph, damping=DAMPING,
                                          max_iterations=ITERATIONS,
                                          tol=0.0)),
            ("katz", lambda: katz_centrality(graph, alpha=KATZ_ALPHA,
                                             max_iterations=ITERATIONS,
                                             tol=-1.0)),
            ("hits", lambda: hits(graph, max_iterations=ITERATIONS,
                                  tol=-1.0))):
        first, cold = timed_run(fn)
        out, warm = timed_run(fn)
        check(out[-1] == ITERATIONS, f"segment {name} ran {out[-1]} "
                                     f"iterations, not {ITERATIONS}")
        vectors = [v for v in out if isinstance(v, torch.Tensor)]
        check(all(same_bits(a, b) for a, b in zip(
            [v for v in first if isinstance(v, torch.Tensor)], vectors)),
              f"two segment {name} runs are not bit-equal")
        runs[name] = (out, cold, warm)
    launches = all_counts()
    check(getattr(graph, "_mxu_state", None) is None,
          "the segment graph took the MXU plan")
    # an iteration: one run sum (two for HITS); PageRank's setup one more
    expected = {"csr_spmm_sum": 2 * ((ITERATIONS + 1) + ITERATIONS
                                     + 2 * ITERATIONS),
                "lane_sum": 0}
    check({k: launches[k] for k in expected} == expected,
          f"segment launch counts {launches} != expected {expected}")

    pr = vs_float64(runs["pagerank"][0][0],
                    reference_pagerank(src, dst, n))
    a_t = transposed_adjacency(src, dst, n)
    kz = vs_float64(runs["katz"][0][0], reference_katz(a_t, KATZ_ALPHA))
    for name, got in (("pagerank", pr), ("katz", kz)):
        check(got["max_rel"] <= F32_REL_TOL and got["top100"] == 100,
              f"segment {name} off the float64 reference: {got}")
    hub64, auth64 = reference_hits(a_t)
    hub, auth = (v.double().cpu().numpy() for v in runs["hits"][0][:2])
    hits_err = {"hub": float(np.abs(hub - hub64).max() / hub64.max()),
                "auth": float(np.abs(auth - auth64).max() / auth64.max())}
    check(max(hits_err.values()) <= HITS_TOL,
          f"segment HITS off the float64 steps: {hits_err} > {HITS_TOL}")
    lam = spectral_radius(a_t)
    summary = {
        "n_nodes": n, "n_edges": SEGMENT_EDGES, "iterations": ITERATIONS,
        "katz_alpha_lambda": KATZ_ALPHA * lam,
        "cold_run_s": {k: v[1] for k, v in runs.items()},
        "iteration_ms": {k: v[2] / ITERATIONS * 1e3
                         for k, v in runs.items()},
        "pagerank_vs_f64": pr, "katz_vs_f64": kz,
        "hits_vs_f64": hits_err, "hits_tol": HITS_TOL,
        "reruns_bit_equal": True, "launches": launches,
        "expected_launches": expected}
    print("segment", json.dumps(summary), flush=True)
    for label, g, s, d in (("segment", graph, src, dst),
                           ("north_star", base["graph"], base["src"],
                            base["dst"])):
        print("degree", json.dumps(degree_line(label, g, s, d)), flush=True)
    del graph
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 9-11: the deterministic segment sums, PPR, components and traversal
# ---------------------------------------------------------------------------

SEG_LANES = (1, 3, 32)
SEGMENT_REPLACES = ("no pallas_call: port's own; the JAX package's sorted "
                    "jax.ops.segment_sum, memgraph_tpu/ops/semiring.py:182")
PPR_TOL = 1e-6
PPR_MAX_ITERATIONS = 100
PPR_LANES = 32
PPR_SEED = 13
# single PPR against float64 after ITERATIONS fixed iterations, relative
# to the largest entry: f32 rounding as for PageRank's 1e-4 (F32_REL_TOL)
PPR_REL_TOL = 1e-4
PPR_TOPK = 100
SSSP_SEED = 17
# Bellman-Ford in f32 against float64 Dijkstra: a path of h hops carries
# h f32 roundings (2^-24 relative each, h ~ 10-20 here); budgeted ~10x
SSSP_REL_TOL = 1e-5
MSSP_SOURCES = 8
KHOP_K = 2


def seg_counts() -> dict:
    from memgraph_tpu_torch.ops import segment_cuda as SC
    return {"csr_spmm_sum": SC.csr_spmm_sum.launches,
            "lane_sum": SC.lane_sum.launches}


def reset_all_counts():
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import segment_cuda as SC
    BC.reset_launch_counts()
    SC.reset_launch_counts()


def all_counts() -> dict:
    return {**counts(), **seg_counts()}


# The previous designs' kernel times (a thread a run for K1, a launch a
# level for K2; PERF.md §6, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's at the shapes they were measured at: (runs, precision,
# lanes) for K1, lanes for K2 (dot form)
PREVIOUS_K1_MS = {("csc", "f32", 1): 0.817, ("csc", "bf16", 1): 0.941,
              ("csc", "f32", 3): 0.740, ("csc", "f32", 32): 1.091,
              ("csc", "bf16", 32): 1.255, ("csr", "f32", 1): 0.106,
              ("csr", "bf16", 1): 0.106, ("csr", "f32", 3): 0.122,
              ("csr", "f32", 32): 0.819}
PREVIOUS_K2_MS = {1: 0.0254, 3: 0.0326, 32: 0.1257}


def spmm_bytes(n_edges: int, n_seg: int, lanes: int, x_rows: int,
               index_bytes: int = 4, weight_bytes: int = 4,
               ptr_bytes: int = 4) -> int:
    """K1's bytes: each edge's index and weight, the B values of each row
    of x that a run reads, each read once (``x_rows``: the distinct
    gathered rows, or the edges with no gather), the run offsets, and the
    output written once."""
    return n_edges * (index_bytes + weight_bytes) + x_rows * lanes * 4 \
        + (n_seg + 1) * ptr_bytes + n_seg * lanes * 4


def segment_kernel_line(label, x, ptr, g, w, precision, n_in, longest,
                        mul="times") -> dict:
    """K1 on the card against its plain version on CPU copies, column by
    column against its 1-lane call, and against a second launch, given
    the longest run as the main path gives it (``longest``: a graph's
    ``longest_csc_run`` / ``longest_csr_run``); timed, with the plain
    version on the card and the library calls: a
    ``torch.sparse_csr_tensor`` product (gathered, f32) and ``index_add_``
    of the precomputed contributions.  Where no run is long, the launch
    with the longest run unknown (the two-role kernel) is held to the
    same bits and timed beside it (``two_role_ms``)."""
    import torch
    from memgraph_tpu_torch.ops import segment_cuda as SC
    lanes = x.shape[1]

    def k1(xx=x, longest=longest):
        return SC.csr_spmm_sum(xx, ptr, g, w, mul=mul, precision=precision,
                               longest=longest)

    def cpu(t):
        return None if t is None else t.cpu()

    got = k1()
    again = k1()
    want = SC.csr_spmm_sum_reference(x.cpu(), ptr.cpu(), cpu(g), cpu(w),
                                     mul=mul, precision=precision)
    what = f"csr_spmm_sum {label} {mul} {precision} B={lanes}"
    check(same_bits(got.cpu(), want),
          f"{what} is not its plain version's bits")
    check(same_bits(got, again), f"{what}: two launches differ")
    col = k1(x[:, lanes - 1].contiguous())
    check(same_bits(col, got[:, lanes - 1].contiguous()),
          f"{what}: a column alone is not its bits inside {lanes} lanes")
    n_seg = ptr.numel() - 1
    longest_run = int((ptr[1:] - ptr[:-1]).max()) if n_seg else 0
    check(longest == longest_run,
          f"{what}: given longest run {longest}, has {longest_run}")
    lo, hi = int(ptr[0]), int(ptr[-1])
    n_edges = hi - lo
    x_rows = n_edges if g is None else int(torch.unique(g[lo:hi]).numel())
    t, by = bound_ms(spmm_bytes(
        n_edges, n_seg, lanes, x_rows,
        index_bytes=0 if g is None else g.element_size(),
        weight_bytes=0 if w is None else 4, ptr_bytes=ptr.element_size()),
        (2.0 if mul == "times" else 1.0) * n_edges * lanes)
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=x.device), (ptr[1:] - ptr[:-1]).long())
    vals = x[lo:hi] if g is None else x[g[lo:hi]]
    if w is not None:
        vals = vals * w[lo:hi].unsqueeze(1)
    index_add_ms = cuda_ms(lambda: torch.zeros(
        n_seg, lanes, device=x.device).index_add_(0, ids, vals), 5)
    line = {
        "runs": label, "mul": mul, "precision": precision, "lanes": lanes,
        "ptr": str(ptr.dtype).replace("torch.", ""),
        "g": None if g is None else str(g.dtype).replace("torch.", ""),
        "n_seg": n_seg, "n_edges": n_edges, "x_rows": x_rows,
        "longest_run": longest_run,
        "bit_equal": True, "lanes_independent": True, "rerun_equal": True,
        "max_abs_err": 0.0,
        "ms": device_ms(k1, 10),
        "previous_ms": PREVIOUS_K1_MS.get((label, precision, lanes)),
        "plain_ms": cuda_ms(lambda: SC.csr_spmm_sum_reference(
            x, ptr, g, w, mul=mul, precision=precision), 3),
        "bound_ms": t, "bound_by": by,
        "index_add_ms": index_add_ms}
    if longest <= SC.long_run():
        check(same_bits(k1(longest=None), got),
              f"{what}: the two-role launch is not the short one's bits")
        line["two_role_ms"] = device_ms(lambda: k1(longest=None), 10)
    if g is not None and w is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # torch's beta-state notices
            mat = torch.sparse_csr_tensor(
                (ptr - lo).contiguous(), g[lo:hi].contiguous(),
                w[lo:hi].contiguous(), size=(n_seg, n_in))
        line["library_ms"] = cuda_ms(lambda: mat @ x, 5)
        line["library"] = "torch.sparse_csr_tensor(ptr, g, w) @ x (f32)"
    else:
        line["library_ms"] = index_add_ms
        line["library"] = "index_add_ of the contributions"
    return line


def lane_sum_line(a, m) -> dict:
    """K2 in each form against its plain version, and B-independence."""
    import torch
    from memgraph_tpu_torch.ops import segment_cuda as SC
    lanes = a.shape[1]
    b = a.flip(0).contiguous()
    forms = {"sum": {}, "dot": {"m": m}, "l1": {"b": b}}
    for form, kw in forms.items():
        got = SC.lane_sum(a, **kw)
        want = SC.lane_sum_reference(a.cpu(), **{k: v.cpu()
                                                 for k, v in kw.items()})
        check(same_bits(got.cpu(), want),
              f"lane_sum {form} B={lanes} is not its plain version's bits")
        check(same_bits(got, SC.lane_sum(a, **kw)),
              f"lane_sum {form} B={lanes}: two launches differ")
        one = SC.lane_sum(a[:, -1].contiguous(),
                          **{k: (v[:, -1].contiguous() if k == "b" else v)
                             for k, v in kw.items()})
        check(same_bits(one.view(1), got[-1:]),
              f"lane_sum {form}: a column alone is not its bits inside "
              f"{lanes} lanes")
    n = a.shape[0]
    t, by = bound_ms(n * lanes * 4 + n * 4 + lanes * 4, 2.0 * n * lanes)
    return {"lanes": lanes, "rows": n, "bit_equal": True,
            "lanes_independent": True, "max_abs_err": 0.0,
            "ms": device_ms(lambda: SC.lane_sum(a, m=m), 20),
            "previous_ms": PREVIOUS_K2_MS.get(lanes),
            "plain_ms": cuda_ms(lambda: SC.lane_sum_reference(a, m=m), 5),
            "bound_ms": t, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.sum(a * m.unsqueeze(1),
                                                    dim=0), 20),
            "library": "torch.sum(a * m[:, None], dim=0)",
            "at": "dot form (the dangling mass)"}


def straddle_lengths(n_runs: int, seed: int) -> np.ndarray:
    """Run lengths around K1's short/long bound T (T - 1, T, T + 1, 2T,
    32T + 1), mixed with empty runs."""
    from memgraph_tpu_torch.ops.segment_cuda import long_run
    T = long_run()
    rng = np.random.default_rng(seed)
    return rng.choice([0, 0, T - 1, T, T + 1, 2 * T, 32 * T + 1], n_runs)


def star_lengths() -> np.ndarray:
    """A star into one node, 2^20 + 5 in-edges, between short runs."""
    return np.array([0, 3, 2**20 + 5, 0, 7, 1])


def phase_segment_kernels(base: dict):
    """K1 and K2 on the north star against their plain versions: CSC runs
    (the pull matvec) and CSR runs (the reversed one), f32 and bf16, 1, 3
    and 32 lanes; then K1 where its design can break: run lengths
    straddling the short/long bound, one run of 2^20 + 5, the no-gather
    form (``g=None``, ⊗ = first, as ``semiring._float_sum`` launches it)
    and int64 offsets and indices.  Bit-equal, lane-independent,
    rerun-equal; timed."""
    import torch
    graph = base["graph"]
    rng = np.random.default_rng(PPR_SEED)
    k1 = []
    for lanes in SEG_LANES:
        x = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).cuda()
        for label, ptr, g, w, longest in (
                ("csc", graph.csc_runs(), graph.csc_src, graph.csc_weights,
                 graph.longest_csc_run),
                ("csr", graph.row_ptr, graph.col_idx, graph.weights,
                 graph.longest_csr_run)):
            for precision in ("f32", "bf16"):
                line = segment_kernel_line(label, x, ptr, g, w, precision,
                                           graph.n_pad, longest)
                print("segment_kernels", json.dumps(line), flush=True)
                k1.append(line)
    k2 = []
    m = torch.from_numpy((rng.random(graph.n_pad) < 0.1).astype(
        np.float32)).cuda()
    for lanes in SEG_LANES:
        a = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).cuda()
        line = lane_sum_line(a, m)
        print("segment_kernels", json.dumps({"lane_sum": line}), flush=True)
        k2.append(line)

    def shape(label, x, ptr, g, w, lanes_list, longest, precisions=("f32",),
              mul="times", n_in=graph.n_pad):
        for lanes in lanes_list:
            xl = x[:, :lanes].contiguous()
            for precision in precisions:
                line = segment_kernel_line(label, xl, ptr, g, w, precision,
                                           n_in, longest, mul=mul)
                print("segment_kernels", json.dumps(line), flush=True)
                k1.append(line)

    rng = np.random.default_rng(PPR_SEED + 1)
    x = torch.from_numpy(rng.random((graph.n_pad, max(SEG_LANES)),
                                    dtype=np.float32)).cuda()
    csc = graph.csc_runs()
    shape("csc_int64", x, csc.long(), graph.csc_src.long(),
          graph.csc_weights, (1, 3), graph.longest_csc_run)
    edges = int(csc[-1])
    per_edge = torch.from_numpy(rng.random((edges, 3),
                                           dtype=np.float32)).cuda()
    shape("csc_no_gather", per_edge, csc, None, None, (1, 3),
          graph.longest_csc_run, mul="first", n_in=edges)
    del per_edge
    for label, lengths in (("straddle", straddle_lengths(2**13, 5)),
                           ("star", star_lengths())):
        ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               .astype(np.int32)).cuda()
        n = int(ptr[-1])
        g = torch.from_numpy(rng.integers(0, graph.n_pad, n)
                             .astype(np.int32)).cuda()
        w = torch.from_numpy(rng.random(n, dtype=np.float32)).cuda()
        shape(label, x, ptr, g, w, SEG_LANES, int(lengths.max()),
              precisions=("f32", "bf16"))
    return {"csr_spmm_sum": k1, "lane_sum": k2}


def segment_kernel_entries(lines: dict, mxu: dict, by_path: dict) -> list:
    """K1's and K2's entries of the {"kernels": [...]} line: numbers at
    the single PPR's shape (CSC runs, f32, one lane), every shape under
    shapes; launches those of the PPR path, by path beside them."""
    out = []
    for name, at in (("csr_spmm_sum", {"runs": "csc", "precision": "f32",
                                       "lanes": 1}),
                     ("lane_sum", {"lanes": 1})):
        shapes = lines[name]
        main = next(ln for ln in shapes
                    if all(ln[k] == v for k, v in at.items()))
        out.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/segment.cu",
            "replaces": SEGMENT_REPLACES,
            "launches": by_path["ppr"][name],
            "launches_by_path": {**{p: c[name] for p, c in mxu.items()},
                                 **{p: c[name] for p, c in by_path.items()}},
            "max_abs_err": max(ln["max_abs_err"] for ln in shapes),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": at,
            # measured in this run only: the previous design's times stay
            # on the segment_kernels lines
            "shapes": [{k: v for k, v in ln.items() if k != "previous_ms"}
                       for ln in shapes]})
    return out


def reference_ppr(src, dst, n_nodes, sources, iterations=ITERATIONS,
                  damping=DAMPING):
    """float64 scipy power iteration of PPR (ops/pagerank.py's update)
    from the normalized restart vector."""
    import scipy.sparse as sp
    deg = np.bincount(src, minlength=n_nodes).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    mat = sp.csr_matrix((inv_deg[src], (dst, src)),
                        shape=(n_nodes, n_nodes))
    dangling = deg == 0
    p = np.zeros(n_nodes)
    p[np.asarray(sources)] = 1.0
    p /= p.sum()
    x = p.copy()
    for _ in range(iterations):
        x = (1 - damping) * p + damping * (mat @ x + x[dangling].sum() * p)
    return x


def phase_ppr(base: dict):
    """PPR on the north star: single against float64, a 32-lane batch
    with lanes bit-equal to sequential runs, a 3-lane batch, bf16 within
    bounds, a warm start, top-k; K1/K2 launches against their counts."""
    import torch
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    rng = np.random.default_rng(PPR_SEED)
    single_sources = rng.choice(n, 3, replace=False)
    sets = [rng.choice(n, int(rng.integers(1, 6)), replace=False)
            for _ in range(PPR_LANES)]
    seq_lanes = (0, 7, 19, PPR_LANES - 1)
    expected = {"csr_spmm_sum": 0, "lane_sum": 0}

    def ran(iterations: int):
        # setup: the CSR weight sums (K1) and the restart norms (K2);
        # an iteration: the matvec (K1), dangling mass and L1 error (K2)
        expected["csr_spmm_sum"] += 1 + iterations
        expected["lane_sum"] += 1 + 2 * iterations

    def single(sources, **kw):
        out, s = timed_run(lambda: PR.personalized_pagerank(
            graph, sources, damping=DAMPING, **kw))
        ran(out[2])
        return out, s

    def batch(lane_sets, raw=True, **kw):
        # the loop runs until its slowest lane stops: max(iters)
        out, s = timed_run(lambda: PR.personalized_pagerank_batch(
            graph, lane_sets, damping=DAMPING, raw=raw, **kw))
        ran(int(out[2].max()))
        return out, s

    # the PPR path: counts set to 0 just before, read just after
    reset_all_counts()
    (r1, _, it1), s1 = single(single_sources, max_iterations=ITERATIONS,
                              tol=-1.0)
    (_, _, it1w), s1w = single(single_sources, max_iterations=ITERATIONS,
                               tol=-1.0)
    (xb, eb, ib), sb = batch(sets, tol=PPR_TOL,
                             max_iterations=PPR_MAX_ITERATIONS)
    seq = {lane: single(sets[lane], tol=PPR_TOL,
                        max_iterations=PPR_MAX_ITERATIONS)[0]
           for lane in seq_lanes}
    (x3, e3, i3), _ = batch(sets[:3], tol=PPR_TOL,
                            max_iterations=PPR_MAX_ITERATIONS)
    (r3, _, _), _ = batch(sets[:3], raw=False, tol=PPR_TOL,
                          max_iterations=PPR_MAX_ITERATIONS)
    (x16, _, i16), _ = batch(sets[:3], tol=PPR_TOL,
                             max_iterations=PPR_MAX_ITERATIONS,
                             precision="bf16")
    (xw, _, iw), _ = batch(sets, tol=PPR_TOL,
                           max_iterations=PPR_MAX_ITERATIONS,
                           x0=xb.cpu().numpy())
    (xt, _, it_t), st = batch(sets, tol=-1.0, max_iterations=ITERATIONS)
    # a dangling source keeps its mass: every other entry ties at 0
    dangling = int(rng.choice(np.flatnonzero(
        np.bincount(src, minlength=n) == 0)))
    (rd, _, _), _ = single([dangling], tol=PPR_TOL,
                           max_iterations=PPR_MAX_ITERATIONS)
    lanes_k = torch.cat([xb[:n].T, rd.unsqueeze(0)])
    (vals, idx) = PR.ppr_topk(lanes_k, n, PPR_TOPK, raw=True)
    torch.cuda.synchronize()
    launches = all_counts()

    check(launches["csr_spmm_sum"] > 0 and launches["lane_sum"] > 0,
          f"the PPR path launched no segment kernel: {launches}")
    check({k: launches[k] for k in expected} == expected,
          f"PPR launch counts {launches} != expected {expected}")
    check(it1 == it1w == ITERATIONS and int(it_t.max()) == ITERATIONS,
          f"fixed-length PPR ran {it1}/{it1w}/{it_t.max()} iterations")

    a = r1.double().cpu().numpy()
    ref = reference_ppr(src, dst, n, single_sources)
    check(bool(np.isfinite(a).all()) and a.shape == (n,),
          "non-finite or misshaped PPR ranks")
    rel = float(np.abs(a - ref).max() / ref.max())
    top = len(set(np.argsort(-a)[:PPR_TOPK])
              & set(np.argsort(-ref)[:PPR_TOPK]))
    check(rel <= PPR_REL_TOL and top == PPR_TOPK,
          f"PPR off float64: max err {rel} of the largest entry, top-"
          f"{PPR_TOPK} {top}")

    ranks = xb[:n].T.cpu()
    iters = ib.cpu().numpy()
    check(bool(torch.isfinite(ranks).all()) and bool((iters >= 1).all()),
          "non-finite batch ranks or a lane that never ran")
    for lane, (r, _, it) in seq.items():
        check(same_bits(r.cpu().contiguous(), ranks[lane].contiguous())
              and it == int(iters[lane]),
              f"batch lane {lane} is not the sequential run: iters "
              f"{iters[lane]} against {it}")
    check(x3.shape[1] == 4 and tuple(i3.shape) == (4,),
          f"3 lanes ran as {x3.shape[1]}, not the bucket of 4")
    check(r3.shape == (3, n) and same_bits(
        torch.from_numpy(r3), ranks[:3].contiguous()),
          "the 3-lane batch is not the 32-lane batch's first lanes")
    bounds = PRECISION_BOUNDS["bf16"]
    d16 = (x16[:n, :3] - x3[:n, :3]).abs()
    linf16 = float(d16.max())
    l1_16 = float(d16.sum(dim=0).max())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"],
          f"bf16 PPR outside PRECISION_BOUNDS: linf {linf16} l1 {l1_16}")
    warm_iters = int(iw.max())
    check(warm_iters <= 2, f"warm start took {warm_iters} iterations")
    want_vals, _ = torch.sort(lanes_k, dim=1, descending=True)
    vals_h, idx_h = vals.cpu(), idx.cpu().long()
    check(same_bits(vals_h, want_vals[:, :PPR_TOPK].cpu().contiguous())
          and same_bits(torch.gather(lanes_k.cpu(), 1, idx_h), vals_h),
          "ppr_topk is not the sorted full vector")
    ties = (vals_h[:, 1:] == vals_h[:, :-1])
    check(bool((idx_h[:, 1:] > idx_h[:, :-1])[ties].all()),
          "ppr_topk broke a tie toward the higher index")
    summary = {
        "n_nodes": n, "n_edges": graph.n_edges, "damping": DAMPING,
        "single": {"sources": single_sources.tolist(),
                   "iterations": ITERATIONS, "cold_s": s1,
                   "iteration_ms": s1w / ITERATIONS * 1e3,
                   "max_err_of_largest": rel, "top100": top},
        "batch": {"lanes": PPR_LANES, "tol": PPR_TOL,
                  "iters_min_max": [int(iters.min()), int(iters.max())],
                  "run_s": sb, "sequential_bit_equal": list(seq_lanes),
                  "fixed_iteration_ms": st / ITERATIONS * 1e3,
                  "warm_iters_max": warm_iters,
                  "bf16_vs_f32": {"linf": linf16, "l1": l1_16},
                  "topk": PPR_TOPK, "topk_ties": int(ties.sum()),
                  "topk_dangling_source": dangling},
        "launches": launches, "expected_launches": expected}
    print("ppr", json.dumps(summary), flush=True)
    return launches


def min_index_labels(labels) -> np.ndarray:
    """Each node's label replaced by the minimum node index of its class."""
    n = len(labels)
    mins = np.full(int(labels.max()) + 1, n, dtype=np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    return mins[labels].astype(np.int32)


def dedup_min(src, dst, w):
    """(src, dst, w) with one edge a (src, dst) pair, its least weight:
    a scipy matrix would sum parallel edges."""
    order = np.lexsort((w, dst, src))
    s, d, ww = src[order], dst[order], w[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    return s[first], d[first], ww[first]


def phase_traversal(base: dict):
    """WCC, SCC, SSSP, direction-optimizing BFS, multi-source SSSP and
    k-hop on the north star against scipy.sparse.csgraph."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    import torch
    from memgraph_tpu_torch.ops import components as C
    from memgraph_tpu_torch.ops import traversal as T
    from memgraph_tpu_torch.ops.csr import from_coo

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    rng = np.random.default_rng(SSSP_SEED)
    weights = rng.uniform(0.5, 1.5, len(src)).astype(np.float32)
    wgraph = from_coo(src, dst, weights, n_nodes=n).to_device("cuda")
    out_deg = np.bincount(src, minlength=n)
    source = int(rng.choice(np.flatnonzero(out_deg > 0)))
    sources = rng.choice(n, MSSP_SOURCES, replace=False)
    scc_stats = {}
    secs = {}

    def call(name, fn):
        out, secs[name] = timed_run(fn)
        return out

    # the traversal path: counts set to 0 just before, read just after
    reset_all_counts()
    T.do_bfs.levels.update(push=0, pull=0)
    comp, wcc_iters = call("wcc", lambda: C.weakly_connected_components(
        graph))
    scc = call("scc", lambda: C.strongly_connected_components(
        graph, stats=scc_stats))
    dist, sssp_iters = call("sssp", lambda: T.sssp(wgraph, source))
    levels, bfs_iters = call("bfs_levels", lambda: T.bfs_levels(
        graph, source))
    mssp = call("multi_source_sssp", lambda: T.multi_source_sssp(
        graph, sources, weighted=False))
    khop = call("khop_neighborhood", lambda: T.khop_neighborhood(
        graph, sources[:4], KHOP_K))
    launches = all_counts()
    bfs_split = dict(T.do_bfs.levels)

    adj = sp.csr_matrix((np.ones(len(src), dtype=np.int8), (src, dst)),
                        shape=(n, n))
    _, weak = csgraph.connected_components(adj, directed=True,
                                           connection="weak")
    check(np.array_equal(comp, min_index_labels(weak)),
          "WCC labels are not scipy's components by their minimum index")
    _, strong = csgraph.connected_components(adj, directed=True,
                                             connection="strong")
    check(np.array_equal(scc, min_index_labels(strong)),
          "SCC labels are not scipy's components by their minimum index")

    s_, d_, w_ = dedup_min(src, dst, weights)
    wadj = sp.csr_matrix((w_.astype(np.float64), (s_, d_)), shape=(n, n))
    ref = csgraph.dijkstra(wadj, indices=source)
    got = dist.double().cpu().numpy()
    reach = np.isfinite(ref)
    check(np.array_equal(np.isfinite(got), reach),
          "SSSP's unreachable set is not Dijkstra's")
    pos = reach & (ref > 0)
    sssp_rel = float((np.abs(got[pos] - ref[pos]) / ref[pos]).max())
    check(sssp_rel <= SSSP_REL_TOL and got[source] == 0.0,
          f"SSSP off Dijkstra by {sssp_rel} > {SSSP_REL_TOL}")

    hops = csgraph.shortest_path(adj, unweighted=True,
                                 indices=np.concatenate([[source], sources]))
    want_levels = np.where(np.isinf(hops[0]), -1, hops[0]).astype(np.int32)
    check(np.array_equal(levels.cpu().numpy(), want_levels),
          "BFS levels are not the unweighted shortest paths")
    check(bfs_split["push"] > 0 and bfs_split["pull"] > 0,
          f"BFS did not run both push and pull levels: {bfs_split}")
    got_m = mssp.double().cpu().numpy()
    check(got_m.shape == (MSSP_SOURCES, n)
          and np.array_equal(got_m, hops[1:]),
          "multi_source_sssp is not the unweighted shortest paths")
    sym = (adj + adj.T).tocsr()
    near = csgraph.dijkstra(sym, unweighted=True, indices=sources[:4],
                            limit=KHOP_K + 0.5)
    check(np.array_equal(khop.cpu().numpy(), (near <= KHOP_K).any(axis=0)),
          "khop_neighborhood is not the k-hop set")
    summary = {
        "n_nodes": n, "n_edges": graph.n_edges,
        "wcc": {"components": int(weak.max()) + 1, "iterations": wcc_iters},
        "scc": {"components": int(strong.max()) + 1,
                "rounds": scc_stats["rounds"]},
        "sssp": {"source": source, "iterations": sssp_iters,
                 "reached": int(reach.sum()), "max_rel": sssp_rel},
        "bfs": {"iterations": bfs_iters, "levels": bfs_split},
        "multi_source_sssp": {"sources": MSSP_SOURCES},
        "khop": {"k": KHOP_K, "sources": 4, "reached": int(khop.sum())},
        "seconds": secs, "launches": launches}
    print("traversal", json.dumps(summary), flush=True)
    del wgraph
    torch.cuda.empty_cache()
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import segment_cuda as SC
    from memgraph_tpu_torch.ops._build import load_kernels
    from memgraph_tpu_torch.ops.native import get_csr_builder, get_router

    card = card_line()
    print("card", card, flush=True)
    t0 = time.perf_counter()
    load_kernels()
    check(get_router() is not None, "host Benes router did not build")
    check(get_csr_builder() is not None, "native CSR builder did not build")
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"phase_s {name} {time.perf_counter() - t0:.3f}", flush=True)
        return out

    timed("benes", phase_benes)
    micro_launches, micro_lines = timed("micro", phase_micro, sm_clock_hz())
    # the segment kernels' counts over the MXU paths too (they stay 0)
    seg_before = {}

    def mxu_path(name, phase, *args):
        SC.reset_launch_counts()
        out = timed(name, phase, *args)
        seg_before[name] = seg_counts()
        return out

    launches, shapes, base = mxu_path("main_path", phase_main_path)
    katz_launches = mxu_path("katz", phase_katz, base)
    refresh_launches, refresh_shapes = mxu_path("refresh", phase_refresh,
                                                base)
    seg_lines = timed("segment_kernels", phase_segment_kernels, base)
    by_path = {"segment": timed("segment", phase_segment, base),
               "ppr": timed("ppr", phase_ppr, base),
               "traversal": timed("traversal", phase_traversal, base)}
    del base

    replaces = {"benes_mid_gather": "memgraph_tpu/ops/benes_pallas.py:225",
                "benes_mid": "memgraph_tpu/ops/benes_pallas.py:225",
                "benes_outer_gather": "memgraph_tpu/ops/benes_pallas.py:208",
                "benes_outer": "memgraph_tpu/ops/benes_pallas.py:208"}
    roles = {"benes_mid_gather": "middle pass, once per routed net an "
                                 "iteration (2 on the main path, 3 on a "
                                 "refresh)",
             "benes_mid": "placement: composes the middle stages into "
                          "mid_idx, once per network and placement",
             "benes_outer_gather": "outer passes, two per net past one "
                                   "tile an iteration (4 on the main "
                                   "path, 6 on a refresh)",
             "benes_outer": "placement: composes each outer side into "
                            "outer_idx, twice per network and placement"}
    check(refresh_launches["benes_mid_gather"] > 0
          and refresh_launches["benes_outer_gather"] > 0,
          f"the refresh path launched no gather: {refresh_launches}")
    shapes.update(refresh_shapes)
    kernels = []
    for name in ("benes_mid_gather", "benes_mid", "benes_outer_gather",
                 "benes_outer"):
        main = shapes["edge_f32"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/benes.cu",
            "replaces": replaces[name], "role": roles[name],
            "launches": launches[name],
            "launches_by_path": {"main_path": launches[name],
                                 "katz": katz_launches[name],
                                 "refresh": refresh_launches[name],
                                 **{p: c[name] for p, c in by_path.items()}},
            "max_abs_err": max(s[name]["max_abs_err"]
                               for s in shapes.values() if name in s),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "at": "edge net, f32",
            "shapes": {k: s[name] for k, s in shapes.items() if name in s}})
    kernels += micro_kernel_entries(micro_launches, micro_lines)
    check(all(c == dict.fromkeys(c, 0) for c in seg_before.values()),
          f"a segment kernel ran on an MXU path: {seg_before}")
    kernels += segment_kernel_entries(seg_lines, seg_before, by_path)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
