"""Gathers and streaming bandwidth: the port of benchmarks/pallas_micro.py.

Measures, on the card:
  1. column gather  out[s, l] = tab[idx[s, l], l]  on (R, 128) operands;
  2. lane gather    out[s, l] = tab[s, idx[s, l]];
  3. streaming bandwidth of  x * 2 + 1;
  4. 50 chained column gathers inside one launch.

Each kernel (``ops/csrc/micro.cu``) has a wrapper here with a launch
counter (``col_gather.launches`` ...) and a plain PyTorch version
(``*_reference``).  A wrapper launches its kernel for CUDA tensors, runs
the plain version for CPU tensors and raises for any other device.
Inputs are made from ``numpy.random.default_rng(0)`` as the JAX module
makes them.

    python -m memgraph_tpu_torch.benchmarks.micro [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ._common import (LANES, check, compare, count, launch, on_card,
                      platform, timeit)

TIMED_CALLS = 20          # pallas_micro.timeit's n
LOOP_TIMED_CALLS = 5      # bench_gather_loop's n
MAX_LOOP_ROWS = 16384     # one column twice in a block's shared memory


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def col_gather_reference(tab, idx):
    lanes = torch.arange(LANES, device=tab.device)
    return tab[idx.long(), lanes]


def lane_gather_reference(tab, idx):
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    return tab[rows, idx.long()]


def stream_reference(x):
    return x * 2.0 + 1.0


def gather_loop_reference(tab, idx, iters):
    acc = tab
    for _ in range(iters):
        acc = col_gather_reference(acc, idx)
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_table(name, tab, idx):
    check(f"{name} tab", tab, torch.float32, (None, LANES))
    check(f"{name} idx", idx, torch.int32, (tab.shape[0], LANES))


@count
def col_gather(tab, idx):
    """out[s, l] = tab[idx[s, l], l]; tab (R, 128) f32, idx (R, 128) int32
    with values < R."""
    _check_table("col_gather", tab, idx)
    if not on_card("col_gather", tab, idx):
        return col_gather_reference(tab, idx)
    out = torch.empty_like(tab)
    launch("col_gather", tab, idx, out, tab.shape[0])
    col_gather.launches += 1
    return out


@count
def lane_gather(tab, idx):
    """out[s, l] = tab[s, idx[s, l]]; tab (R, 128) f32, idx (R, 128) int32
    with values < 128."""
    _check_table("lane_gather", tab, idx)
    if not on_card("lane_gather", tab, idx):
        return lane_gather_reference(tab, idx)
    out = torch.empty_like(tab)
    launch("lane_gather", tab, idx, out, tab.shape[0])
    lane_gather.launches += 1
    return out


@count
def stream(x):
    """x * 2 + 1 over an (R, 128) f32 tensor."""
    check("stream x", x, torch.float32, (None, LANES))
    if not on_card("stream", x):
        return stream_reference(x)
    out = torch.empty_like(x)
    launch("stream", x, out, x.numel())
    stream.launches += 1
    return out


@count
def gather_loop(tab, idx, iters: int = 50):
    """iters chained column gathers acc <- acc[idx[s, l], l] in one
    launch; R <= 16384 on the card."""
    _check_table("gather_loop", tab, idx)
    if not on_card("gather_loop", tab, idx):
        return gather_loop_reference(tab, idx, iters)
    if tab.shape[0] > MAX_LOOP_ROWS:
        raise ValueError(f"gather_loop: R = {tab.shape[0]} > "
                         f"{MAX_LOOP_ROWS} does not fit in shared memory")
    out = torch.empty_like(tab)
    launch("gather_loop", tab, idx, out, tab.shape[0], iters)
    gather_loop.launches += 1
    return out


KERNELS = (col_gather, lane_gather, stream, gather_loop)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the benchmarks (names and sizes of pallas_micro.py)
# ---------------------------------------------------------------------------

def gather_inputs(R: int, hi: int):
    """pallas_micro's (tab, idx) for a gather over (R, 128), idx < hi."""
    rng = np.random.default_rng(0)
    tab = rng.random((R, LANES), dtype=np.float32)
    idx = rng.integers(0, hi, (R, LANES)).astype(np.int32)
    return tab, idx


def _gather_bench(name, fn, plain, R, hi, device):
    dev = resolve_device(device)
    tab, idx = (torch.from_numpy(a).to(dev) for a in gather_inputs(R, hi))
    ms, out = timeit(fn, tab, idx, n=TIMED_CALLS, device=dev)
    ok, err = compare(out, plain(tab, idx))
    rate = R * LANES / ms / 1e6
    print(f"  {name} R={R}: {ms * 1e3:9.1f} us  {rate:8.2f} Gelem/s  "
          f"ok={ok}", flush=True)
    return {"bench": name, "R": R, "ms": ms, "gelem_s": rate, "ok": ok,
            "max_abs_err": err}


def bench_col_gather(R: int, device=None) -> dict:
    """out[s,l] = table[idx[s,l], l] (take_along_axis axis=0)."""
    return _gather_bench("col_gather", col_gather, col_gather_reference,
                         R, R, device)


def bench_lane_gather(R: int, device=None) -> dict:
    """out[s,l] = table[s, idx[s,l]] (take_along_axis axis=1)."""
    return _gather_bench("lane_gather", lane_gather, lane_gather_reference,
                         R, LANES, device)


def bench_stream(MB: int, device=None) -> dict:
    """x*2+1 over an MB-sized array: streaming bandwidth."""
    dev = resolve_device(device)
    R = MB * 1024 * 1024 // (LANES * 4)
    x = torch.ones((R, LANES), dtype=torch.float32, device=dev)
    ms, out = timeit(stream, x, n=TIMED_CALLS, device=dev)
    ok, err = compare(out, stream_reference(x))
    nbytes = R * LANES * 4 * 2          # read + write
    print(f"  stream {MB}MB: {ms:8.2f} ms  {nbytes / ms / 1e6:8.1f} GB/s",
          flush=True)
    return {"bench": "stream", "MB": MB, "R": R, "ms": ms,
            "gb_s": nbytes / ms / 1e6, "ok": ok, "max_abs_err": err}


def bench_gather_loop(R: int, iters: int = 50, device=None) -> dict:
    """iters chained col-gathers inside ONE launch."""
    dev = resolve_device(device)
    tab, idx = (torch.from_numpy(a).to(dev) for a in gather_inputs(R, R))
    ms, out = timeit(gather_loop, tab, idx, iters, n=LOOP_TIMED_CALLS,
                     device=dev)
    ok, err = compare(out, gather_loop_reference(tab, idx, iters))
    per = ms / max(iters, 1)
    print(f"  gather_loop R={R} x{iters}: {per * 1e3:9.1f} us/gather "
          f"{R * LANES / per / 1e6:8.2f} Gelem/s  ok={ok}", flush=True)
    return {"bench": "gather_loop", "R": R, "iters": iters, "ms": ms,
            "ms_per_gather": per, "ok": ok, "max_abs_err": err}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.micro",
        description="Gather and streaming microbenchmarks (the port of "
                    "benchmarks/pallas_micro.py); runs on cuda unless "
                    "--device cpu.")
    p.add_argument("--device", default=None)
    p.add_argument("--col-rows", type=int, nargs="+",
                   default=[8, 64, 512, 2048, 8192])
    p.add_argument("--lane-rows", type=int, nargs="+",
                   default=[8, 512, 8192])
    p.add_argument("--stream-mb", type=int, nargs="+", default=[64, 256])
    p.add_argument("--loop-rows", type=int, default=8192)
    p.add_argument("--loop-iters", type=int, default=50)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"platform: {platform(dev)}", flush=True)
    results = []
    print("col gather (axis=0, cross-sublane):")
    results += [bench_col_gather(R, dev) for R in a.col_rows]
    print("lane gather (axis=1):")
    results += [bench_lane_gather(R, dev) for R in a.lane_rows]
    print("streaming:")
    results += [bench_stream(MB, dev) for MB in a.stream_mb]
    print("gather in-loop:")
    results.append(bench_gather_loop(a.loop_rows, a.loop_iters, dev))
    return results


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
