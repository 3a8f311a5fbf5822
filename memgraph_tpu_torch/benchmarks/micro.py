"""Gathers and streaming bandwidth: the port of benchmarks/pallas_micro.py.

Measures, on the card:
  1. column gather  out[s, l] = tab[idx[s, l], l]  on (R, 128) operands;
  2. lane gather    out[s, l] = tab[s, idx[s, l]];
  3. streaming bandwidth of  x * 2 + 1;
  4. 50 chained column gathers inside one launch: one block a column,
     the column carried in and out by tile transposes
     (``gather_loop_tiling``).

Each kernel (``ops/csrc/micro.cu``) has a wrapper here with a launch
counter (``col_gather.launches`` ...) and a plain PyTorch version
(``*_reference``).  A wrapper launches its kernel for CUDA tensors, runs
the plain version for CPU tensors and raises for any other device.
Inputs are made from ``numpy.random.default_rng(0)`` as the JAX module
makes them.  ``gather_loop_schedule`` replays gather_loop's design in
plain torch (the transposes through their shared tiles, the loop through
the column-major scratch); the tests hold it against the plain version.

    python -m memgraph_tpu_torch.benchmarks.micro [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ._common import (H100_SMS, LANES, check, compare, count, launch,
                      on_card, platform, sm_count, timeit)

TIMED_CALLS = 20          # pallas_micro.timeit's n
LOOP_TIMED_CALLS = 5      # bench_gather_loop's n
MAX_LOOP_ROWS = 16384     # one column twice in a block's shared memory
LOOP_THREADS = 1024       # threads of a gather_loop block
TRANSPOSE_TILE = 32       # tile_transpose's tile edge
TRANSPOSE_THREADS = 256


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
    """iters chained column gathers acc <- acc[idx[s, l], l] in one call
    (on the card: tab and idx transposed into column-major scratch, the
    loop in one launch, the result transposed out); R <= 16384 on the
    card."""
    _check_table("gather_loop", tab, idx)
    if not on_card("gather_loop", tab, idx):
        return gather_loop_reference(tab, idx, iters)
    R = tab.shape[0]
    if R > MAX_LOOP_ROWS:
        raise ValueError(f"gather_loop: R = {R} > {MAX_LOOP_ROWS} does not "
                         "fit in shared memory")
    t = gather_loop_tiling(R, sm_count(tab.device))
    out = torch.empty_like(tab)
    scratch = torch.empty(t["scratch"], dtype=torch.float32,
                          device=tab.device)
    launch("gather_loop", tab, idx, out, scratch, R, iters, t["blocks"],
           t["threads"], t["smem_bytes"], t["pitch"])
    gather_loop.launches += 1
    return out


def gather_loop_tiling(R: int, n_sms: int) -> dict:
    """gather_loop's launch for (R, 128) on a card of n_sms SMs.

    One block of LOOP_THREADS a column for the whole launch (128 blocks),
    the column twice in shared memory at ``pitch`` (R rounded up to 32)
    floats each.  Thread k owns the 4-position groups k, k + LOOP_THREADS,
    ... below pitch / 4 (``groups_per_thread`` of them at most).  The
    column enters and leaves contiguously: the wrapper allocates
    ``scratch`` (tab, idx and the result, each (128, pitch), column-major);
    ``transpose_blocks`` tiles of 32 x 32 carry tab and idx in and the
    result out.  sms: the SMs the loop's blocks occupy."""
    pitch = -(-R // TRANSPOSE_TILE) * TRANSPOSE_TILE
    tiles = pitch // TRANSPOSE_TILE * (LANES // TRANSPOSE_TILE)
    return {"blocks": LANES, "cluster": 1, "threads": LOOP_THREADS,
            "smem_bytes": 2 * pitch * 4, "columns_per_block": 1,
            "pitch": pitch,
            "groups_per_thread": -(-pitch // (4 * LOOP_THREADS)),
            "scratch": (3, LANES, pitch),
            "transpose_blocks": {"in": 2 * tiles, "out": tiles},
            "transpose_threads": TRANSPOSE_THREADS,
            "sms": min(LANES, n_sms)}


def _tile_transpose(src, src_rows, sp, dst, dst_rows, dp, n_tiles,
                    trace=None):
    """tile_transpose as its blocks run it, in plain torch, on flat
    tensors: every 32 x 32 tile of n_tiles (column tiles, row tiles) through
    a 32 x 33 shared tile, each warp's 16-byte loads and stores by the
    kernel's lane arithmetic.  trace, where given, receives the 32 shared
    word addresses of each warp instruction of one tile."""
    T = TRANSPOSE_TILE
    ct, rt = n_tiles
    w = torch.arange(TRANSPOSE_THREADS // 32)[:, None]
    j = torch.arange(32)[None, :]
    r, q = 4 * w + j // 8, j % 8             # (warps, lanes)
    k = torch.arange(4)
    c0 = torch.arange(ct)[:, None, None, None] * T
    r0 = torch.arange(rt)[None, :, None, None] * T
    # loads: 4 words at src[(r0 + r) sp + c0 + 4 q + k], zeros past src_rows
    rows = (r0 + r).unsqueeze(-1)
    cols = (c0 + 4 * q).unsqueeze(-1) + k
    live = (rows < src_rows).expand(ct, rt, *r.shape, 4)
    vals = torch.zeros(live.shape, dtype=src.dtype)
    vals[live] = src[(rows * sp + cols)[live]]
    tile = torch.empty((ct, rt, T * (T + 1)), dtype=src.dtype)
    words = (r * (T + 1) + 4 * q).unsqueeze(-1) + k       # (warps, lanes, 4)
    tile[:, :, words] = vals
    # stores: dst row c0 + c gets tile rows 4 q + k of column c
    c = r
    reads = ((4 * q).unsqueeze(-1) + k) * (T + 1) + c.unsqueeze(-1)
    out_rows = (c0 + c).unsqueeze(-1)
    out_cols = (r0 + 4 * q).unsqueeze(-1) + k
    live = (out_rows < dst_rows).expand(ct, rt, *c.shape, 4)
    dst[(out_rows * dp + out_cols).expand(live.shape)[live]] = \
        tile[:, :, reads][live]
    if trace is not None:
        trace += [words[wi, :, kk] for wi in range(words.shape[0])
                  for kk in range(4)]
        trace += [reads[wi, :, kk] for wi in range(reads.shape[0])
                  for kk in range(4)]


def gather_loop_schedule(tab, idx, iters, tiling=None, trace=None):
    """gather_loop as its kernels deal it out, in plain torch: tab and idx
    transposed into the column-major scratch (zeros past R), each block's
    column gathered through its two shared buffers by 4-position groups
    (all of an iteration's reads before its writes), then the result
    transposed out.  trace, where given, receives the shared word
    addresses of each warp instruction: the transposes', then the first
    loop iteration's of column 0 (its reads hit ~3.6 addresses of one
    bank)."""
    R = tab.shape[0]
    t = tiling or gather_loop_tiling(R, H100_SMS)
    pitch = t["pitch"]
    T = TRANSPOSE_TILE
    scratch = torch.empty(t["scratch"], dtype=torch.int32).view(3, -1)
    _tile_transpose(tab.view(torch.int32).reshape(-1), R, LANES,
                    scratch[0], LANES, pitch, (LANES // T, pitch // T), trace)
    _tile_transpose(idx.reshape(-1), R, LANES, scratch[1], LANES, pitch,
                    (LANES // T, pitch // T))
    cols = scratch[0].view(torch.float32).view(t["blocks"], pitch)
    ix = scratch[1].view(t["blocks"], pitch).long()
    groups = pitch // 4
    g = (torch.arange(t["threads"])[None, :]
         + t["threads"] * torch.arange(t["groups_per_thread"])[:, None])
    live = g < groups                          # (slot, thread)
    pos = (4 * g[live])[:, None] + torch.arange(4)       # owned positions
    if trace is not None and iters:
        src = ix[0, pos]                       # (owned groups, 4)
        for s in range(0, src.shape[0], 32):
            trace += [src[s:s + 32, kk] for kk in range(4)]
    a = cols.clone()
    flat = pos.reshape(-1)
    for _ in range(iters):
        b = torch.empty_like(a)
        b[:, flat] = torch.gather(a, 1, ix[:, flat])
        a = b
    scratch[2] = a.reshape(-1).view(torch.int32)
    out = torch.empty((R * LANES,), dtype=torch.int32)
    _tile_transpose(scratch[2], LANES, pitch, out, R, LANES,
                    (pitch // T, LANES // T))
    return out.view(torch.float32).view(R, LANES)


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
