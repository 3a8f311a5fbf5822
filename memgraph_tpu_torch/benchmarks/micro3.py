"""Lane gathers, tile transposes and a matrix product, each looped inside
one launch: the port of benchmarks/pallas_micro3.py.

These are the primitives of the radix-routed PageRank design:
  - ``lane_gather_loop``: iters x (lane gather, + 1) on (R, 128);
  - ``transpose_loop``: iters x (transpose every 128 x 128 tile, + 1);
  - ``sandwich``: iters x [lane gather s1, transpose, lane gather s2,
    transpose, lane gather s3], which realises an arbitrary permutation
    of a 128 x 128 tile;
  - ``big_matmul``: iters x (acc += A @ B), A (1024, 2048), B (2048, 128),
    full f32.

Wrappers, launch counters and plain versions as in ``micro``.

    python -m memgraph_tpu_torch.benchmarks.micro3 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ._common import (LANES, check, compare, count, launch, on_card,
                      platform, timeit)

TIMED_CALLS = 3           # pallas_micro3.timeit1's n
MATMUL_SHAPE = (1024, 2048, 128)
# big_matmul against another summation order (and cuBLAS or the TPU's
# dot): each of the iters products sums K positive terms, then adds to
# acc, so the relative error is at most about (K + iters) * 2^-24 =
# (2048 + 500) * 2^-24 = 1.5e-4; rounded up
MATMUL_RTOL = 2e-4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _lane_take(acc, idx):
    rows = torch.arange(acc.shape[0], device=acc.device)[:, None]
    return acc[rows, idx]


def _tile_transpose(a):
    R = a.shape[0]
    return a.view(R // LANES, LANES, LANES).transpose(1, 2).reshape(R, LANES)


def lane_gather_loop_reference(x, idx, iters):
    idx, acc = idx.long(), x
    for _ in range(iters):
        acc = _lane_take(acc, idx) + 1.0
    return acc


def transpose_loop_reference(x, iters):
    acc = x
    for _ in range(iters):
        acc = _tile_transpose(acc) + 1.0
    return acc


def sandwich_reference(x, s1, s2, s3, iters):
    s1, s2, s3 = s1.long(), s2.long(), s3.long()
    acc = x
    for _ in range(iters):
        a = _lane_take(acc, s1)
        a = _tile_transpose(a)
        a = _lane_take(a, s2)
        a = _tile_transpose(a)
        acc = _lane_take(a, s3)
    return acc


def big_matmul_reference(a, b, iters):
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for _ in range(iters):
        acc = acc + a @ b
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_tiles(name, x):
    check(f"{name} x", x, torch.float32, (None, LANES))
    if x.shape[0] % LANES:
        raise ValueError(f"{name}: rows {x.shape[0]} are not whole "
                         "128 x 128 tiles")


@count
def lane_gather_loop(x, idx, iters: int = 500):
    """iters x  acc[s, l] <- acc[s, idx[s, l]] + 1 in one launch; x (R, 128)
    f32, idx (R, 128) int32 < 128."""
    check("lane_gather_loop x", x, torch.float32, (None, LANES))
    check("lane_gather_loop idx", idx, torch.int32, tuple(x.shape))
    if not on_card("lane_gather_loop", x, idx):
        return lane_gather_loop_reference(x, idx, iters)
    out = torch.empty_like(x)
    launch("lane_gather_loop", x, idx, out, x.shape[0], iters)
    lane_gather_loop.launches += 1
    return out


@count
def transpose_loop(x, iters: int = 500):
    """iters x (transpose every 128 x 128 tile of x, + 1) in one launch;
    x (R, 128) f32, R a multiple of 128."""
    _check_tiles("transpose_loop", x)
    if not on_card("transpose_loop", x):
        return transpose_loop_reference(x, iters)
    out = torch.empty_like(x)
    launch("transpose_loop", x, out, x.shape[0], iters)
    transpose_loop.launches += 1
    return out


@count
def sandwich(x, s1, s2, s3, iters: int = 200):
    """iters x [lane gather s1, tile transpose, lane gather s2, tile
    transpose, lane gather s3] in one launch; x (R, 128) f32 in whole
    tiles, s1..s3 (R, 128) int32 < 128."""
    _check_tiles("sandwich", x)
    for i, s in enumerate((s1, s2, s3), 1):
        check(f"sandwich s{i}", s, torch.int32, tuple(x.shape))
    if not on_card("sandwich", x, s1, s2, s3):
        return sandwich_reference(x, s1, s2, s3, iters)
    out = torch.empty_like(x)
    launch("sandwich", x, s1, s2, s3, out, x.shape[0], iters)
    sandwich.launches += 1
    return out


@count
def big_matmul(a, b, iters: int = 500):
    """iters x (acc += a @ b) from zero, in full f32, in one launch;
    a (M, K), b (K, N), each a multiple of 32."""
    check("big_matmul a", a, torch.float32, (None, None))
    check("big_matmul b", b, torch.float32, (a.shape[1], None))
    if not on_card("big_matmul", a, b):
        return big_matmul_reference(a, b, iters)
    (M, K), N = a.shape, b.shape[1]
    if M % 32 or K % 32 or N % 32:
        raise ValueError(f"big_matmul: ({M}, {K}) @ ({K}, {N}) needs "
                         "multiples of 32")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    launch("big_matmul", a, b, out, M, K, N, iters)
    big_matmul.launches += 1
    return out


KERNELS = (lane_gather_loop, transpose_loop, sandwich, big_matmul)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the benchmarks (names and sizes of pallas_micro3.py)
# ---------------------------------------------------------------------------

def lane_loop_inputs(R: int, n_idx: int = 1):
    """pallas_micro3's x and n_idx index arrays (< 128) over (R, 128)."""
    rng = np.random.default_rng(0)
    x = rng.random((R, LANES), dtype=np.float32)
    return [x] + [rng.integers(0, LANES, (R, LANES)).astype(np.int32)
                  for _ in range(n_idx)]


def matmul_inputs():
    M, K, N = MATMUL_SHAPE
    rng = np.random.default_rng(0)
    return (rng.random((M, K), dtype=np.float32),
            rng.random((K, N), dtype=np.float32))


def _loop_bench(name, fn, plain, inputs, iters, rtol, device):
    dev = resolve_device(device)
    args = [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in inputs]
    ms, out = timeit(fn, *args, iters, n=TIMED_CALLS, device=dev)
    ok, err = compare(out, plain(*args, iters), rtol)
    return {"bench": name, "iters": iters, "ms": ms,
            "ms_per_op": ms / max(iters, 1), "ok": ok, "max_abs_err": err}


def bench_lane_gather_loop(R: int = 4096, iters: int = 500,
                           device=None) -> dict:
    """Chained lane-gathers on (R, 128) inside one launch."""
    res = _loop_bench("lane_gather_loop", lane_gather_loop,
                      lane_gather_loop_reference, lane_loop_inputs(R),
                      iters, 0.0, device)
    per = res["ms_per_op"]
    print(f"  lane_gather R={R}: {per * 1e3:9.1f} us/op  "
          f"{R * LANES / per / 1e6:7.2f} Gelem/s  ok={res['ok']}",
          flush=True)
    return dict(res, R=R)


def bench_transpose_loop(R: int = 8192, iters: int = 500,
                         device=None) -> dict:
    """Per-(128,128)-tile transpose over an (R, 128) array of ones,
    chained."""
    dev = resolve_device(device)
    x = torch.ones((R, LANES), dtype=torch.float32, device=dev)
    res = _loop_bench("transpose_loop", transpose_loop,
                      transpose_loop_reference, [x], iters, 0.0, dev)
    per = res["ms_per_op"]
    print(f"  tiled transpose R={R}: {per * 1e3:9.1f} us/op  "
          f"{R * LANES / per / 1e6:7.2f} Gelem/s  ok={res['ok']}",
          flush=True)
    return dict(res, R=R)


def bench_sandwich(R: int = 4096, iters: int = 200, device=None) -> dict:
    """Full within-tile permutation sandwich: 3 lane-gathers + 2
    transposes."""
    res = _loop_bench("sandwich", sandwich, sandwich_reference,
                      lane_loop_inputs(R, 3), iters, 0.0, device)
    per = res["ms_per_op"]
    print(f"  sandwich R={R}: {per * 1e3:9.1f} us/op  "
          f"{R * LANES / per / 1e6:7.2f} Gelem/s  (full tile perms)  "
          f"ok={res['ok']}", flush=True)
    return dict(res, R=R)


def bench_big_matmul(iters: int = 500, device=None) -> dict:
    """Reference point: (1024,2048)@(2048,128) matmul rate."""
    res = _loop_bench("big_matmul", big_matmul, big_matmul_reference,
                      matmul_inputs(), iters, MATMUL_RTOL, device)
    M, K, N = MATMUL_SHAPE
    per = res["ms_per_op"]
    print(f"  matmul {M}x{K}x{N}: {per * 1e3:9.1f} us  "
          f"{2 * M * K * N / per / 1e9:6.2f} Tflop/s  ok={res['ok']}",
          flush=True)
    return res


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.micro3",
        description="Lane-gather, transpose and matmul loops (the port of "
                    "benchmarks/pallas_micro3.py); runs on cuda unless "
                    "--device cpu.")
    p.add_argument("--device", default=None)
    p.add_argument("--lane-rows", type=int, default=4096)
    p.add_argument("--lane-iters", type=int, default=500)
    p.add_argument("--transpose-rows", type=int, default=8192)
    p.add_argument("--transpose-iters", type=int, default=500)
    p.add_argument("--sandwich-rows", type=int, default=4096)
    p.add_argument("--sandwich-iters", type=int, default=200)
    p.add_argument("--matmul-iters", type=int, default=500)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"platform: {platform(dev)}", flush=True)
    return [bench_lane_gather_loop(a.lane_rows, a.lane_iters, dev),
            bench_transpose_loop(a.transpose_rows, a.transpose_iters, dev),
            bench_sandwich(a.sandwich_rows, a.sandwich_iters, dev),
            bench_big_matmul(a.matmul_iters, dev)]


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
