"""Lane gathers, tile transposes and a matrix product, each looped inside
one launch: the port of benchmarks/pallas_micro3.py.

These are the primitives of the radix-routed PageRank design:
  - ``lane_gather_loop``: iters x (lane gather, + 1) on (R, 128), 32 rows
    a block, a row a lane, positions dealt over warps, the rows
    position-major in shared memory (``lane_gather_loop_tiling``);
  - ``transpose_loop``: iters x (transpose every 128 x 128 tile, + 1),
    each tile split by the transpose's quadrant orbits over two blocks
    (``transpose_loop_tiling``);
  - ``sandwich``: iters x [lane gather s1, transpose, lane gather s2,
    transpose, lane gather s3], which realises an arbitrary permutation
    of a 128 x 128 tile; a tile a block, each gather fused with the
    transpose after it (``sandwich_tiling``);
  - ``big_matmul``: iters x (acc += A @ B), A (1024, 2048), B (2048, 128),
    full f32, split over the blocks by K (``big_matmul_tiling``).

Wrappers, launch counters and plain versions as in ``micro``.  The
``*_schedule`` functions replay a kernel's design in plain torch (each
block's share of a tile and its passes as the kernel makes them); the
tests hold them against the plain versions.

    python -m memgraph_tpu_torch.benchmarks.micro3 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ._common import (H100_SMS, LANES, check, compare, count, launch,
                      on_card, platform, sm_count, timeit)

TIMED_CALLS = 3           # pallas_micro3.timeit1's n
MATMUL_SHAPE = (1024, 2048, 128)
# big_matmul against another summation order (and cuBLAS or the TPU's
# dot): each of the iters products sums K positive terms, then adds to
# acc, so the relative error is at most about (K + iters) * 2^-24 =
# (2048 + 500) * 2^-24 = 1.5e-4; rounded up.  The kernel's split order
# (each K-slice's ks terms, its iters products, then the slices) stays
# under (ks + iters + K / ks) * 2^-24 = 3.8e-5 at ks = 128.
MATMUL_RTOL = 2e-4
MATMUL_TILES = (128, 64, 32)   # big_matmul's block tiles, fastest first
BLOCK_SMEM_BYTES = 232_448     # shared memory a block may use on an H100
TILE_THREADS = 1024            # threads of a transpose_loop / sandwich block
QUAD = LANES // 2              # transpose_loop's region edge
LANE_ROWS = 32                 # lane_gather_loop: rows a block, a row a lane
LANE_WARPS = 8                 # lane_gather_loop: warps splitting a row
STAGE_PITCH = LANES + 1        # lane_gather_loop's staging row, in words


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
    t = lane_gather_loop_tiling(x.shape[0], sm_count(x.device))
    out = torch.empty_like(x)
    launch("lane_gather_loop", x, idx, out, x.shape[0], iters, t["blocks"],
           t["threads"], t["smem_bytes"])
    lane_gather_loop.launches += 1
    return out


@count
def transpose_loop(x, iters: int = 500):
    """iters x (transpose every 128 x 128 tile of x, + 1) in one launch;
    x (R, 128) f32, R a multiple of 128."""
    _check_tiles("transpose_loop", x)
    if not on_card("transpose_loop", x):
        return transpose_loop_reference(x, iters)
    t = transpose_loop_tiling(x.shape[0], sm_count(x.device))
    out = torch.empty_like(x)
    launch("transpose_loop", x, out, x.shape[0], iters, t["blocks"],
           t["threads"], t["smem_bytes"])
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
    t = sandwich_tiling(x.shape[0], sm_count(x.device))
    out = torch.empty_like(x)
    launch("sandwich", x, s1, s2, s3, out, x.shape[0], iters, t["blocks"],
           t["cluster"], t["threads"], t["smem_bytes"])
    sandwich.launches += 1
    return out


def big_matmul_tiling(M: int, K: int, N: int, n_sms: int) -> dict:
    """big_matmul's launch for (M, K) @ (K, N) on a card of n_sms SMs.

    tile: the largest of MATMUL_TILES dividing M and N (32 divides every
    shape the wrapper takes).  ks: the K-slice a block keeps in shared
    memory, a multiple of 32 dividing K whose A and B slices (8 * ks * tile
    bytes) fit in BLOCK_SMEM_BYTES: the largest that still gives blocks to
    at least 90% of the SMs (128 of an H100's 132 at the main shape), else
    the smallest.  blocks = (M / tile) (N / tile) (K / ks); the product
    kernel writes K / ks slices that a second kernel sums."""
    tile = next(t for t in MATMUL_TILES if M % t == 0 and N % t == 0)
    tiles = (M // tile) * (N // tile)
    fits = [ks for ks in range(32, K + 1, 32)
            if K % ks == 0 and 8 * ks * tile <= BLOCK_SMEM_BYTES]
    filling = [ks for ks in fits if tiles * (K // ks) >= 0.9 * n_sms]
    ks = max(filling) if filling else fits[0]
    return {"tile": tile, "ks": ks, "splits": K // ks,
            "blocks": tiles * (K // ks), "smem_bytes": 8 * ks * tile}


def lane_gather_loop_tiling(R: int, n_sms: int) -> dict:
    """lane_gather_loop's launch for (R, 128) on a card of n_sms SMs.

    A block owns LANE_ROWS rows for the whole launch (R / 32 blocks, the
    last one ragged): lane t of every warp owns row 32 b + t, and warp w
    positions ``positions_per_warp`` w onwards.  The block's rows sit in
    shared memory position-major, (p, t) at word 32 p + t, twice
    (ping-pong), so every access of lane t is in bank t.  sms: the SMs
    the blocks occupy."""
    blocks = -(-R // LANE_ROWS)
    return {"blocks": blocks, "cluster": 1, "warps": LANE_WARPS,
            "threads": 32 * LANE_WARPS,
            "smem_bytes": 2 * LANES * LANE_ROWS * 4,
            "rows_per_block": LANE_ROWS,
            "positions_per_warp": LANES // LANE_WARPS,
            "sms": min(blocks, n_sms)}


def _lane_stage_words(tiling):
    """The staging words of a lane_gather_loop block's 16-byte loads and
    stores: (warps, loads a thread, lanes, 4) words r 129 + 4 q + k, load i
    of warp w covering rows 4 c .. 4 c + 3 and 16-byte columns 8 d ..
    8 d + 7, c = g / 4 and d = g % 4 for g = w + warps i; with the rows
    (warps, loads, lanes) and the 16-byte columns."""
    W = tiling["warps"]
    loads = LANE_ROWS * LANES // 4 // tiling["threads"]
    g = torch.arange(W)[:, None] + W * torch.arange(loads)[None, :]
    j = torch.arange(32)
    r = 4 * (g // 4)[..., None] + j // 8
    q = 8 * (g % 4)[..., None] + j % 8
    words = (r * STAGE_PITCH + 4 * q)[..., None] + torch.arange(4)
    return words, r, q


def lane_gather_loop_schedule(x, idx, iters, tiling=None, trace=None):
    """lane_gather_loop as its kernel deals it out, in plain torch, through
    a flat model of each block's shared memory: rows loaded by 16-byte
    accesses into the staging rows (pitch 129), indices taken from there
    as source words 32 idx + t, values written position-major; then iters
    passes, each warp reading all its gathered values (words 32 idx[t][p]
    + t) before writing (words 32 p + t, + 1), buffers swapped after each
    pass; then back out through the staging rows.  Rows past R (the last
    block's) are zeros and are not written.  trace, where given, receives
    the 32 shared word addresses of each warp instruction (of 32-bit
    words) of every block."""
    R = x.shape[0]
    t = tiling or lane_gather_loop_tiling(R, H100_SMS)
    W, P = t["warps"], t["positions_per_warp"]
    buf = LANES * LANE_ROWS
    stage, rows, cols = _lane_stage_words(t)
    stage = stage.movedim(-1, 2)          # a warp instruction a word k
    lane = torch.arange(32)
    pos = (P * torch.arange(W))[:, None] + torch.arange(P)   # (warps, P)
    # thread (w, t) at its positions: staging word 129 t + p, and the
    # position-major word 32 p + t
    staged = lane * STAGE_PITCH + pos[..., None]             # (warps, P, 32)
    at = 32 * pos[..., None] + lane
    xi = x.view(torch.int32)
    out = torch.empty_like(xi)

    def record(words):
        if trace is not None:
            trace.extend(words.reshape(-1, 32))

    for b in range(t["blocks"]):
        r0 = b * LANE_ROWS
        n = min(LANE_ROWS, R - r0)
        smem = torch.zeros(2 * buf, dtype=torch.int32)

        def stage_in(a):
            # the kernel's 16-byte loads, zeros past the block's rows
            block = torch.zeros((LANE_ROWS, LANES), dtype=torch.int32)
            block[:n] = a[r0:r0 + n]
            smem[stage] = block.view(LANE_ROWS, LANES // 4, 4)[
                rows, cols].movedim(-1, 2)
            record(stage)

        def access(words, vals=None):
            record(words)
            if vals is None:
                return smem[words]
            smem[words] = vals

        stage_in(idx)
        src = 32 * access(staged) + lane      # source words
        stage_in(xi)
        access(at, access(staged))
        cur, nxt = 0, buf
        f32 = smem.view(torch.float32)
        for _ in range(iters):
            record(cur + src)
            record(nxt + at)
            f32[nxt + at] = f32[cur + src] + 1.0
            cur, nxt = nxt, cur
        access(staged, access(cur + at))
        block = torch.empty((LANE_ROWS, LANES // 4, 4), dtype=torch.int32)
        block[rows, cols] = access(stage).movedim(2, -1)
        out[r0:r0 + n] = block.view(LANE_ROWS, LANES)[:n]
    return out.view(torch.float32)


def transpose_loop_tiling(R: int, n_sms: int) -> dict:
    """transpose_loop's launch for (R, 128) on a card of n_sms SMs.

    The transpose maps the 64 x 64 quadrant pairs {Q00, Q11} and {Q01,
    Q10} of a tile onto themselves, so each pair is one block's for the
    whole launch: block 2t owns Q00 and Q11 of tile t, block 2t + 1 owns
    Q01 and Q10 (R / 64 blocks).  regions: each block's (tile, row, column)
    region corners, each region ``region`` in size; a block keeps its two
    regions twice in shared memory (64 x 65 floats each).  sms: the SMs the
    blocks occupy."""
    tiles = R // LANES
    blocks = 2 * tiles
    return {"blocks": blocks, "cluster": 1, "threads": TILE_THREADS,
            "smem_bytes": 2 * 2 * QUAD * (QUAD + 1) * 4,
            "region": (QUAD, QUAD),
            "regions": [((b >> 1, 0, QUAD * (b & 1)),
                         (b >> 1, QUAD, QUAD * (1 - (b & 1))))
                        for b in range(blocks)],
            "sms": min(blocks, n_sms)}


def sandwich_tiling(R: int, n_sms: int) -> dict:
    """sandwich's launch for (R, 128) on a card of n_sms SMs.

    One block of TILE_THREADS a tile for the whole launch (R / 128
    blocks, no cluster: a tile split over a cluster of blocks measured
    slower): the tile in three 128 x 129-float buffers (its values, and
    the targets of the two transposing passes).  Warp w owns rows
    warp_rows * w and the next warp_rows - 1, so its third gather stays in
    the warp.  regions: each block's (tile, row, column) corner, each
    ``region`` in size.  sms: the SMs the blocks occupy."""
    tiles = R // LANES
    return {"blocks": tiles, "cluster": 1, "threads": TILE_THREADS,
            "smem_bytes": 3 * LANES * (LANES + 1) * 4,
            "region": (LANES, LANES),
            "warp_rows": LANES // (TILE_THREADS // 32),
            "regions": [((t, 0, 0),) for t in range(tiles)],
            "sms": min(tiles, n_sms)}


def transpose_loop_schedule(x, iters, tiling=None):
    """transpose_loop as its kernel deals it out, in plain torch: each
    block's regions taken from x and transposed apart from every other
    block's for iters passes (new region at (r, c) = old region at (c, r),
    transposed, + 1), then written back where they were taken."""
    t = tiling or transpose_loop_tiling(x.shape[0], H100_SMS)
    h, w = t["region"]
    tiles = x.view(-1, LANES, LANES)
    out = torch.empty_like(tiles)
    for regs in t["regions"]:
        corners = [(r, c) for _, r, c in regs]
        # the region whose transpose lands on each region: the block owns
        # it too, or the tiling is wrong
        src = [corners.index((c, r)) for r, c in corners]
        cur = [tiles[tl, r:r + h, c:c + w] for tl, r, c in regs]
        for _ in range(iters):
            cur = [cur[g].transpose(0, 1) + 1.0 for g in src]
        for (tl, r, c), v in zip(regs, cur):
            out[tl, r:r + h, c:c + w] = v
    return out.view_as(x)


def sandwich_schedule(x, s1, s2, s3, iters):
    """sandwich as its kernel deals it out, in plain torch: each block
    holds its tile in three buffers X, Y, Z; each warp's rows of X are
    gathered by s1 and written as columns of Y, then (after a block
    barrier) its rows of Y gathered by s2 into columns of Z, then (after
    another) its rows of Z gathered by s3 back into its own rows of X."""
    t = sandwich_tiling(x.shape[0], H100_SMS)
    warps = [slice(r, r + t["warp_rows"])
             for r in range(0, LANES, t["warp_rows"])]
    view = [a.view(-1, LANES, LANES) for a in (x, s1, s2, s3)]
    out = torch.empty_like(view[0])
    for (tile, _, _), in t["regions"]:
        X = view[0][tile].clone()
        Y, Z = torch.empty_like(X), torch.empty_like(X)
        p1, p2, p3 = (s[tile].long() for s in view[1:])
        for _ in range(iters):
            for w in warps:
                Y[:, w] = torch.gather(X[w], 1, p1[w]).transpose(0, 1)
            for w in warps:
                Z[:, w] = torch.gather(Y[w], 1, p2[w]).transpose(0, 1)
            for w in warps:
                X[w] = torch.gather(Z[w], 1, p3[w])
        out[tile] = X
    return out.view_as(x)


@count
def big_matmul(a, b, iters: int = 500):
    """iters x (acc += a @ b) from zero, in full f32, in one call (the
    product kernel, then the sum of its K-slices where there are several);
    a (M, K), b (K, N), each a multiple of 32."""
    check("big_matmul a", a, torch.float32, (None, None))
    check("big_matmul b", b, torch.float32, (a.shape[1], None))
    if not on_card("big_matmul", a, b):
        return big_matmul_reference(a, b, iters)
    (M, K), N = a.shape, b.shape[1]
    if M % 32 or K % 32 or N % 32 or not (M and K and N):
        raise ValueError(f"big_matmul: ({M}, {K}) @ ({K}, {N}) needs "
                         "multiples of 32")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("big_matmul: a and b must be 16-byte aligned")
    t = big_matmul_tiling(M, K, N, sm_count(a.device))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    part = (torch.empty((t["splits"], M, N), dtype=torch.float32,
                        device=a.device) if t["splits"] > 1 else None)
    launch("big_matmul", a, b, out, part, M, K, N, iters, t["tile"],
           t["ks"])
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
