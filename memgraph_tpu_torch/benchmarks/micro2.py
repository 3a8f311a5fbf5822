"""A fixed 12M-slot permutation, and the gather / scatter primitives of
the fused PageRank design: the port of benchmarks/pallas_micro2.py.

  - ``xla_take``: ``acc[idx] * 1.0000001`` looped, for random, duplicate,
    banded and identity indices over E = 12 * 2^20 slots.  The JAX module
    leaves this to XLA (``jnp.take``); here it is plain PyTorch indexing.
  - ``dynslice_gather`` (G2): out[r, l] = rank[8 * grp[r / 8] + row3[r, l], l]:
    an 8-row window of ``rank`` per 8-row block of edge slots, then a
    column gather inside it.
  - ``onehot_scatter`` (S3): acc[dblk[b], l] += sum over the 1024 slots of
    8-row block b whose lane is l.  A one-hot matmul on the TPU, a
    scatter-add here.

Wrappers, launch counters and plain versions as in ``micro``.

    python -m memgraph_tpu_torch.benchmarks.micro2 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ._common import (LANES, check, compare, count, launch, on_card,
                      platform, timeit)

E = 12 * 1024 * 1024      # edge slots
RANK_R = 8192             # rows of the rank / accumulator array
TIMED_CALLS = 3           # pallas_micro2.timeit1's n
TAKE_SCALE = 1.0000001
# onehot_scatter sums ~12 terms a bin in another order than the one-hot
# dot (atomics on the card, in landing order): a few f32 roundings each
ONEHOT_RTOL = 1e-5


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def xla_take(x, idx, iters: int):
    """iters x  acc <- acc[idx] * 1.0000001 (plain PyTorch indexing)."""
    acc = x
    for _ in range(iters):
        acc = acc[idx] * TAKE_SCALE
    return acc


def _block_rows(per_block, rows):
    """(rows, 1) int64: per_block[r // 8] for each row r."""
    return per_block.view(-1).long().repeat_interleave(8)[:rows, None]


def dynslice_gather_reference(grp, row3, rank):
    src = 8 * _block_rows(grp, row3.shape[0]) + row3.long()
    return rank[src, torch.arange(LANES, device=rank.device)]


def onehot_scatter_reference(dblk, lanes, vals, acc_rows: int = RANK_R):
    bins = (_block_rows(dblk, lanes.shape[0]) * LANES + lanes.long())
    acc = torch.zeros(acc_rows * LANES, dtype=torch.float32,
                      device=vals.device)
    return acc.scatter_add_(0, bins.view(-1), vals.view(-1)).view(
        acc_rows, LANES)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_blocks(name, per_block, slots):
    """slots: (R, 128) int32 in whole 8-row blocks; per_block: (R/8, 1)
    int32, one entry a block."""
    check(f"{name} slots", slots, torch.int32, (None, LANES))
    rows = slots.shape[0]
    if rows % 8:
        raise ValueError(f"{name}: rows {rows} not a multiple of 8")
    check(f"{name} per-block index", per_block, torch.int32, (rows // 8, 1))


@count
def dynslice_gather(grp, row3, rank):
    """out[r, l] = rank[8 * grp[r // 8] + row3[r, l], l]; grp (R/8, 1),
    row3 (R, 128) int32 with row3 < 8; rank (RANK_R, 128) f32."""
    _check_blocks("dynslice_gather", grp, row3)
    check("dynslice_gather rank", rank, torch.float32, (None, LANES))
    if not on_card("dynslice_gather", grp, row3, rank):
        return dynslice_gather_reference(grp, row3, rank)
    out = torch.empty(row3.shape, dtype=torch.float32, device=row3.device)
    launch("dynslice_gather", grp, row3, rank, out, row3.shape[0])
    dynslice_gather.launches += 1
    return out


@count
def onehot_scatter(dblk, lanes, vals, acc_rows: int = RANK_R):
    """acc[dblk[b], lanes[8b+s, e]] += vals[8b+s, e] into a new zeroed
    (acc_rows, 128) f32 accumulator; dblk (R/8, 1) int32 < acc_rows,
    lanes (R, 128) int32 < 128, vals (R, 128) f32."""
    _check_blocks("onehot_scatter", dblk, lanes)
    check("onehot_scatter vals", vals, torch.float32, tuple(lanes.shape))
    if not on_card("onehot_scatter", dblk, lanes, vals):
        return onehot_scatter_reference(dblk, lanes, vals, acc_rows)
    # zeroed here, as the Pallas body zeroes at grid step 0: the fill is
    # part of what a launch costs
    acc = torch.zeros((acc_rows, LANES), dtype=torch.float32,
                      device=vals.device)
    launch("onehot_scatter", dblk, lanes, vals, acc, lanes.shape[0])
    onehot_scatter.launches += 1
    return acc


KERNELS = (dynslice_gather, onehot_scatter)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# the benchmarks (names and sizes of pallas_micro2.py)
# ---------------------------------------------------------------------------

def bench_xla_take(name: str, idx, iters: int = 10, edges: int = E,
                   device=None) -> dict:
    """acc[idx] looped (plain PyTorch: the JAX module's jnp.take)."""
    dev = resolve_device(device)
    idx_t = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=dev)
    x = torch.arange(edges, dtype=torch.float32, device=dev)
    ms, _ = timeit(xla_take, x, idx_t, iters, n=TIMED_CALLS, device=dev)
    per = ms / iters
    print(f"  take/{name}: {per:8.2f} ms/pass  {edges / per / 1e3:9.0f} "
          f"Melem/s", flush=True)
    return {"bench": f"take/{name}", "edges": edges, "iters": iters,
            "ms": ms, "ms_per_pass": per, "ok": True, "max_abs_err": 0.0}


def dynslice_inputs(edges: int = E):
    """pallas_micro2's (grp, row3, rank)."""
    rows = edges // LANES
    rng = np.random.default_rng(0)
    grp = rng.integers(0, RANK_R // 8, (rows // 8, 1)).astype(np.int32)
    row3 = rng.integers(0, 8, (rows, LANES)).astype(np.int32)
    rank = rng.random((RANK_R, LANES), dtype=np.float32)
    return grp, row3, rank


def onehot_inputs(edges: int = E):
    """pallas_micro2's (dblk, lanes, vals)."""
    rows = edges // LANES
    rng = np.random.default_rng(0)
    dblk = rng.integers(0, RANK_R, (rows // 8, 1)).astype(np.int32)
    lanes = rng.integers(0, LANES, (rows, LANES)).astype(np.int32)
    vals = rng.random((rows, LANES), dtype=np.float32)
    return dblk, lanes, vals


def _edge_bench(name, label, fn, plain, inputs, rtol, edges, device):
    dev = resolve_device(device)
    args = [torch.from_numpy(a).to(dev) for a in inputs]
    ms, out = timeit(fn, *args, n=TIMED_CALLS, device=dev)
    ok, err = compare(out, plain(*args), rtol)
    print(f"  {label}: {ms:8.2f} ms/pass  {edges / ms / 1e3:9.0f} Melem/s  "
          f"ok={ok}", flush=True)
    return {"bench": name, "edges": edges, "ms": ms, "ok": ok,
            "max_abs_err": err}


def bench_dynslice_gather(edges: int = E, device=None) -> dict:
    """G2: per-block 8-row window + column gather, one pass over the edge
    slots (the JAX function's iters argument is unused there too)."""
    return _edge_bench("dynslice_gather", "g2_gather", dynslice_gather,
                       dynslice_gather_reference, dynslice_inputs(edges),
                       0.0, edges, device)


def bench_onehot_scatter(edges: int = E, device=None) -> dict:
    """S3: per-block scatter-add into a destination row."""
    return _edge_bench("onehot_scatter", "s3_scatter", onehot_scatter,
                       onehot_scatter_reference, onehot_inputs(edges),
                       ONEHOT_RTOL, edges, device)


def take_indices(edges: int = E) -> dict:
    """pallas_micro2.__main__'s four index arrays, from default_rng(1)."""
    rng = np.random.default_rng(1)
    out = {"random_dup": rng.integers(0, edges, edges),
           "random_perm": rng.permutation(edges)}
    B = min(65536, edges)
    out[f"banded_perm_{B // 1024}K"] = (np.arange(edges) // B) * B + \
        np.concatenate([rng.permutation(B) for _ in range(edges // B)])
    out["identity"] = np.arange(edges)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.micro2",
        description="Permutation cost and gather / scatter primitives (the "
                    "port of benchmarks/pallas_micro2.py); runs on cuda "
                    "unless --device cpu.")
    p.add_argument("--device", default=None)
    p.add_argument("--edges", type=int, default=E,
                   help="edge slots, a multiple of 1024")
    p.add_argument("--take-iters", type=int, default=10)
    a = p.parse_args(argv)
    if a.edges % 1024:
        p.error("--edges must be a multiple of 1024")
    dev = resolve_device(a.device)
    print(f"platform: {platform(dev)}", flush=True)
    results = []
    print(f"take on {a.edges} elements (amortized in-loop):")
    for name, idx in take_indices(a.edges).items():
        results.append(bench_xla_take(name, idx, a.take_iters, a.edges, dev))
    print("kernel primitives:")
    results.append(bench_dynslice_gather(a.edges, dev))
    results.append(bench_onehot_scatter(a.edges, dev))
    return results


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
