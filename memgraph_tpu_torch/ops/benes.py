"""Benes permutation-network routing (host side, numpy).

A fixed permutation is applied as a Benes network: 2*log2(N)-1 stages of
masked exchanges, stage s swapping partners i <-> i ^ d_s where its mask
is set.  The routing (which pairs swap at each stage) is computed once on
the host by the classic looping algorithm: at each level, elements paired
at the input stage (i, i+N/2) must route through different halves, as
must elements paired at the output stage; the union of the two pairings
is a disjoint set of even cycles, 2-colored by walking.

Stage application semantics (shared by the numpy, torch and CUDA
implementations):
  stage s has block size B_s and distance d_s = B_s/2;
  y = x.reshape(N//B_s, 2, d_s); out = where(mask_s, y[:, ::-1, :], y)
with mask_s stored flat (N,) and mask_s[i] == mask_s[i ^ d_s].
"""

from __future__ import annotations

import numpy as np


def benes_stage_distances(n_log2: int) -> list[int]:
    """Distances of the 2n-1 stages, in application order."""
    down = [1 << k for k in range(n_log2 - 1, 0, -1)]
    return down + [1] + down[::-1]


def benes_route(perm: np.ndarray) -> list[np.ndarray]:
    """Compute swap masks realizing `perm` (N power of two).

    Semantics: applying the stages to input x yields y with
    y[i] = x[perm[i]] (i.e. perm is in "gather" form: output position i
    receives the element from input position perm[i]).

    Returns a list of (N,) bool masks, one per stage, in application
    order. Pure python/numpy; for large N use the native C++ router
    (ops.native.benes_route_native) which implements the same algorithm.
    """
    perm = np.asarray(perm, dtype=np.int64)
    N = len(perm)
    if N & (N - 1) or N < 2:
        raise ValueError("benes_route requires power-of-two N >= 2")
    n = N.bit_length() - 1
    n_stages = 2 * n - 1
    masks = [np.zeros(N, dtype=bool) for _ in range(n_stages)]

    # Work in "forward" form: element at input p must reach output q.
    # perm is gather form: out[i] = in[perm[i]]  =>  forward[perm[i]] = i.
    if len(np.unique(perm)) != N or perm.min() < 0 or perm.max() >= N:
        raise ValueError("perm is not a bijection on [0, N)")
    forward = np.empty(N, dtype=np.int64)
    forward[perm] = np.arange(N)

    # (level, block_start, forward-subperm) work items; level k has block
    # size N >> k. Stage index for the IN stage of level k is k; the OUT
    # stage is n_stages - 1 - k. Level n-1 (blocks of 2) is the middle
    # single stage.
    stack = [(0, 0, forward)]
    while stack:
        level, base, fwd = stack.pop()
        B = N >> level
        h = B >> 1
        in_stage = level
        out_stage = n_stages - 1 - level
        if B == 2:
            masks[in_stage][base:base + 2] = bool(fwd[0] == 1)
            continue

        # 2-color the pairing cycles. halves[i] = 0 (top) / 1 (bottom)
        # for the element at local input i.
        halves = np.full(B, -1, dtype=np.int8)
        inv = np.empty(B, dtype=np.int64)   # output slot -> input slot
        inv[fwd] = np.arange(B)
        for start in range(B):
            if halves[start] >= 0:
                continue
            i = start
            color = 0
            while halves[i] < 0:
                halves[i] = color
                # input partner must take the other half
                ip = i ^ h
                if halves[ip] < 0:
                    halves[ip] = color ^ 1
                # output partner of ip: element sharing ip's output pair
                op_out = fwd[ip] ^ h
                i = inv[op_out]
                color = halves[ip] ^ 1
        # IN stage masks: element at local input i goes to sub-slot i%h of
        # half halves[i]; swap iff (i < h) != (halves[i] == 0)
        loc = np.arange(B)
        swap_in = (halves == 1) == (loc < h)
        masks[in_stage][base:base + B] = swap_in
        # OUT stage masks: output o receives from half halves[inv-elem]:
        # swap iff (o < h) != (element's half == top)
        swap_out = (halves[inv] == 1) == (loc < h)
        masks[out_stage][base:base + B] = swap_out
        # Build sub-permutations (forward form, local to each half).
        sub_fwd = [np.empty(h, dtype=np.int64), np.empty(h, dtype=np.int64)]
        for i in range(B):
            hlf = halves[i]
            sub_fwd[hlf][i % h] = fwd[i] % h
        stack.append((level + 1, base, sub_fwd[0]))
        stack.append((level + 1, base + h, sub_fwd[1]))
    return masks


def benes_apply_np(x: np.ndarray, masks: list[np.ndarray]) -> np.ndarray:
    """Apply the stage masks to x (numpy reference)."""
    N = len(x)
    n = N.bit_length() - 1
    dists = benes_stage_distances(n)
    out = np.asarray(x)
    for mask, d in zip(masks, dists):
        y = out.reshape(N // (2 * d), 2, d)
        sw = y[:, ::-1, :].reshape(N)
        out = np.where(mask, sw, out.reshape(N))
    return out


def route_packed(perm: np.ndarray) -> np.ndarray:
    """Bit-packed stage masks for perm: the native C++ router when a host
    compiler is available (O(N log N), needed at 10M+ scale), the python
    router otherwise."""
    from .native import benes_route_native
    packed = benes_route_native(perm)
    if packed is not None:
        return packed
    return pack_masks(benes_route(perm))


def pack_masks(masks: list[np.ndarray]) -> np.ndarray:
    """Bit-pack stage masks to a (n_stages, N//8) uint8 array."""
    return np.stack([np.packbits(m.astype(np.uint8)) for m in masks])


def unpack_masks(packed: np.ndarray, n: int) -> list[np.ndarray]:
    return [np.unpackbits(row)[:n].astype(bool) for row in packed]
