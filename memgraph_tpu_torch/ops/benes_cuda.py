"""Benes network application: hand-written CUDA kernels and their plain
PyTorch versions.

Port of memgraph_tpu/ops/benes_pallas.py.  A routed Benes network over
N = 2^n slots is 2n-1 stages of masked exchanges x[i] <-> x[i ^ d] with
d = N/2 ... 2, 1, 2 ... N/2.  Every stage with d < 2^K acts inside aligned
2^K-element tiles, and those stages are contiguous in the middle of the
schedule, so the network runs as three passes:

  outer-down  stages d = 2^(n-1) .. 2^K   (benes_outer_gather)
  middle      all stages with d < 2^K     (benes_mid_gather)
  outer-up    stages d = 2^K .. 2^(n-1)   (benes_outer_gather)

For a given plan each pass is one fixed permutation, so placement composes
its stages once (on the card with the stage kernels ``benes_mid`` and
``benes_outer``) and every iteration applies it as one gather in shared
memory:

  ``compose_mid``   -> ``mid_idx``: for every slot, the position inside
                       its aligned 2^K tile it takes its value from;
  ``compose_outer`` -> ``outer_idx`` (2, N): per side, the row of the
                       (2^(n-K), 2^K) view it takes its value from (outer
                       stages exchange rows within a column).

Masks go to the card as the router packed them: one row of ⌈N/8⌉ bytes
a live stage, bit i of a row being ``(row[i >> 3] >> (7 - (i & 7))) & 1``
(np.packbits order).  ``build_masks`` only selects and orders the live
rows (middle stages, then the outer stages, down side first); nothing on
the placement path unpacks them.

K is the tile size of the middle pass: a tile lives in one block's shared
memory on the card, so 2^K values must fit in it (K = 15 for f32, 16 for
bf16: 128 KB either way).  The permutation does not depend on K.

``benes_mid`` / ``benes_mid_gather`` / ``benes_outer`` /
``benes_outer_gather`` / ``benes_apply`` are the wrappers: a CUDA tensor
goes to the kernels of ``csrc/benes.cu`` (and the kernel's ``launches``
count goes up by one), a CPU tensor to the plain version, any other device
raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .benes import benes_stage_distances

#: shared memory one block may use on an H100 (232,448 bytes)
SMEM_BYTES = 227 * 1024
#: middle-tile log2 size per routed dtype: 2^K values in 128 KB
K_BY_DTYPE = {torch.float32: 15, torch.bfloat16: 16}
_MAX_STAGES = 64            # StageList capacity in csrc/benes.cu


@dataclass(frozen=True)
class BenesSpec:
    """Static routing metadata of one network.

    mid_stages / outer_down / outer_up: tuples of (row, distance) in
    application order, row indexing ``build_masks``' mid rows (middle
    stages) or outer rows (both outer sides).  Dead (all-zero-mask)
    stages are omitted.
    """
    net_log2: int
    K: int
    mid_stages: tuple
    outer_down: tuple
    outer_up: tuple


def build_masks(masks_packed: np.ndarray, net_log2: int, K: int):
    """Select the live stages of bit-packed stage masks (n_stages, ⌈N/8⌉
    uint8, packbits order, as the router emits them) and split them into
    the middle pass (d < 2^K) and the two outer sides, as the JAX
    package's ``build_pallas_masks`` does; nothing is unpacked.

    Returns (spec, mid_rows, outer_rows):
      mid_rows   (n_mid, ⌈N/8⌉) uint8, the live middle stages' rows in
                 application order
      outer_rows (n_outer, ⌈N/8⌉) uint8, the live outer stages' rows, down
                 side first, or None when the net fits one tile
    Tiles above 2^16 slots and row indices above 15 bits (n - K > 15) are
    refused: the placed indices store tile positions in 16 bits and rows
    as int16.
    """
    N = 1 << net_log2
    K = min(K, net_log2)
    if K > 16:
        raise ValueError(f"2^{K}-slot tiles: the middle index holds "
                         "positions of at most 2^16-slot tiles")
    if net_log2 - K > 15:
        raise ValueError(f"2^{net_log2 - K} rows of 2^{K} slots: the outer "
                         "row index holds at most 2^15 rows")
    dists = benes_stage_distances(net_log2)
    n_stages = len(dists)
    assert masks_packed.shape == (n_stages, -(-N // 8)), masks_packed.shape
    mid, down, up = [], [], []
    for s, d in enumerate(dists):
        if not masks_packed[s].any():
            continue                   # dead stage: no swaps routed
        if d < (1 << K):
            mid.append(s)
        else:
            (down if s < n_stages // 2 else up).append(s)
    spec = BenesSpec(
        net_log2=net_log2, K=K,
        mid_stages=tuple((i, dists[s]) for i, s in enumerate(mid)),
        outer_down=tuple((i, dists[s]) for i, s in enumerate(down)),
        outer_up=tuple((len(down) + i, dists[s]) for i, s in enumerate(up)))
    outer = (np.take(masks_packed, down + up, axis=0)
             if net_log2 > K else None)
    return spec, np.take(masks_packed, mid, axis=0), outer


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _stage_bits(row, N: int):
    """The (N,) bool mask of one packed row (uint8 tensor, packbits
    order), unpacked with torch shifts on the row's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=row.device)
    return ((row.unsqueeze(1) >> shifts) & 1).reshape(-1)[:N].bool()


def _apply_stages(x, rows, stages):
    """x[i] <- bit_i ? x[i ^ d] : x[i] for each (row, d) in order;
    rows: (R, ⌈N/8⌉) uint8 packed mask rows."""
    flat = x.reshape(-1)
    N = flat.numel()
    for r, d in stages:
        m = _stage_bits(rows[r], N)
        sw = flat.view(N // (2 * d), 2, d).flip(1).reshape(N)
        flat = torch.where(m, sw, flat)
    return flat.view(x.shape)


def benes_mid_reference(x, mid_rows, spec: BenesSpec):
    return _apply_stages(x, mid_rows, spec.mid_stages)


def benes_mid_gather_reference(x, mid_idx, spec: BenesSpec):
    """x[tile + mid_idx[i]] for every slot i.  mid_idx is int16 storage of
    unsigned 16-bit positions (up to 65535 at K = 16): read unsigned."""
    T = 1 << spec.K
    src = mid_idx.reshape(-1, T).to(torch.int64) & 0xFFFF
    return x.reshape(-1, T).gather(1, src).view(x.shape)


def benes_outer_reference(x, outer_rows, stages):
    return _apply_stages(x, outer_rows, stages)


def benes_outer_gather_reference(x, outer_idx, spec: BenesSpec):
    """x[outer_idx[g, c], c] for every slot (g, c) of the (2^(n-K), 2^K)
    view; outer_idx: one side's (N,) int16 row index (rows < 2^15)."""
    M = 1 << spec.K
    src = outer_idx.reshape(-1, M).to(torch.int64)
    return x.reshape(-1, M).gather(0, src).view(x.shape)


def benes_apply_reference(x, mid_rows, outer_rows, spec: BenesSpec):
    """The whole network in plain PyTorch, stage by stage (from the packed
    rows: ``benes_apply``'s oracle covers the composition too)."""
    if spec.outer_down:
        x = benes_outer_reference(x, outer_rows, spec.outer_down)
    if spec.mid_stages:
        x = benes_mid_reference(x, mid_rows, spec)
    if spec.outer_up:
        x = benes_outer_reference(x, outer_rows, spec.outer_up)
    return x


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from ._build import load_kernels
    lib = load_kernels()["benes"]
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.benes_mid.restype = i32
    lib.benes_mid.argtypes = [vp, vp, vp, i64, i64, i32, i32, ip, i32, vp]
    lib.benes_mid_gather.restype = i32
    lib.benes_mid_gather.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    lib.benes_outer.restype = i32
    lib.benes_outer.argtypes = [vp, vp, vp, i64, i64, i32, i32, ip, i32, vp]
    lib.benes_outer_gather.restype = i32
    lib.benes_outer_gather.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    lib.benes_error_string.restype = ctypes.c_char_p
    lib.benes_error_string.argtypes = [i32]
    return lib


@functools.cache
def _codes(stages: tuple):
    """Stage list as the kernel's ints: row << 8 | log2(d)."""
    if len(stages) > _MAX_STAGES:
        raise ValueError(f"{len(stages)} stages > {_MAX_STAGES}")
    arr = (ctypes.c_int * max(1, len(stages)))(
        *[(r << 8) | (d.bit_length() - 1) for r, d in stages])
    return arr, len(stages)


def _check(x, idx, spec: BenesSpec):
    """x (values) and a gather's placed int16 index."""
    N = 1 << spec.net_log2
    if x.dtype not in K_BY_DTYPE:
        raise TypeError(f"Benes kernels move float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.numel() != N or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous tensor of {N} values")
    if (idx.device != x.device or idx.dtype != torch.int16
            or idx.numel() != N or not idx.is_contiguous()):
        raise ValueError(f"the index must be a contiguous int16 tensor of "
                         f"{N} on {x.device}")
    if (1 << spec.K) * x.element_size() > SMEM_BYTES:
        raise ValueError(f"a 2^{spec.K} tile of {x.dtype} does not fit in "
                         "one block's shared memory")


def _check_stages(x, rows, stages, spec: BenesSpec, y, align_from: int):
    """x (values), y (output) and the packed mask rows a stage kernel
    reads: (R, ⌈N/8⌉) contiguous uint8 on x's device holding every row
    the stages name; 16-byte aligned where 2^K >= 2^align_from (the
    kernel then moves 16-byte vectors)."""
    N = 1 << spec.net_log2
    if x.dtype not in K_BY_DTYPE:
        raise TypeError(f"Benes kernels move float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.numel() != N or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous tensor of {N} values")
    if y.numel() != N or y.dtype != x.dtype or not y.is_contiguous():
        raise ValueError("out must be a contiguous tensor like x")
    if (rows.device != x.device or rows.dtype != torch.uint8
            or rows.dim() != 2 or rows.shape[1] != -(-N // 8)
            or rows.shape[0] <= max((r for r, _ in stages), default=-1)
            or not rows.is_contiguous()):
        raise ValueError(f"mask rows must be a contiguous uint8 tensor of "
                         f"packed rows (R, {-(-N // 8)}) on {x.device} "
                         "holding every row the stages name")
    if spec.K >= align_from and any(t.data_ptr() % 16 for t in (x, y, rows)):
        raise ValueError("the stage kernels move 16-byte vectors: x, out "
                         "and the mask rows must be 16-byte aligned")


def _raise_on(rc: int, name: str):
    if rc != 0:
        msg = _lib().benes_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _target(x, out):
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"Benes kernels run on cuda or cpu, not {x.device}")
    return torch.empty_like(x) if out is None else out


def benes_mid(x, mid_rows, spec: BenesSpec, out=None):
    """All middle stages, from the packed mask rows (``build_masks``).
    CUDA: one launch of ``benes_mid``; writes into ``out`` (may be ``x``
    itself) or a new tensor.  CPU: plain version."""
    y = _target(x, out)
    if y is None:
        res = benes_mid_reference(x, mid_rows, spec)
        return res if out is None else out.copy_(res)
    _check_stages(x, mid_rows, spec.mid_stages, spec, y, align_from=7)
    # the tile and a ring of 8 stage slices of 2^K/8 bytes
    if (1 << spec.K) * (x.element_size() + 1) > SMEM_BYTES:
        raise ValueError(f"a 2^{spec.K} tile of {x.dtype} and its mask ring "
                         "do not fit in one block's shared memory")
    codes, n = _codes(spec.mid_stages)
    rc = _lib().benes_mid(
        x.data_ptr(), y.data_ptr(), mid_rows.data_ptr(), mid_rows.shape[1],
        1 << spec.net_log2, spec.K, x.element_size(), codes, n, _stream(x))
    _raise_on(rc, "benes_mid")
    benes_mid.launches += 1
    return y


benes_mid.launches = 0


def benes_mid_gather(x, mid_idx, spec: BenesSpec, out=None):
    """The middle pass as a gather by the placed index (``compose_mid``).
    CUDA: one launch of ``benes_mid_gather``; writes into ``out`` (may be
    ``x`` itself) or a new tensor.  CPU: plain version."""
    y = _target(x, out)
    if y is None:
        res = benes_mid_gather_reference(x, mid_idx, spec)
        return res if out is None else out.copy_(res)
    _check(x, mid_idx, spec)
    if y.numel() != x.numel() or y.dtype != x.dtype or not y.is_contiguous():
        raise ValueError("out must be a contiguous tensor like x")
    if spec.K >= 3 and any(t.data_ptr() % 16 for t in (x, y, mid_idx)):
        raise ValueError("benes_mid_gather moves 16-byte vectors: x, out "
                         "and mid_idx must be 16-byte aligned")
    rc = _lib().benes_mid_gather(
        x.data_ptr(), y.data_ptr(), mid_idx.data_ptr(), 1 << spec.net_log2,
        spec.K, x.element_size(), _stream(x))
    _raise_on(rc, "benes_mid_gather")
    benes_mid_gather.launches += 1
    return y


benes_mid_gather.launches = 0


def compose_mid(mid_rows, spec: BenesSpec):
    """The middle stages composed into one tile-local index, once per plan:
    an (N,) int16 tensor on mid_rows' device whose slot i holds the
    position inside i's 2^K tile that slot i takes its value from (stored
    as int16, read as unsigned 16 bits: K <= 16).

    The stages are applied to an iota of tile-local positions, moved as
    raw 16-bit words, straight from the packed mask rows: on the card by
    the stage kernel ``benes_mid`` (one launch), on the CPU by the plain
    ``_apply_stages``.  A network with no live middle stage launches
    nothing and gets the iota."""
    N, T = 1 << spec.net_log2, 1 << spec.K
    tile = torch.from_numpy(np.arange(T, dtype=np.uint16).view(np.int16))
    iota = tile.to(mid_rows.device).repeat(N // T)
    if not spec.mid_stages:
        return iota
    if mid_rows.device.type == "cpu":
        return _apply_stages(iota, mid_rows, spec.mid_stages)
    return benes_mid(iota.view(torch.bfloat16), mid_rows,
                     spec).view(torch.int16)


def benes_outer(x, outer_rows, stages: tuple, spec: BenesSpec, out=None):
    """One side's outer stages, from the packed mask rows
    (``build_masks``).  CUDA: one launch of ``benes_outer``; writes into
    ``out`` (may be ``x``) or a new tensor.  CPU: plain version.  Runs at
    placement only (``compose_outer``)."""
    y = _target(x, out)
    if y is None:
        res = benes_outer_reference(x, outer_rows, stages)
        return res if out is None else out.copy_(res)
    _check_stages(x, outer_rows, stages, spec, y, align_from=5)
    codes, n = _codes(stages)
    rc = _lib().benes_outer(
        x.data_ptr(), y.data_ptr(), outer_rows.data_ptr(),
        outer_rows.shape[1], 1 << spec.net_log2, spec.K, x.element_size(),
        codes, n, _stream(x))
    _raise_on(rc, "benes_outer")
    benes_outer.launches += 1
    return y


benes_outer.launches = 0


def benes_outer_gather(x, outer_idx, spec: BenesSpec, out=None):
    """One side's outer pass as a gather by its placed row index (a row of
    ``compose_outer``'s result).  CUDA: one launch of
    ``benes_outer_gather``; writes into ``out`` (may be ``x`` itself) or a
    new tensor.  CPU: plain version."""
    y = _target(x, out)
    if y is None:
        res = benes_outer_gather_reference(x, outer_idx, spec)
        return res if out is None else out.copy_(res)
    _check(x, outer_idx, spec)
    if y.numel() != x.numel() or y.dtype != x.dtype or not y.is_contiguous():
        raise ValueError("out must be a contiguous tensor like x")
    # 16-byte copies wherever a row of the (2^(n-K), 2^K) view has 16 bytes
    align = 16 if x.element_size() << spec.K >= 16 else 4
    if any(t.data_ptr() % align for t in (x, y, outer_idx)):
        raise ValueError(f"benes_outer_gather moves {align}-byte vectors: x, "
                         f"out and outer_idx must be {align}-byte aligned")
    rc = _lib().benes_outer_gather(
        x.data_ptr(), y.data_ptr(), outer_idx.data_ptr(), 1 << spec.net_log2,
        spec.K, x.element_size(), _stream(x))
    _raise_on(rc, "benes_outer_gather")
    benes_outer_gather.launches += 1
    return y


benes_outer_gather.launches = 0


def compose_outer(outer_rows, spec: BenesSpec):
    """Each side's outer stages composed into one row index, once per
    plan: a (2, N) int16 tensor on outer_rows' device, row 0 the down
    side and row 1 the up side, whose slot g·2^K + c holds the row that
    slot (g, c) of the (2^(n-K), 2^K) view takes its value from in that
    side's pass (the column is always c; rows < 2^15).

    The stages are applied to an iota of rows (``i >> K``), moved as raw
    16-bit words, straight from the packed mask rows: on the card by the
    stage kernel ``benes_outer`` (one launch per live side), on the CPU by
    the plain ``_apply_stages``.  A side with no live stage launches
    nothing and gets the iota."""
    N = 1 << spec.net_log2
    dev = outer_rows.device
    rows = (torch.arange(N, dtype=torch.int32, device=dev)
            >> spec.K).to(torch.int16)
    idx = rows.repeat(2, 1)
    for side, stages in enumerate((spec.outer_down, spec.outer_up)):
        if not stages:
            continue
        if dev.type == "cpu":
            idx[side] = _apply_stages(rows, outer_rows, stages)
        else:
            benes_outer(rows.view(torch.bfloat16), outer_rows, stages, spec,
                        out=idx[side].view(torch.bfloat16))
    return idx


def reset_launch_counts():
    benes_mid.launches = 0
    benes_mid_gather.launches = 0
    benes_outer.launches = 0
    benes_outer_gather.launches = 0


def _outer_sides(spec: BenesSpec) -> int:
    return int(bool(spec.outer_down)) + int(bool(spec.outer_up))


def launches_per_apply(spec: BenesSpec) -> dict:
    """Kernel launches one ``benes_apply`` of this network makes."""
    return {"benes_mid_gather": int(bool(spec.mid_stages)),
            "benes_outer_gather": _outer_sides(spec)}


def launches_per_placement(spec: BenesSpec) -> dict:
    """Stage-kernel launches placing this network makes (``compose_mid``
    and ``compose_outer``)."""
    return {"benes_mid": int(bool(spec.mid_stages)),
            "benes_outer": _outer_sides(spec)}


def benes_apply(x2, mid_idx, outer_idx, spec: BenesSpec):
    """Apply the network to x2 (the (N/128, 128) layout, or flat when
    N < 128; f32 or bf16); mid_idx from ``compose_mid``, outer_idx from
    ``compose_outer`` (None when the net fits one tile).  Returns a new
    tensor, or x2 itself when every stage is dead."""
    y = x2
    if spec.outer_down:
        y = benes_outer_gather(y, outer_idx[0], spec)
    if spec.mid_stages:
        y = benes_mid_gather(y, mid_idx, spec,
                             out=None if y is x2 else y)
    if spec.outer_up:
        y = benes_outer_gather(y, outer_idx[1], spec,
                               out=None if y is x2 else y)
    return y
