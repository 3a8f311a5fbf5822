"""Deterministic segment sums: hand-written CUDA kernels and their plain
PyTorch versions.

The JAX package reduces its semiring sums with a sorted
``jax.ops.segment_sum`` (memgraph_tpu/ops/semiring.py:edge_reduce), an
XLA reduction whose order is fixed.  ``index_add_`` on CUDA adds with
float atomics, in an order that changes from run to run, so the port sums
floats here instead (``csrc/segment.cu``):

  ``csr_spmm_sum`` (K1)  y[j, l] = Σ_e r(x[g[e], l] ⊗ w[e]) over the run
                         e ∈ [ptr[j], ptr[j+1]), in run order from 0.0:
                         ⊗ = times or first, r the
                         identity (f32) or a round trip through bfloat16
                         (bf16), g absent when x holds a row a run element.
  ``lane_sum`` (K2)      (n, B) -> (B,): Σ v, Σ v·m or Σ |a − b| a lane, in a
                         fixed order that does not depend on B (chunks of
                         256 rows, each by the halving tree, then the
                         partials the same way).

Each is bit-equal to its plain version (``*_reference``) and gives a
column the same bits alone or beside other lanes.  The plain version of K1
is ``index_add_`` in edge order on the CPU, which adds sequentially.

The designs (one launch a call each; the order of the adds is the
contract, what they spread is the loads):
  K1  short runs (at most ``long_run()`` elements) get a thread a (run,
      lane); longer ones a warp of the long role (the first blocks of the
      launch), whose lanes copy a chunk of run elements at once by
      cp.async into a ring in shared memory, chunks ahead of the adds,
      which stay in run order.  The caller may pass the longest run
      (a graph records its own once, ``DeviceGraph.longest_csc_run`` /
      ``longest_csr_run``): when no run is long, the launch is the short
      walk alone, with no long role and no ring.  The kernel's C entry
      decides the launch shape.
  K2  a warp reduces a chunk of a column in registers and shuffles (lane t
      holds rows 32k + t; replayed by ``lane_sum_schedule``); the block
      that arrives last at a chunk of the next level reduces it, so every
      level runs in the one launch.  Its tickets are a zeroed buffer a
      stream, which every call leaves zeroed.

The wrappers take the plain version for a CPU tensor; for a CUDA tensor
they launch the kernel (and count the launch in ``.launches``) or raise.
Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: rows a lane_sum chunk reduces (kChunk in csrc/segment.cu)
CHUNK = 256
#: lanes a lane_sum block holds (kLaneTile), past WARP_LANES lanes; up to
#: WARP_LANES, lane_sum runs by warps alone (kWarpLanes)
LANE_TILE = 32
WARP_LANES = 8

_MULS = {"first": 0, "times": 1}
_FORMS = {"sum": 0, "dot": 1, "l1": 2}


def segment_runs(ids, num_segments: int):
    """(num_segments + 1,) int32 run offsets of sorted segment ids: run j
    is [ptr[j], ptr[j+1]), the ids equal to j; ids outside [0,
    num_segments) lie in no run (jax.ops.segment_sum drops them).
    Computed on the ids' device (``torch.searchsorted``)."""
    bounds = torch.arange(num_segments + 1, dtype=ids.dtype,
                          device=ids.device)
    return torch.searchsorted(ids, bounds, out_int32=True)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _contributions(x2, lo, hi, g, w, mul, precision):
    """r(x[g[e]] ⊗ w[e]) for e in [lo, hi), as an (hi - lo, B) tensor."""
    vals = x2[g[lo:hi]] if g is not None else x2[lo:hi]
    if mul == "times":
        vals = vals * w[lo:hi].unsqueeze(1)
    if precision == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return vals


def csr_spmm_sum_reference(x, ptr, g=None, w=None, *, mul="times",
                           precision="f32"):
    """K1's plain version: the contributions, then ``index_add_`` in edge
    order into zeros (sequential on the CPU: run order from 0.0)."""
    x2 = x if x.dim() == 2 else x.reshape(-1, 1)
    n_seg = ptr.numel() - 1
    lo, hi = int(ptr[0]), int(ptr[-1])
    vals = _contributions(x2, lo, hi, g, w, mul, precision)
    counts = (ptr[1:] - ptr[:-1]).long()
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=x.device), counts)
    out = torch.zeros(n_seg, x2.shape[1], dtype=torch.float32,
                      device=x.device).index_add_(0, ids, vals)
    return out if x.dim() > 1 else out.view(n_seg)


def _lane_form(a, b, m):
    a2 = a if a.dim() == 2 else a.reshape(-1, 1)
    if b is not None:
        return (a2 - b.reshape(a2.shape)).abs()
    if m is not None:
        return a2 * m.reshape(-1, 1)
    return a2


def lane_sum_reference(a, b=None, m=None):
    """K2's plain version: the same chunked halving trees, as elementwise
    adds of slices."""
    v = _lane_form(a, b, m)
    lanes = v.shape[1]
    while True:
        rows = v.shape[0]
        chunks = max(1, -(-rows // CHUNK))
        pad = chunks * CHUNK - rows
        if pad:
            v = torch.cat([v, v.new_zeros(pad, lanes)])
        v = v.view(chunks, CHUNK, lanes)
        h = CHUNK // 2
        while h >= 1:
            v = v[:, :h] + v[:, h:2 * h]
            h //= 2
        v = v.reshape(chunks, lanes)
        if chunks == 1:
            out = v[0]
            return out if a.dim() > 1 else out.view(())


# ---------------------------------------------------------------------------
# lane_sum's scratch and schedule (replayed on the CPU by the tests)
# ---------------------------------------------------------------------------

def lane_sum_scratch(rows: int, lanes: int):
    """K2's scratch: (floats, tickets) — the partials of every level after
    the first, and a ticket counter a chunk of those levels and lane
    tile."""
    tiles = 1 if lanes <= WARP_LANES else -(-lanes // LANE_TILE)
    floats = tickets = 0
    r = rows
    while True:
        chunks = max(1, -(-r // CHUNK))
        if chunks == 1:
            return floats, tickets
        r = chunks
        floats += r * lanes
        tickets += max(1, -(-r // CHUNK)) * tiles


def lane_sum_schedule(a, b=None, m=None):
    """K2 replayed as the kernel computes it: each chunk of a column by a
    warp (from device memory up to WARP_LANES lanes, else from the block's
    shared copy), lane t holding rows 32k + t in v[k]; h = 128, 64, 32 as
    adds of registers (v[k] += v[k+4], v[k] += v[k+2], v[0] += v[1]),
    h = 16 .. 1 as ``__shfl_down_sync`` (a lane past 31 reads its own
    value), lane 0's value the chunk's; then the partials, level by
    level."""
    v = _lane_form(a, b, m)
    lanes = v.shape[1]
    t = torch.arange(32)
    while True:
        rows = v.shape[0]
        chunks = max(1, -(-rows // CHUNK))
        pad = chunks * CHUNK - rows
        if pad:
            v = torch.cat([v, v.new_zeros(pad, lanes)])
        reg = list(v.view(chunks, 8, 32, lanes).unbind(1))
        for k in range(4):
            reg[k] = reg[k] + reg[k + 4]
        for k in range(2):
            reg[k] = reg[k] + reg[k + 2]
        lane_v = reg[0] + reg[1]
        for h in (16, 8, 4, 2, 1):
            src = torch.where(t + h < 32, t + h, t)
            lane_v = lane_v + lane_v[:, src]
        v = lane_v[:, 0]
        if chunks == 1:
            out = v[0]
            return out if a.dim() > 1 else out.view(())


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from ._build import load_kernels
    lib = load_kernels()["segment"]
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.csr_spmm_sum.restype = i32
    lib.csr_spmm_sum.argtypes = [vp, vp, i32, vp, i32, vp, vp, i64, i32,
                                 i32, i32, i64, vp]
    lib.lane_sum.restype = i32
    lib.lane_sum.argtypes = [vp, vp, vp, vp, vp, i64, vp, i64, i64, i32, i32,
                             vp]
    lib.segment_long_run.restype = i32
    lib.segment_long_run.argtypes = []
    lib.segment_error_string.restype = ctypes.c_char_p
    lib.segment_error_string.argtypes = [i32]
    return lib


def long_run() -> int:
    """The longest run that csr_spmm_sum's short walk takes beside a long
    role (kLong in csrc/segment.cu); builds the kernels."""
    return _lib().segment_long_run()


def _raise_on(rc: int, name: str):
    if rc != 0:
        msg = _lib().segment_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


#: (device index, stream) -> int32 ticket counters of lane_sum, zeroed once
#: and left zeroed by every call on that stream
_TICKETS: dict = {}


def _tickets(device, stream: int, n: int):
    key = (device.index, stream)
    held = _TICKETS.get(key)
    if held is None or held.numel() < n:
        held = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _TICKETS[key] = held
    return held


def _on_card(x, name: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _index(t, what: str, dev, n=None):
    if (t.device != dev or t.dtype not in (torch.int32, torch.int64)
            or t.dim() != 1 or (n is not None and t.numel() != n)):
        raise ValueError(f"{what} must be a 1-D int32 or int64 tensor"
                         + (f" of {n}" if n is not None else "")
                         + f" on {dev}")


def _check_spmm(x, ptr, g, w, mul, precision):
    if mul not in _MULS:
        raise ValueError(f"csr_spmm_sum combines by {tuple(_MULS)}, not "
                         f"{mul!r}")
    if precision not in ("f32", "bf16"):
        raise ValueError(f"csr_spmm_sum rounds f32 or bf16, not "
                         f"{precision!r}")
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise TypeError("csr_spmm_sum sums a float32 (n,) or (n, B) x, "
                        f"not {x.dtype} {tuple(x.shape)}")
    _index(ptr, "ptr", x.device)
    if ptr.numel() < 1:
        raise ValueError("ptr needs at least one offset")
    n_edges = x.shape[0]
    if g is not None:
        _index(g, "g", x.device)
        n_edges = g.numel()
    if mul == "times":
        if (w is None or w.device != x.device or w.dtype != torch.float32
                or w.dim() != 1 or w.numel() != n_edges):
            raise ValueError(f"⊗ = times needs a float32 w of {n_edges} on "
                             f"{x.device}")
    elif w is not None:
        raise ValueError("⊗ = first reads no w")


def csr_spmm_sum(x, ptr, g=None, w=None, *, mul: str = "times",
                 precision: str = "f32", longest: int | None = None):
    """K1: the run sums of ``r(x[g[e]] ⊗ w[e])``, (n_seg,) for a 1-D x and
    (n_seg, B) for an (n_in, B) one, n_seg = len(ptr) - 1.  ``ptr`` holds
    non-decreasing offsets into the run elements (``g``'s, or x's rows
    when g is None); the kernel trusts them and g's rows.  ``longest``:
    the longest run, when the caller knows it (None: unknown); it picks
    the launch shape and never the result.  CUDA: one launch.  CPU: the
    plain version."""
    _check_spmm(x, ptr, g, w, mul, precision)
    if longest is not None and longest < 0:
        raise ValueError(f"longest is a run length, not {longest}")
    if not _on_card(x, "csr_spmm_sum"):
        return csr_spmm_sum_reference(x, ptr, g, w, mul=mul,
                                      precision=precision)
    x = x.contiguous()
    lanes = 1 if x.dim() == 1 else x.shape[1]
    n_seg = ptr.numel() - 1
    ptr = ptr.contiguous()
    g = None if g is None else g.contiguous()
    w = None if w is None else w.contiguous()
    y = torch.empty((n_seg,) if x.dim() == 1 else (n_seg, lanes),
                    dtype=torch.float32, device=x.device)
    rc = _lib().csr_spmm_sum(
        x.data_ptr(), ptr.data_ptr(), int(ptr.dtype == torch.int64),
        None if g is None else g.data_ptr(),
        int(g is not None and g.dtype == torch.int64),
        None if w is None else w.data_ptr(), y.data_ptr(), n_seg, lanes,
        _MULS[mul], int(precision == "bf16"),
        -1 if longest is None else int(longest),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "csr_spmm_sum")
    csr_spmm_sum.launches += 1
    return y


csr_spmm_sum.launches = 0


def lane_sum(a, b=None, m=None):
    """K2: per lane, Σ a (no b, no m), Σ a·m (m one value a row) or
    Σ |a − b|; a (n, B) -> (B,), a 1-D a -> a 0-d tensor.  CUDA: one
    launch for every level of the tree.  CPU: the plain version."""
    if a.dtype != torch.float32 or a.dim() not in (1, 2):
        raise TypeError("lane_sum reduces a float32 (n,) or (n, B) tensor, "
                        f"not {a.dtype} {tuple(a.shape)}")
    if b is not None and m is not None:
        raise ValueError("lane_sum takes b or m, not both")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or b.device != a.device):
        raise ValueError("b must be a float32 tensor like a")
    if m is not None and (m.dim() != 1 or m.numel() != a.shape[0]
                          or m.dtype != a.dtype or m.device != a.device):
        raise ValueError(f"m must be a float32 tensor of {a.shape[0]} rows")
    if not _on_card(a, "lane_sum"):
        return lane_sum_reference(a, b, m)
    form = "l1" if b is not None else "dot" if m is not None else "sum"
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    m = None if m is None else m.contiguous()
    rows = a.shape[0]
    lanes = 1 if a.dim() == 1 else a.shape[1]
    out = torch.empty(lanes, dtype=torch.float32, device=a.device)
    floats, n_tickets = lane_sum_scratch(rows, lanes)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32,
                          device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tickets = _tickets(a.device, stream, n_tickets)
    rc = _lib().lane_sum(
        a.data_ptr(), None if b is None else b.data_ptr(),
        None if m is None else m.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), floats, tickets.data_ptr(), tickets.numel(),
        rows, lanes, _FORMS[form], stream)
    _raise_on(rc, "lane_sum")
    lane_sum.launches += 1
    return out if a.dim() > 1 else out.view(())


lane_sum.launches = 0


def reset_launch_counts():
    csr_spmm_sum.launches = 0
    lane_sum.launches = 0
