"""lane_gather_loop's and gather_loop's launch shapes and designs, on the
CPU.

``micro3.lane_gather_loop_tiling`` (32 rows a block, a row a lane,
positions dealt over warps) and ``micro.gather_loop_tiling`` (a column a
block, the column carried in and out by 32 x 32 tile transposes) give the
shapes the kernels on the card take.  ``lane_gather_loop_schedule`` and
``gather_loop_schedule`` replay each design in plain torch through a
model of its shared memory: they must be bit-equal to the plain versions
and to benchmarks/pallas_micro*.py in interpret mode.  ``bank_ways``
counts the wavefronts of a warp instruction: 1 for every shared access of
lane_gather_loop, whatever the indices.
Tolerance: bit-exact (the kernels only move values and add 1).
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu_torch.benchmarks import _common, loop_split, micro, micro3

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMS = [132, 114]
_SMEM = 232_448


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}_loops", os.path.join(_REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jm1():
    return _load("pallas_micro")


@pytest.fixture(scope="module")
def jm3():
    return _load("pallas_micro3")


def _capture(monkeypatch, mod, helper):
    """Replace mod.<helper> (timeit or timeit1) by one call recording (fn,
    numpy inputs, numpy output)."""
    calls = []

    def once(fn, *args, n=0):
        out = fn(*args)
        calls.append((fn, [np.asarray(a) for a in args], np.asarray(out)))
        return (1.0, out) if helper == "timeit" else 1.0

    monkeypatch.setattr(mod, helper, once)
    return calls


def _same_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got.view(np.int32), want.view(np.int32)))


# ---------------------------------------------------------------------------
# launch shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sms", _SMS)
@pytest.mark.parametrize("R", [8, 100, 256, 4096])
def test_lane_gather_loop_tiling_gives_each_value_one_lane(R, n_sms):
    t = micro3.lane_gather_loop_tiling(R, n_sms)
    rows, W, P = t["rows_per_block"], t["warps"], t["positions_per_warp"]
    assert rows == 32 and W * P == 128 and t["threads"] == 32 * W
    assert t["blocks"] == -(-R // rows) and t["cluster"] == 1
    # (block, warp, lane, slot) -> (row 32 b + lane, position P w + slot)
    b, w, lane, i = np.meshgrid(np.arange(t["blocks"]), np.arange(W),
                                np.arange(32), np.arange(P), indexing="ij")
    r, p = rows * b + lane, P * w + i
    own = np.zeros((t["blocks"] * rows, 128), dtype=np.int64)
    np.add.at(own, (r.ravel(), p.ravel()), 1)
    assert (own == 1).all()                 # every slot, ragged ones too
    assert own[:R].sum() == R * 128
    # two position-major buffers of the block's rows; the staging rows
    # (pitch 129) fit over them
    assert t["smem_bytes"] == 2 * 128 * rows * 4 <= _SMEM
    assert rows * micro3.STAGE_PITCH * 4 <= t["smem_bytes"]
    assert t["sms"] == min(t["blocks"], n_sms)
    if R == 4096:                              # the entry point's shape
        assert t["blocks"] >= 128 and t["sms"] >= min(128, n_sms)


@pytest.mark.parametrize("n_sms", _SMS)
@pytest.mark.parametrize("R", [8, 256, 8192, 16384])
def test_gather_loop_tiling_gives_each_column_a_block(R, n_sms):
    t = micro.gather_loop_tiling(R, n_sms)
    pitch, T = t["pitch"], t["threads"]
    assert pitch % 32 == 0 and R <= pitch < R + 32
    assert t["blocks"] == 128 and t["columns_per_block"] == 1
    assert t["cluster"] == 1 and T == micro.LOOP_THREADS
    # (column l, thread k, slot m, j) -> position 4 (k + T m) + j
    k, m, j = np.meshgrid(np.arange(T), np.arange(t["groups_per_thread"]),
                          np.arange(4), indexing="ij")
    g = k + T * m
    pos = (4 * g + j)[g < pitch // 4]
    own = np.bincount(pos, minlength=pitch)
    assert len(own) == pitch and (own == 1).all()   # each column alike
    # the column twice in shared memory; tab, idx and the result in scratch
    assert t["smem_bytes"] == 2 * pitch * 4 <= _SMEM
    assert t["scratch"] == (3, 128, pitch)
    tiles = (pitch // 32) * (128 // 32)
    assert t["transpose_blocks"] == {"in": 2 * tiles, "out": tiles}
    assert t["transpose_threads"] == micro.TRANSPOSE_THREADS
    assert t["sms"] == min(128, n_sms)
    if R == 8192:                              # the entry point's shape
        assert t["blocks"] >= 128


def test_kernel_constants_match_the_tilings():
    """The CUDA source's shape constants are the ones the tilings use (the
    entry points refuse any other launch)."""
    src = open(os.path.join(_REPO, "memgraph_tpu_torch", "ops", "csrc",
                            "micro.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kLaneWarps") == micro3.LANE_WARPS
    assert const("kLaneRows") == micro3.LANE_ROWS
    assert const("kTT") == micro.TRANSPOSE_TILE
    assert const("kTTThreads") == micro.TRANSPOSE_THREADS
    assert const("kBlockThreads") == micro.LOOP_THREADS
    assert const("kLoopVecs") * 4 * micro.LOOP_THREADS == micro.MAX_LOOP_ROWS
    assert "__shfl" not in src[src.index("lane_gather_loop_kernel("):
                               src.index("// transpose_loop <-")]


# ---------------------------------------------------------------------------
# schedule replays against the plain versions and Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 3, 7])
def test_lane_gather_loop_schedule_matches_plain_and_pallas(jm3, monkeypatch,
                                                            iters):
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_lane_gather_loop(R=256, iters=iters)
    (fn, (x, idx), want), = calls
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    assert _same_bits(micro3.lane_gather_loop_schedule(tx, ti, iters), want)
    assert _same_bits(micro3.lane_gather_loop_reference(tx, ti, iters), want)
    # random values and indices through the same Pallas program
    rng = np.random.default_rng(50 + iters)
    x2 = rng.standard_normal(x.shape).astype(np.float32)
    i2 = rng.integers(0, 128, x.shape).astype(np.int32)
    want2 = np.asarray(fn(jnp.asarray(x2), jnp.asarray(i2)))
    got2 = micro3.lane_gather_loop_schedule(torch.from_numpy(x2),
                                            torch.from_numpy(i2), iters)
    assert _same_bits(got2, want2)


@pytest.mark.parametrize("R,iters", [(100, 3), (1, 2), (33, 5)])
def test_lane_gather_loop_schedule_ragged_rows(jm3, monkeypatch, R, iters):
    """A last block with fewer than 32 rows: its missing rows are zeros in
    the model and nothing of them is written."""
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_lane_gather_loop(R=R, iters=iters)
    (_, (x, idx), want), = calls
    got = micro3.lane_gather_loop_schedule(torch.from_numpy(x),
                                           torch.from_numpy(idx), iters)
    assert _same_bits(got, want)


@pytest.mark.parametrize("iters", [1, 3, 7])
def test_gather_loop_schedule_matches_plain_and_pallas(jm1, monkeypatch,
                                                       iters):
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_gather_loop(256, iters=iters)
    (fn, (tab, idx), want), = calls
    tt, ti = torch.from_numpy(tab), torch.from_numpy(idx)
    assert _same_bits(micro.gather_loop_schedule(tt, ti, iters), want)
    assert _same_bits(micro.gather_loop_reference(tt, ti, iters), want)
    rng = np.random.default_rng(60 + iters)
    t2 = rng.standard_normal(tab.shape).astype(np.float32)
    i2 = rng.integers(0, 256, tab.shape).astype(np.int32)
    want2 = np.asarray(fn(jnp.asarray(t2), jnp.asarray(i2)))
    got2 = micro.gather_loop_schedule(torch.from_numpy(t2),
                                      torch.from_numpy(i2), iters)
    assert _same_bits(got2, want2)


@pytest.mark.parametrize("R,iters", [(200, 3), (8, 5)])
def test_gather_loop_schedule_pads_a_ragged_column(jm1, monkeypatch, R,
                                                   iters):
    """R not a multiple of 32: the column-major scratch is padded with
    value 0 and index 0, and the padding never reaches out."""
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_gather_loop(R, iters=iters)
    (_, (tab, idx), want), = calls
    got = micro.gather_loop_schedule(torch.from_numpy(tab),
                                     torch.from_numpy(idx), iters)
    assert _same_bits(got, want)


# ---------------------------------------------------------------------------
# shared-memory banks
# ---------------------------------------------------------------------------

def test_bank_ways_counts_distinct_addresses_per_bank():
    lanes = torch.arange(32)
    assert _common.bank_ways(lanes) == 1               # one word a bank
    assert _common.bank_ways(torch.full((32,), 7)) == 1    # a broadcast
    assert _common.bank_ways(32 * lanes) == 32          # all in bank 0
    assert _common.bank_ways(lanes * 129) == 1          # a padded column
    assert _common.bank_ways(lanes * 132) == 4          # pitch 132: 4-way
    assert _common.bank_ways(torch.tensor([0, 32, 32, 64] + [1] * 28)) == 3


@pytest.mark.parametrize("kind", ["random", "one_position", "one_row"])
def test_lane_gather_loop_schedule_is_free_of_bank_conflicts(kind):
    """Every warp instruction of the design (staging in and out, the
    position-major writes, each pass's reads and writes) takes one
    wavefront, for random indices and for adversarial ones."""
    R, iters = 256, 3
    rng = np.random.default_rng(70)
    x = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    if kind == "random":
        idx = rng.integers(0, 128, (R, 128))
    elif kind == "one_position":               # all lanes read position 5
        idx = np.full((R, 128), 5)
    else:                           # each row reads its own row number
        idx = np.repeat(np.arange(R)[:, None] % 128, 128, axis=1)
    idx = torch.from_numpy(idx.astype(np.int32))
    trace = []
    got = micro3.lane_gather_loop_schedule(x, idx, iters, trace=trace)
    assert torch.equal(got, micro3.lane_gather_loop_reference(x, idx, iters))
    t = micro3.lane_gather_loop_tiling(R, 132)
    # per block: staging in (2 x 4 words a 16-byte load, 2 reads), the
    # position-major write, 2 accesses a pass, the final read, staging out
    loads, P = 32 * 128 // 4 // t["threads"], t["positions_per_warp"]
    per_warp = 2 * 4 * loads + 3 * P + 2 * P * iters + 2 * P + 4 * loads
    assert len(trace) == t["blocks"] * t["warps"] * per_warp
    assert all(len(w) == 32 for w in trace)
    assert max(_common.bank_ways(w) for w in trace) == 1


def test_gather_loop_transposes_are_free_of_bank_conflicts():
    """The tile transposes' shared accesses take one wavefront each; the
    loop's random reads do not (the expected ~3.6 of the kernel's note)."""
    R = 1024
    rng = np.random.default_rng(71)
    tab = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, R, (R, 128)).astype(np.int32))
    trace = []
    got = micro.gather_loop_schedule(tab, idx, 2, trace=trace)
    assert torch.equal(got, micro.gather_loop_reference(tab, idx, 2))
    n_t = 2 * 4 * micro.TRANSPOSE_THREADS // 32  # stores, loads of a tile
    assert all(_common.bank_ways(w) == 1 for w in trace[:n_t])
    loop = [_common.bank_ways(w) for w in trace[n_t:]]
    assert len(loop) == R // 32 and 2.5 < np.mean(loop) < 5


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [100, 4096])
def test_lane_gather_loop_launch_carries_its_tiling(R, monkeypatch):
    calls = []
    monkeypatch.setattr(micro3, "on_card", lambda name, *t: True)
    monkeypatch.setattr(micro3, "launch", lambda *a: calls.append(a))
    before = micro3.lane_gather_loop.launches
    x = torch.zeros((R, 128))
    idx = torch.zeros((R, 128), dtype=torch.int32)
    out = micro3.lane_gather_loop(x, idx, 11)
    micro3.lane_gather_loop.launches = before
    t = micro3.lane_gather_loop_tiling(R, micro3.H100_SMS)
    (name, gx, gi, gout, *ints), = calls
    assert name == "lane_gather_loop" and gx is x and gi is idx
    assert gout is out and out.shape == x.shape
    assert ints == [R, 11, t["blocks"], t["threads"], t["smem_bytes"]]


@pytest.mark.parametrize("R", [8, 8192])
def test_gather_loop_launch_carries_its_tiling(R, monkeypatch):
    """One counted call hands its entry point the tiling and the scratch
    its three launches share."""
    calls = []
    monkeypatch.setattr(micro, "on_card", lambda name, *t: True)
    monkeypatch.setattr(micro, "launch", lambda *a: calls.append(a))
    before = micro.gather_loop.launches
    tab = torch.zeros((R, 128))
    idx = torch.zeros((R, 128), dtype=torch.int32)
    out = micro.gather_loop(tab, idx, 13)
    assert micro.gather_loop.launches == before + 1
    micro.gather_loop.launches = before
    t = micro.gather_loop_tiling(R, micro.H100_SMS)
    (name, gt, gi, gout, scratch, *ints), = calls
    assert name == "gather_loop" and gt is tab and gi is idx and gout is out
    assert tuple(scratch.shape) == t["scratch"]
    assert scratch.dtype == torch.float32
    assert ints == [R, 13, t["blocks"], t["threads"], t["smem_bytes"],
                    t["pitch"]]


def test_split_of_takes_t0_and_the_time_an_iteration():
    split = loop_split.split_of({0: 1.0, 1: 1.5, 50: 11.0, 100: 21.0},
                                (0, 1, 50, 100))
    assert split["t0_ms"] == 1.0 and split["per_iter_ms"] == 0.2
    assert split["iters"] == [0, 1, 50, 100] and split["ms"]["50"] == 11.0


def test_loop_split_raises_without_a_card(monkeypatch):
    """It times the card only: without one it raises before it loads or
    builds any tree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(loop_split, "tree_modules",
                        lambda *a: pytest.fail("loaded without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop_split.main([])
