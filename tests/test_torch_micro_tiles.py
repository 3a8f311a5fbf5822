"""transpose_loop's and sandwich's launch shapes and designs, on the CPU.

``micro3.transpose_loop_tiling`` / ``sandwich_tiling`` give the blocks,
cluster, threads, shared memory and regions a block owns; the kernels on
the card take exactly those shapes.  ``transpose_loop_schedule`` (each
block's quadrant pair transposed apart) and ``sandwich_schedule`` (fused
gather-transpose passes, rows to warps) replay each design in plain
torch: they must be bit-equal to the plain versions and to
benchmarks/pallas_micro3.py in interpret mode.
Tolerance: bit-exact (the kernels only move values and add 1).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu_torch.benchmarks import cluster_probe, micro3

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SIZES = [128, 256, 4096, 8192]
_SMS = [132, 114]


@pytest.fixture(scope="module")
def jm3():
    spec = importlib.util.spec_from_file_location(
        "_jax_pallas_micro3_tiles",
        os.path.join(_REPO, "benchmarks", "pallas_micro3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(monkeypatch, mod):
    """Replace mod.timeit1 by one call recording (fn, inputs, output)."""
    calls = []

    def once(fn, *args, n=0):
        out = fn(*args)
        calls.append((fn, [np.asarray(a) for a in args], np.asarray(out)))
        return 1.0

    monkeypatch.setattr(mod, "timeit1", once)
    return calls


def _same_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got.view(np.int32), want.view(np.int32)))


def _owners(R, tiling):
    """How many blocks own each value of the (R, 128) array."""
    h, w = tiling["region"]
    own = np.zeros((R // 128, 128, 128), dtype=np.int64)
    for regs in tiling["regions"]:
        for tile, r, c in regs:
            own[tile, r:r + h, c:c + w] += 1
    return own


@pytest.mark.parametrize("n_sms", _SMS)
@pytest.mark.parametrize("R", _SIZES)
def test_transpose_loop_tiling_splits_tiles_by_their_orbits(R, n_sms):
    t = micro3.transpose_loop_tiling(R, n_sms)
    h, w = t["region"]
    assert h == w                              # a transpose maps it onto a
    assert (_owners(R, t) == 1).all()          # value owned exactly once
    assert len(t["regions"]) == t["blocks"] == 2 * (R // 128)
    for regs in t["regions"]:
        assert len({tile for tile, _, _ in regs}) == 1
        corners = {(r, c) for _, r, c in regs}
        assert {(c, r) for r, c in corners} == corners   # its own orbits
    # two copies (ping-pong) of each region, rows padded by one float
    assert t["smem_bytes"] == 2 * 2 * h * (w + 1) * 4
    assert t["smem_bytes"] <= micro3.BLOCK_SMEM_BYTES
    assert t["threads"] == micro3.TILE_THREADS and t["cluster"] == 1
    assert t["sms"] == min(t["blocks"], n_sms)
    if R == 8192:                              # the entry point's shape
        assert t["blocks"] >= 128


@pytest.mark.parametrize("n_sms", _SMS)
@pytest.mark.parametrize("R", _SIZES)
def test_sandwich_tiling_gives_each_tile_a_block(R, n_sms):
    t = micro3.sandwich_tiling(R, n_sms)
    assert (_owners(R, t) == 1).all()          # value owned exactly once
    assert t["region"] == (128, 128) and t["cluster"] == 1
    assert len(t["regions"]) == t["blocks"] == R // 128
    assert sorted(tile for (tile, _, _), in t["regions"]) == list(
        range(R // 128))
    # rows to warps: every row of the tile in exactly one warp
    warps = t["threads"] // 32
    assert t["warp_rows"] * warps == 128
    assert t["warp_rows"] * 128 == 32 * (128 * 128 // t["threads"])
    # three padded tile buffers: the values, the two transposed passes
    assert t["smem_bytes"] == 3 * 128 * 129 * 4
    assert t["smem_bytes"] <= micro3.BLOCK_SMEM_BYTES
    assert t["threads"] == micro3.TILE_THREADS
    assert t["sms"] == min(t["blocks"], n_sms)
    if R == 4096:                              # the entry point's shape
        assert t["blocks"] == 32


@pytest.mark.parametrize("iters", [2, 3, 5])
def test_transpose_loop_schedule_matches_plain_and_pallas(jm3, monkeypatch,
                                                         iters):
    calls = _capture(monkeypatch, jm3)
    jm3.bench_transpose_loop(R=256, iters=iters)
    (fn, (ones,), want_ones), = calls
    assert _same_bits(micro3.transpose_loop_schedule(
        torch.tensor(ones), iters), want_ones)
    x = np.random.default_rng(30 + iters).standard_normal(
        ones.shape).astype(np.float32)
    want = np.asarray(fn(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = micro3.transpose_loop_schedule(xt, iters)
    assert _same_bits(got, want)
    assert _same_bits(micro3.transpose_loop_reference(xt, iters), want)


@pytest.mark.parametrize("iters", [2, 3, 5])
def test_sandwich_schedule_matches_plain_and_pallas(jm3, monkeypatch, iters):
    calls = _capture(monkeypatch, jm3)
    jm3.bench_sandwich(R=256, iters=iters)
    (fn, args, want), = calls
    ts = [torch.tensor(a) for a in args]
    assert _same_bits(micro3.sandwich_schedule(*ts, iters), want)
    assert _same_bits(micro3.sandwich_reference(*ts, iters), want)
    # other random values and indices through the same Pallas program
    rng = np.random.default_rng(40 + iters)
    x = rng.standard_normal(args[0].shape).astype(np.float32)
    s = [rng.integers(0, 128, args[0].shape).astype(np.int32)
         for _ in range(3)]
    want2 = np.asarray(fn(*(jnp.asarray(a) for a in [x] + s)))
    got2 = micro3.sandwich_schedule(
        *(torch.from_numpy(a) for a in [x] + s), iters)
    assert _same_bits(got2, want2)


def test_transpose_loop_schedule_refuses_a_split_across_orbits():
    """Regions that the transpose does not map onto themselves cannot be
    one block's: the emulation finds no source region and raises."""
    t = micro3.transpose_loop_tiling(128, 132)
    bad = dict(t, regions=[((0, 0, 0), (0, 0, 64)), ((0, 64, 0),
                                                      (0, 64, 64))])
    with pytest.raises(ValueError):
        micro3.transpose_loop_schedule(torch.zeros((128, 128)), 1, bad)


@pytest.mark.parametrize("R", [128, 8192])
def test_transpose_loop_launch_carries_its_tiling(R, monkeypatch):
    calls = []
    monkeypatch.setattr(micro3, "on_card", lambda name, *t: True)
    monkeypatch.setattr(micro3, "launch", lambda *a: calls.append(a))
    before = micro3.transpose_loop.launches
    x = torch.zeros((R, 128))
    out = micro3.transpose_loop(x, 7)
    micro3.transpose_loop.launches = before
    t = micro3.transpose_loop_tiling(R, micro3.H100_SMS)
    (name, gx, gout, *ints), = calls
    assert name == "transpose_loop" and gx is x and gout is out
    assert ints == [R, 7, t["blocks"], t["threads"], t["smem_bytes"]]


@pytest.mark.parametrize("R", [128, 4096])
def test_sandwich_launch_carries_its_tiling(R, monkeypatch):
    calls = []
    monkeypatch.setattr(micro3, "on_card", lambda name, *t: True)
    monkeypatch.setattr(micro3, "launch", lambda *a: calls.append(a))
    before = micro3.sandwich.launches
    x = torch.zeros((R, 128))
    s = [torch.zeros((R, 128), dtype=torch.int32) for _ in range(3)]
    out = micro3.sandwich(x, *s, 9)
    micro3.sandwich.launches = before
    t = micro3.sandwich_tiling(R, micro3.H100_SMS)
    (name, gx, g1, g2, g3, gout, *ints), = calls
    assert name == "sandwich" and gx is x and gout is out
    assert all(a is b for a, b in zip((g1, g2, g3), s))
    assert ints == [R, 9, t["blocks"], t["cluster"], t["threads"],
                    t["smem_bytes"]]
    assert t["cluster"] == 1


def test_cluster_probe_raises_without_a_card(monkeypatch):
    """The probe measures the card only: without one it raises before it
    builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cluster_probe, "_lib",
                        lambda: pytest.fail("built without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_probe.main([])
