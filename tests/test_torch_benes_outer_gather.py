"""The Benes outer passes as placed column-chunk gathers
(memgraph_tpu_torch/ops/benes_cuda.py: ``compose_outer`` and
``benes_outer_gather``) against the stage-by-stage plain version and the
JAX package's Pallas network in interpret mode.

On the CPU the wrappers run their plain PyTorch versions.  The passes only
move values, so every comparison is bit-exact (bf16 inputs are rounded
once, identically, by both packages).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops.benes_pallas import (benes_apply_pallas,
                                           build_pallas_masks)
from memgraph_tpu_torch.ops import benes as tbenes
from memgraph_tpu_torch.ops import benes_cuda as BC
from memgraph_tpu_torch.ops import spmv_mxu as T

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _route(n, seed):
    perm = np.random.default_rng(seed).permutation(1 << n)
    return perm, tbenes.route_packed(perm)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _placed(n, K, seed):
    perm, packed = _route(n, seed)
    spec, midw, outw = BC.build_masks(packed, n, K)
    midw, outw = torch.from_numpy(midw), torch.from_numpy(outw)
    return (perm, spec, midw, outw, BC.compose_mid(midw, spec),
            BC.compose_outer(outw, spec))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [8, 9])
@pytest.mark.parametrize("n", [10, 12, 14])
def test_composed_outer_gather_matches_stages_and_pallas_interpret(n, K,
                                                                   dtype):
    """The whole network through compose_outer + the outer gather's plain
    version against the stage plain version (whole and side by side) and
    the JAX Pallas network."""
    _, packed = _route(n, n * 13 + K)
    spec, midw, outw = BC.build_masks(packed, n, K)
    assert spec.outer_down and spec.outer_up
    outw_t = torch.from_numpy(outw)
    outer_idx = BC.compose_outer(outw_t, spec)
    assert outer_idx.dtype == torch.int16 and outer_idx.shape == (2, 1 << n)
    x = np.random.default_rng(n + K).standard_normal(1 << n).astype(
        np.float32)
    xt = torch.from_numpy(x).to(_TDT[dtype]).view(-1, 128)
    for side, stages in enumerate((spec.outer_down, spec.outer_up)):
        assert torch.equal(
            _bits(BC.benes_outer_gather_reference(xt, outer_idx[side], spec)),
            _bits(BC.benes_outer_reference(xt, outw_t, stages)))
    got = BC.benes_apply(xt, BC.compose_mid(torch.from_numpy(midw), spec),
                         outer_idx, spec)
    assert torch.equal(_bits(got), _bits(BC.benes_apply_reference(
        xt, torch.from_numpy(midw), outw_t, spec)))
    jspec, jmid, jout = build_pallas_masks(packed, n, K=K)
    want = benes_apply_pallas(
        jnp.asarray(x.reshape(-1, 128)).astype(_JDT[dtype]),
        jnp.asarray(jmid), jnp.asarray(jout), jspec, interpret=True)
    assert np.array_equal(got.to(torch.float32).numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_fifteen_bits_of_rows_round_trip_through_int16():
    """n - K = 15 (2^15 rows, the most the kernel takes): every row index
    is stored as a non-negative int16 and the network still applies the
    routed permutation."""
    n, K = 16, 1
    perm, spec, _, outw, mid_idx, outer_idx = _placed(n, K, 7)
    assert int(outer_idx.min()) >= 0
    assert int(outer_idx.max()) == (1 << (n - K)) - 1
    iota = torch.arange(1 << n, dtype=torch.int64)
    for side, stages in enumerate((spec.outer_down, spec.outer_up)):
        staged = BC.benes_outer_reference(iota, outw, stages)
        assert torch.equal(staged >> K, outer_idx[side].to(torch.int64))
        assert torch.equal(staged & 1, iota & 1)     # the column stays
        assert torch.equal(
            BC.benes_outer_gather_reference(iota, outer_idx[side], spec),
            staged)
    x = torch.randn(1 << n).to(torch.bfloat16).view(-1, 128)
    got = BC.benes_apply(x, mid_idx, outer_idx, spec)
    assert torch.equal(_bits(got.reshape(-1)),
                       _bits(x.reshape(-1)[torch.from_numpy(perm)]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_outer_gather_in_place_out_x_gives_the_same_result(dtype):
    _, spec, _, _, _, outer_idx = _placed(12, 8, 9)
    x = torch.randn(1 << 12).to(_TDT[dtype]).view(-1, 128)
    for side in (0, 1):
        want = BC.benes_outer_gather(x, outer_idx[side], spec)
        got = BC.benes_outer_gather(x, outer_idx[side], spec, out=x)
        assert got is x and torch.equal(_bits(x), _bits(want))


class _RecordingLib:
    def __init__(self):
        self.calls = []

    def benes_outer(self, *args):
        self.calls.append(("benes_outer",) + args)
        return 0

    def benes_outer_gather(self, *args):
        self.calls.append(("benes_outer_gather",) + args)
        return 0


def _as_card(monkeypatch):
    """Make the wrappers treat any tensor as a card tensor: the kernels'
    entry points become a recorder, the plain versions failures."""
    lib = _RecordingLib()
    monkeypatch.setattr(BC, "_lib", lambda: lib)
    monkeypatch.setattr(BC, "_stream", lambda x: 0)
    monkeypatch.setattr(BC, "_target", lambda x, out: (
        torch.empty_like(x) if out is None else out))
    for name in ("benes_outer_reference", "benes_outer_gather_reference",
                 "_apply_stages"):
        monkeypatch.setattr(BC, name,
                            lambda *a: pytest.fail("plain version taken"))
    return lib


def test_dead_side_launches_nothing_and_its_row_is_the_iota(monkeypatch):
    n, K = 12, 8
    _, packed = _route(n, 21)
    spec, _, outw = BC.build_masks(packed, n, K)
    half = dataclasses.replace(spec, outer_up=())
    rows = torch.arange(1 << n) >> K
    idx = BC.compose_outer(torch.from_numpy(outw), half)
    assert torch.equal(idx[1].to(torch.int64), rows)
    assert not torch.equal(idx[0].to(torch.int64), rows)
    assert BC.launches_per_placement(half) == {"benes_mid": 1,
                                               "benes_outer": 1}
    assert BC.launches_per_apply(half) == {"benes_mid_gather": 1,
                                           "benes_outer_gather": 1}
    # the card branch (meta tensors stand in for the card's): one stage
    # launch for the live side, none for the dead one
    lib = _as_card(monkeypatch)
    before = BC.benes_outer.launches
    BC.compose_outer(torch.from_numpy(outw).to("meta"), half)
    assert [c[0] for c in lib.calls] == ["benes_outer"]
    assert BC.benes_outer.launches == before + 1
    # the packed rows, their stride (N/8 bytes) and the side's codes, whose
    # rows index the down side first in outw
    (call,) = lib.calls
    assert call[4:8] == ((1 << n) // 8, 1 << n, K, 2)
    assert [call[8][i] for i in range(call[9])] == [
        (r << 8) | (d.bit_length() - 1) for r, d in half.outer_down]
    assert [r for r, _ in spec.outer_down + spec.outer_up] == list(
        range(outw.shape[0]))
    BC.benes_outer.launches = before


def test_outer_gather_takes_the_plain_version_only_for_cpu_tensors():
    _, spec, _, outw, _, outer_idx = _placed(10, 8, 3)
    BC.reset_launch_counts()
    x = torch.randn(1 << 10).view(-1, 128)
    assert torch.equal(BC.benes_outer_gather(x, outer_idx[0], spec),
                       BC.benes_outer_gather_reference(x, outer_idx[0], spec))
    assert (BC.benes_outer.launches, BC.benes_outer_gather.launches) == (0, 0)
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        BC.benes_outer_gather(x.to("meta"), outer_idx[0].to("meta"), spec)
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        BC.compose_outer(outw.to("meta"), spec)


def test_outer_gather_launches_its_kernel_for_a_card_tensor(monkeypatch):
    n, K = 10, 8
    _, spec, _, _, _, outer_idx = _placed(n, K, 5)
    lib = _as_card(monkeypatch)
    before = BC.benes_outer_gather.launches
    x = torch.randn(1 << n).to(torch.bfloat16).view(-1, 128)
    side = outer_idx[1]
    y = BC.benes_outer_gather(x, side, spec, out=x)
    assert y is x and BC.benes_outer_gather.launches == before + 1
    (args,) = lib.calls
    assert args == ("benes_outer_gather", x.data_ptr(), x.data_ptr(),
                    side.data_ptr(), 1 << n, K, 2, 0)
    with pytest.raises(ValueError, match="int16"):
        BC.benes_outer_gather(x, side.to(torch.int32), spec)
    with pytest.raises(ValueError, match="int16"):
        BC.benes_outer_gather(x, side[:-8], spec)
    with pytest.raises(TypeError):
        BC.benes_outer_gather(x.double(), side, spec)
    off = torch.randn((1 << n) + 1)[1:]     # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        BC.benes_outer_gather(off, side, spec)
    off_idx = torch.empty((1 << n) + 1, dtype=torch.int16)[1:]
    off_idx.copy_(side)                     # 2 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        BC.benes_outer_gather(x, off_idx, spec)
    assert BC.benes_outer_gather.launches == before + 1
    BC.benes_outer_gather.launches = before


def test_kernel_source_defines_and_binds_the_outer_gather():
    ops = os.path.join(_REPO, "memgraph_tpu_torch", "ops")
    src = open(os.path.join(ops, "csrc", "benes.cu")).read()
    assert "int benes_outer_gather(" in src
    assert "benes_pallas.py:155" in src
    assert "cp.async.cg.shared.global" in src
    assert "lib.benes_outer_gather.argtypes" in open(
        os.path.join(ops, "benes_cuda.py")).read()
    includes = [ln.split()[1] for ln in src.splitlines()
                if ln.startswith("#include")]
    assert includes == ["<cuda_runtime.h>", "<cstdint>"]
    for lib in ("cublas", "cudnn", "cutlass", "thrust", "cub::"):
        assert lib not in src.lower()


@pytest.mark.parametrize("route_dtype", [torch.float32, torch.bfloat16])
def test_placed_route_holds_the_composed_outer_index(route_dtype):
    """make_semiring_kernel places outer_idx (not the packed mask rows) and
    the matvec runs through it."""
    rng = np.random.default_rng(11)
    n, e = 3000, 30000
    src = rng.integers(0, n, e)
    dst = ((rng.random(e) ** 2) * n).astype(np.int64)
    plan = T.build_plan(src, dst, None, n)
    run = T.make_pagerank_kernel(plan, route_dtype=route_dtype, device="cpu")
    for name, packed, net_log2, dt in (
            ("edge", plan.masks_packed, plan.net_log2, route_dtype),
            ("node", plan.node_masks_packed, plan.node_net_log2,
             torch.float32)):
        _, outer_idx, spec = run.routes[name]
        _, _, outw = BC.build_masks(packed, net_log2, BC.K_BY_DTYPE[dt])
        if outw is None:
            assert outer_idx is None and net_log2 <= spec.K
            continue
        assert outer_idx.dtype == torch.int16
        assert outer_idx.shape == (2, 1 << net_log2)
        assert torch.equal(outer_idx,
                           BC.compose_outer(torch.from_numpy(outw), spec))
    assert run.routes["edge"][1] is not None
    rank, _, iters = run(None, 0.85, 3, -1.0)
    assert iters == 3 and bool(torch.isfinite(rank).all())
