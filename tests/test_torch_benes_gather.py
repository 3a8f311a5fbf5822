"""The Benes middle pass as a placed tile-local gather
(memgraph_tpu_torch/ops/benes_cuda.py: ``compose_mid`` and
``benes_mid_gather``) against the stage-by-stage plain version and the JAX
package's Pallas middle pass in interpret mode.

On the CPU the wrappers run their plain PyTorch versions.  The pass only
moves values, so every comparison is bit-exact (bf16 inputs are rounded
once, identically, by both packages).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import benes as jbenes
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [8, 9, None])
@pytest.mark.parametrize("n", [10, 12, 14])
def test_composed_gather_matches_stages_and_pallas_interpret(n, K, dtype):
    """The middle pass alone: compose_mid + the gather's plain version
    against the stage plain version and the JAX Pallas middle kernel."""
    K = n if K is None else K
    _, packed = _route(n, n * 17 + K)
    spec, midw, _ = BC.build_masks(packed, n, K)
    assert spec.mid_stages
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    assert mid_idx.dtype == torch.int16 and mid_idx.shape == (1 << n,)
    x = np.random.default_rng(n + K).standard_normal(1 << n).astype(
        np.float32)
    xt = torch.from_numpy(x).to(_TDT[dtype]).view(-1, 128)
    got = BC.benes_mid_gather_reference(xt, mid_idx, spec)
    assert torch.equal(_bits(got), _bits(
        BC.benes_mid_reference(xt, torch.from_numpy(midw), spec)))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(_bits(BC.benes_mid_gather(xt, mid_idx, spec)),
                       _bits(got))
    jspec, jmid, _ = build_pallas_masks(packed, n, K=K)
    jmid_only = dataclasses.replace(jspec, outer_down=(), outer_up=())
    want = benes_apply_pallas(
        jnp.asarray(x.reshape(-1, 128)).astype(_JDT[dtype]),
        jnp.asarray(jmid), None, jmid_only, interpret=True)
    assert np.array_equal(got.to(torch.float32).numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_positions_above_32767_survive_int16_storage():
    """K = 16 (the bf16 tile): positions up to 65535 are stored as int16
    and read back unsigned."""
    n, K = 17, 16
    perm, packed = _route(n, 4)
    spec, midw, outw = BC.build_masks(packed, n, K)
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    pos = mid_idx.to(torch.int32) & 0xFFFF
    assert int(mid_idx.min()) < 0 and int(pos.max()) >= 32768
    iota = torch.arange(1 << n, dtype=torch.int64)
    staged = BC.benes_mid_reference(iota, torch.from_numpy(midw), spec)
    gathered = BC.benes_mid_gather_reference(iota, mid_idx, spec)
    assert torch.equal(gathered, staged)
    tile_base = iota & ~((1 << K) - 1)
    assert torch.equal(staged - tile_base, pos.to(torch.int64))
    x = torch.randn(1 << n).to(torch.bfloat16).view(-1, 128)
    got = BC.benes_apply(x, mid_idx,
                         BC.compose_outer(torch.from_numpy(outw), spec), spec)
    assert torch.equal(_bits(got.reshape(-1)),
                       _bits(x.reshape(-1)[torch.from_numpy(perm)]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_in_place_out_x_gives_the_same_result(dtype):
    n = 12
    _, packed = _route(n, 9)
    spec, midw, _ = BC.build_masks(packed, n, 8)
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    x = torch.randn(1 << n).to(_TDT[dtype]).view(-1, 128)
    want = BC.benes_mid_gather(x, mid_idx, spec)
    got = BC.benes_mid_gather(x, mid_idx, spec, out=x)
    assert got is x and torch.equal(_bits(x), _bits(want))


def test_identity_network_composes_and_launches_nothing():
    n, K = 12, 8
    spec, midw, outw = BC.build_masks(tbenes.route_packed(np.arange(1 << n)),
                                      n, K)
    assert not (spec.mid_stages or spec.outer_down or spec.outer_up)
    BC.reset_launch_counts()
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    assert torch.equal(mid_idx.to(torch.int64),
                       torch.arange(1 << n) & ((1 << K) - 1))
    x = torch.randn(1 << n).view(-1, 128)
    assert BC.benes_apply(x, mid_idx, None, spec) is x
    assert (BC.benes_mid.launches, BC.benes_mid_gather.launches,
            BC.benes_outer.launches, BC.benes_outer_gather.launches
            ) == (0, 0, 0, 0)


def test_gather_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    n = 10
    _, packed = _route(n, 3)
    spec, midw, _ = BC.build_masks(packed, n, 8)
    BC.reset_launch_counts()
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    x = torch.randn(1 << n).view(-1, 128)
    assert torch.equal(BC.benes_mid_gather(x, mid_idx, spec),
                       BC.benes_mid_gather_reference(x, mid_idx, spec))
    assert (BC.benes_mid.launches, BC.benes_mid_gather.launches) == (0, 0)
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        BC.benes_mid_gather(x.to("meta"), mid_idx.to("meta"), spec)
    with pytest.raises(ValueError, match="run on cuda or cpu"):
        BC.compose_mid(torch.from_numpy(midw).to("meta"), spec)


class _RecordingLib:
    def __init__(self):
        self.calls = []

    def benes_mid_gather(self, *args):
        self.calls.append(args)
        return 0

    def benes_mid(self, *args):
        self.calls.append(("benes_mid",) + args)
        return 0


def _as_card(monkeypatch):
    """Make the wrappers treat CPU tensors as card tensors: the kernel's
    entry point becomes a recorder, the plain version a failure."""
    lib = _RecordingLib()
    monkeypatch.setattr(BC, "_lib", lambda: lib)
    monkeypatch.setattr(BC, "_stream", lambda x: 0)
    monkeypatch.setattr(BC, "_target", lambda x, out: (
        torch.empty_like(x) if out is None else out))
    monkeypatch.setattr(BC, "benes_mid_gather_reference",
                        lambda *a: pytest.fail("plain version taken"))
    return lib


def test_gather_wrapper_launches_its_kernel_for_a_card_tensor(monkeypatch):
    n = 10
    _, packed = _route(n, 5)
    spec, midw, _ = BC.build_masks(packed, n, 8)
    mid_idx = BC.compose_mid(torch.from_numpy(midw), spec)
    lib = _as_card(monkeypatch)
    before = BC.benes_mid_gather.launches
    x = torch.randn(1 << n).to(torch.bfloat16).view(-1, 128)
    y = BC.benes_mid_gather(x, mid_idx, spec, out=x)
    assert y is x and BC.benes_mid_gather.launches == before + 1
    (args,) = lib.calls
    assert args == (x.data_ptr(), x.data_ptr(), mid_idx.data_ptr(), 1 << n,
                    8, 2, 0)
    with pytest.raises(ValueError, match="int16"):
        BC.benes_mid_gather(x, mid_idx.to(torch.int32), spec)
    with pytest.raises(ValueError, match="int16"):
        BC.benes_mid_gather(x, mid_idx[:-8], spec)
    with pytest.raises(TypeError):
        BC.benes_mid_gather(x.double(), mid_idx, spec)
    off = torch.randn((1 << n) + 1)[1:]     # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        BC.benes_mid_gather(off, mid_idx, spec)
    assert BC.benes_mid_gather.launches == before + 1
    BC.benes_mid_gather.launches = before


def test_stage_kernel_takes_the_packed_rows_for_a_card_tensor(monkeypatch):
    """compose_mid's card branch: one benes_mid launch on the iota, fed
    the packed rows, their row stride and (row << 8 | log2 d) codes;
    rows that are not packed uint8 rows, or misaligned, are refused."""
    n, K = 10, 8
    _, packed = _route(n, 5)
    spec, mid_rows, _ = BC.build_masks(packed, n, K)
    rows = torch.from_numpy(mid_rows)
    lib = _as_card(monkeypatch)
    monkeypatch.setattr(BC, "_apply_stages",
                        lambda *a: pytest.fail("plain version taken"))
    monkeypatch.setattr(BC, "benes_mid_reference",
                        lambda *a: pytest.fail("plain version taken"))
    before = BC.benes_mid.launches
    tile = torch.arange(1 << n, dtype=torch.int16).view(torch.bfloat16)
    BC.compose_mid(rows.to("meta"), spec)       # meta stands in for cuda
    assert BC.benes_mid.launches == before + 1
    (args,) = lib.calls
    assert args[0] == "benes_mid" and args[4:8] == (128, 1 << n, K, 2)
    codes, n_codes = args[8], args[9]
    assert n_codes == len(spec.mid_stages) == 2 * K - 1
    assert [codes[i] for i in range(n_codes)] == [
        (r << 8) | (d.bit_length() - 1) for r, d in spec.mid_stages]
    x = tile.clone()
    with pytest.raises(ValueError, match="packed rows"):
        BC.benes_mid(x, rows.to(torch.int32), spec)
    with pytest.raises(ValueError, match="packed rows"):
        BC.benes_mid(x, rows[:, :-16], spec)
    with pytest.raises(ValueError, match="packed rows"):
        BC.benes_mid(x, rows[:1], spec)
    off = torch.empty(rows.numel() + 1, dtype=torch.uint8)[1:]
    off = off.view(rows.shape)
    off.copy_(rows)                             # 1 byte past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        BC.benes_mid(x, off, spec)
    with pytest.raises(TypeError):
        BC.benes_mid(x.to(torch.float16), rows, spec)
    assert BC.benes_mid.launches == before + 1
    BC.benes_mid.launches = before


def test_kernel_source_defines_and_binds_the_gather():
    src = open(os.path.join(_REPO, "memgraph_tpu_torch", "ops", "csrc",
                            "benes.cu")).read()
    assert "int benes_mid_gather(" in src
    assert "benes_pallas.py:138, launched at :225" in src
    # the stage kernels read the router's packed rows, a cp.async ring
    assert "int benes_mid(const void* x, void* y, const void* rows" in src
    assert "cp.async.wait_group" in src and "kRing" in src
    includes = [ln.split()[1] for ln in src.splitlines()
                if ln.startswith("#include")]
    assert includes == ["<cuda_runtime.h>", "<cstdint>"]
    for lib in ("cublas", "cudnn", "cutlass", "thrust", "cub::"):
        assert lib not in src.lower()


@pytest.mark.parametrize("route_dtype", [torch.float32, torch.bfloat16])
def test_placed_route_holds_the_composed_index(route_dtype):
    """make_semiring_kernel places mid_idx (not the packed mask rows) and
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
        mid_idx, _, spec = run.routes[name]
        _, midw, _ = BC.build_masks(packed, net_log2, BC.K_BY_DTYPE[dt])
        assert mid_idx.dtype == torch.int16
        assert torch.equal(mid_idx, BC.compose_mid(torch.from_numpy(midw),
                                                   spec))
    rank, _, iters = run(None, 0.85, 3, -1.0)
    assert iters == 3 and bool(torch.isfinite(rank).all())
