"""The port's Benes network (memgraph_tpu_torch/ops/benes_cuda.py) against
the JAX package: its Pallas kernels in interpret mode, its numpy reference
and its host routers.

On the CPU the port's wrappers run their plain PyTorch versions.  A Benes
network only moves values, never rounds them, so every comparison here is
bit-exact (bf16 inputs are rounded once, identically, by both packages).
"""

import ast
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.ops import benes as jbenes
from memgraph_tpu.ops.benes_pallas import (benes_apply_pallas,
                                           build_pallas_masks)
from memgraph_tpu.ops.spmv_mxu import _benes_apply_rolls
from memgraph_tpu_torch.ops import benes as tbenes
from memgraph_tpu_torch.ops import benes_cuda as BC

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _jax_apply(x, packed, n, K, dtype):
    spec, midw, outw = build_pallas_masks(packed, n, K=K)
    got = benes_apply_pallas(
        jnp.asarray(x.reshape(-1, 128)).astype(_JDT[dtype]),
        jnp.asarray(midw), None if outw is None else jnp.asarray(outw),
        spec, interpret=True)
    return np.asarray(got.astype(jnp.float32)).reshape(-1)


def _port_apply(x, packed, n, K, dtype):
    spec, midw, outw = BC.build_masks(packed, n, K)
    shape = (-1, 128) if x.size >= 128 else (-1,)
    got = BC.benes_apply(
        torch.from_numpy(x).to(_TDT[dtype]).reshape(shape),
        BC.compose_mid(torch.from_numpy(midw), spec),
        None if outw is None else BC.compose_outer(torch.from_numpy(outw),
                                                   spec), spec)
    return got.to(torch.float32).numpy().reshape(-1), spec


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [8, 9, None])
@pytest.mark.parametrize("n", [10, 12, 14])
def test_plain_version_matches_pallas_interpret(n, K, dtype):
    rng = np.random.default_rng(n * 31 + (K or 0))
    N = 1 << n
    perm = rng.permutation(N)
    packed = jbenes.pack_masks(jbenes.benes_route(perm))
    x = rng.standard_normal(N).astype(np.float32)
    K = n if K is None else K
    got, spec = _port_apply(x, packed, n, K, dtype)
    want = _jax_apply(x, packed, n, K, dtype)
    assert np.array_equal(got, want)
    xr = torch.from_numpy(x).to(_TDT[dtype]).to(torch.float32).numpy()
    assert np.array_equal(got, xr[perm])
    if K < n:       # the pass split really exercised the outer stages
        assert spec.outer_down and spec.outer_up


def _planes(rows, stages, n_planes, N):
    """The JAX package's int32 bit-planes rebuilt from the port's packed
    rows: stage i sets bit i % 31 of plane i // 31 (the test unpacks; the
    port does not)."""
    words = np.zeros((n_planes, N), dtype=np.int64)
    for i, (r, _) in enumerate(stages):
        bits = np.unpackbits(rows[r])[:N].astype(np.int64)
        words[i // 31] |= bits << (i % 31)
    return words.astype(np.int32).reshape(n_planes, N // 128, 128)


def _jax_stage_codes(spec):
    """The port's (row, d) stages as the JAX spec's (plane, bit, d)."""
    mid = tuple((i // 31, i % 31, d) for i, (_, d) in
                enumerate(spec.mid_stages))
    outer = [(0, i, d) for i, (_, d) in
             enumerate(spec.outer_down + spec.outer_up)]
    return (mid, tuple(outer[:len(spec.outer_down)]),
            tuple(outer[len(spec.outer_down):]))


@pytest.mark.parametrize("K", [8, 12])
def test_masks_and_spec_match_the_jax_package(K):
    """The port's packed rows, unpacked here, are the JAX package's
    bit-planes, and its spec the same stages in the same order."""
    n, N = 12, 1 << 12
    packed = jbenes.pack_masks(jbenes.benes_route(
        np.random.default_rng(K).permutation(1 << n)))
    jspec, jmid, jout = build_pallas_masks(packed, n, K=K)
    spec, mid, out = BC.build_masks(packed, n, K)
    assert mid.dtype == np.uint8 and mid.shape == (len(spec.mid_stages),
                                                   N // 8)
    assert np.array_equal(
        jmid, _planes(mid, spec.mid_stages, jspec.mid_planes, N))
    if jout is None:
        assert out is None
    else:
        both = spec.outer_down + spec.outer_up
        assert out.shape == (len(both), N // 8)
        assert [r for r, _ in both] == list(range(len(both)))
        assert np.array_equal(jout, _planes(out, both, 1, N)[0])
    assert (spec.net_log2, spec.K) == (jspec.net_log2, jspec.K)
    assert _jax_stage_codes(spec) == (jspec.mid_stages, jspec.outer_down,
                                      jspec.outer_up)


@pytest.mark.parametrize("case", ["random", "identity", "one_dead_side"])
@pytest.mark.parametrize("n,K", [(7, 1), (8, 2), (10, 3), (12, 8), (14, 9),
                                 (17, 3), (16, 16)])
def test_spec_stage_order_and_split_match_the_jax_package(n, K, case):
    """Stage order, distances and the down/up split of the port's spec
    equal build_pallas_masks' spec, dead stages dropped alike (the
    identity permutation has none live), and each row of the port's
    arrays is the router's row for that stage.  (The JAX builder takes
    nets of 128 slots and more, and at most 31 outer stages.)"""
    N = 1 << n
    perm = (np.arange(N) if case == "identity" else
            np.random.default_rng(n * 7 + K).permutation(N))
    packed = _routed(n, 0) if case == "random" else tbenes.route_packed(perm)
    if case == "one_dead_side":
        packed = packed.copy()
        packed[:n - 1] = 0                       # every down stage dead
    jspec, _, _ = build_pallas_masks(packed, n, K=K)
    spec, mid, out = BC.build_masks(packed, n, K)
    assert _jax_stage_codes(spec) == (jspec.mid_stages, jspec.outer_down,
                                      jspec.outer_up)
    dists = tbenes.benes_stage_distances(n)
    live = [s for s in range(2 * n - 1) if packed[s].any()]
    mids = [s for s in live if dists[s] < (1 << spec.K)]
    outers = [s for s in live if s not in mids]
    assert np.array_equal(mid, packed[mids])
    if n > spec.K:
        assert np.array_equal(out, packed[outers])
    else:
        assert out is None and not outers
    if case == "identity":
        assert not (spec.mid_stages or spec.outer_down or spec.outer_up)
    if case == "one_dead_side":
        assert not spec.outer_down


@functools.cache
def _routed(n, seed):
    return tbenes.route_packed(
        np.random.default_rng(1000 * n + seed).permutation(1 << n))


@functools.cache
def _rolls_reference(n, dtype):
    """The JAX package's network (``_benes_apply_rolls``, every stage as
    XLA rolls) on seeded values: the composition tests' reference."""
    N = 1 << n
    packed = _routed(n, 0)
    x = np.random.default_rng(n).standard_normal(N).astype(np.float32)
    xr = jnp.asarray(x).astype(_JDT[dtype])
    got = _benes_apply_rolls(
        xr, jnp.asarray(np.stack(jbenes.unpack_masks(packed, N))), n)
    return x, np.asarray(got.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 2, 3, 8, None])
@pytest.mark.parametrize("n", [3, 7, 10, 12, 14, 17])
def test_packed_row_composition_matches_the_jax_network(n, K, dtype):
    """compose_mid / compose_outer from the packed rows, applied by the
    gathers' plain versions, bit-equal to the JAX package's network:
    sub-byte tiles (K < 3), nets under one byte (n = 3), K past n.  Rows
    of more than 15 bits (n = 17 at K = 1) and tiles past 2^16 slots
    (n = K = 17) are refused."""
    K = n if K is None else K
    packed = _routed(n, 0)
    if n - min(K, n) > 15 or min(K, n) > 16:
        with pytest.raises(ValueError, match="2\\^15 rows|2\\^16-slot"):
            BC.build_masks(packed, n, K)
        return
    x, want = _rolls_reference(n, dtype)
    got, spec = _port_apply(x, packed, n, K, dtype)
    assert np.array_equal(got, want)
    assert spec.K == min(K, n)
    if n > K:
        assert spec.outer_down and spec.outer_up


def test_put_route_never_unpacks(monkeypatch):
    """_put_route on the CPU with np.unpackbits made to raise: the placed
    indices still equal the composition of the unpacked masks, computed
    here stage by stage on the old bit-planes."""
    from memgraph_tpu_torch.ops import spmv_mxu
    n, N = 17, 1 << 17
    packed = _routed(n, 1)
    unpacked = np.stack(jbenes.unpack_masks(packed, N))
    real = np.unpackbits

    def refuse(*a, **kw):
        raise AssertionError("np.unpackbits on the placement path")

    monkeypatch.setattr(np, "unpackbits", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        split = {}
        mid_idx, outer_idx, spec = spmv_mxu._put_route(
            packed, n, dtype, torch.device("cpu"), split)
        K = spec.K
        assert set(split) == {"mask_prep_s", "upload_s", "compose_ms"}
        assert split["compose_ms"] is None      # no device time on the CPU
        dists = tbenes.benes_stage_distances(n)
        live = [s for s in range(2 * n - 1) if unpacked[s].any()]

        def compose(iota, stages):
            out = iota.copy()
            for s in stages:
                d = dists[s]
                sw = out.reshape(-1, 2, d)[:, ::-1, :].reshape(-1)
                out = np.where(unpacked[s], sw, out)
            return out
        pos = np.arange(N)
        mid = [s for s in live if dists[s] < (1 << K)]
        assert np.array_equal(compose(pos & ((1 << K) - 1), mid),
                              mid_idx.numpy().astype(np.int64) & 0xFFFF)
        half = (2 * n - 1) // 2
        for side, stages in enumerate(
                ([s for s in live if s < half and s not in mid],
                 [s for s in live if s >= half and s not in mid])):
            assert np.array_equal(compose(pos >> K, stages),
                                  outer_idx[side].numpy())
    monkeypatch.setattr(np, "unpackbits", real)


def test_identity_perm_skips_dead_stages():
    n, N = 12, 1 << 12
    packed = tbenes.route_packed(np.arange(N))
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    got, spec = _port_apply(x, packed, n, 8, "f32")
    assert np.array_equal(got, x)
    assert not (spec.mid_stages or spec.outer_down or spec.outer_up)


@pytest.mark.parametrize("n", [1, 3, 5, 6])
def test_nets_below_one_lane_row_are_flat(n):
    """N < 128: the JAX layout is flat; one (mid) pass covers the net."""
    rng = np.random.default_rng(n)
    N = 1 << n
    perm = rng.permutation(N)
    masks = jbenes.benes_route(perm)
    packed = jbenes.pack_masks(masks)
    x = rng.standard_normal(N).astype(np.float32)
    got, spec = _port_apply(x, packed, n, 15, "f32")
    assert spec.K == n and not spec.outer_down
    assert np.array_equal(got, jbenes.benes_apply_np(x, masks))
    rolls = _benes_apply_rolls(
        jnp.asarray(x),
        jnp.asarray(np.stack(jbenes.unpack_masks(packed, N))), n)
    assert np.array_equal(got, np.asarray(rolls))


@pytest.mark.parametrize("N", [2, 8, 256, 4096])
def test_routers_match_the_jax_package(N):
    perm = np.random.default_rng(N).permutation(N)
    py_masks = tbenes.benes_route(perm)
    for a, b in zip(py_masks, jbenes.benes_route(perm)):
        assert np.array_equal(a, b)
    packed = tbenes.route_packed(perm)
    assert np.array_equal(packed, tbenes.pack_masks(py_masks))
    assert np.array_equal(packed, jbenes.route_packed(perm))
    x = np.random.default_rng(1).random(N)
    assert np.array_equal(
        tbenes.benes_apply_np(x, tbenes.unpack_masks(packed, N)), x[perm])


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    n = 10
    packed = tbenes.route_packed(np.random.default_rng(3).permutation(1 << n))
    spec, mid, out = BC.build_masks(packed, n, 8)
    x = torch.randn(1 << n).view(-1, 128)
    BC.reset_launch_counts()
    want = BC.benes_apply_reference(x, torch.from_numpy(mid),
                                    torch.from_numpy(out), spec)
    mid_idx = BC.compose_mid(torch.from_numpy(mid), spec)
    outer_idx = BC.compose_outer(torch.from_numpy(out), spec)
    got = BC.benes_apply(x, mid_idx, outer_idx, spec)
    assert torch.equal(got, want)
    # the plain version launches nothing
    assert (BC.benes_mid.launches, BC.benes_mid_gather.launches,
            BC.benes_outer.launches, BC.benes_outer_gather.launches
            ) == (0, 0, 0, 0)
    with pytest.raises(ValueError):
        BC.benes_apply(x.to("meta"), mid_idx.to("meta"),
                       outer_idx.to("meta"), spec)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Statically (every import statement of every module of the package
    and of chip_smoke.py), then at run time: a fresh interpreter imports
    every module of the package and chip_smoke.py and must have loaded
    neither jax nor the JAX package (this also catches imports built at
    run time, e.g. by importlib)."""
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(_REPO, "memgraph_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 5
    bad = [(p, m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "memgraph_tpu")]
    assert not bad, bad
    probe = (
        "import importlib, pkgutil, sys\n"
        "import memgraph_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'memgraph_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'memgraph_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split("\n")[-3:-1]
    assert int(n_modules) >= 15
    assert loaded == "[]", loaded
