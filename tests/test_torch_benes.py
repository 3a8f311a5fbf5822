"""The port's Benes network (memgraph_tpu_torch/ops/benes_cuda.py) against
the JAX package: its Pallas kernels in interpret mode, its numpy reference
and its host routers.

On the CPU the port's wrappers run their plain PyTorch versions.  A Benes
network only moves values, never rounds them, so every comparison here is
bit-exact (bf16 inputs are rounded once, identically, by both packages).
"""

import ast
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


@pytest.mark.parametrize("K", [8, 12])
def test_masks_and_spec_match_the_jax_package(K):
    n = 12
    packed = jbenes.pack_masks(jbenes.benes_route(
        np.random.default_rng(K).permutation(1 << n)))
    jspec, jmid, jout = build_pallas_masks(packed, n, K=K)
    spec, mid, out = BC.build_masks(packed, n, K)
    assert np.array_equal(jmid, mid)
    assert (jout is None and out is None) or np.array_equal(jout, out)
    assert (spec.net_log2, spec.K, spec.mid_planes, spec.mid_stages,
            spec.outer_down, spec.outer_up) == (
        jspec.net_log2, jspec.K, jspec.mid_planes, jspec.mid_stages,
        jspec.outer_down, jspec.outer_up)


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
