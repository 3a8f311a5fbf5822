"""The port's microbenchmark kernels (memgraph_tpu_torch/benchmarks/micro*.py)
against the JAX package's benchmarks/pallas_micro*.py.

Each JAX module is loaded by path and its timing helper replaced by one
that calls the jitted Pallas program once (interpret mode on the CPU) and
records its inputs and output.  The same numpy inputs then go through the
port's wrapper on CPU tensors, that is through its plain PyTorch version.
Tolerances: bit-exact for every kernel that only moves values or adds 1
(gathers, stream, transposes, sandwich); onehot_scatter rtol 1e-5 (sums
of ~12 terms a bin in another order); big_matmul rtol 2e-4
((K + iters) * 2^-24).
"""

import ast
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu_torch.benchmarks import _common, micro, micro2, micro3

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL_EDGES = 131072     # pallas_micro2 needs E / 128 rows in 512-row tiles


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(_REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jm1():
    return _load("pallas_micro")


@pytest.fixture(scope="module")
def jm2():
    return _load("pallas_micro2")


@pytest.fixture(scope="module")
def jm3():
    return _load("pallas_micro3")


def _capture(monkeypatch, mod, helper):
    """Replace mod.<helper> (timeit or timeit1) by one call that records
    (fn, numpy inputs, numpy output)."""
    calls = []

    def once(fn, *args, n=0):
        out = fn(*args)
        calls.append((fn, [np.asarray(a) for a in args], np.asarray(out)))
        return (1.0, out) if helper == "timeit" else 1.0

    monkeypatch.setattr(mod, helper, once)
    return calls


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _same_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.int32), want.view(np.int32)))


def _within(got, want, rtol):
    got = got.numpy()
    return got.shape == want.shape and bool(
        (np.abs(got - want) <= rtol * np.abs(want)).all())


# ---------------------------------------------------------------------------
# pallas_micro.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [8, 64, 512, 2048, 8192])
def test_col_gather_matches_pallas(jm1, monkeypatch, R):
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_col_gather(R)
    (_, (tab, idx), want), = calls
    for a, b in zip((tab, idx), micro.gather_inputs(R, R)):
        assert np.array_equal(a, b)          # the port makes the same data
    assert _same_bits(micro.col_gather(*_t(tab, idx)), want)


@pytest.mark.parametrize("R", [8, 512])
def test_lane_gather_matches_pallas(jm1, monkeypatch, R):
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_lane_gather(R)
    (_, (tab, idx), want), = calls
    for a, b in zip((tab, idx), micro.gather_inputs(R, 128)):
        assert np.array_equal(a, b)
    assert _same_bits(micro.lane_gather(*_t(tab, idx)), want)


def test_stream_matches_pallas(jm1, monkeypatch):
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_stream(1)
    (fn, (x,), want), = calls
    assert _same_bits(micro.stream(*_t(x)), want)
    # random values too, through the same Pallas program
    xr = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    assert _same_bits(micro.stream(*_t(xr)), np.asarray(fn(jnp.asarray(xr))))


@pytest.mark.parametrize("iters", [1, 7])
def test_gather_loop_matches_pallas(jm1, monkeypatch, iters):
    calls = _capture(monkeypatch, jm1, "timeit")
    jm1.bench_gather_loop(256, iters=iters)
    (_, (tab, idx), want), = calls
    assert _same_bits(micro.gather_loop(*_t(tab, idx), iters), want)


# ---------------------------------------------------------------------------
# pallas_micro2.py (E cut to 131072 slots)
# ---------------------------------------------------------------------------

def test_dynslice_gather_matches_pallas(jm2, monkeypatch):
    monkeypatch.setattr(jm2, "E", _SMALL_EDGES)
    calls = _capture(monkeypatch, jm2, "timeit1")
    jm2.bench_dynslice_gather()
    (_, args, want), = calls
    for a, b in zip(args, micro2.dynslice_inputs(_SMALL_EDGES)):
        assert np.array_equal(a, b)
    assert _same_bits(micro2.dynslice_gather(*_t(*args)), want)


def test_onehot_scatter_matches_pallas(jm2, monkeypatch):
    monkeypatch.setattr(jm2, "E", _SMALL_EDGES)
    calls = _capture(monkeypatch, jm2, "timeit1")
    jm2.bench_onehot_scatter()
    (_, args, want), = calls
    for a, b in zip(args, micro2.onehot_inputs(_SMALL_EDGES)):
        assert np.array_equal(a, b)
    got = micro2.onehot_scatter(*_t(*args))
    assert _within(got, want, micro2.ONEHOT_RTOL)
    assert (want != 0).sum() > 1000          # the scatter really landed


@pytest.mark.parametrize("kind", ["random_dup", "random_perm", "identity"])
def test_xla_take_matches_jax(jm2, monkeypatch, kind):
    monkeypatch.setattr(jm2, "E", _SMALL_EDGES)
    calls = _capture(monkeypatch, jm2, "timeit1")
    idx = micro2.take_indices(_SMALL_EDGES)[kind]
    jm2.bench_xla_take(kind, idx, iters=3)
    (_, (x, jidx), want), = calls
    assert np.array_equal(jidx, idx)
    got = micro2.xla_take(torch.from_numpy(x), torch.from_numpy(idx), 3)
    assert _same_bits(got, want)


# ---------------------------------------------------------------------------
# pallas_micro3.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 3])
def test_lane_gather_loop_matches_pallas(jm3, monkeypatch, iters):
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_lane_gather_loop(R=256, iters=iters)
    (_, (x, idx), want), = calls
    for a, b in zip((x, idx), micro3.lane_loop_inputs(256)):
        assert np.array_equal(a, b)
    assert _same_bits(micro3.lane_gather_loop(*_t(x, idx), iters), want)


@pytest.mark.parametrize("iters", [2, 3])
def test_transpose_loop_matches_pallas(jm3, monkeypatch, iters):
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_transpose_loop(R=256, iters=iters)
    (fn, (x,), want), = calls
    assert _same_bits(micro3.transpose_loop(*_t(x), iters), want)
    # ones hide a missing transpose: random values through the same program
    xr = np.random.default_rng(iters).random(x.shape, dtype=np.float32)
    assert _same_bits(micro3.transpose_loop(*_t(xr), iters),
                      np.asarray(fn(jnp.asarray(xr))))


@pytest.mark.parametrize("iters", [1, 3])
def test_sandwich_matches_pallas(jm3, monkeypatch, iters):
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_sandwich(R=256, iters=iters)
    (_, args, want), = calls
    for a, b in zip(args, micro3.lane_loop_inputs(256, 3)):
        assert np.array_equal(a, b)
    assert _same_bits(micro3.sandwich(*_t(*args), iters), want)


def test_big_matmul_matches_pallas(jm3, monkeypatch):
    calls = _capture(monkeypatch, jm3, "timeit1")
    jm3.bench_big_matmul(iters=2)
    (_, (a, b), want), = calls
    for p, q in zip((a, b), micro3.matmul_inputs()):
        assert np.array_equal(p, q)
    assert _within(micro3.big_matmul(*_t(a, b), 2), want, micro3.MATMUL_RTOL)


# ---------------------------------------------------------------------------
# big_matmul's launch: tiling, split-K summation order, arguments
# ---------------------------------------------------------------------------

def test_big_matmul_tiling_fills_the_card_at_the_main_shape():
    t = micro3.big_matmul_tiling(*micro3.MATMUL_SHAPE, n_sms=132)
    assert t["blocks"] >= 128 and t["smem_bytes"] <= 227 * 1024
    assert t == {"tile": 128, "ks": 128, "splits": 16, "blocks": 128,
                 "smem_bytes": 131072}


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("shape", [(64, 32, 32), (256, 512, 96),
                                   (1024, 2048, 128), (32, 32, 32),
                                   (96, 4096, 160), (128, 8192, 128)])
def test_big_matmul_tiling_is_valid(shape, n_sms):
    M, K, N = shape
    t = micro3.big_matmul_tiling(M, K, N, n_sms)
    assert t["tile"] in micro3.MATMUL_TILES
    assert M % t["tile"] == 0 and N % t["tile"] == 0
    assert t["ks"] % 32 == 0 and t["ks"] * t["splits"] == K
    assert t["smem_bytes"] == 8 * t["ks"] * t["tile"]
    assert t["smem_bytes"] <= micro3.BLOCK_SMEM_BYTES
    assert t["blocks"] == (M // t["tile"]) * (N // t["tile"]) * t["splits"]
    # the 128 x 128 tile wherever it fits, smaller ones only where not
    assert (t["tile"] == 128) == (M % 128 == 0 and N % 128 == 0)


def _split_order(a, b, iters, ks):
    """big_matmul's summation order in torch: each K-slice's product as a
    chain of rank-1 updates in k order, its iters products added to the
    slice's acc one after another, then the slices summed in index
    order."""
    (M, K), N = a.shape, b.shape[1]
    S = K // ks
    a_s = a.view(M, S, ks).permute(1, 0, 2)
    b_s = b.view(S, ks, N)
    p = torch.zeros((S, M, N))
    for k in range(ks):
        p += a_s[:, :, k:k + 1] * b_s[:, k:k + 1, :]
    acc = torch.zeros_like(p)
    for _ in range(iters):
        acc += p
    out = acc[0].clone()
    for s in range(1, S):
        out += acc[s]
    return out


@pytest.mark.parametrize("shape,iters", [(micro3.MATMUL_SHAPE, 3),
                                         ((128, 1024, 64), 500)])
def test_big_matmul_split_order_stays_inside_rtol(shape, iters):
    M, K, N = shape
    t = micro3.big_matmul_tiling(M, K, N, 132)
    assert t["splits"] > 1
    rng = np.random.default_rng(9)
    a = rng.random((M, K), dtype=np.float32)
    b = rng.random((K, N), dtype=np.float32)
    got = _split_order(*_t(a, b), iters, t["ks"]).numpy()
    want = (a.astype(np.float64) @ b.astype(np.float64)) * iters
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= micro3.MATMUL_RTOL
    # and the plain version, the kernel's oracle, is inside it too
    plain = micro3.big_matmul(*_t(a, b), iters).numpy()
    assert (np.abs(plain - want) <= micro3.MATMUL_RTOL * want).all()


@pytest.mark.parametrize("shape", [(64, 32, 32), (256, 512, 96),
                                   (1024, 2048, 128)])
def test_big_matmul_launch_carries_its_tiling(shape, monkeypatch):
    """On the card the wrapper hands the kernel its tile and K-slice, and
    a (splits, M, N) scratch where there are several slices."""
    M, K, N = shape
    calls = []
    monkeypatch.setattr(micro3, "on_card", lambda name, *t: True)
    monkeypatch.setattr(micro3, "launch", lambda *a: calls.append(a))
    before = micro3.big_matmul.launches
    a, b = torch.zeros((M, K)), torch.zeros((K, N))
    out = micro3.big_matmul(a, b, 5)
    micro3.big_matmul.launches = before
    t = micro3.big_matmul_tiling(M, K, N, micro3.H100_SMS)
    (name, ga, gb, gout, part, *ints), = calls
    assert name == "big_matmul" and ga is a and gb is b and gout is out
    assert out.shape == (M, N)
    assert ints == [M, K, N, 5, t["tile"], t["ks"]]
    if t["splits"] == 1:
        assert part is None
    else:
        assert part.shape == (t["splits"], M, N)
        assert part.dtype == torch.float32


# ---------------------------------------------------------------------------
# plain versions against numpy, on random values at odd iteration counts
# ---------------------------------------------------------------------------

def _np_tile_t(a):
    R = a.shape[0]
    return a.reshape(R // 128, 128, 128).transpose(0, 2, 1).reshape(R, 128)


def test_transpose_loop_random_odd_count_against_numpy():
    x = np.random.default_rng(11).standard_normal((384, 128)).astype(
        np.float32)
    want = x
    for _ in range(5):
        want = _np_tile_t(want) + np.float32(1.0)
    got = micro3.transpose_loop(*_t(x), 5)
    assert _same_bits(got, want)
    assert not np.array_equal(got.numpy(), x + np.float32(5.0))


def test_sandwich_random_odd_count_against_numpy():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    s = [rng.integers(0, 128, (256, 128)).astype(np.int32) for _ in range(3)]
    want = x
    for _ in range(3):
        a = np.take_along_axis(want, s[0], axis=1)
        a = np.take_along_axis(_np_tile_t(a), s[1], axis=1)
        want = np.take_along_axis(_np_tile_t(a), s[2], axis=1)
    assert _same_bits(micro3.sandwich(*_t(x, *s), 3), want)


# ---------------------------------------------------------------------------
# entry points and wrapper contracts
# ---------------------------------------------------------------------------

_MAINS = [
    (micro, ["--col-rows", "8", "64", "--lane-rows", "8", "64",
             "--stream-mb", "1", "--loop-rows", "256", "--loop-iters", "3"],
     ["col_gather", "col_gather", "lane_gather", "lane_gather", "stream",
      "gather_loop"]),
    (micro2, ["--edges", str(_SMALL_EDGES), "--take-iters", "2"],
     ["take/random_dup", "take/random_perm", "take/banded_perm_64K",
      "take/identity", "dynslice_gather", "onehot_scatter"]),
    (micro3, ["--lane-rows", "256", "--lane-iters", "3",
              "--transpose-rows", "256", "--transpose-iters", "3",
              "--sandwich-rows", "256", "--sandwich-iters", "3",
              "--matmul-iters", "2"],
     ["lane_gather_loop", "transpose_loop", "sandwich", "big_matmul"]),
]


@pytest.mark.parametrize("mod,argv,benches", _MAINS,
                         ids=["micro", "micro2", "micro3"])
def test_entry_point_runs_on_cpu_when_asked(mod, argv, benches, capsys):
    mod.reset_launch_counts()
    results = mod.main(["--device", "cpu"] + argv)
    assert [r["bench"] for r in results] == benches
    assert all(r["ok"] and r["ms"] > 0 for r in results)
    assert "platform: cpu" in capsys.readouterr().out
    # the plain versions launch nothing
    assert all(fn.launches == 0 for fn in mod.KERNELS)


@pytest.mark.parametrize("mod", [micro, micro2, micro3])
def test_entry_point_raises_without_a_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _valid_args():
    f = torch.zeros((256, 128))
    i = torch.zeros((256, 128), dtype=torch.int32)
    blk = torch.zeros((32, 1), dtype=torch.int32)
    return {
        micro.col_gather: (f, i), micro.lane_gather: (f, i),
        micro.stream: (f,), micro.gather_loop: (f, i, 2),
        micro2.dynslice_gather: (blk, i, f),
        micro2.onehot_scatter: (blk, i, f, 256),
        micro3.lane_gather_loop: (f, i, 2), micro3.transpose_loop: (f, 2),
        micro3.sandwich: (f, i, i, i, 2),
        micro3.big_matmul: (torch.zeros((64, 32)), torch.zeros((32, 32)), 2),
    }


def _bad_shape_args():
    f, i, _ = _valid_args()[micro.gather_loop]
    blk = _valid_args()[micro2.dynslice_gather][0]
    return {
        micro.col_gather: (f, i[:128]), micro.lane_gather: (f, i[:128]),
        micro.stream: (f[:, :64].contiguous(),),
        micro.gather_loop: (f, i[:128], 2),
        micro2.dynslice_gather: (blk[:16], i, f),
        micro2.onehot_scatter: (blk, i, f[:128], 256),
        micro3.lane_gather_loop: (f, i[:128], 2),
        micro3.transpose_loop: (f[:200], 2),
        micro3.sandwich: (f, i, i[:128], i, 2),
        micro3.big_matmul: (torch.zeros((64, 32)), torch.zeros((64, 32)), 2),
    }


_WRAPPERS = list(_valid_args())


@pytest.mark.parametrize("fn", _WRAPPERS, ids=lambda f: f.__name__)
def test_wrapper_raises_on_meta_wrong_dtype_and_shape(fn):
    args = _valid_args()[fn]
    fn(*args)                                       # valid on the CPU
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fn(*meta)
    with pytest.raises(TypeError):
        fn(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fn(*_bad_shape_args()[fn])


@pytest.mark.parametrize("fn", _WRAPPERS, ids=lambda f: f.__name__)
def test_wrapper_launches_its_kernel_for_a_card_tensor(fn, monkeypatch):
    """Where the tensors are on the card, the wrapper calls its kernel's
    entry point (here a recorder) and counts the launch; it never takes
    the plain version."""
    mod = sys.modules[fn.__module__]
    launched = []
    monkeypatch.setattr(mod, "on_card", lambda name, *t: True)
    monkeypatch.setattr(mod, "launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(mod, f"{fn.__name__}_reference",
                        lambda *a: pytest.fail("plain version taken"),
                        raising=False)
    before = fn.launches
    fn(*_valid_args()[fn])
    assert launched == [fn.__name__] and fn.launches == before + 1
    fn.launches = before


def test_entry_point_names_match_the_kernel_source():
    src = open(os.path.join(_REPO, "memgraph_tpu_torch", "ops", "csrc",
                            "micro.cu")).read()
    for fn in _WRAPPERS:
        assert f"int micro_{fn.__name__}(" in src
        assert f"micro_{fn.__name__}" in _common._SIGNATURES
    # hand-written: no library kernel is included or called
    includes = [ln.split()[1] for ln in src.splitlines()
                if ln.startswith("#include")]
    assert includes == ["<cuda_runtime.h>", "<cstdint>"]
    for lib in ("cublas", "cudnn", "cutlass", "thrust", "cub::"):
        assert lib not in src.lower()


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_benchmarks_import_neither_jax_nor_the_jax_package():
    root = os.path.join(_REPO, "memgraph_tpu_torch", "benchmarks")
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
             if f.endswith(".py")]
    assert {os.path.basename(p) for p in paths} >= {
        "__init__.py", "_common.py", "micro.py", "micro2.py", "micro3.py"}
    bad = [(p, m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "memgraph_tpu")]
    assert not bad, bad
