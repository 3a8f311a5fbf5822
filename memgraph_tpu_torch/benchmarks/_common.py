"""What the three microbenchmark modules share: the ctypes binding of
``ops/csrc/micro.cu``, argument checks, device dispatch and timing."""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from ..device import resolve_device

LANES = 128
H100_SMS = 132
_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# argument types of each entry point of micro.cu, stream last
_SIGNATURES = {
    "micro_col_gather": [_VP, _VP, _VP, _I64, _VP],
    "micro_lane_gather": [_VP, _VP, _VP, _I64, _VP],
    "micro_stream": [_VP, _VP, _I64, _VP],
    "micro_gather_loop": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I64,
                          _I32, _VP],
    "micro_dynslice_gather": [_VP, _VP, _VP, _VP, _I64, _VP],
    "micro_onehot_scatter": [_VP, _VP, _VP, _VP, _I64, _VP],
    "micro_lane_gather_loop": [_VP, _VP, _VP, _I64, _I32, _I64, _I32, _I64,
                               _VP],
    "micro_transpose_loop": [_VP, _VP, _I64, _I32, _I64, _I32, _I64, _VP],
    "micro_sandwich": [_VP, _VP, _VP, _VP, _VP, _I64, _I32, _I64, _I32,
                       _I32, _I64, _VP],
    "micro_big_matmul": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
                         _I32, _VP],
}


@functools.cache
def _lib():
    from ..ops._build import load_kernels
    lib = load_kernels()["micro"]
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = _I32
        fn.argtypes = argtypes
    lib.micro_error_string.restype = ctypes.c_char_p
    lib.micro_error_string.argtypes = [_I32]
    return lib


def launch(name: str, *args) -> None:
    """Call ``micro_<name>`` with tensors passed as device pointers, on
    the current stream of the first tensor's device; raise if the launch
    failed."""
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(_lib(), f"micro_{name}")(
        *conv, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = _lib().micro_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def on_card(name: str, *tensors) -> bool:
    """True where the wrapper launches its kernel (CUDA tensors), False
    where it takes its plain version (CPU tensors); raises for any other
    device or for tensors on different devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return True


def check(name: str, t, dtype, shape=None):
    """Raise unless t is a contiguous tensor of dtype and shape (None in
    shape: any size there)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and (
            t.dim() != len(shape)
            or any(s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def count(fn):
    """Give a wrapper its launch counter (``fn.launches``)."""
    fn.launches = 0
    return fn


def timeit(fn, *args, n: int, device: torch.device):
    """Mean time of fn(*args) over n calls after one warm-up call, and the
    last output: CUDA-event time on the card, host wall time on the CPU.
    Makes n + 1 calls."""
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n, out
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    return (time.perf_counter() - t0) * 1e3 / n, out


def compare(got, want, rtol: float = 0.0) -> tuple:
    """(ok, max_abs_err) of got against want: bit-exact when rtol is 0,
    else |got - want| <= rtol * |want| everywhere."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if rtol == 0.0:
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        ok = bool(((got - want).abs() <= rtol * want.abs()).all())
    return bool(ok), err


def platform(device) -> str:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return "cpu"


def sm_count(dev) -> int:
    """SMs of the card the tensors lie on (an H100's for another device,
    which only a test that records the launch hands in)."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return H100_SMS


def bank_ways(words) -> int:
    """The shared-memory wavefronts one warp instruction of 32-bit accesses
    takes: the largest count of distinct word addresses that fall in one of
    the 32 banks (bank = word % 32; lanes on one address share it)."""
    words = torch.as_tensor(words).reshape(-1).long().unique()
    return int(torch.bincount(words % 32, minlength=32).max())
