"""What a thread-block cluster of 4 costs on the card: the latency of a
cluster barrier by block size, the rate of 16-byte stores into another
block's shared memory, and the time of a pass's all-to-all exchange by
bulk copies.  These decide whether a tile kernel gains by splitting a
tile over a cluster (``sandwich`` does not: PERF.md).

    python -m memgraph_tpu_torch.benchmarks.cluster_probe

Needs a card (sm_90a): it builds ``cluster_probe.cu`` beside this file
into ``memgraph_tpu_torch/_build/`` at first use.  One JSON line a probe,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

import torch

from ..device import resolve_device
from ..ops import _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cluster_probe.cu")
BLOCKS = 128                  # 32 clusters of 4, as a 32-tile launch
ROUNDS = 400                  # sandwich's exchanges a 200-iteration launch
_VP, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    out = _build.lib_path(SRC)
    if not os.path.exists(out):
        _build.compile_all([([_build._nvcc()] + _build.NVCC_FLAGS + [SRC],
                             out)])
    lib = ctypes.CDLL(out)
    for name, n_ints in (("probe_barrier", 3), ("probe_push", 4),
                         ("probe_bulk", 4)):
        fn = getattr(lib, name)
        fn.restype = _I32
        fn.argtypes = [_I32] * n_ints + [_VP, _VP]
    return lib


def _per_round_us(name, *ints) -> float:
    """Device time a round of probe ``name``: a launch of ROUNDS rounds
    less a launch of none, over ROUNDS (CUDA events, 5 launches each)."""
    out = torch.empty(BLOCKS * 1024, device="cuda")

    def run(n):
        fn = getattr(_lib(), name)
        stream = torch.cuda.current_stream().cuda_stream
        args = list(ints)
        args.insert(2, n)                     # blocks, threads, n, ...
        rc = fn(*args, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUDA error {rc}")

    def ms(n):
        run(n)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run(n)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    return (ms(ROUNDS) - ms(0)) / ROUNDS * 1e3


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.cluster_probe",
        description="Cluster barrier latency and distributed shared memory "
                    "rates on the card (clusters of 4).")
    p.parse_args(argv)
    resolve_device(None)                    # the card, or raise
    lines = []
    for threads in (128, 256, 512, 1024):
        lines.append({"probe": "barrier", "threads": threads,
                      "us": _per_round_us("probe_barrier", BLOCKS, threads)})
    for shift in (1, 0):
        us = _per_round_us("probe_push", BLOCKS, 1024, shift)
        lines.append({"probe": "push", "threads": 1024,
                      "to": "another block" if shift else "its own block",
                      "us": us, "gb_per_s_a_block": 1024 * 16 / us / 1e3})
    for threads in (256, 1024):
        # a sandwich block's pass: a 32 x 32 f32 chunk to each other block
        us = _per_round_us("probe_bulk", BLOCKS, threads, 4096)
        lines.append({"probe": "bulk_exchange", "threads": threads,
                      "bytes_to_each": 4096, "us": us,
                      "gb_per_s_out_a_block": 3 * 4096 / us / 1e3})
    for line in lines:
        print("cluster_probe", json.dumps(line), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    return lines


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
