"""Where the time of the two chained-gather kernels goes, and how two
builds of the micro kernels compare on one card.

    python -m memgraph_tpu_torch.benchmarks.loop_split [--against DIR ...]

Card only.  For this checkout's port and for each other checkout named by
``--against`` (its ``memgraph_tpu_torch`` loaded as a package of its own,
its kernels built from its own sources), in turns (others, this, this,
others reversed):
  - ``gather_loop`` at R = 8192 and ``lane_gather_loop`` at R = 4096, each
    at several iteration counts (``split``: t(0) is the entry, the exit
    and the launch; the time an iteration is taken between the two largest
    counts);
  - every other micro kernel at its entry point's largest size.
Each kernel is first held bit-exact (big_matmul and onehot_scatter within
their tolerances) against its plain version, per build.  Times are CUDA
events over launches queued behind a device spin, as in chip_smoke.py.
Prints the card's name and power limit, then one JSON line a kernel.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device

SPLITS = {"gather_loop": (0, 1, 50, 100), "lane_gather_loop": (0, 1, 250, 500)}
# ~10 ms of device spin at 1.98 GHz: the host queues the timed launches
# meanwhile
QUEUE_AHEAD_CYCLES = 20_000_000


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split_of(ms: dict, counts) -> dict:
    """The split of a looping kernel timed at each of ``counts`` (ms by
    count): t(0), and the time an iteration between the two largest."""
    hi, mid = counts[-1], counts[-2]
    return {"iters": list(counts), "ms": {str(k): ms[k] for k in counts},
            "t0_ms": ms[counts[0]],
            "per_iter_ms": (ms[hi] - ms[mid]) / (hi - mid)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def load_tree(root: str, alias: str) -> dict:
    """The micro modules of the port in checkout ``root``, as package
    ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "memgraph_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return tree_modules(alias)


def tree_modules(package: str) -> dict:
    names = ("micro", "micro2", "micro3", "_common")
    out = {n: importlib.import_module(f"{package}.benchmarks.{n}")
           for n in names}
    out["build"] = importlib.import_module(f"{package}.ops._build")
    return out


def cases(dev):
    """(kernel, size, args, rtol, iteration counts or None), one a kernel
    at its entry point's largest size, built from the modules' own
    input makers (the same in every build)."""
    from . import micro as M1, micro2 as M2, micro3 as M3

    def put(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    yield "gather_loop", "R=8192", put(*M1.gather_inputs(8192, 8192)), 0.0, \
        SPLITS["gather_loop"]
    yield "lane_gather_loop", "R=4096", put(*M3.lane_loop_inputs(4096)), \
        0.0, SPLITS["lane_gather_loop"]
    yield "col_gather", "R=8192", put(*M1.gather_inputs(8192, 8192)), 0.0, None
    yield "lane_gather", "R=8192", put(*M1.gather_inputs(8192, 128)), 0.0, \
        None
    yield "stream", "256 MB", [torch.randn((2**19, 128), device=dev)], 0.0, \
        None
    yield "dynslice_gather", "main", put(*M2.dynslice_inputs()), 0.0, None
    yield "onehot_scatter", "main", put(*M2.onehot_inputs()), \
        M2.ONEHOT_RTOL, None
    yield "transpose_loop", "R=8192 x500", \
        [torch.ones((8192, 128), device=dev), 500], 0.0, None
    yield "sandwich", "R=4096 x200", \
        put(*M3.lane_loop_inputs(4096, 3)) + [200], 0.0, None
    yield "big_matmul", "x500", put(*M3.matmul_inputs()) + [500], \
        M3.MATMUL_RTOL, None


def kernel_of(mods: dict, name: str):
    for m in ("micro", "micro2", "micro3"):
        if hasattr(mods[m], name) and hasattr(mods[m], f"{name}_reference"):
            return getattr(mods[m], name), getattr(mods[m],
                                                   f"{name}_reference")
    raise KeyError(name)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.loop_split",
        description="Iteration split of gather_loop and lane_gather_loop, "
                    "and every micro kernel's time, for this build and "
                    "others, in turns (card only).")
    p.add_argument("--against", action="append", default=[],
                   help="root of another checkout to time in turns")
    a = p.parse_args(argv)
    dev = resolve_device(None)
    trees = {"this": tree_modules(__package__.rsplit(".", 1)[0])}
    for i, root in enumerate(a.against):
        trees[os.path.basename(os.path.normpath(root))] = load_tree(
            root, f"_against{i}_memgraph_tpu_torch")
    with ThreadPoolExecutor(len(trees)) as pool:     # nvcc in parallel
        list(pool.map(lambda m: m["build"].load_kernels(), trees.values()))
    card = card_line()
    print("card", card, flush=True)
    others = [k for k in trees if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    lines = []
    for name, size, args, rtol, counts in cases(dev):
        res = {"kernel": name, "size": size, "card": card}
        held = args if counts is None else args + [counts[-1]]
        for label, mods in trees.items():
            kern, plain = kernel_of(mods, name)
            ok, err = mods["_common"].compare(kern(*held), plain(*held), rtol)
            if not ok:
                raise SystemExit(f"{name} {size} of {label} disagrees with "
                                 f"its plain version (max abs err {err})")
        for label in order:
            kern, _ = kernel_of(trees[label], name)
            entry = res.setdefault(label, {"ms": []})
            if counts is None:
                entry["ms"].append(device_ms(lambda: kern(*args), 5))
                continue
            t = {}
            for it in counts:
                t[it] = device_ms(lambda: kern(*args, it), 5)
            entry["ms"].append(t[counts[-1]])
            entry.setdefault("split_ms", []).append(
                {str(k): v for k, v in t.items()})
        for label in trees:
            entry = res[label]
            entry["mean_ms"] = float(np.mean(entry["ms"]))
            if counts is not None:
                entry["split"] = split_of(
                    {k: float(np.mean([s[str(k)] for s in entry["split_ms"]]))
                     for k in counts}, counts)
        if others:
            res["ratio_to"] = {lab: res["this"]["mean_ms"]
                               / res[lab]["mean_ms"] for lab in others}
        print(json.dumps(res), flush=True)
        lines.append(res)
    print(card_line(), flush=True)
    return lines


if __name__ == "__main__":
    main()
