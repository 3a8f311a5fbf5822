"""Label propagation of this checkout against other checkouts' on one card,
in turns, with each build's round broken down by kernel.

    python -m memgraph_tpu_torch.benchmarks.labelprop_against [--against DIR ...]
        [--rounds R]

Card only.  On the north-star graph (``northstar.generate_graph``, built
by each checkout's own ``ops/csr.py`` and placed on the card once), for
this checkout's ``ops/labelprop.py`` and for each other checkout named by
``--against`` (its ``memgraph_tpu_torch`` loaded as a package of its own,
its kernels built from its own sources, every build at once):
``label_propagation`` undirected, ``--rounds`` rounds at most (30, the
procedure's default), timed on the host clock (the call ends in a host
transfer of the labels) in turns: others, this, this, others reversed,
twice each.  Every build's labels and rounds are held equal to this
checkout's.  Then one call of each build under ``torch.profiler``: device
ms a round by kernel name, largest first, and the device-busy ms a round.
Prints the card's name and power limit, then one JSON line a build.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .loop_split import card_line, load_tree

TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0][:100]


def profile_round(call, rounds: int) -> dict:
    """Device ms a round by kernel name (the TOP largest) and in all."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _short(e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ms_a_round": total / rounds / 1e3,
            "kernels_ms_a_round": {k: us / rounds / 1e3 for k, us in top}}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.labelprop_against",
        description="label propagation of this build and others on the "
                    "north-star graph, in turns (card only).")
    p.add_argument("--against", action="append", default=[],
                   help="root of another checkout to time in turns")
    p.add_argument("--rounds", type=int, default=30)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("labelprop_against needs a CUDA card")
    dev = torch.device("cuda")
    this = __package__.rsplit(".", 1)[0]
    packages = {"this": this}
    for i, root in enumerate(a.against):
        alias = f"_against{i}_memgraph_tpu_torch"
        load_tree(root, alias)
        packages[os.path.basename(os.path.normpath(root))] = alias
    builds = {name: importlib.import_module(f"{pkg}.ops.segment_cuda")
              for name, pkg in packages.items()}
    with ThreadPoolExecutor(len(builds)) as pool:     # nvcc in parallel
        list(pool.map(lambda sc: sc._lib(), builds.values()))
    northstar = importlib.import_module(f"{this}.northstar")
    src, dst = northstar.generate_graph()
    calls = {}
    for name, pkg in packages.items():
        csr = importlib.import_module(f"{pkg}.ops.csr")
        lp = importlib.import_module(f"{pkg}.ops.labelprop")
        graph = csr.from_coo(src, dst,
                             n_nodes=northstar.N_NODES).to_device(dev)
        calls[name] = (lambda lp=lp, graph=graph: lp.label_propagation(
            graph, max_iterations=a.rounds, directed=False))
    card = card_line()
    print("card", card, flush=True)
    want, rounds = calls["this"]()
    for name, call in calls.items():
        got, r = call()
        if r != rounds or not np.array_equal(got, want):
            raise SystemExit(f"{name}'s labels or rounds are not this "
                             f"build's")
    others = [k for k in calls if k != "this"]
    turns = (others + ["this", "this"] + others[::-1]) * 2
    seconds: dict = {name: [] for name in calls}
    for name in turns:
        t0 = time.perf_counter()
        calls[name]()
        seconds[name].append(time.perf_counter() - t0)
    lines = []
    for name, call in calls.items():
        line = {"build": name, "rounds": rounds, "seconds": seconds[name],
                "ms_a_round": float(np.mean(seconds[name])) / rounds * 1e3,
                **profile_round(call, rounds), "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(card_line(), flush=True)
    return lines


if __name__ == "__main__":
    main()
