"""The deterministic segment sums of this checkout against other checkouts'
on one card, in turns.

    python -m memgraph_tpu_torch.benchmarks.segment_against [--against DIR ...]

Card only.  On the north-star graph (``northstar.generate_graph``, built
by this checkout's ``ops/csr.py`` and placed on the card once), for this
checkout's ``ops/segment_cuda.py`` and for each other checkout named by
``--against`` (its ``memgraph_tpu_torch`` loaded as a package of its own,
its kernels built from its own sources, every build at once):
  - ``csr_spmm_sum`` over the CSC runs (the pull matvec) and the CSR runs
    (the reversed one), f32 at 1, 3 and 32 lanes and bf16 at one lane,
    given the graph's longest run where the build's wrapper takes it;
    this checkout also with the longest run unknown (``this_two_role``,
    the launch with a long role);
  - ``lane_sum``, dot form (the dangling mass), at 1, 3 and 32 lanes.
Every build's result is held bit-equal to this checkout's (``chip_smoke.py``
holds this checkout's against the plain versions).  Times are CUDA events
over launches queued behind a device spin, in turns (others, this, this,
others reversed; for K1 the two-role launch twice between this build's
two).  Prints the card's name and power limit, then one JSON line a
shape.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .loop_split import card_line, device_ms, load_tree

LANES = (1, 3, 32)
SEED = 5


def segment_module(package: str):
    return importlib.import_module(f"{package}.ops.segment_cuda")


def k1_call(sc, x, ptr, g, w, precision, longest, give_longest: bool):
    """One K1 launch as the build's wrapper takes it."""
    kw = {"precision": precision}
    if give_longest and "longest" in inspect.signature(
            sc.csr_spmm_sum).parameters:
        kw["longest"] = longest
    return lambda: sc.csr_spmm_sum(x, ptr, g, w, **kw)


def shapes(graph, dev):
    """(label, (kind, *args)) for every timed shape: ("k1", x, ptr, g, w,
    precision, longest) or ("k2", a, m)."""
    rng = np.random.default_rng(SEED)
    runs = (("csc", graph.csc_runs(), graph.csc_src, graph.csc_weights,
             graph.longest_csc_run),
            ("csr", graph.row_ptr, graph.col_idx, graph.weights,
             graph.longest_csr_run))
    for lanes in LANES:
        x = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).to(dev)
        for label, ptr, g, w, longest in runs:
            for precision in ("f32", "bf16") if lanes == 1 else ("f32",):
                yield (f"csr_spmm_sum {label} {precision} B={lanes}",
                       ("k1", x, ptr, g, w, precision, longest))
    m = torch.from_numpy((rng.random(graph.n_pad) < 0.1)
                         .astype(np.float32)).to(dev)
    for lanes in LANES:
        a = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).to(dev)
        yield f"lane_sum dot B={lanes}", ("k2", a, m)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m memgraph_tpu_torch.benchmarks.segment_against",
        description="csr_spmm_sum and lane_sum of this build and others "
                    "on the north-star graph, in turns (card only).")
    p.add_argument("--against", action="append", default=[],
                   help="root of another checkout to time in turns")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("segment_against needs a CUDA card")
    dev = torch.device("cuda")
    this = __package__.rsplit(".", 1)[0]
    trees = {"this": segment_module(this)}
    for i, root in enumerate(a.against):
        alias = f"_against{i}_memgraph_tpu_torch"
        load_tree(root, alias)
        trees[os.path.basename(os.path.normpath(root))] = \
            segment_module(alias)
    with ThreadPoolExecutor(len(trees)) as pool:     # nvcc in parallel
        list(pool.map(lambda sc: sc._lib(), trees.values()))
    northstar = importlib.import_module(f"{this}.northstar")
    csr = importlib.import_module(f"{this}.ops.csr")
    src, dst = northstar.generate_graph()
    graph = csr.from_coo(src, dst, n_nodes=northstar.N_NODES).to_device(dev)
    card = card_line()
    print("card", card, flush=True)
    others = [k for k in trees if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    lines = []
    for label, (kind, *args) in shapes(graph, dev):
        calls = {}
        for name, sc in trees.items():
            if kind == "k1":
                calls[name] = k1_call(sc, *args, give_longest=True)
            else:
                calls[name] = (lambda sc=sc: sc.lane_sum(args[0], m=args[1]))
        if kind == "k1":
            calls["this_two_role"] = k1_call(trees["this"], *args,
                                             give_longest=False)
        want = calls["this"]()
        for name, call in calls.items():
            if not torch.equal(call().view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"{label}: {name} is not this build's bits")
        res = {"shape": label, "card": card}
        turns = (others + ["this", "this_two_role", "this_two_role", "this"]
                 + others[::-1]) if kind == "k1" else order
        for name in turns:
            res.setdefault(name, {"ms": []})["ms"].append(
                device_ms(calls[name], 10))
        for name in calls:
            res[name]["mean_ms"] = float(np.mean(res[name]["ms"]))
        res["ratio_to"] = {name: res["this"]["mean_ms"] / res[name]["mean_ms"]
                           for name in calls if name != "this"}
        print(json.dumps(res), flush=True)
        lines.append(res)
    print(card_line(), flush=True)
    return lines


if __name__ == "__main__":
    main()
