"""Where a training step's time goes on one card: a GraphSAGE link
epoch on the north star and a node2vec batch on the segment graph, each
broken down by kernel under ``torch.profiler``.

    python -m memgraph_tpu_torch.benchmarks.train_profile [--epochs E]
        [--batches B]

Card only.  The link epoch is ``train_link_prediction``'s step at the
procedures' defaults (hidden 64, out 32, 2 layers) on degree features of
``northstar.generate_graph`` (1M nodes, 10M edges), split into the
negatives' draw and sort, the forward to the loss, the backward and Adam;
the node2vec batch is ``models.node2vec.train_step`` at the defaults
(dim 128, batch 8192, 5 negatives) on the segment graph (100,000 nodes,
450,000 edges).  For each: host ms a step (ending in a synchronize), the
device-busy ms a step, and device ms a step by kernel name, largest
first.  Prints the card's name and power limit, then one JSON line a
step kind.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .labelprop_against import _short
from .loop_split import card_line

TOP = 12


def profiled(step, reps: int) -> dict:
    """Host ms a step, device-busy ms a step and the TOP kernels' device
    ms a step over ``reps`` steps (after one warm step)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _short(e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"host_ms": host_ms,
            "device_ms": sum(by_name.values()) / reps / 1e3,
            "kernels_ms": {k: us / reps / 1e3 for k, us in top}}


def link_epoch(reps: int) -> dict:
    from ..northstar import generate_graph
    from ..ops import gnn as G
    from ..ops.csr import from_coo
    src, dst = generate_graph()
    graph = from_coo(src, dst).to_device("cuda")
    feats = G.degree_features(graph)
    model = G.init_sage_params(16, 64, 32, 2, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    opt = G.adam(model.parameters(), 0.01)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pos = G.edge_runs(graph)
    n, m = graph.n_nodes, graph.n_edges

    def draw():
        return tuple(G.row_runs(torch.randint(
            0, n, (m,), generator=gen, device="cuda", dtype=torch.int32),
            graph.n_pad) for _ in range(2))

    neg = draw()
    parts = {
        "draw_and_sort": draw,
        "forward": lambda: G.link_loss(model, feats, graph, pos, neg),
        "forward_backward": lambda: G.link_loss(model, feats, graph, pos,
                                                neg).backward(),
        "adam": opt.step,
        "inference_forward": lambda: G.sage_forward(model, feats, graph)}

    def epoch():
        opt.zero_grad(set_to_none=True)
        G.link_loss(model, feats, graph, pos, draw()).backward()
        opt.step()

    return {"step": "link_epoch", "n_nodes": n, "n_edges": m,
            "epoch": profiled(epoch, reps),
            "parts": {k: profiled(fn, reps) for k, fn in parts.items()}}


def node2vec_batch(reps: int) -> dict:
    from ..models import node2vec as N2V
    from ..northstar import generate_graph
    from ..ops import gnn as G
    from ..ops import walks as W
    from ..ops.csr import from_coo
    src, dst = generate_graph(100_000, 450_000)
    graph = from_coo(src, dst).to_device("cuda")
    cfg = N2V.Node2VecConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = N2V.init_params(graph.n_pad, cfg.embedding_dim, gen)
    for t in tables.values():
        t.requires_grad_(True)
    opt = G.adam(list(tables.values()), cfg.learning_rate)
    pairs = W.walks_to_skipgram_pairs(W.random_walks(
        graph, torch.arange(graph.n_nodes, device="cuda"), cfg.walk_length,
        gen), cfg.window)[:cfg.batch_size]
    negs = torch.randint(0, graph.n_nodes, (cfg.batch_size, cfg.negatives),
                         generator=gen, device="cuda", dtype=torch.int32)
    return {"step": "node2vec_batch", "n_nodes": graph.n_nodes,
            "batch": cfg.batch_size,
            "train_step": profiled(lambda: N2V.train_step(
                tables, opt, pairs[:, 0], pairs[:, 1], negs), reps)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batches", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA device")
    print("card", card_line(), flush=True)
    print(json.dumps(link_epoch(args.epochs)), flush=True)
    print(json.dumps(node2vec_batch(args.batches)), flush=True)


if __name__ == "__main__":
    main()
