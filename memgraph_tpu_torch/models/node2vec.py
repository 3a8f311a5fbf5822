"""node2vec: biased random walks and skip-gram with negative sampling.

Port of memgraph_tpu/models/node2vec.py.  Each epoch samples the walks
on the graph's device (ops/walks.py), expands them into (center,
context) pairs, permutes the pairs and trains the two embedding tables
("in" for centers, "out" for contexts and negatives) a batch of
``batch_size`` pairs at a time, ``negatives`` uniform nodes in [0,
n_nodes) a pair.  Adam is dense over both whole tables, as optax.adam
is (ops/gnn.py ``adam``): every row's moments decay at every step,
whether or not the batch touched the row.

The table gradients are sums of gathered rows: ``gather_rows``
(ops/gnn.py) sums each row's gradient rows in position order by one K1
launch (ops/segment_cuda.py) over the batch's indices sorted stably, so
two fits from one seed give the same bits.  Randomness comes from one
``torch.Generator`` on the graph's device seeded with ``seed``: the
initial tables, the walks, the permutations and the negatives.

``build_sharded_train_step`` (the reference's mesh layout) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.csr import DeviceGraph
from ..ops.gnn import adam, gather_rows, row_runs
from ..ops.pagerank import graph_device, on_device
from ..ops.walks import random_walks, walks_to_skipgram_pairs


@dataclass
class Node2VecConfig:
    embedding_dim: int = 128
    walk_length: int = 20
    walks_per_node: int = 4
    window: int = 5
    negatives: int = 5
    p: float = 1.0
    q: float = 1.0
    learning_rate: float = 0.01
    epochs: int = 3
    batch_size: int = 8192
    seed: int = 0


def init_params(n_nodes_pad: int, dim: int, generator=None,
                device=None) -> dict:
    """{"in", "out"}: (n_nodes_pad, dim) f32 tables, N(0, 1/dim) entries
    drawn on ``device`` (default: the generator's, else the card) from
    ``generator`` (None: torch's default)."""
    dev = resolve_device(device if device is not None or generator is None
                         else generator.device)
    scale = 1.0 / float(np.sqrt(dim))
    return {k: torch.randn(n_nodes_pad, dim, generator=generator,
                           device=dev) * scale for k in ("in", "out")}


def node2vec_params_from_jax(params, device=None) -> dict:
    """{"in", "out"} tables of the reference's parameters (any arrays
    numpy can read) on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)).to(
        dev) for k in ("in", "out")}


def sgns_loss(params, centers, contexts, negatives):
    """The reference's skip-gram negative-sampling loss: softplus(-c·t)
    + Σ_k softplus(c·n_k) a pair, averaged over the pairs whose ids are
    both >= 0 (-1 pads)."""
    mask = ((centers >= 0) & (contexts >= 0)).to(torch.float32)
    rows = params["in"].shape[0]
    c = torch.clamp(centers, min=0)
    t = torch.clamp(contexts, min=0)
    e_c = gather_rows(params["in"], row_runs(c, rows))            # (B, D)
    e_t = gather_rows(params["out"], row_runs(t, rows))           # (B, D)
    e_n = gather_rows(params["out"], row_runs(negatives.reshape(-1), rows)
                      ).view(*negatives.shape, -1)                # (B, K, D)
    pos = torch.sum(e_c * e_t, dim=-1)
    neg = torch.sum(e_c.unsqueeze(1) * e_n, dim=-1)
    loss = F.softplus(-pos) + torch.sum(F.softplus(neg), dim=-1)
    return torch.sum(loss * mask) / torch.clamp(mask.sum(), min=1.0)


def train_step(params, optimizer, centers, contexts, negatives):
    """One Adam step of ``optimizer`` (over the tables ``params``) on a
    batch; the batch's loss (a 0-d tensor)."""
    optimizer.zero_grad(set_to_none=True)
    loss = sgns_loss(params, centers, contexts, negatives)
    loss.backward()
    optimizer.step()
    return loss.detach()


class Node2Vec:
    """End-to-end node2vec trainer over a DeviceGraph."""

    def __init__(self, config: Node2VecConfig | None = None):
        self.config = config or Node2VecConfig()
        self.epoch_losses = []     # the last batch's loss of each epoch

    def fit(self, graph: DeviceGraph, verbose: bool = False, device=None):
        """The "in" table's rows of the n_nodes true nodes, (n_nodes,
        embedding_dim) f32, trained on ``device`` (explicit, else the
        graph's, else the card)."""
        cfg = self.config
        dev = graph_device(graph, device)
        g = on_device(graph, dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = init_params(g.n_pad, cfg.embedding_dim, gen, dev)
        for table in params.values():
            table.requires_grad_(True)
        optimizer = adam(list(params.values()), cfg.learning_rate)
        starts = torch.arange(g.n_nodes, device=dev).repeat(
            cfg.walks_per_node)
        B = cfg.batch_size
        self.epoch_losses = []
        for epoch in range(cfg.epochs):
            walks = random_walks(g, starts, cfg.walk_length, gen, p=cfg.p,
                                 q=cfg.q)
            pairs = walks_to_skipgram_pairs(walks, cfg.window)
            pairs = pairs[torch.randperm(pairs.shape[0], generator=gen,
                                         device=dev)]
            n_batches = max(pairs.shape[0] // B, 1)
            for b in range(n_batches):
                batch = pairs[b * B:(b + 1) * B]
                if batch.shape[0] < B:
                    batch = torch.cat([batch, batch.new_full(
                        (B - batch.shape[0], 2), -1)])
                negs = torch.randint(0, g.n_nodes, (B, cfg.negatives),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
                loss = train_step(params, optimizer, batch[:, 0],
                                  batch[:, 1], negs)
            self.epoch_losses.append(float(loss))
            if verbose:
                print(f"epoch {epoch}: loss={self.epoch_losses[-1]:.4f}")
        return params["in"].detach()[:g.n_nodes]
