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

``build_sharded_train_step`` is the reference's mesh layout on a
(data x model) ``Mesh2D`` (parallel/mesh.py ``make_mesh_2d``): the tables
split by columns over ``model``, the batch by rows over ``data``.  Each
shard gathers its rows of its column block (K1 in the backward, as the
single-card step); a pair's dot products sum the model shards in shard
order; the loss's sums and pair counts sum the data shards in shard
order; each column block's gradient is its data shards' gradients
summed in shard order, and Adam runs a column block at a time, which is
exact because Adam is elementwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.csr import DeviceGraph
from ..parallel import mesh as M
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


class ShardLayout:
    """Where the pieces of a tensor live on a ``Mesh2D``.

    ``"table"``: an (n, D) table split by columns over ``model`` (D a
    multiple of ``model``), each column block replicated over ``data``:
    ``place`` gives ``{device: block}`` a model index (one copy a
    distinct device, shared by the shards on it), ``gather`` the whole
    table back.  ``"batch"``: a (B, ...) tensor split by rows over
    ``data`` (B a multiple of ``data``), each row block replicated over
    ``model``: ``place`` gives ``[data][model]`` tensors."""

    def __init__(self, mesh: "M.Mesh2D", kind: str):
        if kind not in ("table", "batch"):
            raise ValueError(f"unknown layout {kind!r}")
        self.mesh, self.kind = mesh, kind

    def place(self, t: torch.Tensor):
        mesh = self.mesh
        if self.kind == "table":
            if t.shape[1] % mesh.model:
                raise ValueError(f"{t.shape[1]} columns do not split over "
                                 f"{mesh.model} model shards")
            cols = t.shape[1] // mesh.model
            blocks = []
            for j in range(mesh.model):
                block = t[:, j * cols:(j + 1) * cols]
                devs = dict.fromkeys(mesh.device(i, j)
                                     for i in range(mesh.data))
                blocks.append({d: block.to(d, copy=True).contiguous()
                               for d in devs})
            return blocks
        if t.shape[0] % mesh.data:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{mesh.data} data shards")
        rows = t.shape[0] // mesh.data
        return [[t[i * rows:(i + 1) * rows].to(mesh.device(i, j))
                 for j in range(mesh.model)] for i in range(mesh.data)]

    def gather(self, blocks) -> torch.Tensor:
        """The whole table from placed blocks (shard (0, j)'s copies)."""
        mesh = self.mesh
        dev = mesh.device(0, 0)
        return torch.cat([blocks[j][mesh.device(0, j)].detach().to(dev)
                          for j in range(mesh.model)], dim=1)


class ShardedStep:
    """The step ``build_sharded_train_step`` returns:
    ``step(params, opt_state, centers, contexts, negatives)`` ->
    ``(params, opt_state, loss)``, ``params`` the tables placed by the
    table layout (``{"in", "out"}``), ``opt_state`` from ``init(params)``
    (one optimizer a column block and device), the batch as whole
    tensors (split here by the batch layout) and ``loss`` a 0-d tensor
    on shard (0, 0)'s device.  The blocks are updated in place."""

    def __init__(self, mesh: "M.Mesh2D", optimizer):
        self.mesh = mesh
        self.optimizer = optimizer
        self.batch = ShardLayout(mesh, "batch")

    def init(self, params) -> dict:
        """One optimizer a (model index, device) over the two tables'
        blocks there."""
        opt = {}
        for j in range(self.mesh.model):
            for dev in params["in"][j]:
                ts = [params[k][j][dev] for k in ("in", "out")]
                for t in ts:
                    t.requires_grad_(True)
                opt[(j, dev)] = self.optimizer(ts)
        return opt

    def __call__(self, params, opt_state, centers, contexts, negatives):
        mesh = self.mesh
        cs, ts, ns = (self.batch.place(a) for a in (centers, contexts,
                                                    negatives))
        leaves = {}
        pos = [[None] * mesh.model for _ in range(mesh.data)]
        neg = [[None] * mesh.model for _ in range(mesh.data)]
        for i in range(mesh.data):
            for j in range(mesh.model):
                dev = mesh.device(i, j)
                # a leaf of its own a shard (no copy): the shards'
                # gradients stay apart, to be summed in shard order
                tin, tout = (params[k][j][dev].detach().requires_grad_(True)
                             for k in ("in", "out"))
                leaves[(i, j)] = (tin, tout)
                rows = tin.shape[0]
                c = torch.clamp(cs[i][j], min=0)
                t = torch.clamp(ts[i][j], min=0)
                e_c = gather_rows(tin, row_runs(c, rows))
                e_t = gather_rows(tout, row_runs(t, rows))
                e_n = gather_rows(tout, row_runs(ns[i][j].reshape(-1), rows)
                                  ).view(*ns[i][j].shape, -1)
                pos[i][j] = torch.sum(e_c * e_t, dim=-1)
                neg[i][j] = torch.sum(e_c.unsqueeze(1) * e_n, dim=-1)
        pos = M.psum_axis(mesh, pos, "model")
        neg = M.psum_axis(mesh, neg, "model")
        sums = [[None] * mesh.model for _ in range(mesh.data)]
        counts = [[None] * mesh.model for _ in range(mesh.data)]
        for i in range(mesh.data):
            for j in range(mesh.model):
                mask = ((cs[i][j] >= 0) & (ts[i][j] >= 0)).to(torch.float32)
                loss = F.softplus(-pos[i][j]) + torch.sum(
                    F.softplus(neg[i][j]), dim=-1)
                sums[i][j] = torch.sum(loss * mask)
                counts[i][j] = mask.sum()
        total = M.psum_axis(mesh, sums, "data")[0][0]
        count = M.psum_axis(mesh, counts, "data")[0][0]
        loss = total / torch.clamp(count, min=1.0)
        loss.backward()
        with torch.no_grad():
            for j in range(mesh.model):
                for k, name in enumerate(("in", "out")):
                    grads = M.psum_axis(mesh, [
                        [leaves[(i, j2)][k].grad for j2 in range(mesh.model)]
                        for i in range(mesh.data)], "data")
                    for i in range(mesh.data):
                        params[name][j][mesh.device(i, j)].grad = grads[i][j]
            for opt in opt_state.values():
                opt.step()
                opt.zero_grad(set_to_none=True)
        return params, opt_state, loss.detach()


def build_sharded_train_step(mesh, optimizer):
    """The reference's sharded step on a ``Mesh2D``: (step, param_layout,
    batch_layout), where ``param_layout`` is ``{"in", "out"}`` of the
    table layout (columns over ``model``), ``batch_layout`` the batch's
    (rows over ``data``) and ``step`` a ``ShardedStep``.  ``optimizer``
    makes a torch optimizer over a list of tensors (e.g. ``lambda ts:
    adam(ts, lr)``, ops/gnn.py's optax.adam)."""
    table = ShardLayout(mesh, "table")
    return (ShardedStep(mesh, optimizer), {"in": table, "out": table},
            ShardLayout(mesh, "batch"))
