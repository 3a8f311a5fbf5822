"""GraphSAGE in PyTorch: the GNN behind the link-prediction and
node-classification procedures, inference and training.

Port of memgraph_tpu/ops/gnn.py.  The undirected mean aggregation is two
run sums of the deterministic kernel ``csr_spmm_sum`` (ops/segment_cuda.py,
K1, gathered, ⊗ = first, a lane a feature): the in-neighbors' rows over
the CSC runs (``csc_src`` gathered) and the out-neighbors' rows over the
CSR runs (``col_idx`` gathered).  The reference sums the second direction
by an unsorted segment sum keyed by ``csc_src``; within a source its CSC
edges come in ascending dst, which is the CSR run's order, so each row
adds the same values in the same order from 0.0.  Degrees are the run
lengths (exact in f32).  Only the sink row (index ``n_nodes``) differs
from the reference's: the padding edges are left out of the runs
(``csc_runs()``), and no real node reads the sink.

The feature transforms keep the reference's roundings: h and the
aggregate rounded to bfloat16, each product accumulated in f32 and
rounded to bfloat16 (XLA's bf16 dot), their sum rounded to bfloat16,
then f32 plus the bias; ReLU between layers.  Autograd through those
casts rounds the gradients where JAX's autodiff of the same casts does:
a cotangent reaching a bf16 value is rounded to bfloat16.

Training (``train_link_prediction``, ``train_node_classification``):
the reference's losses (sigmoid binary cross-entropy over the edges then
uniform negative pairs; softmax cross-entropy of ``logits[label_idx]``),
``torch.optim.Adam`` with optax.adam's constants (b1 0.9, b2 0.999, eps
1e-8, eps_root 0) and the rank AUC.  Randomness comes from
``torch.Generator``s seeded with ``seed``: the initial weights from one
on the CPU (as ``init_sage_params`` draws them), the negatives from one on
the graph's device.

Determinism: every float sum of rows into a table adds in a fixed order,
so two runs give the same bits.  The aggregation's backward
(``_Aggregate``) is its own transpose, A_in + A_out being symmetric: the
same two K1 passes over ``grad / deg``, taken only when the aggregation's
input needs a gradient (never layer 1's: the features need none).  The
backward of a row gather ``table[idx]`` (``gather_rows``) sums the
gradient rows of each table row by K1 over ``idx`` sorted stably
(``RowRuns``), rows in their position order: the edges' own pairs are
already sorted, by dst as the CSC runs and, through a stable sort of
``csc_src`` (done once a graph), by src as the CSR runs; each epoch's
negatives and the label rows are sorted by ``torch.sort(stable=True)``.
Torch's own backward of advanced indexing is ``index_put_(accumulate=
True)``, whose CUDA order is the library's and not a documented
contract, and ``index_add_`` adds with float atomics: neither is used.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import exact_f32_matmuls, resolve_device
from . import segment_cuda as SC
from .csr import DeviceGraph
from .pagerank import graph_device, on_device


def _bf16_product(a, w):
    """a.bf16 @ w.bf16 as XLA's bf16 dot: f32 accumulation of the rounded
    operands, the result rounded to bfloat16."""
    return (a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
            ).to(torch.bfloat16)


def _undirected_sum(x, graph: DeviceGraph):
    """(A_in + A_out) x: each node's in- and out-neighbors' rows of
    ``x`` (n_pad, d) summed, by two K1 launches."""
    summed = SC.csr_spmm_sum(x, graph.csc_runs(), graph.csc_src,
                             mul="first", longest=graph.longest_csc_run)
    return summed + SC.csr_spmm_sum(x, graph.row_ptr, graph.col_idx,
                                    mul="first",
                                    longest=graph.longest_csr_run)


def _degrees(graph: DeviceGraph):
    """(n_pad,) f32 undirected degrees, at least 1."""
    csc = graph.csc_runs()
    deg = ((csc[1:] - csc[:-1]) + (graph.row_ptr[1:] - graph.row_ptr[:-1])
           ).to(torch.float32)
    return torch.clamp(deg, min=1.0)


class _Aggregate(torch.autograd.Function):
    """The mean aggregation D⁻¹(A_in + A_out) x and its transpose
    (A_in + A_out) D⁻¹ g: A_inᵀ = A_out, so the backward is the same two
    K1 passes over g / deg."""

    @staticmethod
    def forward(ctx, feats, graph):
        deg = _degrees(graph)
        ctx.graph = graph
        ctx.save_for_backward(deg)
        return _undirected_sum(feats, graph) / deg[:, None]

    @staticmethod
    def backward(ctx, grad):
        deg, = ctx.saved_tensors
        return _undirected_sum(grad / deg[:, None], ctx.graph), None


def _mean_aggregate(feats, graph: DeviceGraph):
    """(n_pad, d) mean of each node's in- and out-neighbors' rows of
    ``feats`` (n_pad, d), on the graph's device (``feats`` lies there
    too); rows with no neighbor are 0.  Differentiable in ``feats``."""
    return _Aggregate.apply(feats, graph)


class SAGE(nn.Module):
    """GraphSAGE with one (W_self, W_neigh, b) a layer: layer k maps
    h (n_pad, d_k) to bf16(h @ W_self + agg(h) @ W_neigh) + b, ReLU
    between layers.  The parameters take no gradient (serving); the
    trainers turn it on with ``requires_grad_`` for their epochs."""

    def __init__(self, layers):
        super().__init__()
        self.w_self = nn.ParameterList()
        self.w_neigh = nn.ParameterList()
        self.b = nn.ParameterList()
        for w_self, w_neigh, b in layers:
            self.w_self.append(nn.Parameter(w_self, requires_grad=False))
            self.w_neigh.append(nn.Parameter(w_neigh, requires_grad=False))
            self.b.append(nn.Parameter(b, requires_grad=False))

    @property
    def dims(self) -> list:
        """[in, hidden..., out]: the width of each layer's input, then
        the output's."""
        return [w.shape[0] for w in self.w_self] + [self.w_self[-1].shape[1]]

    def forward(self, feats, graph: DeviceGraph):
        """(n_pad, out) embeddings of ``feats`` (n_pad, in) over
        ``graph``, both on one device."""
        exact_f32_matmuls()
        h = feats
        n = len(self.w_self)
        for k in range(n):
            agg = _mean_aggregate(h, graph)
            h = (_bf16_product(h, self.w_self[k])
                 + _bf16_product(agg, self.w_neigh[k])).float() + self.b[k]
            if k < n - 1:
                h = torch.relu(h)
        return h


def init_sage_params(in_dim: int, hidden_dim: int, out_dim: int,
                     n_layers: int = 2, generator=None, device=None) -> SAGE:
    """A SAGE model, Glorot normal weights (std sqrt(2 / (fan_in +
    fan_out))) drawn on the CPU from ``generator`` (a torch.Generator;
    None: torch's default), zero biases, placed on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [out_dim]
    layers = []
    for k in range(n_layers):
        scale = float(np.sqrt(2.0 / (dims[k] + dims[k + 1])))
        w_self = torch.randn(dims[k], dims[k + 1], generator=generator)
        w_neigh = torch.randn(dims[k], dims[k + 1], generator=generator)
        layers.append((w_self * scale, w_neigh * scale,
                       torch.zeros(dims[k + 1])))
    return SAGE(layers).to(dev)


def sage_params_from_jax(params, device=None) -> SAGE:
    """The SAGE model of the reference's parameters ``[(W_self, W_neigh,
    b)]`` (any arrays numpy can read), on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    return SAGE([tuple(torch.from_numpy(np.array(a, dtype=np.float32))
                       for a in layer) for layer in params]).to(dev)


def sage_forward(model: SAGE, feats, graph: DeviceGraph, device=None):
    """The model's embeddings of ``feats`` over ``graph`` on ``device``
    (explicit, else the graph's, else the card); the model is moved
    there too."""
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    return model.to(dev)(feats, g)


def _edge_scores(emb, src, dst):
    """Σ emb[src] · emb[dst] over the embedding lanes, a pair a row."""
    return torch.sum(emb[src] * emb[dst], dim=-1)


def degree_features(graph: DeviceGraph, dim: int = 16, device=None):
    """The default node features (n_pad, dim) f32 when no property is
    given: log1p of the total degree, then sin / cos positional bins of
    the node index; computed in numpy as the reference computes them,
    placed on ``device`` (explicit, else the graph's, else the card)."""
    dev = graph_device(graph, device)
    src, dst, _ = graph.host_edges()
    deg = (np.bincount(src, minlength=graph.n_pad)
           + np.bincount(dst, minlength=graph.n_pad)).astype(np.float32)
    feats = np.zeros((graph.n_pad, dim), dtype=np.float32)
    feats[:, 0] = np.log1p(deg)
    idx = np.arange(graph.n_pad, dtype=np.float32)
    for k in range(1, dim):
        if k % 2:
            feats[:, k] = np.sin(idx / (10_000 ** (k / dim)))
        else:
            feats[:, k] = np.cos(idx / (10_000 ** (k / dim)))
    return torch.from_numpy(feats).to(dev)


# ---------------------------------------------------------------------------
# training: row gathers with a deterministic backward, losses, Adam, AUC
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RowRuns:
    """A gather index ``idx`` grouped by the table row each element
    reads: in the stable sort of ``idx``, row j's elements are positions
    [ptr[j], ptr[j+1]), and the e-th sorted element is ``idx[order[e]]``
    (``order`` None: ``idx`` is sorted already).  ``longest``: the
    longest run, where known (K1's launch shape; never its result)."""

    idx: torch.Tensor
    ptr: torch.Tensor
    order: Optional[torch.Tensor]
    longest: Optional[int] = None


def row_runs(idx, n_rows: int) -> RowRuns:
    """The RowRuns of ``idx`` (1-D, values in [0, n_rows)) into a table
    of ``n_rows`` rows: a stable sort on idx's device."""
    keys, order = torch.sort(idx, stable=True)
    return RowRuns(idx, SC.segment_runs(keys, n_rows), order)


def edge_runs(graph: DeviceGraph):
    """(by src, by dst): the RowRuns of the true edges' endpoints in CSC
    order, which are the link trainer's positive pairs.  By dst they are
    sorted (the CSC runs); by src the stable sort is the CSR order, whose
    runs are ``row_ptr``.  Made once a graph."""
    held = getattr(graph, "_sage_edge_runs", None)
    if held is None:
        m = graph.n_edges
        src = graph.csc_src[:m]
        held = (RowRuns(src, graph.row_ptr,
                        torch.sort(src, stable=True).indices,
                        graph.longest_csr_run),
                RowRuns(graph.csc_dst[:m], graph.csc_runs(), None,
                        graph.longest_csc_run))
        # DeviceGraph is frozen; bypass its setattr guard
        object.__setattr__(graph, "_sage_edge_runs", held)
    return held


class _GatherRows(torch.autograd.Function):
    """table[idx]; the backward sums each table row's gradient rows in
    position order by one K1 launch (gathered by ``order``, ⊗ = first)."""

    @staticmethod
    def forward(ctx, table, runs):
        ctx.runs = runs
        return table[runs.idx]

    @staticmethod
    def backward(ctx, grad):
        runs = ctx.runs
        return SC.csr_spmm_sum(grad.contiguous(), runs.ptr, runs.order,
                               mul="first", longest=runs.longest), None


def gather_rows(table, runs: RowRuns):
    """``table[runs.idx]``, differentiable in ``table`` with a
    deterministic backward."""
    return _GatherRows.apply(table, runs)


def _pair_scores(emb, pairs):
    src, dst = pairs
    return torch.sum(gather_rows(emb, src) * gather_rows(emb, dst), dim=-1)


def link_loss(model: SAGE, feats, graph: DeviceGraph, pos, neg):
    """The reference's ``_link_loss``: optax's sigmoid binary
    cross-entropy of the positive pairs' scores (label 1) then the
    negative pairs' (label 0), averaged.  ``pos`` / ``neg``: (src, dst)
    RowRuns."""
    emb = model(feats, graph)
    pos_s, neg_s = _pair_scores(emb, pos), _pair_scores(emb, neg)
    scores = torch.cat([pos_s, neg_s])
    labels = torch.cat([torch.ones_like(pos_s), torch.zeros_like(neg_s)])
    return (-labels * F.logsigmoid(scores)
            - (1.0 - labels) * F.logsigmoid(-scores)).mean()


def classify_loss(model: SAGE, feats, graph: DeviceGraph, label_runs,
                  labels):
    """The reference's ``_classify_loss``: softmax cross-entropy of
    ``logits[label_idx]`` with the integer ``labels``, averaged (the
    label's log-probability picked by a one-hot product: no scatter in
    the backward)."""
    logits = gather_rows(model(feats, graph), label_runs)
    logp = F.log_softmax(logits, dim=-1)
    picked = F.one_hot(labels, logits.shape[1]).to(logp.dtype)
    return -(logp * picked).sum(dim=-1).mean()


def adam(params, lr: float):
    """optax.adam(lr) over the tensors ``params``, each dense and whole:
    b1 0.9, b2 0.999, eps 1e-8 (outside the square root; optax's eps_root
    is 0)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _auc(pos, neg) -> float:
    """The reference's rank AUC (Mann-Whitney U over n_pos · n_neg, the
    reference's n² with as many negatives as positives), ties averaged:
    a tie group at sorted positions [start, end) ranks (start + 1 + end)
    / 2.  Vectorized on the scores' device; the ranks are halves of
    integers, so their float64 sum is exact in any order."""
    n, n_neg = pos.numel(), neg.numel()
    if n == 0 or n_neg == 0:
        return 0.0
    _, inverse, counts = torch.unique(torch.cat([pos, neg]), sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
    ends = torch.cumsum(counts, 0).double()
    ranks = (2.0 * ends - counts.double() + 1.0) / 2.0
    u = ranks[inverse[:n]].sum() - n * (n + 1) / 2.0
    return float(u / (n * n_neg))


def _initial_model(params, dims, generator, dev) -> SAGE:
    """The trainer's starting model on ``dev``: a copy of ``params`` (a
    SAGE or the reference's ``[(W_self, W_neigh, b)]``), else Glorot
    weights from ``generator``."""
    if params is None:
        return init_sage_params(dims[0], dims[1], dims[2], dims[3],
                                generator=generator, device=dev)
    if isinstance(params, SAGE):
        return copy.deepcopy(params).to(dev)
    return sage_params_from_jax(params, dev)


def _index(a, dev):
    """An int64 index tensor of ``a`` (a tensor or any array) on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.int64))
    return a.to(dev, torch.int64)


def _fit(model: SAGE, lr: float, epochs: int, loss_of):
    """``epochs`` Adam steps on ``loss_of(epoch)``; the history."""
    model.requires_grad_(True)
    opt = adam(model.parameters(), lr)
    history = []
    try:
        for epoch in range(epochs):
            opt.zero_grad(set_to_none=True)
            loss = loss_of(epoch)
            loss.backward()
            opt.step()
            history.append({"epoch": epoch + 1,
                            "loss": float(loss.detach())})
    finally:
        model.requires_grad_(False)
    return history


def train_link_prediction(graph: DeviceGraph, feats=None, hidden_dim=64,
                          out_dim=32, n_layers=2, epochs=50, lr=1e-2,
                          neg_ratio=1, seed=0, *, device=None, params=None,
                          negatives=None):
    """(model, feats, [per-epoch {epoch, loss}, ``auc`` on the last]).

    Positives are the graph's edges (in CSC order); negatives are
    ``m · neg_ratio`` uniform pairs in [0, n_nodes) drawn anew each epoch,
    and the AUC's m pairs after the last epoch, from a generator seeded
    with ``seed`` on the graph's device.  ``params``: the starting
    parameters (a SAGE or the reference's list; default Glorot from a CPU
    generator seeded with ``seed``).  ``negatives``: (src, dst) index
    pairs to use instead of the draws, one an epoch and then the AUC's.
    Runs on ``device`` (explicit, else the graph's, else the card)."""
    if epochs <= 0:
        raise ValueError("epochs must be a positive integer")
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    feats = degree_features(g) if feats is None \
        else torch.as_tensor(feats, dtype=torch.float32).to(dev)
    model = _initial_model(
        params, (feats.shape[1], hidden_dim, out_dim, n_layers),
        torch.Generator().manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = g.n_edges
    pos = edge_runs(g)

    def pairs(epoch, count):
        if negatives is not None:
            return tuple(_index(a, dev) for a in negatives[epoch])
        return tuple(torch.randint(0, g.n_nodes, (count,), generator=gen,
                                   device=dev, dtype=torch.int32)
                     for _ in range(2))

    def loss_of(epoch):
        neg = tuple(row_runs(i, g.n_pad) for i in pairs(epoch,
                                                        m * neg_ratio))
        return link_loss(model, feats, g, pos, neg)

    history = _fit(model, lr, epochs, loss_of)
    with torch.no_grad():
        emb = model(feats, g)
        neg_src, neg_dst = pairs(epochs, m)
        history[-1]["auc"] = _auc(_edge_scores(emb, pos[0].idx, pos[1].idx),
                                  _edge_scores(emb, neg_src, neg_dst))
    return model, feats, history


def train_node_classification(graph: DeviceGraph, label_idx, labels,
                              feats=None, hidden_dim=64, n_layers=2,
                              epochs=100, lr=1e-2, seed=0, *, device=None,
                              params=None):
    """(model, feats, n_classes, [per-epoch {epoch, loss}, ``acc`` on the
    last]): full-batch training on the rows ``label_idx`` with integer
    ``labels``; n_classes = max(labels) + 1.  ``params`` and the device as
    for ``train_link_prediction``."""
    if epochs <= 0:
        raise ValueError("epochs must be a positive integer")
    dev = graph_device(graph, device)
    g = on_device(graph, dev)
    feats = degree_features(g) if feats is None \
        else torch.as_tensor(feats, dtype=torch.float32).to(dev)
    label_idx, labels = _index(label_idx, dev), _index(labels, dev)
    n_classes = int(labels.max()) + 1
    model = _initial_model(
        params, (feats.shape[1], hidden_dim, n_classes, n_layers),
        torch.Generator().manual_seed(seed), dev)
    runs = row_runs(label_idx, g.n_pad)
    history = _fit(model, lr, epochs, lambda _: classify_loss(
        model, feats, g, runs, labels))
    with torch.no_grad():
        pred = torch.argmax(model(feats, g)[label_idx], dim=-1)
        history[-1]["acc"] = float((pred == labels).double().mean())
    return model, feats, n_classes, history
