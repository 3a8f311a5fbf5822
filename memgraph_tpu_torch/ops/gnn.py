"""GraphSAGE inference in PyTorch: the forward half of the GNN behind the
link-prediction and node-classification procedures.

Port of memgraph_tpu/ops/gnn.py (``init_sage_params``,
``_mean_aggregate``, ``sage_forward``, ``_edge_scores``,
``degree_features``).  The undirected mean aggregation is two run sums of
the deterministic kernel ``csr_spmm_sum`` (ops/segment_cuda.py, K1,
gathered, ⊗ = first, a lane a feature): the in-neighbors' rows over the
CSC runs (``csc_src`` gathered) and the out-neighbors' rows over the CSR
runs (``col_idx`` gathered).  The reference sums the second direction by
an unsorted segment sum keyed by ``csc_src``; within a source its CSC
edges come in ascending dst, which is the CSR run's order, so each row
adds the same values in the same order from 0.0.  Degrees are the run
lengths (exact in f32).  Only the sink row (index ``n_nodes``) differs
from the reference's: the padding edges are left out of the runs
(``csc_runs()``), and no real node reads the sink.

The feature transforms keep the reference's roundings: h and the
aggregate rounded to bfloat16, each product accumulated in f32 and
rounded to bfloat16 (XLA's bf16 dot), their sum rounded to bfloat16,
then f32 plus the bias; ReLU between layers.  Training (the losses,
Adam, the AUC) is not here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import exact_f32_matmuls, resolve_device
from . import segment_cuda as SC
from .csr import DeviceGraph
from .pagerank import graph_device, on_device


def _bf16_product(a, w):
    """a.bf16 @ w.bf16 as XLA's bf16 dot: f32 accumulation of the rounded
    operands, the result rounded to bfloat16."""
    return (a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
            ).to(torch.bfloat16)


def _mean_aggregate(feats, graph: DeviceGraph):
    """(n_pad, d) mean of each node's in- and out-neighbors' rows of
    ``feats`` (n_pad, d), on the graph's device (``feats`` lies there
    too); rows with no neighbor are 0."""
    csc = graph.csc_runs()
    summed = SC.csr_spmm_sum(feats, csc, graph.csc_src, mul="first",
                             longest=graph.longest_csc_run)
    summed = summed + SC.csr_spmm_sum(feats, graph.row_ptr, graph.col_idx,
                                      mul="first",
                                      longest=graph.longest_csr_run)
    deg = ((csc[1:] - csc[:-1]) + (graph.row_ptr[1:] - graph.row_ptr[:-1])
           ).to(torch.float32)
    return summed / torch.clamp(deg, min=1.0)[:, None]


class SAGE(nn.Module):
    """GraphSAGE with one (W_self, W_neigh, b) a layer: layer k maps
    h (n_pad, d_k) to bf16(h @ W_self + agg(h) @ W_neigh) + b, ReLU
    between layers."""

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
