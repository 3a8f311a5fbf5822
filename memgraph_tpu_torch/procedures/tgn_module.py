"""Host results of the temporal graph network procedures (``tgn.*``).

Port of memgraph_tpu/procedures/tgn_module.py: per-node MEMORY updated by
the reference's own GRU form on each streamed edge batch, a sinusoidal
encoding of the time since a source was last seen, and an MLP link
scorer over ``[m_s, m_d, m_s*m_d, f_s*f_d, te]`` (memories, the fixed
initial memories as node features, the time encoding), trained online
with negative sampling.  The state (weights, Adam moments, memory,
``last_seen``) lives on the device the first call names (default: the
card); the functions take the procedures' arguments with their defaults
and return host columns by gid, in the style of ``node2vec_module``.

The GRU has no bias: z = σ([x, m] W_z), r = σ([x, m] W_r), h = tanh([x,
r*m] W_h), m' = (1-z) m + z h, with x = [m_other, te]; it is not
``torch.nn.GRUCell``.  The destination of each event is updated from its
source, then the source from the (updated) destination, with the weights
after the batch's Adam step.  Gradients go to the weights only.  The
dense products run at full f32 (``device.exact_f32_matmuls``): the JAX
package runs them outside any Pallas kernel, so they stay
``torch.matmul``.

Copied from the reference exactly: the defaults, the initial memory rows
(numpy, seed 0; rows added when the gid table outgrows the memory are
drawn with the old capacity as their seed, the capacity doubling), the
negatives (``default_rng(step)`` over the rows seen so far), the edge
order of ``train_and_eval`` (a stable sort by timestamp, a non-numeric
timestamp counting as 0) and the memory reset at each epoch.  Adam is
ops/gnn.py's ``adam`` (optax's b1, b2 and eps).

Repeated rows: the reference's ``mem.at[rows].set`` leaves unsaid which
update a row keeps when it appears twice in a batch, and CUDA's
``index_put_`` with repeated indices is nondeterministic.  The port's
rule: the last occurrence in batch order wins (for ``last_seen`` too,
the sources written before the destinations); only each row's last
occurrence is written, so two runs give the same bits.

The initial weights come from a ``torch.Generator`` seeded with
``seed`` on the CPU (the reference draws them from ``jax.random``, whose
stream the port cannot draw); ``tgn_weights_from_jax`` carries the
reference's weights across instead.  ``get`` returns every tracked gid
(the reference drops the gids whose vertex is gone from its view: the
caller, which owns the storage, filters).
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.nn import functional as F

from ..device import exact_f32_matmuls, resolve_device
from ..ops.gnn import adam
from . import ProcedureError

_WEIGHT_NAMES = ("W_z", "W_r", "W_h", "W_p1", "b_p1", "W_p2", "b_p2")


def _defaults() -> dict:
    return {"memory_dim": 32, "time_dim": 8, "learning_rate": 0.01,
            "num_neg_samples": 1, "seed": 7}


def _init_rows(n_rows: int, d: int, seed: int) -> np.ndarray:
    """Fixed pseudorandom initial memory rows (the node features): the
    reference's draw."""
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal((n_rows, d)).astype(np.float32)


def init_weights(memory_dim: int, time_dim: int, seed: int,
                 device=None) -> dict:
    """The model's weights, N(0, 0.01) entries and zero biases, drawn on
    the CPU from a generator seeded with ``seed`` and placed on
    ``device`` (default: the card)."""
    d, t = int(memory_dim), int(time_dim)
    gen = torch.Generator().manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.1

    w = {"W_z": normal(d + t + d, d), "W_r": normal(d + t + d, d),
         "W_h": normal(d + t + d, d), "W_p1": normal(4 * d + t, d),
         "b_p1": torch.zeros(d), "W_p2": normal(d, 1),
         "b_p2": torch.zeros(1)}
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in w.items()}


def tgn_weights_from_jax(weights, device=None) -> dict:
    """The reference's weights (any arrays numpy can read) as the port's,
    f32 on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(weights[k], dtype=np.float32)).to(
        dev) for k in _WEIGHT_NAMES}


def time_encode(delta: torch.Tensor, t_dim: int) -> torch.Tensor:
    """[sin(δ f), cos(δ f)], f_i = e^{-i}: (B, t_dim), in δ's dtype."""
    freqs = torch.exp(-torch.arange(t_dim // 2, dtype=delta.dtype,
                                    device=delta.device))
    ang = delta[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def last_occurrences(rows: np.ndarray) -> np.ndarray:
    """The positions of each distinct row's last occurrence, ascending:
    the writes the repeat rule keeps."""
    rows = np.asarray(rows)
    _, first_of_reversed = np.unique(rows[::-1], return_index=True)
    return np.sort(len(rows) - 1 - first_of_reversed)


class TgnState:
    """The module's state: weights and their Adam, the memory, the fixed
    initial memory (features), ``last_seen``, the gid -> row table, the
    step counter and the losses.  ``dtype``: float32 (the module's), or
    float64 for a reference run of the same arithmetic."""

    def __init__(self, params=None, n_hint: int = 256, device=None,
                 weights=None, dtype=torch.float32):
        p = _defaults()
        p.update(params or {})
        self.params = p
        self.device = resolve_device(device)
        self.dtype = dtype
        d, t = int(p["memory_dim"]), int(p["time_dim"])
        weights = weights if weights is not None else init_weights(
            d, t, int(p["seed"]), self.device)
        # copies: a caller's tensors are never trained in place
        self.weights = {k: w.detach().to(self.device, dtype, copy=True)
                        for k, w in weights.items()}
        for w in self.weights.values():
            w.requires_grad_(True)
        self.optimizer = adam([self.weights[k] for k in _WEIGHT_NAMES],
                              float(p["learning_rate"]))
        init = self._rows(n_hint, seed=0)
        self.memory = init.clone()
        self.init_memory = init
        self.last_seen = torch.zeros(n_hint, device=self.device,
                                     dtype=dtype)
        self.gid_to_row: dict = {}
        self.clock = 0.0
        self.step = 0
        self.train_losses: list = []
        self.eval_scores: list = []

    def _rows(self, n_rows: int, seed: int) -> torch.Tensor:
        return torch.from_numpy(_init_rows(
            n_rows, int(self.params["memory_dim"]), seed)).to(
                self.device, self.dtype)

    @property
    def memory_dim(self) -> int:
        return int(self.memory.shape[1])

    @property
    def time_dim(self) -> int:
        return int(self.weights["W_p1"].shape[0]) - 4 * self.memory_dim

    def rows_for(self, gids) -> np.ndarray:
        """The rows of ``gids`` (new gids take the next rows); the memory
        grows as the reference's does."""
        rows = []
        for g in gids:
            if g not in self.gid_to_row:
                self.gid_to_row[g] = len(self.gid_to_row)
            rows.append(self.gid_to_row[g])
        need, cap = len(self.gid_to_row), int(self.memory.shape[0])
        if need > cap:
            new_cap = max(need, cap * 2)
            grow = self._rows(new_cap - cap, seed=cap)
            self.memory = torch.cat([self.memory, grow])
            self.init_memory = torch.cat([self.init_memory, grow])
            self.last_seen = torch.cat([self.last_seen, torch.zeros(
                new_cap - cap, device=self.device, dtype=self.dtype)])
        return np.asarray(rows, dtype=np.int64)

    def _link_logits(self, s, d_, te):
        w, mem, feats = self.weights, self.memory, self.init_memory
        h = torch.cat([mem[s], mem[d_], mem[s] * mem[d_],
                       feats[s] * feats[d_], te], dim=1)
        h = torch.tanh(h @ w["W_p1"] + w["b_p1"])
        return (h @ w["W_p2"] + w["b_p2"])[:, 0]

    def _gru(self, rows: np.ndarray, other: np.ndarray, te) -> None:
        w, mem = self.weights, self.memory
        r_t = torch.from_numpy(rows).to(self.device)
        o_t = torch.from_numpy(other).to(self.device)
        m = mem[r_t]
        x = torch.cat([mem[o_t], te], dim=1)
        xin = torch.cat([x, m], dim=1)
        z = torch.sigmoid(xin @ w["W_z"])
        r = torch.sigmoid(xin @ w["W_r"])
        h = torch.tanh(torch.cat([x, r * m], dim=1) @ w["W_h"])
        new = (1 - z) * m + z * h
        keep = torch.from_numpy(last_occurrences(rows)).to(self.device)
        self.memory = mem.index_copy(0, r_t[keep], new[keep])

    def batch_step(self, src_r: np.ndarray, dst_r: np.ndarray,
                   ts: np.ndarray, neg_r: np.ndarray,
                   train: bool = True) -> float:
        """One streamed batch: the loss of positive against negative
        links, the weights' Adam step (``train``), then the memory and
        ``last_seen`` updates.  Returns the loss."""
        exact_f32_matmuls()
        dev = self.device
        s = torch.from_numpy(src_r).to(dev)
        d_ = torch.from_numpy(dst_r).to(dev)
        n = torch.from_numpy(neg_r.astype(np.int64)).to(dev)
        ts_t = torch.from_numpy(np.asarray(ts, np.float32)).to(dev,
                                                                self.dtype)
        te = time_encode(ts_t - self.last_seen[s], self.time_dim)

        def loss_fn():
            pos = self._link_logits(s, d_, te)
            neg = self._link_logits(s, n, te)
            return torch.mean(F.softplus(-pos) + F.softplus(neg))

        if train:
            self.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            self.optimizer.step()
        else:
            with torch.no_grad():
                loss = loss_fn()
        with torch.no_grad():
            self._gru(dst_r, src_r, te)
            self._gru(src_r, dst_r, te)
            seen = self.last_seen.clone()
            for rows in (src_r, dst_r):
                keep = last_occurrences(rows)
                seen[torch.from_numpy(rows[keep]).to(dev)] = \
                    ts_t[torch.from_numpy(keep).to(dev)]
            self.last_seen = seen
        return float(loss.detach())

    def ingest(self, edges, train: bool) -> float:
        """edges: (src gid, dst gid, timestamp) triples; fresh negatives
        a batch from ``default_rng(step)``."""
        if not edges:
            return 0.0
        ts = np.asarray([float(e[2]) for e in edges], np.float32)
        src_r = self.rows_for([e[0] for e in edges])
        dst_r = self.rows_for([e[1] for e in edges])
        self.step += 1
        rng = np.random.default_rng(self.step)
        neg_r = rng.integers(0, len(self.gid_to_row),
                             len(src_r)).astype(np.int32)
        loss = self.batch_step(src_r, dst_r, ts, neg_r, train=train)
        self.clock = max(self.clock, float(ts.max()))
        (self.train_losses if train else self.eval_scores).append(loss)
        return loss

    def reset_memory(self) -> None:
        """An epoch's start: the memory back to the features, nothing
        seen."""
        self.memory = self.init_memory.clone()
        self.last_seen = torch.zeros_like(self.last_seen)


_STATE: dict = {}
_LOCK = threading.RLock()


def _state(device=None) -> TgnState:
    st = _STATE.get("tgn")
    if st is None:
        st = _STATE["tgn"] = TgnState({}, device=device)
    return st


def _timestamp(value) -> float:
    """A timestamp property's value: a number, else 0 (the reference's
    ``isinstance(ts, (int, float))`` test)."""
    if isinstance(value, (int, float, np.integer, np.floating)):
        return value
    return 0


def edges_by_time(source, timestamp_property="timestamp") -> list:
    """The source's edges as (src gid, dst gid, timestamp), in a stable
    sort by timestamp of the source's edge order."""
    e_src, e_dst, raw = source.edges(timestamp_property, None)
    if raw is None:
        ts = [0] * len(e_src)
    else:
        ts = [_timestamp(v) for v in (raw.tolist() if isinstance(
            raw, np.ndarray) else raw)]
    out = list(zip(np.asarray(e_src).tolist(), np.asarray(e_dst).tolist(),
                   ts))
    out.sort(key=lambda e: e[2])
    return out


def set_params(params=None, *, device=None, weights=None) -> dict:
    """``tgn.set_params``: a fresh state with ``params`` over the
    defaults, on ``device`` (default: the card); ``weights`` (the port's
    dict, e.g. ``tgn_weights_from_jax``'s) replace the seeded draw."""
    with _LOCK:
        st = _STATE["tgn"] = TgnState(dict(params or {}), device=device,
                                      weights=weights)
        return {"message": np.asarray(
            [f"tgn initialized with {st.params}"], dtype=object)}


def update(edges, *, device=None) -> dict:
    """``tgn.update``: one online training batch on ``edges``, a list of
    (src gid, dst gid, timestamp); a non-numeric timestamp counts as 0.
    Returns ``loss`` (one record)."""
    spec = [(s, d, _timestamp(t)) for s, d, t in (edges or [])]
    with _LOCK:
        loss = _state(device).ingest(spec, train=True)
    return {"loss": np.asarray([loss], dtype=np.float64)}


def train_and_eval(source, num_epochs, timestamp_property="timestamp",
                   train_fraction=0.8, batch_size=64, *,
                   device=None) -> dict:
    """``tgn.train_and_eval``: epochs over the source's edges in timestamp
    order, the first ``train_fraction`` trained on and the rest scored,
    ``batch_size`` edges a batch, the memory reset at each epoch.
    Returns epoch, train_loss, eval_loss (the mean batch losses), one
    record an epoch."""
    edges = edges_by_time(source, timestamp_property)
    if not edges:
        raise ProcedureError("tgn: the graph has no edges to train on")
    cut = max(1, int(len(edges) * float(train_fraction)))
    train_edges, eval_edges = edges[:cut], edges[cut:]
    bs = max(1, int(batch_size))
    rows = {"epoch": [], "train_loss": [], "eval_loss": []}
    with _LOCK:
        st = _state(device)
        for epoch in range(int(num_epochs)):
            st.reset_memory()
            t_losses = [st.ingest(train_edges[i:i + bs], train=True)
                        for i in range(0, len(train_edges), bs)]
            e_losses = [st.ingest(eval_edges[i:i + bs], train=False)
                        for i in range(0, len(eval_edges), bs)]
            rows["epoch"].append(epoch)
            rows["train_loss"].append(
                float(np.mean(t_losses)) if t_losses else 0.0)
            rows["eval_loss"].append(
                float(np.mean(e_losses)) if e_losses else 0.0)
    return {"epoch": np.asarray(rows["epoch"], dtype=np.int64),
            "train_loss": np.asarray(rows["train_loss"], dtype=np.float64),
            "eval_loss": np.asarray(rows["eval_loss"], dtype=np.float64)}


def get(*, device=None) -> dict:
    """``tgn.get``: the memory row of every tracked gid (``node_gids``,
    ``embedding``: (n, memory_dim) float32)."""
    with _LOCK:
        st = _state(device)
        gids = np.asarray(list(st.gid_to_row), dtype=np.int64)
        rows = np.asarray([st.gid_to_row[g] for g in gids.tolist()],
                          dtype=np.int64)
        mem = st.memory.detach().cpu().numpy()
    return {"node_gids": gids,
            "embedding": mem[rows] if len(rows) else
            np.zeros((0, mem.shape[1]), np.float32)}


def predict_link_score(src, dest, *, device=None) -> dict:
    """``tgn.predict_link_score``: σ of the link scorer on (src, dest)
    gids at a zero time delta (``prediction``, one record); unseen gids
    take new rows, as in the reference."""
    with _LOCK:
        st = _state(device)
        exact_f32_matmuls()
        rows = torch.from_numpy(st.rows_for([src, dest])).to(st.device)
        with torch.no_grad():
            te = time_encode(torch.zeros(1, device=st.device), st.time_dim)
            logit = st._link_logits(rows[:1], rows[1:], te)[0]
            p = float(torch.sigmoid(logit))
    return {"prediction": np.asarray([p], dtype=np.float64)}


def reset() -> dict:
    """``tgn.reset``: the state cleared."""
    with _LOCK:
        _STATE.clear()
    return {"message": np.asarray(["tgn state cleared"], dtype=object)}
