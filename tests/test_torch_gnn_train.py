"""The port's GraphSAGE training (memgraph_tpu_torch/ops/gnn.py) against
the JAX package's ``ops/gnn.py`` on the CPU.

Tolerances, and why:
- The aggregation's backward is its transpose: ⟨agg(x), y⟩ = ⟨x, aggᵀ(y)⟩
  within 1e-5 of Σ|agg(x)||y| (two f32 sums of a few thousand products
  each), and ``gradcheck`` in float64 on the plain version.
- One step: the forward rounds h, the aggregate and the weights to
  bfloat16 as the reference does, and may move a rounding by one bf16 ulp
  where the f32 sums under it add in another order (tests/test_torch_gnn.py:
  2^-7 of the largest |h|); the gradients are rounded to bfloat16 where
  JAX's autodiff rounds them (2^-8 relative each, a few chained).  The
  loss is held within 2^-10 relative (measured 4e-5) and each gradient
  tensor within 2^-6 of its largest entry (measured 0.0053, three
  layers).
- Adam against optax.adam on one gradient sequence: 1e-6 relative of the
  largest parameter (the same f32 formula, two rounding orders).
- The AUC: the rank formula's value exactly (ranks are halves of
  integers, summed exactly in float64).
- Teacher-forced training (the reference's own initial parameters and
  negatives fed to the port): the per-epoch differences above carry
  through Adam; the loss history within 2^-7 relative (measured 1.1e-3
  over 20 epochs), the AUC within 0.01 (measured 4e-4), the accuracy
  within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu.ops import gnn as jgnn
from memgraph_tpu_torch.ops import gnn as G
from memgraph_tpu_torch.ops import segment_cuda as SC
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

LOSS_REL = 2.0 ** -10
GRAD_OF_LARGEST = 2.0 ** -6
HISTORY_REL = 2.0 ** -7
AUC_TOL = 0.01
ACC_TOL = 0.05


def _graph(n, e, seed):
    """A skewed digraph with parallel edges and self loops, in both
    packages."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    src = np.concatenate([src, src[:e // 20], np.arange(5)])
    dst = np.concatenate([dst, dst[:e // 20], np.arange(5)])
    jg = jcsr.from_coo(src, dst, None, n_nodes=n).to_device()
    tg = from_coo(src, dst, None, n_nodes=n).to_device("cpu")
    return jg, tg


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --- the aggregation's backward ----------------------------------------------


@pytest.mark.parametrize("width,seed", [(1, 0), (16, 1), (64, 2)])
def test_aggregation_backward_is_its_transpose(width, seed):
    _, tg = _graph(300, 2500, seed)
    rng = np.random.default_rng(seed + 5)
    x = _t(rng.standard_normal((tg.n_pad, width)), torch.float32)
    y = _t(rng.standard_normal((tg.n_pad, width)), torch.float32)
    x.requires_grad_(True)
    agg = G._mean_aggregate(x, tg)
    (agg * y).sum().backward()
    lhs = (agg.detach().double() * y.double()).sum()
    rhs = (x.detach().double() * x.grad.double()).sum()
    scale = (agg.detach().double().abs() * y.double().abs()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * float(scale)
    # the backward is the forward's operator on grad / deg
    deg = G._degrees(tg)
    assert torch.equal(x.grad, G._undirected_sum(y / deg[:, None], tg))


class _Float64Runs:
    """K1's plain version (index_add_ in run order) in the input's own
    dtype: the aggregation's plain route at float64 for gradcheck."""

    def __getattr__(self, name):
        return getattr(SC, name)

    @staticmethod
    def csr_spmm_sum(x, ptr, g=None, w=None, *, mul="times", precision="f32",
                     longest=None):
        lo, hi = int(ptr[0]), int(ptr[-1])
        vals = x[g[lo:hi]] if g is not None else x[lo:hi]
        if mul == "times":
            vals = vals * w[lo:hi].unsqueeze(1)
        ids = torch.repeat_interleave(torch.arange(ptr.numel() - 1),
                                      (ptr[1:] - ptr[:-1]).long())
        return torch.zeros(ptr.numel() - 1, x.shape[1],
                           dtype=x.dtype).index_add_(0, ids, vals)


def test_aggregation_gradcheck_in_float64(monkeypatch):
    _, tg = _graph(40, 160, 3)
    monkeypatch.setattr(G, "SC", _Float64Runs())
    monkeypatch.setattr(G, "_degrees", lambda g: torch.clamp(
        ((g.csc_runs()[1:] - g.csc_runs()[:-1])
         + (g.row_ptr[1:] - g.row_ptr[:-1])).double(), min=1.0))
    x = torch.randn(tg.n_pad, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: G._mean_aggregate(t, tg), (x,))


def test_gather_rows_backward_sums_each_rows_gradients_in_order():
    rng = np.random.default_rng(4)
    table = _t(rng.standard_normal((30, 5)), torch.float32)
    idx = _t(rng.integers(0, 30, 200))
    grad = _t(rng.standard_normal((200, 5)), torch.float32)
    table.requires_grad_(True)
    out = G.gather_rows(table, G.row_runs(idx, 30))
    assert torch.equal(out, table.detach()[idx])
    out.backward(grad)
    want = torch.zeros(30, 5)
    for k in range(200):        # position order, from 0.0
        want[int(idx[k])] += grad[k]
    assert torch.equal(table.grad, want)


def test_edge_runs_are_the_csc_and_csr_runs():
    _, tg = _graph(200, 1500, 5)
    by_src, by_dst = G.edge_runs(tg)
    m = tg.n_edges
    assert by_dst.order is None and torch.equal(by_dst.ptr, tg.csc_runs())
    assert torch.equal(by_src.ptr, tg.row_ptr)
    assert torch.equal(by_src.idx[by_src.order], tg.src_idx[:m])
    assert torch.equal(tg.csc_dst[:m][by_src.order], tg.col_idx[:m])
    assert G.edge_runs(tg) is G.edge_runs(tg)


# --- one step against the reference ------------------------------------------


def _grads_close(jax_grads, model):
    for k, layer in enumerate(jax_grads):
        for want, p in zip(layer, (model.w_self[k], model.w_neigh[k],
                                   model.b[k])):
            want = np.asarray(want)
            got = p.grad.numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() \
                <= GRAD_OF_LARGEST * np.abs(want).max()


@pytest.mark.parametrize("layers,seed", [(1, 0), (2, 1), (3, 2)])
def test_link_loss_and_gradients_against_the_reference(layers, seed):
    jg, tg = _graph(300, 2000, seed)
    feats = jgnn.degree_features(jg)
    params = jgnn.init_sage_params(jax.random.PRNGKey(seed), 16, 64, 32,
                                   layers)
    m = jg.n_edges
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 9))
    neg_src = jax.random.randint(k1, (2 * m,), 0, jg.n_nodes)
    neg_dst = jax.random.randint(k2, (2 * m,), 0, jg.n_nodes)
    want, grads = jax.value_and_grad(jgnn._link_loss)(
        params, feats, jg.csc_src, jg.csc_dst, jg.n_pad, jg.csc_src[:m],
        jg.csc_dst[:m], neg_src, neg_dst)
    model = G.sage_params_from_jax(params, "cpu")
    model.requires_grad_(True)
    neg = tuple(G.row_runs(_t(a, torch.int64), tg.n_pad)
                for a in (neg_src, neg_dst))
    got = G.link_loss(model, _t(feats), tg, G.edge_runs(tg), neg)
    got.backward()
    assert abs(float(got.detach()) - float(want)) \
        <= LOSS_REL * abs(float(want))
    _grads_close(grads, model)


@pytest.mark.parametrize("width,seed", [(16, 0), (8, 3)])
def test_classify_loss_and_gradients_against_the_reference(width, seed):
    jg, tg = _graph(300, 2000, seed)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((jg.n_pad, width)).astype(np.float32)
    label_idx = rng.choice(300, 120, replace=False)
    labels = rng.integers(0, 5, 120)
    params = jgnn.init_sage_params(jax.random.PRNGKey(seed), width, 32, 5, 2)
    want, grads = jax.value_and_grad(jgnn._classify_loss)(
        params, jnp.asarray(feats), jg.csc_src, jg.csc_dst, jg.n_pad,
        jnp.asarray(label_idx, jnp.int32), jnp.asarray(labels, jnp.int32))
    model = G.sage_params_from_jax(params, "cpu")
    model.requires_grad_(True)
    got = G.classify_loss(model, _t(feats), tg,
                          G.row_runs(_t(label_idx), tg.n_pad), _t(labels))
    got.backward()
    assert abs(float(got.detach()) - float(want)) \
        <= LOSS_REL * abs(float(want))
    _grads_close(grads, model)


def test_adam_against_optax_over_five_steps():
    rng = np.random.default_rng(6)
    layers = [[rng.standard_normal(s).astype(np.float32)
               for s in ((6, 4), (6, 4), (4,))]]
    grads = [[[rng.standard_normal(a.shape).astype(np.float32) * 10 ** -k
               for a in layers[0]]] for k in range(5)]
    opt = optax.adam(0.01)
    params = [[jnp.asarray(a) for a in layers[0]]]
    state = opt.init(params)
    model = G.sage_params_from_jax(layers, "cpu")
    model.requires_grad_(True)
    torch_opt = G.adam(model.parameters(), 0.01)
    for step in grads:
        updates, state = opt.update([[jnp.asarray(a) for a in step[0]]],
                                    state)
        params = optax.apply_updates(params, updates)
        for p, g in zip((model.w_self[0], model.w_neigh[0], model.b[0]),
                        step[0]):
            p.grad = torch.from_numpy(g)
        torch_opt.step()
    for p, want in zip((model.w_self[0], model.w_neigh[0], model.b[0]),
                       params[0]):
        want = np.asarray(want)
        assert np.abs(p.detach().numpy() - want).max() \
            <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_is_the_references_rank_formula(seed):
    """Integer embeddings give many tied scores, across positives and
    negatives; the negatives are the reference's own draws."""
    rng = np.random.default_rng(seed)
    n = 60
    emb = rng.integers(-1, 2, (n, 3)).astype(np.float32)
    pos_src, pos_dst = rng.integers(0, n, 500), rng.integers(0, n, 500)
    key = jax.random.PRNGKey(seed)
    want = jgnn._auc(jnp.asarray(emb), pos_src, pos_dst, n, key)
    k1, k2 = jax.random.split(key)
    neg_src = np.asarray(jax.random.randint(k1, (500,), 0, n))
    neg_dst = np.asarray(jax.random.randint(k2, (500,), 0, n))
    e = torch.from_numpy(emb)
    got = G._auc(G._edge_scores(e, _t(pos_src), _t(pos_dst)),
                 G._edge_scores(e, _t(neg_src), _t(neg_dst)))
    assert got == want
    assert G._auc(torch.zeros(0), torch.zeros(0)) == 0.0


# --- whole trainers ----------------------------------------------------------


def _reference_draws(jg, seed, epochs, in_dim, hidden, out, layers,
                     neg_ratio=1):
    """The reference trainer's initial parameters and negatives, by its
    own jax.random splits (memgraph_tpu/ops/gnn.py train_link_prediction
    and _auc)."""
    rng = jax.random.PRNGKey(seed)
    rng, init_rng = jax.random.split(rng)
    params = jgnn.init_sage_params(init_rng, in_dim, hidden, out, layers)
    m, negatives = jg.n_edges, []
    for _ in range(epochs):
        rng, k1, k2 = jax.random.split(rng, 3)
        negatives.append(tuple(np.asarray(jax.random.randint(
            k, (m * neg_ratio,), 0, jg.n_nodes)) for k in (k1, k2)))
    k1, k2 = jax.random.split(rng)
    negatives.append(tuple(np.asarray(jax.random.randint(
        k, (m,), 0, jg.n_nodes)) for k in (k1, k2)))
    return params, negatives


def _histories_close(want, got):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for a, b in zip(want, got):
        assert abs(a["loss"] - b["loss"]) <= HISTORY_REL * abs(a["loss"])


@pytest.mark.parametrize("layers,neg_ratio", [(2, 1), (3, 2)])
def test_teacher_forced_link_prediction(layers, neg_ratio):
    jg, tg = _graph(400, 3000, 7)
    epochs, seed = 15, 3
    _, _, want = jgnn.train_link_prediction(
        jg, hidden_dim=16, out_dim=8, n_layers=layers, epochs=epochs,
        seed=seed, neg_ratio=neg_ratio)
    params, negatives = _reference_draws(jg, seed, epochs, 16, 16, 8,
                                         layers, neg_ratio)
    model, feats, got = G.train_link_prediction(
        tg, hidden_dim=16, out_dim=8, n_layers=layers, epochs=epochs,
        seed=seed, neg_ratio=neg_ratio, device="cpu", params=params,
        negatives=negatives)
    _histories_close(want, got)
    assert set(got[-1]) == {"epoch", "loss", "auc"}
    assert set(got[0]) == {"epoch", "loss"}
    assert abs(got[-1]["auc"] - want[-1]["auc"]) <= AUC_TOL
    assert not any(p.requires_grad for p in model.parameters())
    assert feats.shape == (tg.n_pad, 16)


def test_node_classification_from_the_same_parameters():
    jg, tg = _graph(400, 3000, 8)
    n, seed, epochs = 400, 2, 20
    idx = np.arange(0, n, 2)
    labels = (np.arange(n) % 3)[idx]
    _, _, n_classes, want = jgnn.train_node_classification(
        jg, idx, labels, hidden_dim=16, n_layers=2, epochs=epochs, seed=seed)
    init = jgnn.init_sage_params(jax.random.split(jax.random.PRNGKey(seed))[1],
                                 16, 16, 3, 2)
    model, _, got_classes, got = G.train_node_classification(
        tg, idx, labels, hidden_dim=16, n_layers=2, epochs=epochs,
        seed=seed, device="cpu", params=init)
    assert got_classes == n_classes == 3 and model.dims[-1] == 3
    _histories_close(want, got)
    assert abs(got[-1]["acc"] - want[-1]["acc"]) <= ACC_TOL


def test_trainers_are_reproducible_from_a_seed_and_learn():
    _, tg = _graph(300, 2500, 9)
    runs = [G.train_link_prediction(tg, hidden_dim=16, out_dim=8,
                                    epochs=12, seed=4, device="cpu")
            for _ in range(2)]
    (m1, _, h1), (m2, _, h2) = runs
    assert h1 == h2
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                 m2.parameters()))
    assert h1[-1]["loss"] < h1[0]["loss"] and h1[-1]["auc"] > 0.5
    other = G.train_link_prediction(tg, hidden_dim=16, out_dim=8, epochs=12,
                                    seed=5, device="cpu")[2]
    assert other != h1


class _CountingRuns:
    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        return getattr(SC, name)

    def csr_spmm_sum(self, *a, **kw):
        self.calls += 1
        return SC.csr_spmm_sum(*a, **kw)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_k1_calls_are_what_the_epochs_imply(monkeypatch, layers):
    """Two a layer a forward, two an aggregation whose input needs a
    gradient (every layer's but the first), one a gathered index set: the
    link trainer's four (both ends of the edges and of the negatives),
    the classifier's one (the label rows); the evaluation's forward."""
    _, tg = _graph(200, 1500, 10)
    epochs = 3
    counter = _CountingRuns()
    monkeypatch.setattr(G, "SC", counter)
    G.train_link_prediction(tg, hidden_dim=8, out_dim=8, n_layers=layers,
                            epochs=epochs, device="cpu")
    per_epoch = 2 * layers + 2 * (layers - 1)
    assert counter.calls == epochs * (per_epoch + 4) + 2 * layers
    counter.calls = 0
    G.train_node_classification(tg, np.arange(0, 200, 3),
                                np.arange(0, 200, 3) % 4, hidden_dim=8,
                                n_layers=layers, epochs=epochs, device="cpu")
    assert counter.calls == epochs * (per_epoch + 1) + 2 * layers


def test_epochs_must_be_positive():
    _, tg = _graph(50, 200, 11)
    with pytest.raises(ValueError, match="positive"):
        G.train_link_prediction(tg, epochs=0, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        G.train_node_classification(tg, [0], [1], epochs=0, device="cpu")
