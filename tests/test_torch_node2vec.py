"""The port's node2vec trainer (memgraph_tpu_torch/models/node2vec.py)
against the JAX package's ``models/node2vec.py`` on the CPU.

``sgns_loss`` and its gradients are held within 1e-6 relative of the
reference's on the same tables and batch (f32 sums of D products in
another order; measured 1e-7), one ``train_step`` within 1e-6 of the
largest table entry (Adam's update is lr-sized, 1e-2).  ``fit``: each
package trains with its own generator on a two-community graph and both
must place nodes of one community nearer (mean cosine) than nodes of
different ones; the port's fit is the same bits twice from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from memgraph_tpu.models import node2vec as jn2v
from memgraph_tpu.ops import csr as jcsr
from memgraph_tpu_torch.models import node2vec as N
from memgraph_tpu_torch.ops import gnn as G
from memgraph_tpu_torch.ops import segment_cuda as SC
from memgraph_tpu_torch.ops.csr import from_coo

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REL = 1e-6


def _batch(seed, n=60, B=96, K=5):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-1, n, B).astype(np.int32)
    contexts = rng.integers(-1, n, B).astype(np.int32)
    centers[:10] = 3                     # a row gathered many times
    negatives = rng.integers(0, n, (B, K)).astype(np.int32)
    return centers, contexts, negatives


def _torch_tables(params):
    tables = N.node2vec_params_from_jax(params, "cpu")
    for t in tables.values():
        t.requires_grad_(True)
    return tables


@pytest.mark.parametrize("seed,dim", [(0, 16), (1, 128), (2, 7)])
def test_sgns_loss_and_gradients_against_the_reference(seed, dim):
    params = jn2v.init_params(64, dim, jax.random.PRNGKey(seed))
    c, t, neg = _batch(seed)
    want, grads = jax.value_and_grad(jn2v.sgns_loss)(
        params, jnp.asarray(c), jnp.asarray(t), jnp.asarray(neg))
    tables = _torch_tables(params)
    got = N.sgns_loss(tables, torch.from_numpy(c), torch.from_numpy(t),
                      torch.from_numpy(neg))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= REL * abs(float(want))
    for k in ("in", "out"):
        w = np.asarray(grads[k])
        assert np.abs(tables[k].grad.numpy() - w).max() \
            <= REL * np.abs(w).max()


def test_fully_masked_batch_has_zero_loss():
    params = jn2v.init_params(16, 8, jax.random.PRNGKey(0))
    tables = _torch_tables(params)
    c = torch.full((12,), -1, dtype=torch.int32)
    loss = N.sgns_loss(tables, c, c, torch.zeros(12, 5, dtype=torch.int32))
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert not tables["in"].grad.any() and not tables["out"].grad.any()


def test_train_steps_against_the_reference_and_adam_is_dense():
    params = jn2v.init_params(64, 16, jax.random.PRNGKey(4))
    opt = optax.adam(0.01)
    state = opt.init(params)
    tables = _torch_tables(params)
    torch_opt = G.adam(list(tables.values()), 0.01)
    batches = [_batch(5), _batch(6, n=30)]   # the second misses rows 30..
    for c, t, neg in batches:
        params, state, want = jn2v.train_step(
            params, state, jnp.asarray(c), jnp.asarray(t), jnp.asarray(neg),
            opt)
        before = {k: v.detach().clone() for k, v in tables.items()}
        got = N.train_step(tables, torch_opt, torch.from_numpy(c),
                           torch.from_numpy(t), torch.from_numpy(neg))
        assert abs(float(got) - float(want)) <= REL * abs(float(want))
        for k in ("in", "out"):
            w = np.asarray(params[k])
            assert np.abs(tables[k].detach().numpy() - w).max() \
                <= REL * np.abs(w).max()
    # rows the second batch did not touch still moved (dense Adam)
    untouched = torch.arange(30, 60)
    first = set(np.concatenate([batches[0][0], batches[0][1]]).tolist())
    moved = [r for r in untouched.tolist() if r in first]
    assert moved and not torch.equal(tables["in"].detach()[moved],
                                     before["in"][moved])


def test_init_params_and_the_carried_tables():
    gen = torch.Generator().manual_seed(0)
    tables = N.init_params(4096, 64, gen)
    for t in tables.values():
        assert t.shape == (4096, 64) and t.dtype == torch.float32
        assert abs(float(t.std()) * 8.0 - 1.0) < 0.02
    assert not torch.equal(tables["in"], tables["out"])
    ref = jn2v.init_params(8, 4, jax.random.PRNGKey(1))
    carried = N.node2vec_params_from_jax(ref, "cpu")
    assert np.array_equal(carried["in"].numpy(), np.asarray(ref["in"]))
    assert N.Node2VecConfig() == N.Node2VecConfig(
        **vars(jn2v.Node2VecConfig()))


def _communities(seed=0, per=30):
    """Two communities of ``per`` nodes, dense inside (0.3), one bridge
    edge a direction between them."""
    rng = np.random.default_rng(seed)
    n = 2 * per
    block = np.repeat([0, 1], per)
    linked = (rng.random((n, n)) < 0.3) & (block[:, None] == block[None, :])
    np.fill_diagonal(linked, False)
    src, dst = np.nonzero(linked)
    src = np.concatenate([src, [0, per]])
    dst = np.concatenate([dst, [per, 0]])
    return src, dst, n, block


def _separation(emb, block):
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    cos = e @ e.T
    same = block[:, None] == block[None, :]
    np.fill_diagonal(same, False)
    other = block[:, None] != block[None, :]
    return cos[same].mean(), cos[other].mean()


CONFIG = dict(embedding_dim=16, walk_length=10, walks_per_node=4, window=3,
              negatives=3, epochs=3, batch_size=256, learning_rate=0.05)


def test_fit_separates_two_communities_in_both_packages():
    src, dst, n, block = _communities()
    jg = jcsr.from_coo(src, dst, n_nodes=n).to_device()
    want = jn2v.Node2Vec(jn2v.Node2VecConfig(**CONFIG)).fit(jg)
    tg = from_coo(src, dst, n_nodes=n)
    model = N.Node2Vec(N.Node2VecConfig(**CONFIG))
    got = model.fit(tg, device="cpu")
    assert got.shape == (n, 16) and got.dtype == torch.float32
    assert len(model.epoch_losses) == 3
    for emb in (np.asarray(want), got.numpy()):
        inside, across = _separation(emb, block)
        assert inside > across + 0.2
    again = N.Node2Vec(N.Node2VecConfig(**CONFIG)).fit(tg, device="cpu")
    assert torch.equal(got, again)
    other = N.Node2Vec(N.Node2VecConfig(**CONFIG, seed=1)).fit(
        tg, device="cpu")
    assert not torch.equal(got, other)


def test_a_batch_launches_three_k1_sums(monkeypatch):
    """One K1 launch a gathered index set: the centers, the contexts and
    the negatives."""
    calls = []

    class Counting:
        def __getattr__(self, name):
            return getattr(SC, name)

        @staticmethod
        def csr_spmm_sum(*a, **kw):
            calls.append(kw)
            return SC.csr_spmm_sum(*a, **kw)

    monkeypatch.setattr(G, "SC", Counting())
    tables = _torch_tables(jn2v.init_params(64, 8, jax.random.PRNGKey(0)))
    c, t, neg = _batch(9)
    N.train_step(tables, G.adam(list(tables.values()), 0.01),
                 torch.from_numpy(c), torch.from_numpy(t),
                 torch.from_numpy(neg))
    assert len(calls) == 3 and all(k["mul"] == "first" for k in calls)
    src, dst, n, _ = _communities(per=10)
    cfg = N.Node2VecConfig(**{**CONFIG, "epochs": 1})
    calls.clear()
    N.Node2Vec(cfg).fit(from_coo(src, dst, n_nodes=n), device="cpu")
    pairs = 2 * cfg.window * n * cfg.walks_per_node * (cfg.walk_length + 1)
    assert len(calls) == 3 * max(pairs // cfg.batch_size, 1)


def _jax_sharded_steps(params, batches, lr=0.01):
    """The reference's ``build_sharded_train_step`` on 4 x 2 of the host
    devices, as ``__graft_entry__.dryrun_multichip`` drives it: (tables
    after each step, losses)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    optimizer = optax.adam(lr)
    step, param_sharding, batch_sharding = jn2v.build_sharded_train_step(
        mesh, optimizer)
    params = jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                          {"in": param_sharding["in"],
                           "out": param_sharding["out"]})
    state = optimizer.init(params)
    out = []
    for c, t, neg in batches:
        params, state, loss = step(
            params, state, jax.device_put(c, batch_sharding),
            jax.device_put(t, batch_sharding),
            jax.device_put(neg, NamedSharding(mesh, P("data", None))))
        out.append(({k: np.asarray(v) for k, v in params.items()},
                    float(loss)))
    return out


def _port_sharded_steps(params, batches, mesh, lr=0.01):
    step, layout, _ = N.build_sharded_train_step(
        mesh, lambda ts: G.adam(ts, lr))
    tables = N.node2vec_params_from_jax(params, "cpu")
    placed = {k: layout[k].place(tables[k]) for k in ("in", "out")}
    state = step.init(placed)
    out = []
    for c, t, neg in batches:
        placed, state, loss = step(placed, state, torch.from_numpy(c),
                                   torch.from_numpy(t),
                                   torch.from_numpy(neg))
        out.append(({k: layout[k].gather(placed[k]) for k in placed},
                    loss))
    return out


@pytest.fixture(scope="module")
def sharded_runs():
    """Two steps of the 4 x 2 sharded step in both packages, and of the
    port's single-card step, from the reference's tables."""
    assert len(jax.devices()) >= 8
    params = jn2v.init_params(64, 16, jax.random.PRNGKey(7))
    batches = [_batch(11, B=64), _batch(12, n=30, B=64)]
    mesh = N.M.make_mesh_2d(4, 2, devices=("cpu",) * 8)
    tables = _torch_tables(params)
    opt = G.adam(list(tables.values()), 0.01)
    single = []
    for c, t, neg in batches:
        loss = N.train_step(tables, opt, torch.from_numpy(c),
                            torch.from_numpy(t), torch.from_numpy(neg))
        single.append(({k: v.detach().clone() for k, v in tables.items()},
                       loss))
    return (_jax_sharded_steps(params, batches),
            _port_sharded_steps(params, batches, mesh), single,
            params, batches, mesh)


def test_2d_step_against_the_reference_and_the_single_card_step(
        sharded_runs):
    """One 4 x 2 step and the next: the loss within 1e-6 relative of the
    reference's sharded step on 8 host devices and of the port's
    single-card ``train_step``; the tables within 1e-6 of their largest
    entry of the single-card step's (the same arithmetic but the order of
    the dot products' sums; measured 6e-8), and within 1e-5 of the
    reference's: after the second step Adam's m/√v amplifies the rounding
    of a gradient that nearly cancels (a row gathered many times), and
    the single-card port stands off the reference by the same amount
    (measured 1.3e-6 of a largest entry 0.92)."""
    want, got, single, _, _, _ = sharded_runs
    for (wt, wl), (gt, gl), (st, sl) in zip(want, got, single):
        for ref_loss in (wl, float(sl)):
            assert abs(float(gl) - ref_loss) <= REL * abs(ref_loss)
        for k in ("in", "out"):
            for ref, rel in ((st[k].numpy(), REL), (wt[k], 10 * REL)):
                assert np.abs(gt[k].numpy() - ref).max() \
                    <= rel * np.abs(ref).max()


def test_2d_step_is_the_same_bits_twice(sharded_runs):
    _, got, _, params, batches, mesh = sharded_runs
    again = _port_sharded_steps(params, batches, mesh)
    for (a, la), (b, lb) in zip(got, again):
        assert torch.equal(la, lb)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_2d_step_layouts_and_k1_launches(monkeypatch, sharded_runs):
    """The tables split by columns over ``model`` (each shard (n, D /
    model)), the batch by rows over ``data``, and 3 K1 launches a shard a
    step."""
    _, _, _, params, batches, _ = sharded_runs
    mesh = N.M.make_mesh_2d(2, 2, devices=("cpu",) * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    step, layout, batch_layout = N.build_sharded_train_step(
        mesh, lambda ts: G.adam(ts, 0.01))
    tables = N.node2vec_params_from_jax(params, "cpu")
    placed = layout["in"].place(tables["in"])
    assert [tuple(b[mesh.device(0, j)].shape) for j, b in
            enumerate(placed)] == [(64, 8), (64, 8)]
    assert torch.equal(layout["in"].gather(placed), tables["in"])
    rows = batch_layout.place(torch.arange(8))
    assert [r[0].tolist() for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    calls = []

    class Counting:
        def __getattr__(self, name):
            return getattr(SC, name)

        @staticmethod
        def csr_spmm_sum(*a, **kw):
            calls.append(kw)
            return SC.csr_spmm_sum(*a, **kw)

    monkeypatch.setattr(G, "SC", Counting())
    _port_sharded_steps(params, batches, mesh)
    assert len(calls) == 3 * 4 * len(batches)
    with pytest.raises(ValueError, match="columns"):
        N.ShardLayout(N.M.make_mesh_2d(1, 3, devices=("cpu",) * 3),
                      "table").place(tables["in"])
