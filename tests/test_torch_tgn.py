"""The port's temporal graph network (memgraph_tpu_torch/procedures/
tgn_module.py) against the JAX package's (memgraph_tpu/procedures/
tgn_module.py), with the reference's initial weights carried across
(``tgn_weights_from_jax``).

Data: bipartite temporal edges, 150 users and 150 pages, made from a numpy
seed; every batch holds 64 edges with distinct users and distinct pages,
so no row repeats within a batch (the reference leaves a repeated row's
write unsaid; the port's repeat rule has a test of its own).  300 nodes
outgrow the memory's 256 initial rows, so the growth runs.

Tolerances: a batch's loss within 1e-6 and the memory within 1e-6 (f32
rounding of the same products); ``last_seen`` equal; the weights within
1e-4 after at most five Adam steps: Adam divides a gradient by its own
root mean square, so a rounding difference in a gradient near zero moves
a step by up to a fraction of the learning rate (0.01), measured 2.8e-5.
``train_and_eval``'s epoch rows: the losses within 1e-5.
"""

import numpy as np
import pytest
import torch

from memgraph_tpu.procedures import tgn_module as JT
from memgraph_tpu.query.interpreter import Interpreter, InterpreterContext
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu_torch.procedures import ProcedureError
from memgraph_tpu_torch.procedures import tgn_module as TT
from test_torch_snapshot import StorageSource

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

USERS, PAGES, BATCH = 150, 150, 64


def _batches(n_batches, seed=3):
    """Edges (user, page, t) of ``n_batches`` batches without repeats,
    timestamps increasing."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_batches):
        u = rng.permutation(USERS)[:BATCH]
        p = USERS + rng.permutation(PAGES)[:BATCH]
        out.append([(int(a), int(b), float(100 * k + i))
                    for i, (a, b) in enumerate(zip(u, p))])
    return out


def _state_pair():
    JT._STATE.clear()
    JT._init_state({})
    st = TT.TgnState({}, device="cpu", weights=TT.tgn_weights_from_jax(
        JT._STATE["weights"], "cpu"))
    return st


@pytest.fixture(scope="module")
def streamed():
    """Six batches through both packages (five trained, one scored)."""
    st = _state_pair()
    losses = []
    for k, b in enumerate(_batches(6)):
        train = k < 5
        losses.append((JT._ingest(b, train=train), st.ingest(b, train=train)))
    return JT._STATE, st, losses


def test_batch_losses_match(streamed):
    _, _, losses = streamed
    for lj, lt in losses:
        assert abs(lj - lt) <= 1e-6


def test_memory_and_last_seen_match(streamed):
    ref, st, _ = streamed
    assert np.asarray(ref["memory"]).shape == tuple(st.memory.shape) \
        == (512, 32)                         # grown past n_hint = 256
    np.testing.assert_allclose(st.memory.numpy(), np.asarray(ref["memory"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(st.init_memory.numpy(),
                                  np.asarray(ref["init_memory"]))
    np.testing.assert_array_equal(st.last_seen.numpy(),
                                  np.asarray(ref["last_seen"]))
    assert st.gid_to_row == ref["gid_to_row"]
    assert (st.step, st.clock) == (ref["step"], ref["clock"])


@pytest.mark.parametrize("name", TT._WEIGHT_NAMES)
def test_weights_match(streamed, name):
    ref, st, _ = streamed
    np.testing.assert_allclose(st.weights[name].detach().numpy(),
                               np.asarray(ref["weights"][name]), atol=1e-4,
                               rtol=0)


def test_repeated_rows_keep_the_last_occurrence_and_the_same_bits():
    """A batch whose sources repeat: each repeated row holds the GRU
    output of its last occurrence (recomputed here in float64), and two
    runs give the same bits."""
    def run():
        st = TT.TgnState({}, device="cpu")
        first = _batches(1, seed=9)[0]
        st.ingest(first, train=True)
        batch = [(first[i % 4][0], first[i][1], 500.0 + i)
                 for i in range(16)]       # 4 users, each 4 times
        mem0 = st.memory.clone()
        w = {k: v.detach().double() for k, v in st.weights.items()}
        seen0 = st.last_seen.clone()
        st.ingest(batch, train=False)      # no weight step: w holds
        return st, batch, mem0, w, seen0

    st, batch, mem0, w, seen0 = run()
    st2 = run()[0]
    assert torch.equal(st.memory, st2.memory)
    assert torch.equal(st.last_seen, st2.last_seen)
    rows = {g: st.gid_to_row[g] for g in {b[0] for b in batch}}
    m = mem0.double()
    src = np.asarray([st.gid_to_row[b[0]] for b in batch])
    dst = np.asarray([st.gid_to_row[b[1]] for b in batch])
    ts = torch.tensor([b[2] for b in batch], dtype=torch.float32)
    te = TT.time_encode(ts - seen0[torch.from_numpy(src)], st.time_dim
                        ).double()

    def gru(mem, r, o):
        x = torch.cat([mem[o], te], 1)
        xin = torch.cat([x, mem[r]], 1)
        z = torch.sigmoid(xin @ w["W_z"])
        rr = torch.sigmoid(xin @ w["W_r"])
        h = torch.tanh(torch.cat([x, rr * mem[r]], 1) @ w["W_h"])
        return (1 - z) * mem[r] + z * h

    m[torch.from_numpy(dst)] = gru(m, torch.from_numpy(dst),
                                   torch.from_numpy(src))  # dst distinct
    new = gru(m, torch.from_numpy(src), torch.from_numpy(dst))
    for g, row in rows.items():
        last = max(i for i, b in enumerate(batch) if b[0] == g)
        first = min(i for i, b in enumerate(batch) if b[0] == g)
        got = st.memory[row].double()
        assert torch.allclose(got, new[last], atol=1e-6, rtol=0)
        assert not torch.allclose(got, new[first], atol=1e-6, rtol=0)
        assert float(st.last_seen[row]) == batch[last][2]


def test_init_weights_shapes_scales_and_determinism():
    """The reference's shapes (memgraph_tpu/procedures/tgn_module.py
    ``_init_state``), N(0, 0.1^2) entries, zero biases, one seed one
    draw."""
    a = TT.init_weights(32, 8, seed=7, device="cpu")
    b = TT.init_weights(32, 8, seed=7, device="cpu")
    shapes = {"W_z": (72, 32), "W_r": (72, 32), "W_h": (72, 32),
              "W_p1": (136, 32), "b_p1": (32,), "W_p2": (32, 1),
              "b_p2": (1,)}
    for k in TT._WEIGHT_NAMES:
        assert torch.equal(a[k], b[k])
        assert tuple(a[k].shape) == shapes[k]
        if k.startswith("b_"):
            assert not a[k].any()
        else:
            assert 0.08 < float(a[k].std()) < 0.12
    assert not torch.equal(a["W_z"],
                           TT.init_weights(32, 8, seed=8, device="cpu")
                           ["W_z"])


def _storage(batches):
    """A JAX storage with the edges of ``batches`` (a ``timestamp``
    property a edge; two edges carry a string, which counts as 0),
    created in a shuffled order so the sort by time does the work."""
    storage = InMemoryStorage()
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    ts_p = storage.property_mapper.name_to_id("timestamp")
    vs = [acc.create_vertex() for _ in range(USERS + PAGES)]
    edges = [e for b in batches for e in b]
    order = np.random.default_rng(5).permutation(len(edges))
    for k in order.tolist():
        s, d, t = edges[k]
        e = acc.create_edge(vs[s], vs[d], et)
        e.set_property(ts_p, "late" if t in (1.0, 2.0) else t)
    acc.commit()
    return storage, [v.gid for v in vs]


@pytest.fixture(scope="module")
def trained():
    """Two epochs of ``tgn.train_and_eval`` in both packages on one
    storage (4 train batches, 1 scored); the reference through Cypher."""
    batches = _batches(5, seed=4)
    # the strings sort first: keep the first batch's rows distinct
    storage, gids = _storage(batches)
    ictx = InterpreterContext(storage)
    interp = Interpreter(ictx)
    interp.execute("CALL tgn.set_params({}) YIELD message RETURN message")
    weights = TT.tgn_weights_from_jax(JT._STATE["weights"], "cpu")
    want = interp.execute(
        "CALL tgn.train_and_eval(2) YIELD epoch, train_loss, eval_loss "
        "RETURN epoch, train_loss, eval_loss")[1]
    TT.set_params({}, device="cpu", weights=weights)
    acc = storage.access()
    got = TT.train_and_eval(StorageSource(acc), 2, device="cpu")
    acc.commit()
    return storage, gids, interp, want, got


def test_train_and_eval_epoch_rows(trained):
    _, _, _, want, got = trained
    assert list(got["epoch"]) == [r[0] for r in want] == [0, 1]
    np.testing.assert_allclose(got["train_loss"], [r[1] for r in want],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["eval_loss"], [r[2] for r in want],
                               atol=1e-5, rtol=0)


def test_the_edge_order_is_a_stable_sort_by_time(trained):
    storage = trained[0]
    acc = storage.access()
    edges = TT.edges_by_time(StorageSource(acc))
    acc.commit()
    ts = [e[2] for e in edges]
    assert ts == sorted(ts) and ts[:2] == [0, 0]


def test_get_and_predict_link_score_match(trained):
    storage, gids, interp, _, _ = trained
    want = dict(interp.execute("CALL tgn.get() YIELD node, embedding "
                               "RETURN id(node), embedding")[1])
    got = TT.get(device="cpu")
    assert sorted(want) == sorted(got["node_gids"].tolist())
    for g, row in zip(got["node_gids"].tolist(), got["embedding"]):
        np.testing.assert_allclose(row, want[g], atol=1e-5, rtol=0)
    for a, b in ((gids[0], gids[USERS]), (gids[3], gids[USERS + 7])):
        p = interp.execute(
            "MATCH (a), (b) WHERE id(a) = $a AND id(b) = $b "
            "CALL tgn.predict_link_score(a, b) YIELD prediction "
            "RETURN prediction", {"a": a, "b": b})[1][0][0]
        got_p = TT.predict_link_score(a, b, device="cpu")["prediction"][0]
        assert abs(got_p - p) <= 1e-5


def test_update_and_reset():
    TT.set_params({"memory_dim": 8, "time_dim": 4}, device="cpu")
    out = TT.update([(1, 2, 3.0), (4, 5, "x")], device="cpu")
    assert np.isfinite(out["loss"][0])
    assert TT.get(device="cpu")["embedding"].shape == (4, 8)
    TT.reset()
    assert TT._STATE == {}


def test_no_edges_refused():
    from memgraph_tpu_torch.northstar import CooSource
    with pytest.raises(ProcedureError, match="no edges"):
        TT.train_and_eval(CooSource(np.zeros(0, np.int64),
                                    np.zeros(0, np.int64), 3), 1,
                          timestamp_property="weight", device="cpu")
