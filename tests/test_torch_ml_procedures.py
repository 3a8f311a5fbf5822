"""The port's dense-path procedures (memgraph_tpu_torch/procedures/
ml_modules.py, vector_search.py, utility_modules.py, structure_modules.py)
against the JAX package's Cypher ``CALL``s on one storage.

The storage: N vertices and E edges, each vertex with ``emb`` (8 floats,
distinct), ``blob`` (8 floats, one of 4 coinciding blob centers) and
``label`` (an int).  The port reads it through the storage adapter of
tests/test_torch_snapshot.py.

GNN serving: the JAX package trains (``CALL link_prediction.train()``,
``node_classification.train()``); its parameters are carried to the port
(``load_parameters``), which serves on the same snapshot.  Embeddings are
held within one bf16 ulp of the largest |h| (2^-7 max |h|, the forward's
bound in tests/test_torch_gnn.py); a link score within what that bound
allows through the dot product and the sigmoid (slope 1/4):
(1/4) Σ_l ε(|a_l| + |b_l| + ε), ε = 2^-7 max |h|, a, b the reference's
embeddings; recommend's order equal wherever the reference's scores
differ by more than twice that; a predicted class equal wherever the
reference's two largest logits differ by more than 2ε.

GNN training: the port's ``train`` and its records have the reference's
fields and epoch counts; on a planted-community graph each package trains
with its own draws, so the link AUC is held within 0.1 and the class
accuracy within 0.15 of the reference's ``CALL``s (measured 0.860 against
0.849, and 1.0 against 1.0); ``predict`` retrains after a commit and keeps
its embeddings across a version whose change log is empty.  node2vec's
procedures: the reference's shapes, gids and ``nodes_updated``.

Vector search (bf16 scores, as the reference's): the same gids in the same
order, similarities within 1e-6; PPR search within 1e-6 of the largest
rank (tests/test_torch_procedures.py's PPR bound); k-means from the
reference's initial rows (the same ``jax.random.choice`` call) on the
coinciding blobs: equal clusters; node similarity: equal scores.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from memgraph_tpu.procedures import vector_search as jvs
from memgraph_tpu.query.interpreter import Interpreter, InterpreterContext
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu.storage.common import View
from memgraph_tpu_torch.ops import gnn as G
from memgraph_tpu_torch.ops import knn as K
from memgraph_tpu_torch.ops import similarity as SIM
from memgraph_tpu_torch.ops import walks as W
from memgraph_tpu_torch.ops.csr import GraphCache, export_csr, from_coo, \
    property_rows
from memgraph_tpu_torch.models import node2vec as N2V_MODEL
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.procedures import ProcedureError
from memgraph_tpu_torch.procedures import ml_modules as ML
from memgraph_tpu_torch.procedures import node2vec_module as N2V
from memgraph_tpu_torch.procedures import structure_modules as SM
from memgraph_tpu_torch.procedures import utility_modules as UM
from memgraph_tpu_torch.procedures import vector_search as VS

from test_torch_snapshot import StorageSource

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N, E = 120, 600
ULP = 2.0 ** -7


def _build():
    storage = InMemoryStorage()
    rng = np.random.default_rng(21)
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    pm = storage.property_mapper
    emb, blob, label = (pm.name_to_id(p) for p in ("emb", "blob", "label"))
    vs = [acc.create_vertex() for _ in range(N)]
    vectors = rng.standard_normal((N, 8))
    centers = rng.standard_normal((4, 8)) * 5
    which = rng.integers(0, 4, N)
    for i, v in enumerate(vs):
        v.set_property(emb, [float(x) for x in vectors[i]])
        v.set_property(blob, [float(x) for x in centers[which[i]]])
        v.set_property(label, int(i % 3))
    src = rng.integers(0, N, E)
    dst = (rng.random(E) ** 2 * N).astype(np.int64)
    for s, d in zip(src, dst):
        acc.create_edge(vs[s], vs[d], et)
    acc.commit()
    return storage, InterpreterContext(storage), [v.gid for v in vs]


@pytest.fixture(scope="module")
def trained():
    """A storage whose link-prediction model (degree features) and
    node-classification model (``emb`` features) the JAX package
    trained."""
    storage, ictx, gids = _build()
    rows(ictx, "CALL link_prediction.train() YIELD training_results "
               "RETURN training_results")
    rows(ictx, "CALL node_classification.set_model_parameters("
               "{node_features_property: 'emb', num_epochs: 20}) "
               "YIELD status RETURN status")
    rows(ictx, "CALL node_classification.train() YIELD epoch RETURN epoch")
    return storage, ictx, gids


@pytest.fixture
def db():
    return _build()


def rows(ictx, query, params=None) -> list:
    return Interpreter(ictx).execute(query, params)[1]


def port(storage, fn, *args, **kw) -> dict:
    acc = storage.access()
    try:
        return fn(StorageSource(acc), *args, device="cpu", **kw)
    finally:
        acc.abort()


def _loaded(storage, name, config=None):
    """A fresh registry whose slot ``name`` holds the JAX slot's
    parameters, bound to the current snapshot; and the cache."""
    models, cache = ML.ModelRegistry(), GraphCache()
    acc = storage.access()
    try:
        source = StorageSource(acc)
        if config:
            ML.set_model_parameters(source, name, config, models=models)
        params = [[np.asarray(a) for a in layer]
                  for layer in storage._gnn_models[name].params]
        ML.load_parameters(source, name, params, models=models, cache=cache,
                           device="cpu")
    finally:
        acc.abort()
    return models, cache


def _emb_bound(storage, name, models):
    """(the reference's embeddings by row, ε, the slot's snapshot); the
    port's embeddings held within ε = 2^-7 max |h| of them."""
    want = np.asarray(storage._gnn_models[name].emb)
    slot = models.slot(SimpleNamespace(storage=storage), name)
    got = slot.emb.numpy()
    n = slot.graph.n_nodes
    eps = ULP * np.abs(want[:n]).max()
    assert np.abs(got[:n] - want[:n]).max() <= eps
    return want, eps, slot.graph


def _lp_bound(a, b, eps):
    return 0.25 * float(np.sum(eps * (np.abs(a) + np.abs(b) + eps))) + 1e-7


def test_link_prediction_predict(trained):
    storage, ictx, gids = trained
    models, cache = _loaded(storage, "link_prediction")
    pairs = [(gids[i], gids[j]) for i, j in ((0, 5), (3, 3), (17, 90),
                                             (119, 1), (44, 60))]
    for a, b in pairs:
        want = rows(ictx, "MATCH (a), (b) WHERE id(a) = $a AND id(b) = $b "
                          "CALL link_prediction.predict(a, b) YIELD score "
                          "RETURN score", {"a": a, "b": b})[0][0]
        got = port(storage, ML.link_prediction_predict, a, b, models=models,
                   cache=cache)
        assert got["score"].shape == (1,)
        emb, eps, g = _emb_bound(storage, "link_prediction", models)
        bound = _lp_bound(emb[g.gid_to_idx[a]], emb[g.gid_to_idx[b]], eps)
        assert abs(got["score"][0] - want) <= bound


def test_link_prediction_recommend(trained):
    storage, ictx, gids = trained
    models, cache = _loaded(storage, "link_prediction")
    src, cands = gids[7], gids[20:80]
    want = rows(ictx, "MATCH (s) WHERE id(s) = $s MATCH (c) WHERE id(c) IN "
                      "$c WITH s, collect(c) AS cs "
                      "CALL link_prediction.recommend(s, cs, 10) "
                      "YIELD score, recommendation "
                      "RETURN id(recommendation), score",
                {"s": src, "c": cands})
    got = port(storage, ML.link_prediction_recommend, src, cands, 10,
               models=models, cache=cache)
    assert len(got["node_gids"]) == len(want) == 10
    emb, eps, g = _emb_bound(storage, "link_prediction", models)
    ref = {c: 1 / (1 + np.exp(-float(emb[g.gid_to_idx[src]]
                                     @ emb[g.gid_to_idx[c]])))
           for c in cands}
    bound = max(_lp_bound(emb[g.gid_to_idx[src]], emb[g.gid_to_idx[c]], eps)
                for c in cands)
    for gid, score in zip(got["node_gids"], got["score"]):
        assert abs(score - ref[int(gid)]) <= bound
    # the order: where the reference's scores differ by more than 2x the
    # bound, the port ranks them as the reference
    order = [int(g_) for g_ in got["node_gids"]]
    for i in range(len(order)):
        for j in range(i + 1, len(order)):
            assert ref[order[i]] >= ref[order[j]] - 2 * bound
    assert set(order) == {int(r[0]) for r in want} or \
        abs(sorted(ref.values())[-10] - sorted(ref.values())[-11]) \
        <= 2 * bound
    assert port(storage, ML.link_prediction_recommend, src, [None, -5], 3,
                models=models, cache=cache)["node_gids"].size == 0


def test_node_classification_predict(trained):
    storage, ictx, gids = trained
    models, cache = _loaded(storage, "node_classification",
                            {"node_features_property": "emb"})
    emb, eps, compared = None, None, 0
    sampled = range(0, N, 7)
    for i in sampled:
        want = rows(ictx, "MATCH (a) WHERE id(a) = $a CALL "
                          "node_classification.predict(a) "
                          "YIELD predicted_class RETURN predicted_class",
                    {"a": gids[i]})[0][0]
        got = port(storage, ML.node_classification_predict, gids[i],
                   models=models, cache=cache)
        assert got["status"][0] == "ok" and got["node_gids"][0] == gids[i]
        if emb is None:
            emb, eps, _ = _emb_bound(storage, "node_classification",
                                     models)
        logits = np.sort(emb[i])
        if logits[-1] - logits[-2] > 2 * eps:
            assert got["predicted_class"][0] == want
            compared += 1
    assert compared >= len(sampled) // 2


def test_no_parameters_and_a_changed_snapshot_raise(trained):
    """Where the port once refused (no parameters; a snapshot other than
    the bound one), it now trains on the current snapshot, as the
    reference does."""
    storage, _, gids = trained
    fresh = ML.ModelRegistry()
    port(storage, ML.link_prediction_predict, gids[0], gids[1],
         models=fresh, cache=GraphCache())
    slot = fresh.slot(SimpleNamespace(storage=storage), "link_prediction")
    assert len(slot.history) == 30 and slot.emb is not None
    models, cache = _loaded(storage, "link_prediction")
    port(storage, ML.link_prediction_predict, gids[0], gids[1],
         models=models, cache=cache)
    slot = models.slot(SimpleNamespace(storage=storage), "link_prediction")
    loaded, bound = slot.params, slot.graph
    assert slot.emb is not None and slot.history == []
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    acc.create_edge(acc.find_vertex(gids[2], View.OLD),
                    acc.find_vertex(gids[9], View.OLD), et)
    acc.commit()
    try:
        got = port(storage, ML.link_prediction_predict, gids[0], gids[1],
                   models=models, cache=cache)
        assert 0.0 <= got["score"][0] <= 1.0
        assert slot.params is not loaded and slot.graph is not bound
        assert slot.graph.n_edges == bound.n_edges + 1
        assert len(slot.history) == 30 and slot.emb is not None
    finally:
        acc = storage.access()
        for e in list(acc.find_vertex(gids[2], View.OLD).out_edges(
                View.OLD)):
            if e.to_vertex().gid == gids[9]:
                acc.delete_edge(e)
                break
        acc.commit()


def _set(ictx, name, params):
    rows(ictx, f"CALL {name}.set_model_parameters($p) YIELD status "
               "RETURN status", {"p": params})


def test_training_procedures_have_the_references_fields(db):
    storage, ictx, gids = db
    config = {"num_epochs": 6, "hidden_features_size": 16}
    models = ML.ModelRegistry()
    for name in ("link_prediction", "node_classification"):
        _set(ictx, name, config)
        acc = storage.access()
        try:
            ML.set_model_parameters(StorageSource(acc), name, config,
                                    models=models)
        finally:
            acc.abort()
    with pytest.raises(Exception) as want:
        rows(ictx, "CALL link_prediction.get_training_results() "
                   "YIELD training_results RETURN training_results")
    with pytest.raises(ProcedureError) as got:
        port(storage, lambda s, device: (
            ML.link_prediction_get_training_results(s, models=models)))
    assert str(got.value) in str(want.value)

    want = rows(ictx, "CALL link_prediction.train() YIELD training_results, "
                      "validation_results RETURN training_results, "
                      "validation_results")
    got = port(storage, ML.link_prediction_train, models=models,
               cache=GraphCache())
    assert len(want) == 1 and set(got) == {"training_results",
                                           "validation_results"}
    (w_train, w_val), g_train = want[0], got["training_results"][0]
    assert len(g_train) == len(w_train) == 6
    assert [h["epoch"] for h in g_train] == [h["epoch"] for h in w_train]
    assert [set(h) for h in g_train] == [set(h) for h in w_train]
    assert got["validation_results"][0] == [g_train[-1]]
    assert set(w_val[0]) == set(got["validation_results"][0][0])
    again = port(storage, lambda s, device: (
        ML.link_prediction_get_training_results(s, models=models)))
    assert again["training_results"][0] == g_train

    fields = "epoch, loss, val_loss, train_log, val_log"
    want = rows(ictx, f"CALL node_classification.train() YIELD {fields} "
                      f"RETURN {fields}")
    got = port(storage, ML.node_classification_train, models=models,
               cache=GraphCache())
    assert set(got) == {"epoch", "loss", "val_loss", "train_log",
                        "val_log"}
    assert got["epoch"].tolist() == [r[0] for r in want] == list(range(1, 7))
    assert np.array_equal(got["loss"], got["val_loss"])
    assert [set(h) for h in got["train_log"]] == [set(r[3]) for r in want]
    assert "acc" in got["val_log"][-1]
    again = port(storage, lambda s, device: (
        ML.node_classification_get_training_data(s, models=models)))
    assert again["epoch"].tolist() == got["epoch"].tolist()
    assert list(again["train_log"]) == list(got["train_log"])


def _planted(seed=5, blocks=4, per=40):
    """Four planted communities (edges inside at 0.15, across at 0.005,
    nodes in a shuffled order), each vertex with ``community`` (its
    block) and ``feat`` (its block's one-hot plus N(0, 0.8²) noise)."""
    storage = InMemoryStorage()
    rng = np.random.default_rng(seed)
    n = blocks * per
    block = rng.permutation(np.repeat(np.arange(blocks), per))
    acc = storage.access()
    et = storage.edge_type_mapper.name_to_id("E")
    pm = storage.property_mapper
    comm, feat = pm.name_to_id("community"), pm.name_to_id("feat")
    vs = [acc.create_vertex() for _ in range(n)]
    for i, v in enumerate(vs):
        v.set_property(comm, int(block[i]))
        v.set_property(feat, [float(x) for x in np.eye(blocks)[block[i]]
                              + rng.normal(0, 0.8, blocks)])
    same = block[:, None] == block[None, :]
    linked = rng.random((n, n)) < np.where(same, 0.15, 0.005)
    np.fill_diagonal(linked, False)
    for s, d in zip(*np.nonzero(linked)):
        acc.create_edge(vs[s], vs[d], et)
    acc.commit()
    return storage, InterpreterContext(storage)


def test_planted_communities_auc_and_accuracy_near_the_references():
    """Each package trains with its own draws (the reference's
    ``jax.random``, the port's generators): the link AUC within 0.1 and
    the class accuracy within 0.15 of the reference's ``CALL``s, both
    well above chance."""
    storage, ictx = _planted()
    config = {"node_features_property": "feat", "target_property":
              "community", "num_epochs": 30}
    _set(ictx, "link_prediction", config)
    _set(ictx, "node_classification", config)
    want_auc = rows(ictx, "CALL link_prediction.train() YIELD "
                          "validation_results RETURN validation_results"
                    )[0][0][0]["auc"]
    want_acc = rows(ictx, "CALL node_classification.train() YIELD val_log "
                          "RETURN val_log")[-1][0]["acc"]
    models = ML.ModelRegistry()
    acc = storage.access()
    try:
        source = StorageSource(acc)
        for name in ("link_prediction", "node_classification"):
            ML.set_model_parameters(source, name, config, models=models)
    finally:
        acc.abort()
    got_auc = port(storage, ML.link_prediction_train, models=models,
                   cache=GraphCache())["validation_results"][0][0]["auc"]
    got_acc = port(storage, ML.node_classification_train, models=models,
                   cache=GraphCache())["val_log"][-1]["acc"]
    assert want_auc > 0.75 and want_acc > 0.6
    assert abs(got_auc - want_auc) <= 0.1
    assert abs(got_acc - want_acc) <= 0.15


def test_predict_retrains_after_a_commit_and_keeps_across_an_empty_log(db):
    storage, ictx, gids = db
    models, cache = ML.ModelRegistry(), GraphCache()
    acc = storage.access()
    try:
        for name in ("link_prediction", "node_classification"):
            ML.set_model_parameters(StorageSource(acc), name,
                                    {"num_epochs": 4}, models=models)
    finally:
        acc.abort()
    lp = models.slot(SimpleNamespace(storage=storage), "link_prediction")
    nc = models.slot(SimpleNamespace(storage=storage),
                     "node_classification")
    port(storage, ML.link_prediction_predict, gids[0], gids[1],
         models=models, cache=cache)
    cls = port(storage, ML.node_classification_predict, gids[3],
               models=models, cache=cache)["predicted_class"][0]
    assert 0 <= cls < 3 and nc.n_classes == 3
    held = [(s.params, s.emb, s.graph, s.version) for s in (lp, nc)]
    storage.access().abort()        # a version with an empty change set
    port(storage, ML.link_prediction_predict, gids[0], gids[1],
         models=models, cache=cache)
    port(storage, ML.node_classification_predict, gids[3], models=models,
         cache=cache)
    for slot, (params, emb, graph, version) in zip((lp, nc), held):
        assert slot.params is params and slot.emb is emb
    acc = storage.access()
    acc.find_vertex(gids[5], View.OLD).set_property(
        storage.property_mapper.name_to_id("label"), 0)
    acc.create_edge(acc.find_vertex(gids[2], View.OLD),
                    acc.find_vertex(gids[9], View.OLD),
                    storage.edge_type_mapper.name_to_id("E"))
    acc.commit()
    port(storage, ML.link_prediction_predict, gids[0], gids[1],
         models=models, cache=cache)
    port(storage, ML.node_classification_predict, gids[3], models=models,
         cache=cache)
    for slot, (params, emb, graph, version) in zip((lp, nc), held):
        assert slot.params is not params and slot.emb is not emb
        assert slot.graph is not graph and slot.version > version
        assert len(slot.history) == 4


def test_labels_are_the_integer_values_of_the_target(db):
    storage, ictx, gids = db
    acc = storage.access()
    label = storage.property_mapper.name_to_id("label")
    acc.find_vertex(gids[0], View.OLD).set_property(label, True)
    acc.find_vertex(gids[1], View.OLD).set_property(label, 1.5)
    acc.find_vertex(gids[2], View.OLD).set_property(label, None)
    acc.commit()
    acc = storage.access()
    try:
        source = StorageSource(acc)
        graph = export_csr(source, device="cpu")
        idx, labels = ML._labels(source, graph, "label")
        assert idx.tolist() == list(range(3, N))
        assert labels.tolist() == [i % 3 for i in range(3, N)]
        for target, msg in (("nope", "no node carries the target"),
                            ("emb", "no node carries an integer")):
            with pytest.raises(ProcedureError, match=msg):
                ML._labels(source, graph, target)
    finally:
        acc.abort()
    coo = CooSource([0, 1], [1, 2], 3,
                    properties={"c": np.array([2, 0, 1])})
    graph = export_csr(coo, device="cpu")
    assert ML._labels(coo, graph, "c")[1].tolist() == [2, 0, 1]


@pytest.mark.parametrize("prop,value", [("nope", None), ("label", None),
                                        ("ragged", None)])
def test_feature_errors_are_the_references(db, prop, value):
    storage, ictx, gids = db
    acc = storage.access()
    ragged = storage.property_mapper.name_to_id("ragged")
    for i, g in enumerate(gids):
        acc.find_vertex(g, View.OLD).set_property(ragged,
                                                  [1.0] * (2 + i % 2))
    acc.commit()
    with pytest.raises(Exception) as want:
        rows(ictx, "CALL link_prediction.set_model_parameters("
                   "{node_features_property: $p}) YIELD status "
                   "RETURN status", {"p": prop})
        rows(ictx, "CALL link_prediction.train() YIELD training_results "
                   "RETURN training_results")
    models = ML.ModelRegistry()
    acc = storage.access()
    try:
        source = StorageSource(acc)
        ML.set_model_parameters(source, "link_prediction",
                                {"node_features_property": prop},
                                models=models)
        with pytest.raises(ProcedureError) as got:
            ML.load_parameters(source, "link_prediction", [], models=models,
                               cache=GraphCache(), device="cpu")
    finally:
        acc.abort()
    assert str(got.value) in str(want.value)


def test_model_parameters_are_validated():
    source = CooSource([0], [1], 2)
    models = ML.ModelRegistry()
    for bad in ({"nope": 1}, {"num_layers": 0}, {"learning_rate": True},
                {"node_features_property": 3}):
        with pytest.raises(ProcedureError):
            ML.set_model_parameters(source, "link_prediction", bad,
                                    models=models)
    out = ML.set_model_parameters(source, "link_prediction",
                                  {"hidden_features_size": 8}, models=models)
    assert out["status"][0]
    assert models.slot(source, "link_prediction").config[
        "hidden_features_size"] == 8
    ML.reset_parameters(source, "link_prediction", models=models)
    assert models.slot(source, "link_prediction").config == ML._DEFAULTS


def _ordered(want_rows, got, scale=1.0):
    assert [int(r[0]) for r in want_rows] == got["node_gids"].tolist()
    np.testing.assert_allclose(got["similarity"],
                               [r[1] for r in want_rows], atol=1e-6 * scale)


@pytest.mark.parametrize("metric", ["cosine", "l2sq", "dot"])
def test_vector_search(db, metric):
    storage, ictx, gids = db
    q = [0.3, -1.0, 0.5, 2.0, 0.0, 0.1, -0.7, 1.2]
    want = rows(ictx, "CALL vector_search.search('emb', $q, 7, $m) "
                      "YIELD node, similarity RETURN id(node), similarity",
                {"q": q, "m": metric})
    index_cache = VS.IndexCache()
    got = port(storage, VS.search, "emb", q, 7, metric,
               index_cache=index_cache)
    _ordered(want, got, max(1.0, max(abs(r[1]) for r in want)))
    port(storage, VS.search, "emb", q, 3, index_cache=index_cache)
    assert index_cache.counters["full_builds"] == 1
    assert port(storage, VS.search, "nope", q, 3)["node_gids"].size == 0


@pytest.mark.parametrize("metric", ["cosine", "l2sq"])
def test_knn_get(db, metric):
    storage, ictx, gids = db
    want = rows(ictx, "MATCH (n) WHERE id(n) = $g CALL knn.get(n, 'emb', 6, "
                      "$m) YIELD neighbor, similarity "
                      "RETURN id(neighbor), similarity",
                {"g": gids[11], "m": metric})
    got = port(storage, VS.knn_get, gids[11], "emb", 6, metric)
    assert gids[11] not in got["node_gids"].tolist()
    _ordered(want, got, max(1.0, max(abs(r[1]) for r in want)))


def test_ppr_search(db):
    storage, ictx, gids = db
    q = [1.0, 0.5, -0.5, 0.0, 0.2, 0.9, -1.1, 0.4]
    want = rows(ictx, "CALL vector_search.ppr_search('emb', $q, 3, $n) "
                      "YIELD node, score, seed_similarity "
                      "RETURN id(node), score, seed_similarity",
                {"q": q, "n": N})
    got = port(storage, VS.ppr_search, "emb", q, 3, N, cache=GraphCache())
    by_gid = {int(g): (s, t) for g, s, t in zip(
        got["node_gids"], got["score"], got["seed_similarity"])}
    assert set(by_gid) == {int(r[0]) for r in want} and len(want) > 3
    top = max(r[1] for r in want)
    for gid, score, seed_sim in want:
        assert abs(by_gid[gid][0] - score) <= 1e-6 * top
        assert abs(by_gid[gid][1] - seed_sim) <= 1e-6


@pytest.mark.parametrize("k,seed", [(4, 0), (3, 5), (6, 2)])
def test_kmeans_get_clusters(db, k, seed, monkeypatch):
    storage, ictx, gids = db
    want = rows(ictx, "CALL kmeans.get_clusters('blob', $k, 10, $s) "
                      "YIELD node, cluster_id RETURN id(node), cluster_id",
                {"k": k, "s": seed})
    init = np.array(jax.random.choice(jax.random.PRNGKey(seed), N,
                                      shape=(k,), replace=False))
    with monkeypatch.context() as m:
        # the reference's initial rows in place of the port's draw
        m.setattr(K, "kmeans_init", lambda n, n_clusters, generator:
                  torch.as_tensor(init[:n_clusters], dtype=torch.int64))
        got = port(storage, UM.kmeans_get_clusters, "blob", k, 10, seed)
    assert got["node_gids"].tolist() == [int(r[0]) for r in want]
    assert got["cluster_id"].tolist() == [int(r[1]) for r in want]
    drawn = port(storage, UM.kmeans_get_clusters, "blob", k, 10, seed)
    assert len(set(drawn["cluster_id"].tolist())) <= k


@pytest.mark.parametrize("mode", ["jaccard", "overlap", "cosine"])
def test_node_similarity_all_pairs(db, mode):
    storage, ictx, _ = db
    want = rows(ictx, f"CALL node_similarity.{mode}() "
                      "YIELD node1, node2, similarity "
                      "RETURN id(node1), id(node2), similarity")
    got = port(storage, SM.node_similarity_all, mode, cache=GraphCache())
    assert len(want) > 100
    assert list(zip(got["node1_gids"].tolist(), got["node2_gids"].tolist(),
                    got["similarity"].tolist())) == \
        [(int(a), int(b), s) for a, b, s in want]


@pytest.mark.parametrize("mode", ["jaccard", "overlap", "cosine"])
def test_node_similarity_pairwise(db, mode):
    storage, ictx, gids = db
    rng = np.random.default_rng(3)
    pairs = [[gids[i], gids[j]] for i, j in rng.integers(0, N, (30, 2))]
    want = rows(ictx, "UNWIND $pairs AS p MATCH (a), (b) WHERE id(a) = p[0] "
                      "AND id(b) = p[1] WITH collect([a, b]) AS ps "
                      "CALL node_similarity.pairwise(ps, $m) "
                      "YIELD node1, node2, similarity "
                      "RETURN id(node1), id(node2), similarity",
                {"pairs": pairs, "m": mode})
    got = port(storage, SM.node_similarity_pairwise,
               pairs + [[gids[0]], [None, gids[1]], [gids[0], -7]], mode,
               cache=GraphCache())
    assert list(zip(got["node1_gids"].tolist(), got["node2_gids"].tolist(),
                    got["similarity"].tolist())) == \
        [(int(a), int(b), s) for a, b, s in want]


def test_all_pairs_similarity_refuses_past_the_dense_limit():
    storage = InMemoryStorage()
    acc = storage.access()
    vs = [acc.create_vertex() for _ in range(SIM.DENSE_LIMIT + 1)]
    acc.create_edge(vs[0], vs[1], storage.edge_type_mapper.name_to_id("E"))
    acc.commit()
    with pytest.raises(Exception) as want:
        rows(InterpreterContext(storage), "CALL node_similarity.jaccard() "
                                          "YIELD similarity RETURN similarity")
    with pytest.raises(ProcedureError) as got:
        port(storage, SM.node_similarity_all, "jaccard", cache=GraphCache())
    assert str(got.value) in str(want.value)


class IndexSource(StorageSource):
    """The storage adapter whose vertex property ``emb`` is read from a
    reference vector index entry (``_get_index``): a gid's live row, else
    None; the rows follow the storage's vertex order."""

    def __init__(self, accessor, entry):
        super().__init__(accessor)
        self.entry = entry

    def vertex_property(self, name, gids):
        matrix = np.asarray(self.entry.matrix)
        return [matrix[self.entry.gid_to_row[g]].tolist()
                if g in self.entry.gid_to_row else None for g in gids]


def test_search_over_a_delta_refreshed_reference_index(db):
    storage, ictx, gids = db
    q = [0.3, -1.0, 0.5, 2.0, 0.0, 0.1, -0.7, 1.2]
    query = "CALL vector_search.search('emb', $q, 9) YIELD node, " \
            "similarity RETURN id(node), similarity"
    rows(ictx, query, {"q": q})
    acc = storage.access()
    emb = storage.property_mapper.name_to_id("emb")
    acc.find_vertex(gids[4], View.OLD).set_property(emb, [1.0] * 8)
    acc.find_vertex(gids[8], View.OLD).set_property(emb, None)
    acc.find_vertex(gids[9], View.OLD).set_property(emb, [0.5, -2.0] * 4)
    acc.commit()
    before = jvs.STATS["delta_refreshes"]
    want = rows(ictx, query, {"q": q})
    assert jvs.STATS["delta_refreshes"] == before + 1
    acc = storage.access()
    try:
        ctx = SimpleNamespace(storage=storage, accessor=acc, view=View.OLD)
        entry = jvs._get_index(ctx, "emb")
        assert entry.size == N - 1
        got = VS.search(IndexSource(acc, entry), "emb", q, 9, device="cpu",
                        index_cache=VS.IndexCache())
        direct = VS.search(StorageSource(acc), "emb", q, 9, device="cpu",
                           index_cache=VS.IndexCache())
    finally:
        acc.abort()
    _ordered(want, got)
    _ordered(want, direct)


def test_the_coo_source_serves_the_dense_procedures():
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    vectors = rng.standard_normal((50, 4)).astype(np.float32)
    source = CooSource(src, dst, 50, properties={"v": vectors})
    assert source.vertex_property("w", [0]) is None
    assert np.array_equal(source.vertex_property("v", [3, 1]),
                          vectors[[3, 1]])
    source.commit(add_vertices=1)
    assert source.vertex_property("v", [49, 50])[1] is None
    got = VS.search(source, "v", vectors[0].tolist(), 3, device="cpu",
                    index_cache=VS.IndexCache())
    assert got["node_gids"][0] == 0
    models, cache = ML.ModelRegistry(), GraphCache()
    ML.set_model_parameters(source, "link_prediction",
                            {"node_features_property": "v"}, models=models)
    with pytest.raises(ProcedureError, match="numeric list"):
        ML.load_parameters(source, "link_prediction", [], models=models,
                           cache=cache, device="cpu")


class ListSource(CooSource):
    """A CooSource that reads vertex properties in the storage's form: a
    list with a value (a list, or None) a gid."""

    def vertex_property(self, name, gids):
        values = super().vertex_property(name, gids)
        return None if values is None else [
            None if v is None else np.asarray(v).tolist() for v in values]


@pytest.mark.parametrize("added", [0, 1])
def test_both_property_forms_give_the_same_rows(added):
    rng = np.random.default_rng(6)
    vectors = rng.standard_normal((40, 5)).astype(np.float32)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    sources = [cls(src, dst, 40, properties={"v": vectors})
               for cls in (CooSource, ListSource)]
    for source in sources:
        source.commit(add_vertices=added)
    gids = np.arange(40 + added)
    forms = [s.vertex_property("v", gids) for s in sources]
    assert isinstance(forms[0], list if added else np.ndarray)
    assert isinstance(forms[1], list)
    (m0, k0), (m1, k1) = (property_rows(f) for f in forms)
    assert np.array_equal(m0, vectors) and np.array_equal(m1, vectors)
    assert k0.tolist() == k1.tolist() == [True] * 40 + [False] * added
    snaps = [VS.full_build(s, "v", "cpu") for s in sources]
    assert snaps[0].row_gids == snaps[1].row_gids == list(range(40))
    assert torch.equal(snaps[0].matrix, snaps[1].matrix)
    graphs = [export_csr(s, device="cpu") for s in sources]
    if added:
        for source, graph in zip(sources, graphs):
            with pytest.raises(ProcedureError, match="numeric list"):
                ML._features(source, graph, "v")
    else:
        assert torch.equal(ML._features(sources[0], graphs[0], "v"),
                           ML._features(sources[1], graphs[1], "v"))


def test_property_rows_keep_the_dominant_numeric_lists():
    values = [None, [1, 2], [True, 1.0], [], [1.0, 2.0, 3.0], (3, 4.5),
              "ab", [5.0, 6.0, 7.0], [8, 9]]
    matrix, kept = property_rows(values)
    assert kept.tolist() == [False, True, False, False, False, True, False,
                             False, True]
    assert matrix.dtype == np.float32
    assert matrix.tolist() == [[1.0, 2.0], [3.0, 4.5], [8.0, 9.0]]
    assert property_rows([None, [], [True]])[0] is None
    assert property_rows(np.zeros((3, 0)))[1].tolist() == [False] * 3


def _host_graph():
    return from_coo(np.array([0, 1]), np.array([1, 2]), n_nodes=3)


@pytest.mark.parametrize("call", [
    lambda: G.init_sage_params(4, 8, 2),
    lambda: G.sage_params_from_jax([]),
    lambda: G.degree_features(_host_graph()),
    lambda: G.sage_forward(G.init_sage_params(16, 8, 2, device="cpu"),
                           np.zeros((4, 16), np.float32), _host_graph()),
    lambda: K.IvfIndex(np.zeros((8, 4), np.float32)),
    lambda: SIM.similarity_matrix(_host_graph()),
    lambda: VS.search(CooSource([0], [1], 2, properties={
        "v": np.ones((2, 3))}), "v", [1.0, 0.0, 0.0], 1),
    lambda: SM.node_similarity_all(CooSource([0], [1], 2), "jaccard"),
    lambda: UM.kmeans_get_clusters(CooSource([0], [1], 2, properties={
        "v": np.ones((2, 3))}), "v", 1),
    lambda: ML.load_parameters(CooSource([0], [1], 2), "link_prediction",
                               []),
    lambda: G.train_link_prediction(_host_graph(), epochs=1),
    lambda: G.train_node_classification(_host_graph(), [0], [1], epochs=1),
    lambda: ML.link_prediction_train(CooSource([0], [1], 2)),
    lambda: W.random_walks(_host_graph(), [0], 3),
    lambda: N2V_MODEL.Node2Vec().fit(_host_graph()),
    lambda: N2V_MODEL.init_params(4, 2),
    lambda: N2V.random_walks(CooSource([0], [1], 2), [0]),
    lambda: N2V.get_embeddings(CooSource([0], [1], 2)),
])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_node2vec_procedures_give_the_references_shapes_and_gids(db):
    storage, ictx, gids = db
    want = rows(ictx, "CALL node2vec.get_embeddings(8, 5, 2, 1.0, 1.0, 2, "
                      "1) YIELD node, embedding RETURN id(node), embedding")
    got = port(storage, N2V.get_embeddings, 8, 5, 2, 1.0, 1.0, 2, 1,
               cache=GraphCache())
    assert got["node_gids"].tolist() == [int(r[0]) for r in want]
    assert got["embedding"].shape == (len(want), 8) == (N, 8)
    assert got["embedding"].dtype == np.float32
    assert np.isfinite(got["embedding"]).all()

    want = rows(ictx, "CALL node2vec.set_embeddings('n2v', 4, 5, 1, 1) "
                      "YIELD nodes_updated RETURN nodes_updated")
    got = port(storage, N2V.set_embeddings, "n2v", 4, 5, 1, 1,
               cache=GraphCache())
    assert got["nodes_updated"].tolist() == [want[0][0]] == [N]
    assert got["property"] == "n2v" and got["embedding"].shape == (N, 4)
    acc = storage.access()
    try:
        pid = storage.property_mapper.name_to_id("n2v")
        written = [acc.find_vertex(g, View.OLD).get_property(pid, View.OLD)
                   for g in got["node_gids"].tolist()]
    finally:
        acc.abort()
    assert all(len(w) == 4 for w in written)

    starts = [gids[0], gids[7], gids[50], -3]
    want = rows(ictx, "MATCH (n) WHERE id(n) IN $s WITH collect(n) AS ns "
                      "CALL node2vec.random_walks(ns, 6, 0.5, 2.0, 3) "
                      "YIELD walk RETURN [v IN walk | id(v)]",
                {"s": starts})
    got = port(storage, N2V.random_walks, starts, 6, 0.5, 2.0, 3,
               cache=GraphCache())
    assert got["walk"].shape == (3, 7) and len(want) == 3
    assert got["walk"].dtype == np.int64
    assert sorted(got["walk"][:, 0].tolist()) == \
        sorted(r[0][0] for r in want) == sorted(starts[:3])
    assert all(len(r[0]) == 7 for r in want)
    acc = storage.access()
    try:
        edges = {(e.from_vertex().gid, e.to_vertex().gid)
                 for g in gids for e in acc.find_vertex(g, View.OLD)
                 .out_edges(View.OLD)}
    finally:
        acc.abort()
    outs = {a for a, _ in edges}
    for walk in got["walk"].tolist():
        for a, b in zip(walk, walk[1:]):
            assert (a, b) in edges or (a == b and a not in outs)
    none = port(storage, N2V.random_walks, [-3], cache=GraphCache())
    assert none["walk"].shape == (0, 11)
