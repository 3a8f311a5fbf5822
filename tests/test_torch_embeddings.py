"""The port's node text embeddings (memgraph_tpu_torch/procedures/
embeddings_module.py) against the JAX package's (memgraph_tpu/procedures/
embeddings_module.py).

``build_text`` and ``_hash_tokens`` are copies and must agree exactly;
the chunk counts equal the reference's loop.  ``hashing_encode`` with the
reference's projection carried across (drawn here by the reference's own
``jax.random`` call) holds within 1e-6 of the reference's rows (f32
rounding of one (B, 2^14) x (2^14, D) product and a norm; entries are at
most 1).  The port's own projection is held to unit norms (1e-6), to
determinism and to equal text giving an equal vector.  The procedures run
on one JAX storage (vertices with labels and properties of several kinds),
the reference's through Cypher.  The ``model`` switch is tested only for
its typed refusal: nothing may be fetched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memgraph_tpu.procedures import embeddings_module as JE
from memgraph_tpu.query.interpreter import Interpreter, InterpreterContext
from memgraph_tpu.storage import InMemoryStorage
from memgraph_tpu_torch.northstar import CooSource
from memgraph_tpu_torch.procedures import ProcedureError
from memgraph_tpu_torch.procedures import embeddings_module as TE
from test_torch_snapshot import StorageSource

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

D, BS = 32, 16
WORDS = ["alpha", "beta", "gamma", "delta", "Graph", "node", "x", "ab",
         "Ünïcode", "tpu-card", "42"]


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(0, 6)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def ref_projection():
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(JE._SEED), (JE._N_FEATURES, D),
        dtype=jnp.float32) / np.sqrt(D))


def test_build_text_and_hash_tokens_equal():
    props = {"name": "Ada", "age": 36, "tags": ["a", "b"], "none": None,
             "skip": 1, "score": 0.5}
    for labels in ([], ["Person"], ["Person", "Admin"]):
        for excluded in (set(), {"skip"}, {"skip", "name"}):
            assert TE.build_text(None, labels, props, excluded) == \
                JE.build_text(None, labels, props, excluded)
    for t in _texts(50) + ["", "  spaced   out  ", "ab", "ÄÖÜ ß"]:
        assert TE._hash_tokens(t) == JE._hash_tokens(t)


def test_chunk_counts_equal_the_reference_loop():
    texts = _texts(BS - 3, seed=1)
    want = np.zeros((BS, TE._N_FEATURES), dtype=np.float32)
    for i, t in enumerate(texts):
        for fid in JE._hash_tokens(t):
            want[i, fid] += 1.0
    np.testing.assert_array_equal(TE.chunk_counts(texts, BS), want)


def test_hashing_encode_with_the_reference_projection(ref_projection):
    texts = _texts(3 * BS + 5, seed=2)
    want = JE.hashing_encode(texts, D, BS)
    got = TE.hashing_encode(texts, D, BS, projection=ref_projection,
                            device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_own_projection_unit_norms_and_determinism():
    texts = _texts(2 * BS + 1, seed=3) + ["alpha beta", "alpha beta"]
    a = TE.hashing_encode(texts, D, BS, device="cpu")
    b = TE.hashing_encode(texts, D, BS, device="cpu")
    assert np.array_equal(a, b)
    norms = np.linalg.norm(a.astype(np.float64), axis=1)
    nonempty = np.asarray([bool(t.split()) for t in texts])
    np.testing.assert_allclose(norms[nonempty], 1.0, atol=1e-6)
    assert not a[~nonempty].any()         # no token: the 1e-12 floor
    assert np.array_equal(a[-1], a[-2])
    same = [i for i, t in enumerate(texts) if t == "alpha beta"]
    assert all(np.array_equal(a[i], a[-1]) for i in same)
    proj = TE.default_projection(D, "cpu")
    assert tuple(proj.shape) == (TE._N_FEATURES, D)
    assert abs(float(proj.std()) * np.sqrt(D) - 1.0) < 0.01


def _storage():
    storage = InMemoryStorage()
    acc = storage.access()
    pm, lm = storage.property_mapper, storage.label_mapper
    rng = np.random.default_rng(7)
    for i in range(40):
        v = acc.create_vertex()
        for lb in rng.choice(["Person", "City", "Tag"], rng.integers(0, 3),
                             replace=False):
            v.add_label(lm.name_to_id(str(lb)))
        v.set_property(pm.name_to_id("name"), " ".join(
            rng.choice(WORDS, rng.integers(1, 4))))
        if i % 3:
            v.set_property(pm.name_to_id("age"), int(rng.integers(0, 90)))
        if i % 4 == 0:
            v.set_property(pm.name_to_id("tags"), ["x", "ab"])
    acc.commit()
    return storage


@pytest.fixture(scope="module")
def db(ref_projection):
    """The port's procedures, then the reference's ``CALL``s (which
    write ``embedding``), on one storage."""
    storage = _storage()
    acc = storage.access()
    source = StorageSource(acc)
    cfg = {"dimension": D, "batch_size": BS}
    got = TE.compute_embeddings(source, cfg, device="cpu",
                                projection=ref_projection)
    sentences = TE.node_sentence(source)
    acc.commit()
    interp = Interpreter(InterpreterContext(storage))
    want_sent = interp.execute(
        "CALL embeddings.node_sentence() YIELD node, sentence "
        "RETURN id(node), sentence")[1]
    want = interp.execute(
        "CALL embeddings.compute_embeddings({dimension: 32, batch_size: "
        "16}) YIELD success, count, dimension RETURN success, count, "
        "dimension")[1]
    vecs = dict(interp.execute("MATCH (n) RETURN id(n), n.embedding")[1])
    return got, sentences, want, want_sent, vecs


def test_compute_embeddings_matches_the_reference(db):
    got, _, want, _, vecs = db
    assert [[bool(got["success"][0]), int(got["count"][0]),
             int(got["dimension"][0])]] == [list(r) for r in want]
    assert got["property"] == "embedding"
    assert sorted(got["node_gids"].tolist()) == sorted(vecs)
    for g, row in zip(got["node_gids"].tolist(), got["embedding"]):
        np.testing.assert_allclose(row, vecs[g], atol=1e-6, rtol=0)


def test_node_sentence_matches_the_reference(db):
    _, sentences, _, want_sent, _ = db
    assert dict(zip(sentences["node_gids"].tolist(),
                    sentences["sentence"].tolist())) == dict(want_sent)


def test_coo_source_records_have_no_labels():
    src = CooSource(np.asarray([0, 1]), np.asarray([1, 2]), 3,
                    properties={"age": np.asarray([5, 6, 7])})
    got = TE.node_sentence(src)
    assert got["sentence"].tolist() == ["age: 5", "age: 6", "age: 7"]
    out = TE.compute_embeddings(src, {"dimension": 8}, device="cpu")
    assert out["embedding"].shape == (3, 8)


def test_model_info_names_the_device():
    info = TE.model_info({"dimension": 64}, device="cpu")
    assert info["device"].tolist() == ["cpu"]
    assert info["dimension"].tolist() == [64]
    info = TE.model_info({"model": "m"}, device="cpu")
    assert info["dimension"].tolist() == [-1]
    assert info["device"].tolist() == ["cpu"]


def test_bad_sizes_refused():
    src = CooSource(np.asarray([0]), np.asarray([1]), 2)
    with pytest.raises(ProcedureError, match="must be positive"):
        TE.compute_embeddings(src, {"dimension": 0}, device="cpu")


def test_a_model_without_local_files_is_refused(monkeypatch):
    """The gated ``model`` switch loads local files only: a model this
    machine does not hold is a typed refusal, with nothing fetched."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    src = CooSource(np.asarray([0]), np.asarray([1]), 2,
                    properties={"name": np.asarray(["a", "b"])})
    with pytest.raises(ProcedureError,
                       match="no local files|not available"):
        TE.compute_embeddings(
            src, {"model": "sentence-transformers/all-MiniLM-L6-v2"},
            device="cpu")
    assert torch.is_tensor(TE.default_projection(D, "cpu"))


def test_the_model_switch_runs_on_the_card_or_raises(monkeypatch):
    """Without a card and without ``device="cpu"``, the ``model`` switch
    and ``model_info`` raise before any model is looked up: nothing
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    looked_up = []
    monkeypatch.setattr(TE, "_gather",
                        lambda *a: looked_up.append(a) or ([], []))
    src = CooSource(np.asarray([0]), np.asarray([1]), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.compute_embeddings(src, {"model": "m"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE._transformer_encode(["a"], "m", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.model_info({"model": "m"})
    assert looked_up == []
