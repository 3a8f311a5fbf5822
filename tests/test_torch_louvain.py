"""The port's Louvain (memgraph_tpu_torch/ops/louvain.py) against the JAX
package's (memgraph_tpu/ops/louvain.py) on the same seeded edges, and
the port's ``community_detection.louvain`` and
``leiden_community_detection.get`` against the JAX interpreter's CALLs
on one storage, gid by gid.

Louvain is a host algorithm in both packages: the communities must be
equal and the modularity equal within 1e-12 (the port sums in the same
order; the native move loop and its python plain version both).
"""

import numpy as np
import pytest

from memgraph_tpu.ops import louvain as JL
from memgraph_tpu.ops.csr import from_coo as jfrom_coo
from memgraph_tpu_torch.ops import louvain as TL
from memgraph_tpu_torch.ops.csr import GraphCache
from memgraph_tpu_torch.ops.csr import from_coo as tfrom_coo
from memgraph_tpu_torch.ops.native import get_louvain
from memgraph_tpu_torch.procedures import combinatorial_modules as CM
from memgraph_tpu_torch.procedures import structure_modules as SM

from test_torch_procedures import cypher, db, port  # noqa: F401

import torch

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

MOD_TOL = 1e-12


def _edges(case: str, seed: int):
    """(src, dst, weights or None, n_nodes) of a seeded case."""
    rng = np.random.default_rng(seed)
    if case == "one_node":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), None, 1
    if case == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), None, 30
    n, e = 200, 900
    src = rng.integers(0, n, e)
    dst = (rng.random(e) ** 2 * n).astype(np.int64)
    w = None
    if case == "weighted":
        w = rng.uniform(0.1, 3.0, e).astype(np.float32)
    elif case == "self_loops":
        src[::7] = dst[::7]
    elif case == "disconnected":
        # three islands of different sizes, no edge between them
        cut = np.array([0, 40, 110, n])
        part = rng.integers(0, 3, e)
        lo, hi = cut[part], cut[part + 1]
        src = lo + rng.integers(0, 1 << 30, e) % (hi - lo)
        dst = lo + rng.integers(0, 1 << 30, e) % (hi - lo)
    return src, dst, w, n


def _both(src, dst, w, n):
    return (JL.louvain(jfrom_coo(src, dst, w, n_nodes=n)),
            TL.louvain(tfrom_coo(src, dst, w, n_nodes=n)))


@pytest.mark.parametrize("case", ["plain", "weighted", "self_loops",
                                  "disconnected", "one_node", "empty"])
@pytest.mark.parametrize("seed", [3, 11])
def test_louvain_equals_the_reference(case, seed):
    (want, want_q), (got, got_q) = _both(*_edges(case, seed))
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert abs(got_q - want_q) <= MOD_TOL


def test_the_native_move_loop_is_built_here():
    assert get_louvain() is not None


@pytest.mark.parametrize("case", ["plain", "weighted", "self_loops"])
def test_python_move_loop_equals_the_native_one(case):
    src, dst, w, n = _edges(case, 5)
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    ww = np.concatenate([w, w]).astype(np.float64) if w is not None \
        else np.ones(len(s))
    want = TL._one_level(n, s, d, ww, 1e-7, 0, native=False)
    got = TL._one_level(n, s, d, ww, 1e-7, 0, native=True)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_louvain_on_a_graph_on_the_cpu_device():
    src, dst, w, n = _edges("weighted", 2)
    want = JL.louvain(jfrom_coo(src, dst, w, n_nodes=n))
    got = TL.louvain(tfrom_coo(src, dst, w, n_nodes=n).to_device("cpu"))
    assert np.array_equal(got[0], want[0]) and abs(got[1] - want[1]) <= \
        MOD_TOL


def test_an_empty_graph_has_no_community():
    got = TL.louvain(tfrom_coo(np.zeros(0), np.zeros(0), n_nodes=0))
    assert got[0].shape == (0,) and got[1] == 0.0


@pytest.mark.parametrize("weighted", [False, True])
def test_community_detection_louvain(db, weighted):
    storage, ictx, cache, _ = db
    args = "'weight'" if weighted else ""
    want = cypher(ictx, f"CALL community_detection.louvain({args}) "
                        "YIELD node, community_id, modularity "
                        "RETURN id(node), community_id, modularity")
    got = port(storage, cache, SM.community_detection_louvain,
               weight_property="weight" if weighted else None)
    assert set(got) == set(want)
    for gid, (cid, q) in want.items():
        assert got[gid][0] == cid
        assert abs(got[gid][1] - q) <= MOD_TOL
    ids = sorted({r[0] for r in got.values()})
    assert ids == list(range(1, len(ids) + 1))


@pytest.mark.parametrize("weighted", [False, True])
def test_leiden_community_detection_get(db, weighted):
    storage, ictx, cache, _ = db
    args = "'weight'" if weighted else ""
    want = cypher(ictx, f"CALL leiden_community_detection.get({args}) "
                        "YIELD node, community_id, communities "
                        "RETURN id(node), community_id, communities")
    got = port(storage, cache, CM.leiden_get,
               weight_property="weight" if weighted else None)
    assert set(got) == set(want)
    for gid, (cid, comms) in want.items():
        assert got[gid][0] == cid
        assert got[gid][1].tolist() == comms


def test_community_procedures_on_an_empty_storage():
    from memgraph_tpu.storage import InMemoryStorage
    from test_torch_snapshot import StorageSource
    storage = InMemoryStorage()
    acc = storage.access()
    for fn in (SM.community_detection_louvain, CM.leiden_get):
        out = fn(StorageSource(acc), cache=GraphCache(), device="cpu")
        assert all(len(v) == 0 for v in out.values())
    acc.abort()
