"""Host results of the node2vec procedures, from a storage snapshot.

Port of the compute half of memgraph_tpu/procedures/node2vec_module.py:
``node2vec.get_embeddings``, ``node2vec.set_embeddings`` and
``node2vec.random_walks``, in the style of ``graph_algorithms``: each
function takes a source (ops/csr.py), the procedure's arguments with its
defaults, the snapshot ``cache`` and the ``device``, and returns host
columns by gid.  Walks (ops/walks.py) and the skip-gram trainer
(models/node2vec.py) run on the snapshot's device.

The storage belongs to its own package, so ``set_embeddings`` writes
nothing: it returns the record (``nodes_updated``) and the rows it would
write (``node_gids`` and ``embedding``, under ``property``); the caller
sets each vertex's property to its row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.node2vec import Node2Vec, Node2VecConfig
from ..ops.csr import GLOBAL_GRAPH_CACHE
from ..ops.walks import random_walks as _walks


def _embeddings(graph, cfg: Node2VecConfig) -> dict:
    emb = Node2Vec(cfg).fit(graph)
    return {"node_gids": np.asarray(graph.node_gids, dtype=np.int64),
            "embedding": emb.cpu().numpy()}


def get_embeddings(source, dimensions=128, walk_length=20, walks_per_node=4,
                   p=1.0, q=1.0, window=5, epochs=3, learning_rate=0.01, *,
                   cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``node2vec.get_embeddings``: node (``node_gids``), embedding — an
    (n, dimensions) float32 row a node."""
    graph = cache.get(source, device=device)
    if graph.n_nodes == 0:
        return {"node_gids": np.zeros(0, dtype=np.int64),
                "embedding": np.zeros((0, int(dimensions)), np.float32)}
    return _embeddings(graph, Node2VecConfig(
        embedding_dim=int(dimensions), walk_length=int(walk_length),
        walks_per_node=int(walks_per_node), p=float(p), q=float(q),
        window=int(window), epochs=int(epochs),
        learning_rate=float(learning_rate)))


def set_embeddings(source, property="embedding", dimensions=128,
                   walk_length=20, walks_per_node=4, epochs=3, *,
                   cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``node2vec.set_embeddings``: nodes_updated (one record), and the
    writes for the caller to make: ``property`` := each row of
    ``embedding`` on the vertex of ``node_gids``."""
    graph = cache.get(source, device=device)
    rows = {"node_gids": np.zeros(0, dtype=np.int64),
            "embedding": np.zeros((0, int(dimensions)), np.float32)}
    if graph.n_nodes:
        rows = _embeddings(graph, Node2VecConfig(
            embedding_dim=int(dimensions), walk_length=int(walk_length),
            walks_per_node=int(walks_per_node), epochs=int(epochs)))
    return {"nodes_updated": np.asarray([len(rows["node_gids"])],
                                        dtype=np.int64),
            "property": str(property), **rows}


def random_walks(source, start_nodes, length=10, p=1.0, q=1.0, seed=0, *,
                 cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``node2vec.random_walks``: walk — a record a start node that the
    snapshot holds (the others dropped), each a row of length + 1 gids,
    the start first; drawn from a generator seeded with ``seed``."""
    graph = cache.get(source, device=device)
    starts = [graph.gid_to_idx[g] for g in start_nodes
              if g is not None and g in graph.gid_to_idx]
    if graph.n_nodes == 0 or not starts:
        return {"walk": np.zeros((0, int(length) + 1), dtype=np.int64)}
    gen = torch.Generator(device=graph.device).manual_seed(int(seed))
    walks = _walks(graph, starts, int(length), gen, p=float(p), q=float(q))
    gids = np.asarray(graph.node_gids, dtype=np.int64)
    return {"walk": gids[walks.cpu().numpy()]}
