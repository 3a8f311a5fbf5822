"""The north-star graph and its refresh mutation, made from seeds.

``generate_graph``: a skewed random digraph (heavy-tail in-degree by
squared sampling of destinations), 1,000,000 nodes and 10,000,000 edges
from seed 7 (``GRAPH_SEED``), as ``bench.py`` builds it.  ``mutate``: the
commit that a snapshot refresh serves (seed 11).  Used by
``chip_smoke.py`` and ``trace_pagerank``.
"""

from __future__ import annotations

import numpy as np

N_NODES = 1_000_000
N_EDGES = 10_000_000
GRAPH_SEED = 7
REFRESH_SEED = 11
REFRESH_MOVES = 5_000        # edges removed uniformly, and edges added
REFRESH_NODES = 8            # nodes made dangling, and dangling nodes fed


def generate_graph(n_nodes=N_NODES, n_edges=N_EDGES):
    """(src, dst) int64: src uniform, dst = rand**2 * n."""
    rng = np.random.default_rng(GRAPH_SEED)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    dst = (rng.random(n_edges) ** 2 * n_nodes).astype(np.int64)
    return src, dst


def mutate(src, dst, n_nodes):
    """The refresh mutation, from ``REFRESH_SEED``: remove
    ``REFRESH_MOVES`` existing edges drawn uniformly, add as many edges
    (src uniform, dst from the graph's own skew rand**2 * n), remove every
    out-edge of ``REFRESH_NODES`` nodes (they become dangling) and add one
    out-edge to each of as many nodes that had none.  Returns the mutated
    COO and the dense ids of the nodes whose out-edges changed."""
    rng = np.random.default_rng(REFRESH_SEED)
    moves, nodes = REFRESH_MOVES, REFRESH_NODES
    E = len(src)
    out_deg = np.bincount(src, minlength=n_nodes)
    drop = np.zeros(E, dtype=bool)
    drop[rng.choice(E, moves, replace=False)] = True
    emptied = rng.choice(np.flatnonzero(out_deg > 0), nodes, replace=False)
    drop |= np.isin(src, emptied)
    fed = rng.choice(np.flatnonzero(out_deg == 0), nodes, replace=False)
    add_src = np.concatenate([rng.integers(0, n_nodes, moves), fed])
    add_dst = np.concatenate([
        (rng.random(moves) ** 2 * n_nodes).astype(np.int64),
        rng.integers(0, n_nodes, nodes)])
    src2 = np.concatenate([src[~drop], add_src])
    dst2 = np.concatenate([dst[~drop], add_dst])
    changed = np.unique(np.concatenate([src[drop], add_src]))
    return src2, dst2, changed
