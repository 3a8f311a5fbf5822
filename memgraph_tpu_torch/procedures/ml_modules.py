"""Host results of the GNN procedures' serving compute, from a storage
snapshot.

Port of the compute half of memgraph_tpu/procedures/ml_modules.py:
``link_prediction.predict``, ``link_prediction.recommend`` and
``node_classification.predict`` over a model slot, with
``set_model_parameters`` and ``reset_parameters``.  A slot holds the
configuration (the reference's ``_DEFAULTS``), the parameters (a SAGE
model, ops/gnn.py), the features, the snapshot they were bound to and
the cached forward pass (``emb``), whose lifetime is the parameters'.

Training is not ported: parameters come in through ``load_parameters``
(a SAGE model, or the reference's ``[(W_self, W_neigh, b)]``), which
binds them to the source's current snapshot and computes the features
(the configured vertex property, else ``degree_features``).  Where the
reference would train (no parameters yet, or a snapshot other than the
bound one, unless the change log records no change since the binding)
the port raises ``TrainingNotPorted``, and never serves an ``emb`` of
another graph.  ``ModelRegistry`` keeps the slots of each
storage (weakly); functions take it as ``models=``.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..ops.csr import GLOBAL_GRAPH_CACHE, property_rows
from ..ops.gnn import SAGE, _edge_scores, degree_features, \
    sage_params_from_jax
from . import ProcedureError

_DEFAULTS = {
    "hidden_features_size": 64,
    "out_features_size": 32,
    "num_epochs": 30,
    "learning_rate": 0.01,
    "num_layers": 2,
    "node_features_property": "",
    "target_property": "",   # node_classification label property
}

_INT_PARAMS = {"hidden_features_size", "out_features_size", "num_epochs",
               "num_layers"}


class TrainingNotPorted(ProcedureError):
    """The call needs a model trained on the current snapshot, which the
    reference would train here; training is not yet ported."""


class ModelSlot:
    def __init__(self):
        self.lock = threading.Lock()
        self.config = dict(_DEFAULTS)
        self.params = None
        self.feats = None
        self.graph = None
        self.version = None       # the source's version when bound
        self.emb = None           # the cached forward; the params' lifetime

    def invalidate(self):
        self.params = None
        self.emb = None


class ModelRegistry:
    """The model slots of each storage (weakly), by name
    ("link_prediction", "node_classification")."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots = weakref.WeakKeyDictionary()

    def slot(self, source, name: str) -> ModelSlot:
        with self._lock:
            per = self._slots.get(source.storage)
            if per is None:
                per = self._slots[source.storage] = {}
            if name not in per:
                per[name] = ModelSlot()
            return per[name]


GLOBAL_MODELS = ModelRegistry()


def _validate_parameters(parameters):
    unknown = set(parameters or {}) - set(_DEFAULTS)
    if unknown:
        raise ProcedureError(f"unknown model parameters: {sorted(unknown)}")
    for key, value in (parameters or {}).items():
        if key in _INT_PARAMS:
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value <= 0:
                raise ProcedureError(f"{key} must be a positive integer")
        elif key == "learning_rate":
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool) or value <= 0:
                raise ProcedureError("learning_rate must be positive")
        elif not isinstance(value, str):
            raise ProcedureError(f"{key} must be a string")


def _features(source, graph, prop_name):
    """The (n_pad, d) f32 features of a numeric list property on every
    node of the snapshot, on the snapshot's device, or None for no
    property (the degree features serve)."""
    if not prop_name:
        return None
    values = source.vertex_property(prop_name, graph.node_gids)
    if values is None:
        raise ProcedureError(f"unknown feature property {prop_name!r}")
    rows, kept = property_rows(values)
    if rows is None or not kept.all():
        # the reference's checks and conversion, value by value
        rows, dim = [], None
        for val in values:
            if not isinstance(val, (list, tuple)):
                raise ProcedureError(
                    f"node feature property {prop_name!r} must be a "
                    f"numeric list on every node")
            if dim is None:
                dim = len(val)
            if len(val) != dim:
                raise ProcedureError(
                    f"node feature property {prop_name!r} has inconsistent "
                    f"dimensions")
            rows.append([float(x) for x in val])
        rows = np.asarray(rows, dtype=np.float32).reshape(len(rows), dim)
    feats = np.zeros((graph.n_pad, rows.shape[1]), dtype=np.float32)
    feats[:graph.n_nodes] = rows
    return torch.from_numpy(feats).to(graph.device)


def set_model_parameters(source, name, parameters, *, models=GLOBAL_MODELS):
    """``<name>.set_model_parameters``: status, message.  The slot's
    parameters (and cached embeddings) are dropped."""
    slot = models.slot(source, name)
    _validate_parameters(parameters)
    with slot.lock:
        slot.config.update(parameters or {})
        slot.invalidate()
    return {"status": np.asarray([True]),
            "message": np.asarray(["Model parameters updated. Train to "
                                   "apply."])}


def reset_parameters(source, name, *, models=GLOBAL_MODELS):
    """``link_prediction.reset_parameters`` / ``node_classification.reset``:
    status — the defaults again, no parameters."""
    slot = models.slot(source, name)
    with slot.lock:
        slot.config = dict(_DEFAULTS)
        slot.invalidate()
    return {"status": np.asarray(["Parameters and model reset."
                                  if name == "link_prediction"
                                  else "Model reset."])}


def load_parameters(source, name, params, *, models=GLOBAL_MODELS,
                    cache=GLOBAL_GRAPH_CACHE, device=None) -> ModelSlot:
    """Bind trained parameters (a SAGE model, or the reference's
    ``[(W_self, W_neigh, b)]``) to the slot ``name`` and the source's
    current snapshot, with the configured features."""
    slot = models.slot(source, name)
    with slot.lock:
        graph = cache.get(source, device=device)
        feats = _features(source, graph, slot.config["node_features_property"])
        if feats is None:
            feats = degree_features(graph)
        model = params if isinstance(params, SAGE) \
            else sage_params_from_jax(params, graph.device)
        model = model.to(graph.device)
        if model.dims[0] != feats.shape[1]:
            raise ProcedureError(
                f"the parameters take {model.dims[0]} input features, the "
                f"snapshot gives {feats.shape[1]}")
        slot.params, slot.feats, slot.graph = model, feats, graph
        slot.version = source.version
        slot.emb = None
    return slot


def _embeddings(source, slot, cache, device):
    """The snapshot and the slot's forward pass on it (cached); the
    caller holds the slot's lock.  A later version whose change log
    records no changed vertex since the binding holds the same graph and
    features: the slot moves to its snapshot and keeps its ``emb``."""
    graph = cache.get(source, device=device)
    if slot.params is None:
        raise TrainingNotPorted(
            "the model has no parameters: training is not yet ported; "
            "load trained parameters with load_parameters")
    if slot.graph is not graph:
        version = source.version
        changed = source.changes_between(slot.version, version)
        if not (isinstance(changed, frozenset) and not changed
                and version >= slot.version
                and graph.device == slot.graph.device):
            slot.emb = None
            raise TrainingNotPorted(
                "the graph changed since the parameters were loaded: the "
                "reference retrains here, and training is not yet ported")
        slot.graph, slot.version = graph, version
    if slot.emb is None:
        slot.emb = slot.params(slot.feats, graph)
    return graph


def _index(graph, gid) -> int:
    idx = graph.gid_to_idx.get(gid) if gid is not None else None
    if idx is None:
        raise ProcedureError("vertex is not part of the graph")
    return idx


def link_prediction_predict(source, src_vertex, dest_vertex, *,
                            models=GLOBAL_MODELS, cache=GLOBAL_GRAPH_CACHE,
                            device=None) -> dict:
    """``link_prediction.predict``: score, the sigmoid of the embeddings'
    dot product of the vertices with gids ``src_vertex`` and
    ``dest_vertex``."""
    slot = models.slot(source, "link_prediction")
    with slot.lock:
        graph = _embeddings(source, slot, cache, device)
        src, dst = _index(graph, src_vertex), _index(graph, dest_vertex)
        score = torch.sigmoid(_edge_scores(slot.emb, [src], [dst]))[0]
    return {"score": np.asarray([float(score)])}


def link_prediction_recommend(source, src_vertex, dest_vertexes, k, *,
                              models=GLOBAL_MODELS, cache=GLOBAL_GRAPH_CACHE,
                              device=None) -> dict:
    """``link_prediction.recommend``: score, recommendation (``node_gids``)
    — the k best-scored of the gids ``dest_vertexes`` (those outside the
    snapshot dropped) for the vertex with gid ``src_vertex``."""
    slot = models.slot(source, "link_prediction")
    with slot.lock:
        graph = _embeddings(source, slot, cache, device)
        src = _index(graph, src_vertex)
        keep = [g for g in dest_vertexes
                if g is not None and g in graph.gid_to_idx]
        if not keep:
            return {"node_gids": np.zeros(0, dtype=np.int64),
                    "score": np.zeros(0, dtype=np.float32)}
        dsts = [graph.gid_to_idx[g] for g in keep]
        scores = torch.sigmoid(_edge_scores(
            slot.emb, [src] * len(dsts), dsts)).cpu().numpy()
    order = np.argsort(-scores)[:max(0, int(k))]
    return {"node_gids": np.asarray(keep, dtype=np.int64)[order],
            "score": scores[order]}


def node_classification_predict(source, vertex, *, models=GLOBAL_MODELS,
                                cache=GLOBAL_GRAPH_CACHE,
                                device=None) -> dict:
    """``node_classification.predict``: predicted_class (the largest
    logit's, the first on a tie), status, of the vertex with gid
    ``vertex``."""
    slot = models.slot(source, "node_classification")
    with slot.lock:
        graph = _embeddings(source, slot, cache, device)
        cls = int(torch.argmax(slot.emb[_index(graph, vertex)]))
    return {"node_gids": np.asarray([vertex], dtype=np.int64),
            "predicted_class": np.asarray([cls], dtype=np.int64),
            "status": np.asarray(["ok"])}

