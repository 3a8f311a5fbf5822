"""Host results of the GNN procedures, from a storage snapshot.

Port of the compute half of memgraph_tpu/procedures/ml_modules.py:
``link_prediction.train``, ``predict``, ``recommend`` and
``get_training_results``; ``node_classification.train``, ``predict``
and ``get_training_data``; ``set_model_parameters`` and
``reset_parameters`` of both.  A slot holds the configuration (the
reference's ``_DEFAULTS``), the parameters (a SAGE model, ops/gnn.py),
the features, the snapshot they were bound to, the training history and
the cached forward pass (``emb``), whose lifetime is the parameters'.

``train`` trains on the source's current snapshot (ops/gnn.py's
trainers, seed 0, the slot's configuration) on the configured vertex
property's features, else ``degree_features``; node classification's
labels are the integer values of the target property (default
``label``) and the nodes that carry one.  ``predict`` / ``recommend``
train where the reference trains: when the slot has no parameters, or
its snapshot is not the current one, unless the change log records no
changed vertex since the binding (a storage's abort and every commit
bump the version with an empty change set), where the slot moves to the
new snapshot and keeps its ``emb``.  ``load_parameters`` binds given
parameters (a SAGE model, or the reference's ``[(W_self, W_neigh, b)]``)
to the current snapshot instead.  ``ModelRegistry`` keeps the slots of
each storage (weakly); functions take it as ``models=``.  A list-valued
field (``training_results``, ``train_log``) is an object column.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..ops.csr import GLOBAL_GRAPH_CACHE, property_rows
from ..ops.gnn import SAGE, _edge_scores, degree_features, \
    sage_params_from_jax, train_link_prediction, train_node_classification
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


class ModelSlot:
    def __init__(self):
        self.lock = threading.Lock()
        self.config = dict(_DEFAULTS)
        self.params = None
        self.feats = None
        self.graph = None
        self.version = None       # the source's version when bound
        self.emb = None           # the cached forward; the params' lifetime
        self.n_classes = None
        self.history = []

    def invalidate(self):
        self.params = None
        self.emb = None
        self.history = []


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
        _bind(slot, graph, source.version, model, feats)
        slot.history = []       # no training made these parameters
    return slot


def _bind(slot, graph, version, params, feats):
    slot.params, slot.feats, slot.graph = params, feats, graph
    slot.version = version
    slot.emb = None


def _train_lp(source, slot, cache, device) -> list:
    """Train the link-prediction slot on the current snapshot; its
    history.  The caller holds the slot's lock."""
    graph = cache.get(source, device=device)
    if graph.n_edges == 0:
        raise ProcedureError("link_prediction.train needs at least one edge")
    cfg = slot.config
    feats = _features(source, graph, cfg["node_features_property"])
    model, feats, history = train_link_prediction(
        graph, feats=feats, hidden_dim=int(cfg["hidden_features_size"]),
        out_dim=int(cfg["out_features_size"]),
        n_layers=int(cfg["num_layers"]), epochs=int(cfg["num_epochs"]),
        lr=float(cfg["learning_rate"]))
    _bind(slot, graph, source.version, model, feats)
    slot.history = history
    return history


def _labels(source, graph, target):
    """(dense indices, labels) of the snapshot's nodes whose ``target``
    property is an integer (not a bool)."""
    values = source.vertex_property(target, graph.node_gids)
    if values is None:
        raise ProcedureError(
            f"no node carries the target property {target!r}")
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        idx = np.arange(len(values))
        labels = values.astype(np.int64)
    else:
        idx = [i for i, v in enumerate(values)
               if isinstance(v, (int, np.integer))
               and not isinstance(v, (bool, np.bool_))]
        labels = np.asarray([int(values[i]) for i in idx], dtype=np.int64)
        idx = np.asarray(idx, dtype=np.int64)
    if len(labels) == 0:
        raise ProcedureError(
            f"no node carries an integer {target!r} property")
    return idx, labels


def _train_nc(source, slot, cache, device) -> list:
    """Train the node-classification slot on the current snapshot; its
    history.  The caller holds the slot's lock."""
    graph = cache.get(source, device=device)
    cfg = slot.config
    label_idx, labels = _labels(source, graph,
                                cfg["target_property"] or "label")
    feats = _features(source, graph, cfg["node_features_property"])
    model, feats, n_classes, history = train_node_classification(
        graph, label_idx, labels, feats=feats,
        hidden_dim=int(cfg["hidden_features_size"]),
        n_layers=int(cfg["num_layers"]), epochs=int(cfg["num_epochs"]),
        lr=float(cfg["learning_rate"]))
    _bind(slot, graph, source.version, model, feats)
    slot.n_classes = n_classes
    slot.history = history
    return history


_TRAIN = {"link_prediction": _train_lp, "node_classification": _train_nc}


def _embeddings(source, slot, name, cache, device):
    """The snapshot and the slot's forward pass on it (cached), trained
    first where the reference trains (no parameters, or another
    snapshot); the caller holds the slot's lock.  A later version whose
    change log records no changed vertex since the binding holds the
    same graph and features: the slot moves to its snapshot and keeps its
    ``emb``."""
    graph = cache.get(source, device=device)
    if slot.params is not None and slot.graph is not graph:
        version = source.version
        changed = source.changes_between(slot.version, version)
        if (isinstance(changed, frozenset) and not changed
                and version >= slot.version
                and graph.device == slot.graph.device):
            slot.graph, slot.version = graph, version
    if slot.params is None or slot.graph is not graph:
        _TRAIN[name](source, slot, cache, device)
        graph = slot.graph
    if slot.emb is None:
        slot.emb = slot.params(slot.feats, graph)
    return graph


def _objects(*values) -> np.ndarray:
    """An object column of ``values`` (lists and dicts kept whole)."""
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _history_rows(history) -> dict:
    """node_classification's records: a row an epoch."""
    return {"epoch": np.asarray([h["epoch"] for h in history],
                                dtype=np.int64),
            "loss": np.asarray([h["loss"] for h in history]),
            "val_loss": np.asarray([h["loss"] for h in history]),
            "train_log": _objects(*history), "val_log": _objects(*history)}


def _trained_history(slot) -> list:
    if not slot.history:
        raise ProcedureError("model is not trained yet")
    return list(slot.history)


def link_prediction_train(source, *, models=GLOBAL_MODELS,
                          cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``link_prediction.train``: training_results (the history, a dict
    an epoch), validation_results (the last epoch's) — one record."""
    slot = models.slot(source, "link_prediction")
    with slot.lock:
        history = _train_lp(source, slot, cache, device)
    return {"training_results": _objects(history),
            "validation_results": _objects([history[-1]])}


def link_prediction_get_training_results(source, *, models=GLOBAL_MODELS
                                         ) -> dict:
    """``link_prediction.get_training_results``: the last training's
    record, as ``train`` gave it."""
    slot = models.slot(source, "link_prediction")
    with slot.lock:
        history = _trained_history(slot)
    return {"training_results": _objects(history),
            "validation_results": _objects([history[-1]])}


def node_classification_train(source, *, models=GLOBAL_MODELS,
                              cache=GLOBAL_GRAPH_CACHE, device=None) -> dict:
    """``node_classification.train``: epoch, loss, val_loss, train_log,
    val_log — a record an epoch."""
    slot = models.slot(source, "node_classification")
    with slot.lock:
        history = _train_nc(source, slot, cache, device)
    return _history_rows(history)


def node_classification_get_training_data(source, *, models=GLOBAL_MODELS
                                          ) -> dict:
    """``node_classification.get_training_data``: the last training's
    records, as ``train`` gave them."""
    slot = models.slot(source, "node_classification")
    with slot.lock:
        history = _trained_history(slot)
    return _history_rows(history)


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
        graph = _embeddings(source, slot, "link_prediction", cache, device)
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
        graph = _embeddings(source, slot, "link_prediction", cache, device)
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
        graph = _embeddings(source, slot, "node_classification", cache,
                            device)
        cls = int(torch.argmax(slot.emb[_index(graph, vertex)]))
    return {"node_gids": np.asarray([vertex], dtype=np.int64),
            "predicted_class": np.asarray([cls], dtype=np.int64),
            "status": np.asarray(["ok"])}

