"""Host results of the node text embedding procedures (``embeddings.*``).

Port of memgraph_tpu/procedures/embeddings_module.py: a "sentence" a
vertex from its label names and properties (``build_text``), encoded by
feature hashing (``hashing_encode``): word unigrams and character
trigrams hashed by crc32 into 2^14 counts a sentence, one (batch, 2^14)
x (2^14, D) product a chunk on the device, L2-normalized with the
reference's 1e-12 floor.  The product runs at full f32
(``device.exact_f32_matmuls``); the JAX package runs it outside any
Pallas kernel, so it stays ``torch.matmul``.  The counts of a chunk are
built on the host (vectorized; equal to the reference's loop), and every
chunk is padded to ``batch_size`` rows as the reference pads it, so that
every chunk runs one product of one shape.

The projection: N(0, 1) entries / √D, drawn on the CPU from a
``torch.Generator`` seeded with the reference's ``_SEED`` (the reference
draws ``jax.random``'s stream, which the port cannot draw); the
``projection=`` argument takes the reference's projection carried across
as numpy instead.

``compute_embeddings`` writes nothing: it returns the record and the
writes for the caller to make (``node_gids``, ``embedding`` under
``property``), as ``node2vec_module.set_embeddings`` does.  The source
gives each vertex's label names and properties through
``vertex_records`` (ops/csr.py's source protocol).  The ``model`` switch
loads a local HuggingFace model only (``local_files_only=True``) and runs
it on the same device as the hashing encoder: nothing is fetched, and a
model without local files is refused.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from ..device import exact_f32_matmuls, resolve_device
from . import ProcedureError

_N_FEATURES = 1 << 14          # hashed n-gram vocabulary
_SEED = 1234567


def build_text(vertex, label_names, prop_named, excluded) -> str:
    """Node sentence: labels + 'key: value' pairs, property-name sorted
    (the reference's; ``vertex`` is unused, as there)."""
    parts = [" ".join(label_names)]
    for key, value in sorted(prop_named.items()):
        if key in excluded or value is None:
            continue
        parts.append(f"{key}: {value}")
    return " ".join(p for p in parts if p).strip()


def _hash_tokens(text: str):
    """Word unigrams + character trigrams -> hashed feature ids."""
    ids = []
    for tok in text.lower().split():
        ids.append(zlib.crc32(tok.encode()) % _N_FEATURES)
        for i in range(len(tok) - 2):
            ids.append(zlib.crc32(tok[i:i + 3].encode("utf-8"))
                       % _N_FEATURES)
    return ids


@functools.lru_cache(maxsize=1 << 16)
def _token_ids(tok: str) -> tuple:
    """``_hash_tokens`` of one lower-cased token (sentences repeat their
    tokens: labels, property names, values)."""
    return tuple(_hash_tokens(tok))


def chunk_counts(texts, batch_size: int) -> np.ndarray:
    """The (batch_size, 2^14) float32 counts of up to ``batch_size``
    texts (rows past them zero): ``_hash_tokens`` token by token,
    memoized."""
    ids = [[f for tok in t.lower().split() for f in _token_ids(tok)]
           for t in texts]
    lengths = np.fromiter((len(i) for i in ids), dtype=np.int64,
                          count=len(ids))
    flat = np.fromiter((f for i in ids for f in i), dtype=np.int64,
                       count=int(lengths.sum()))
    rows = np.repeat(np.arange(len(ids), dtype=np.int64), lengths)
    cells, n = np.unique(rows * _N_FEATURES + flat, return_counts=True)
    counts = np.zeros((batch_size, _N_FEATURES), dtype=np.float32)
    counts.reshape(-1)[cells] = n
    return counts


_PROJECTIONS: dict = {}


def default_projection(dimension: int, device=None) -> torch.Tensor:
    """The port's own (2^14, dimension) projection on ``device`` (drawn
    once a dimension, on the CPU, so every device gets the same
    values)."""
    dev = resolve_device(device)
    key = (int(dimension), dev)
    got = _PROJECTIONS.get(key)
    if got is None:
        host = _PROJECTIONS.get((int(dimension), torch.device("cpu")))
        if host is None:
            gen = torch.Generator().manual_seed(_SEED)
            host = torch.randn(_N_FEATURES, int(dimension), generator=gen,
                               dtype=torch.float32) / float(
                                   np.sqrt(dimension))
            _PROJECTIONS[(int(dimension), torch.device("cpu"))] = host
        got = _PROJECTIONS[key] = host.to(dev)
    return got


def encode_chunk(counts: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """counts @ proj, each row L2-normalized (norm floored at 1e-12)."""
    exact_f32_matmuls()
    emb = counts @ proj
    norm = torch.linalg.norm(emb, dim=1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-12)


def hashing_encode(texts, dimension: int, batch_size: int = 2048, *,
                   projection=None, device=None) -> np.ndarray:
    """Deterministic feature-hash embedding: (len(texts), dimension)
    float32 rows of unit norm.  ``projection``: the (2^14, dimension)
    matrix to use (e.g. the reference's, as numpy); default the port's
    own.  Runs on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if projection is None:
        proj = default_projection(dimension, dev)
    else:
        proj = torch.from_numpy(np.array(projection, dtype=np.float32)
                                ).to(dev)
    out = np.zeros((len(texts), int(dimension)), dtype=np.float32)
    for lo in range(0, len(texts), batch_size):
        chunk = texts[lo:lo + batch_size]
        counts = torch.from_numpy(chunk_counts(chunk, batch_size)).to(dev)
        out[lo:lo + len(chunk)] = \
            encode_chunk(counts, proj)[:len(chunk)].cpu().numpy()
    return out


def _transformer_encode(texts, model_name, batch_size, device=None):
    """Mean-pooled, normalized hidden states of a local HuggingFace
    model, run on ``device`` (default: the card); refused
    (``ProcedureError``) when transformers is missing or the model has
    no local files.  Nothing is fetched."""
    dev = resolve_device(device)
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as e:
        raise ProcedureError(
            "embeddings: transformers/torch are not available") from e
    try:
        tok = AutoTokenizer.from_pretrained(model_name,
                                            local_files_only=True)
        model = AutoModel.from_pretrained(model_name, local_files_only=True)
    except (OSError, ValueError) as e:
        raise ProcedureError(
            f"embeddings: model {model_name!r} has no local files") from e
    model.to(dev).eval()
    outs = []
    with torch.no_grad():
        for lo in range(0, len(texts), batch_size):
            batch = tok(texts[lo:lo + batch_size], padding=True,
                        truncation=True, return_tensors="pt").to(dev)
            hidden = model(**batch).last_hidden_state
            mask = batch["attention_mask"].unsqueeze(-1)
            emb = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1)
            outs.append(
                torch.nn.functional.normalize(emb, dim=1).cpu().numpy())
    return np.concatenate(outs)


def _gather(source, excluded):
    """(vertex gids, their sentences), in the source's vertex order."""
    gids = np.asarray(list(source.vertices(None)), dtype=np.int64)
    records = source.vertex_records(gids)
    keep, texts = [], []
    for i, rec in enumerate(records):
        if rec is None:
            continue
        labels, props = rec
        keep.append(i)
        texts.append(build_text(None, labels, props, excluded))
    return gids[np.asarray(keep, dtype=np.int64)], texts


def compute_embeddings(source, configuration=None, *, device=None,
                       projection=None) -> dict:
    """``embeddings.compute_embeddings``: success, count, dimension (one
    record), and the writes for the caller to make: ``property`` := each
    row of ``embedding`` on the vertex of ``node_gids``.  ``projection``
    as ``hashing_encode``'s."""
    cfg = dict(configuration or {})
    prop_name = cfg.get("embedding_property", "embedding")
    dimension = int(cfg.get("dimension", 256))
    batch_size = int(cfg.get("batch_size", 2048))
    model = cfg.get("model")          # None -> hashing encoder
    excluded = set(cfg.get("excluded_properties") or [prop_name])
    excluded.add(prop_name)
    if dimension <= 0 or batch_size <= 0:
        raise ProcedureError("embeddings: dimension and batch_size "
                             "must be positive")
    dev = resolve_device(device)
    gids, texts = _gather(source, excluded)
    if model:
        vecs = _transformer_encode(texts, model, batch_size, dev) \
            if texts else np.zeros((0, 0), np.float32)
        dimension = vecs.shape[1] if len(texts) else dimension
    elif texts:
        vecs = hashing_encode(texts, dimension, batch_size,
                              projection=projection, device=dev)
    else:
        vecs = np.zeros((0, dimension), np.float32)
    return {"success": np.asarray([True]),
            "count": np.asarray([len(gids)], dtype=np.int64),
            "dimension": np.asarray([dimension], dtype=np.int64),
            "property": str(prop_name), "node_gids": gids,
            "embedding": vecs}


def node_sentence(source, configuration=None) -> dict:
    """``embeddings.node_sentence``: node (``node_gids``), sentence — the
    text each vertex would be embedded with."""
    cfg = dict(configuration or {})
    excluded = set(cfg.get("excluded_properties") or [])
    excluded.add(cfg.get("embedding_property", "embedding"))
    gids, texts = _gather(source, excluded)
    return {"node_gids": gids, "sentence": np.asarray(texts, dtype=object)}


def model_info(configuration=None, *, device=None) -> dict:
    """``embeddings.model_info``: name, dimension, device (one record):
    the card's name where the encoder (the hashing one or the ``model``)
    runs on one."""
    cfg = dict(configuration or {})
    model = cfg.get("model")
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if model:
        return {"name": np.asarray([model], dtype=object),
                "dimension": np.asarray([-1], dtype=np.int64),
                "device": np.asarray([name], dtype=object)}
    return {"name": np.asarray(["feature-hashing/ngram-projection"],
                               dtype=object),
            "dimension": np.asarray([int(cfg.get("dimension", 256))],
                                    dtype=np.int64),
            "device": np.asarray([name], dtype=object)}
