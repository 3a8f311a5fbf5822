"""Single-blob host-to-device transfer.

Port of memgraph_tpu/ops/blob.py.  A multi-array upload ships ONE
contiguous blob of 4-byte words, copied once from pinned memory, and the
arrays are views (or casts) of it on the device.  The sharded MXU route
(ops/spmv_mxu_sharded.py) places each shard's layout this way: one
upload a shard.

The layout is the reference's: every segment is whole int32 words; 1- and
2-byte integers and bools are widened on the host (``"cast"``); 4-byte
dtypes are stored as they are (``"word"``); a ``("bits", uint8 array)``
payload keeps its bytes, each row zero-padded to a word boundary
(``"bits"``), and comes back as int32 words (the same bits as the
reference's uint32), for ``unpack_bit_words`` or a byte view.
"""

from __future__ import annotations

import numpy as np
import torch

_WORD = 4

_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.int32): torch.int32,
          np.dtype(np.uint32): torch.int32,
          np.dtype(np.int16): torch.int16,
          np.dtype(np.uint16): torch.int32,
          np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8,
          np.dtype(np.bool_): torch.bool}


def pack_blob(arrays: dict):
    """Concatenate host arrays into one contiguous int32-word blob.

    Values: numpy arrays of 4-byte dtypes (float32 / int32 / uint32),
    1- or 2-byte integers or bool (widened to int32 on the host), or
    ``("bits", uint8_array)`` for bit-packed payloads.  Returns
    (blob_i32, segments); ``segments[name]`` = (word offset, words, kind,
    shape, dtype) describes the layout for ``unblob``."""
    segs = {}
    parts = []
    off = 0

    def add_words(name, words_i32, kind, shape, dtype):
        nonlocal off
        segs[name] = (off, words_i32.size, kind, shape, dtype)
        parts.append(words_i32)
        off += words_i32.size

    for name, arr in arrays.items():
        if isinstance(arr, tuple) and arr[0] == "bits":
            raw = np.ascontiguousarray(arr[1])
            if raw.dtype != np.uint8:
                raise TypeError(f"{name}: bits payload must be uint8")
            pad = (-raw.shape[-1]) % _WORD
            if pad:
                raw = np.concatenate(
                    [raw, np.zeros(raw.shape[:-1] + (pad,), np.uint8)],
                    axis=-1)
            add_words(name, raw.reshape(-1).view(np.int32), "bits",
                      raw.shape[:-1] + (raw.shape[-1] // _WORD,), np.uint32)
            continue
        a = np.ascontiguousarray(arr)
        if a.dtype in (np.dtype(np.int16), np.dtype(np.uint16),
                       np.dtype(np.int8), np.dtype(np.uint8),
                       np.dtype(np.bool_)):
            add_words(name, a.astype(np.int32).reshape(-1), "cast", a.shape,
                      a.dtype)
        elif a.dtype.itemsize == _WORD:
            add_words(name, a.reshape(-1).view(np.int32), "word", a.shape,
                      a.dtype)
        else:
            raise TypeError(f"{name}: unsupported dtype {a.dtype}")
    if not parts:
        raise ValueError("pack_blob: no arrays")
    return np.concatenate(parts), segs


def unblob(blob: torch.Tensor, segs: dict, name: str) -> torch.Tensor:
    """One array of the int32-word blob, on the blob's device: a view for
    a word segment (float32 reinterpreted), a cast for a widened one,
    int32 words for a bits segment."""
    off, n_words, kind, shape, dtype = segs[name]
    raw = blob[off:off + n_words]
    shape = tuple(int(s) for s in shape)
    if kind == "cast":
        return raw.view(shape).to(_TORCH[np.dtype(dtype)])
    if kind == "bits" or np.dtype(dtype) in (np.dtype(np.int32),
                                             np.dtype(np.uint32)):
        return raw.view(shape)
    return raw.view(_TORCH[np.dtype(dtype)]).view(shape)


def unpack_bit_words(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n_bits) bool.  Bit i lives in word
    i >> 5; within the word the bytes are little-endian and the bits
    MSB-first per byte (numpy.packbits order): shift 8*((i&31)>>3) + 7 -
    (i&7)."""
    j = np.arange(32)
    shifts = torch.as_tensor(8 * (j >> 3) + 7 - (j & 7), dtype=torch.int32,
                             device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * 32)
    return bits[..., :n_bits] != 0


def put_packed(arrays: dict, device) -> dict:
    """Ship ``arrays`` (a dict of host numpy arrays) to ``device`` in one
    transfer (pinned on a card); returns a dict of tensors on it."""
    blob_np, segs = pack_blob(arrays)
    t = torch.from_numpy(blob_np)
    dev = torch.device(device)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)
    return {name: unblob(t, segs, name) for name in segs}
