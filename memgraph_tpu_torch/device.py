"""Device resolution (the card by default, the CPU only when asked) and
the port's one switch for full-f32 matrix products."""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on, in one normal form.

    ``device`` names it explicitly ("cuda", "cuda:1", "cpu", a
    ``torch.device``).  Otherwise ``like`` (a tensor) lends its device.
    Otherwise the default is ``cuda``.  A CUDA device on a host without
    one raises: nothing falls back to the CPU unless the CPU was asked
    for.

    The result is what caches key on and compare: a CUDA device always
    carries its index (bare ``cuda`` is the current device), the CPU
    never does (``cpu:0`` is ``cpu``).  So "cuda" and "cuda:0" name one
    card, and a plan placed for one serves the other.
    """
    if device is not None:
        dev = torch.device(device)
    elif like is not None:
        dev = like.device
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def exact_f32_matmuls() -> None:
    """Full-f32 matrix products from here on: TF32 off for cuBLAS, and
    the "highest" float32 matmul precision.  Every entry point that runs
    an f32 product it means exactly (the MXU plan's one-hot matmuls, kNN
    scores, k-means distances, the similarity counts) calls it first,
    so its answer does not depend on what ran before it in the process
    or on the global defaults: TF32 keeps 10 bits of mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
