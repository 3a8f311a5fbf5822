"""Device resolution: the card by default, the CPU only when asked."""

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
