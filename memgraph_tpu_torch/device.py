"""Device resolution: the card by default, the CPU only when asked."""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` names it explicitly ("cuda", "cuda:1", "cpu", a
    ``torch.device``).  Otherwise ``like`` (a tensor) lends its device.
    Otherwise the default is ``cuda``.  A CUDA device on a host without
    one raises: nothing falls back to the CPU unless the CPU was asked
    for.
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
    return dev
