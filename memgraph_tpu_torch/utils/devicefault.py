"""The device fault boundary: injected faults and the typed outcome of
what a dispatch raised.

Port of memgraph_tpu/utils/devicefault.py.  Every supervised dispatch of
the kernel server (server/kernel_server.py) calls ``device_fault_point``
first; armed (utils/faultinject.py) it becomes one of the four device
failures, in this order: ``device.hang`` (sleeps), ``device.lost``
(``DeviceLostError``, or the process ends when armed ``kill``),
``device.oom`` (``DeviceOomError``) and ``device.call``
(``DeviceFaultError``).

``classify_device_error`` maps the injected errors and what torch raises
on the card onto "oom", "device_lost" and "device_error", so that the
server reports the same outcome for the same failure:

  * ``torch.cuda.OutOfMemoryError``, or "CUDA out of memory" / "out of
    memory" in a CUDA error's text: "oom";
  * "no CUDA-capable device", a driver that is missing or shutting down,
    an unavailable or busy device: "device_lost";
  * an illegal address, a device-side assert, a launch failure (the
    kernels' wrappers raise "<kernel> launch failed: CUDA error ..."), or
    any other CUDA error: "device_error".

Anything else is no device failure (None): the server answers it as
``invalid``.
"""

from __future__ import annotations

from . import faultinject as FI


class DeviceFaultError(RuntimeError):
    """An injected device failure (the base of the typed ones)."""


class DeviceLostError(DeviceFaultError):
    """The card is gone: its buffers and built kernels are invalid."""


class DeviceOomError(DeviceFaultError):
    """Device memory exhausted."""


def device_fault_point() -> None:
    """The dispatch hook: fires hang, lost, oom and call, in that order;
    each point keeps its own hit count."""
    FI.fire("device.hang")
    try:
        FI.fire("device.lost")
    except FI.FaultInjected as e:
        raise DeviceLostError(
            f"UNAVAILABLE: device backend lost: {e}") from e
    try:
        FI.fire("device.oom")
    except FI.FaultInjected as e:
        raise DeviceOomError(
            "RESOURCE_EXHAUSTED: injected out-of-memory allocating "
            f"device buffer: {e}") from e
    try:
        FI.fire("device.call")
    except FI.FaultInjected as e:
        raise DeviceFaultError(
            f"INTERNAL: injected device failure: {e}") from e


_OOM_MARKERS = ("CUDA out of memory", "out of memory")
_LOST_MARKERS = ("no CUDA-capable device", "no NVIDIA driver", "CUDA driver",
                 "driver shutting down", "device not ready",
                 "busy or unavailable", "initialization error",
                 "device lost")
_ERROR_MARKERS = ("illegal memory access", "illegal address",
                  "device-side assert", "launch failure", "launch failed",
                  "misaligned address", "CUDA error", "CUDA kernel errors")


def classify_device_error(exc: BaseException) -> str | None:
    """"oom", "device_lost" or "device_error" for a device failure, None
    for anything else."""
    if isinstance(exc, DeviceOomError):
        return "oom"
    if isinstance(exc, DeviceLostError):
        return "device_lost"
    if isinstance(exc, DeviceFaultError):
        return "device_error"
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if not isinstance(exc, RuntimeError):
        return None
    text = str(exc)
    if any(m in text for m in _OOM_MARKERS):
        return "oom"
    if any(m in text for m in _LOST_MARKERS):
        return "device_lost"
    if any(m in text for m in _ERROR_MARKERS):
        return "device_error"
    return None
