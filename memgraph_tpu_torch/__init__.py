"""PyTorch/CUDA port of memgraph_tpu's device path.

The package runs on an NVIDIA GPU by default: every entry point takes a
``device=`` argument and uses ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, a CPU tensor or a graph placed on the CPU).  Without a
GPU and without such a request it raises; it never drops to the CPU
quietly.  The kernels that the JAX package wrote in Pallas are CUDA C++
kernels here (``ops/csrc``), built with ``nvcc`` at first use.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
