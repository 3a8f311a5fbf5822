"""Host-driven execution planes: the mesh (a MeshContext over torch
devices, its collectives and the sharded kernels), the checkpoint/resume
layer and the streamed out-of-core fixpoints."""
