"""Microbenchmarks of the port's kernel primitives.

Counterparts of the JAX package's ``benchmarks/pallas_micro*.py``: the
primitives the TPU PageRank kernel was designed from (streaming, gathers
within a column and within a lane row, a fixed permutation, tile
transposes, scatter-adds, a matrix product), each as a hand-written CUDA
kernel in ``ops/csrc/micro.cu`` with its plain PyTorch version.

    python -m memgraph_tpu_torch.benchmarks.micro  [--device cpu]
    python -m memgraph_tpu_torch.benchmarks.micro2 [--device cpu]
    python -m memgraph_tpu_torch.benchmarks.micro3 [--device cpu]
"""
