"""Numeric substrate: PBC math, the landmark kernels and their plain
versions, clustering and jump statistics, on PyTorch tensors.  The CUDA
kernels are built on first use (``ops._cuda``), never at import."""
from sitator_tpu_torch.ops import cluster, jumps, landmark, pbc

__all__ = ["pbc", "landmark", "cluster", "jumps"]
