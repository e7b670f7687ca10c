"""Numeric substrate: PBC math, the landmark kernels and their plain
versions, clustering, jump statistics and MCL, on PyTorch tensors.  The
CUDA kernels are built on first use (``ops._cuda``), never at import."""
from sitator_tpu_torch.ops import cluster, jumps, landmark, mcl, pbc

__all__ = ["pbc", "landmark", "cluster", "jumps", "mcl"]
