"""Trajectory readers: ``TrajectoryReader``, ``ArrayTrajectory`` and
``ChunkedFeeder`` (the background block prefetcher).

Copies of the NumPy-only classes of :mod:`sitator_tpu.io.formats`, so the
port imports nothing of the JAX package.  The streaming engine takes any
object with ``len()`` and ``reader[lo:hi] -> (n, A, 3)``, either package's
readers included."""
from sitator_tpu_torch.io.formats import (ArrayTrajectory, ChunkedFeeder,
                                          TrajectoryReader)

__all__ = ["TrajectoryReader", "ArrayTrajectory", "ChunkedFeeder"]
