"""Trajectory readers, shared with :mod:`sitator_tpu`.

``TrajectoryReader``, ``ArrayTrajectory`` and ``ChunkedFeeder`` (the
background block prefetcher) are NumPy-only and import without JAX, so the
port re-exports them instead of copying them, as :mod:`sitator_tpu_torch.core`
does the data model."""
from sitator_tpu.io.formats import (ArrayTrajectory, ChunkedFeeder,
                                    TrajectoryReader)

__all__ = ["TrajectoryReader", "ArrayTrajectory", "ChunkedFeeder"]
