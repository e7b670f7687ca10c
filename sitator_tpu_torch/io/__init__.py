"""Trajectory readers (``TrajectoryReader``, ``ArrayTrajectory`` and
``ChunkedFeeder``, the background block prefetcher) and the synthetic-MD
generators with known ground truth (``SyntheticMD``, ``make_*_trajectory``).

Copies of the NumPy-only classes of :mod:`sitator_tpu.io.formats` and of
:mod:`sitator_tpu.io.synthetic`, so the port imports nothing of the JAX
package.  The streaming engine takes any
object with ``len()`` and ``reader[lo:hi] -> (n, A, 3)``, either package's
readers included."""
from sitator_tpu_torch.io.formats import (ArrayTrajectory, ChunkedFeeder,
                                          TrajectoryReader)
from sitator_tpu_torch.io.synthetic import (SyntheticMD,
                                            make_fcc_hopping_trajectory,
                                            make_hopping_trajectory,
                                            make_langevin_trajectory)

__all__ = ["SyntheticMD", "make_hopping_trajectory",
           "make_fcc_hopping_trajectory", "make_langevin_trajectory",
           "TrajectoryReader", "ArrayTrajectory", "ChunkedFeeder"]
