"""The data model: ``Structure``, ``SiteNetwork``, ``SiteTrajectory``.

Copies of :mod:`sitator_tpu.core` (NumPy only), so the port imports nothing
of the JAX package.  The engines are duck-typed: they take either package's
objects and return the port's."""
from sitator_tpu_torch.core.structure import Structure
from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory

__all__ = ["Structure", "SiteNetwork", "SiteTrajectory"]
