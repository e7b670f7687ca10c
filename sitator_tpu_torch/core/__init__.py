"""The data model, shared with :mod:`sitator_tpu`.

``Structure``, ``SiteNetwork`` and ``SiteTrajectory`` are NumPy-only and
import without JAX, so the port re-exports them instead of copying them:
the engines of both packages take and return the same objects."""
from sitator_tpu.core.structure import Structure
from sitator_tpu.core.sitenet import SiteNetwork
from sitator_tpu.core.sitetraj import SiteTrajectory

__all__ = ["Structure", "SiteNetwork", "SiteTrajectory"]
