"""Domain failure detectors (copy of ``sitator_tpu.util.errors``, whose
package cannot be imported without JAX).

On-device predicates are reduced to booleans/counters and raised host-side
as these exceptions.
"""
from __future__ import annotations


class SitatorError(Exception):
    """Base class for all sitator_tpu_torch domain errors."""


class StaticLatticeError(SitatorError):
    """A static-lattice atom drifted beyond ``static_movement_threshold`` —
    the host lattice melted or the static/mobile split is wrong, so the
    landmark basis is invalid."""

    def __init__(self, msg, atom_index=None, max_drift=None, frame=None):
        super().__init__(msg)
        self.atom_index = atom_index
        self.max_drift = max_drift
        self.frame = frame


class ZeroLandmarkError(SitatorError):
    """A mobile ion produced an all-zero landmark vector — it escaped the
    support of every landmark polyhedron."""

    def __init__(self, msg, frame=None, mobile_index=None):
        super().__init__(msg)
        self.frame = frame
        self.mobile_index = mobile_index


class MultipleOccupancyError(SitatorError):
    """More mobile ions were assigned to one site at one frame than
    ``max_mobile_per_site`` allows."""

    def __init__(self, msg, site=None, frame=None, count=None):
        super().__init__(msg)
        self.site = site
        self.frame = frame
        self.count = count


class InsufficientSitesError(SitatorError):
    """Clustering produced no sites above the occupancy threshold."""
