"""Pluggable landmark clustering backends.

A backend is a module exposing ``do_landmark_clustering(landmark_vectors,
clustering_params, min_samples, verbose, device) -> (counts, assignments,
confidences, centers)``.  Backends: ``dotprod`` (the default) and ``mcl``;
:func:`register_backend` adds one by name.  A backend written to the
reference's contract, without ``device``, is called without it.
"""
from sitator_tpu_torch.landmark.cluster import dotprod, mcl

_BACKENDS = {"dotprod": dotprod, "mcl": mcl}


def get_backend(name):
    if isinstance(name, str):
        try:
            return _BACKENDS[name]
        except KeyError:
            raise ValueError(
                f"unknown clustering backend {name!r}; "
                f"available: {sorted(_BACKENDS)}") from None
    # a module-like object with do_landmark_clustering is accepted directly
    if hasattr(name, "do_landmark_clustering"):
        return name
    raise TypeError("clustering_algorithm must be a backend name or module")


def register_backend(name, module):
    """Make ``module`` (anything with ``do_landmark_clustering``) the
    backend named ``name``, for ``LandmarkAnalysis(clustering_algorithm=
    name)``."""
    _BACKENDS[name] = module
