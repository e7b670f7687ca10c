"""Site-network comparison: optimal minimum-image matching of sites.

Beyond-reference glue (upstream ``sitator`` offers nothing to relate two
analyses, SURVEY.md §3.5): match the sites of two :class:`SiteNetwork`
objects over the same periodic cell by solving the optimal-assignment
problem on their minimum-image distance matrix.  Uses:

- **temperature series** (:class:`~sitator_tpu_torch.dynamics.ArrheniusAnalysis`
  workflows): establish which site at 600 K is which site at 800 K so
  per-site quantities (occupancies, free energies, barriers) can be
  compared site-by-site;
- **run-to-run / engine-to-engine validation**: assert two analyses of
  the same system discovered the same site set (e.g. classic vs
  streaming engine, different clustering thresholds);
- **ground-truth checks**: match discovered sites against known
  crystallographic positions.

Host-side (scipy Hungarian on an (S_a, S_b) matrix — runs once per
comparison, never in the hot path).
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["min_image_distance_matrix", "match_sites",
           "compare_site_networks"]


def min_image_distance_matrix(centers_a, centers_b, cell):
    """``(S_a, S_b)`` minimum-image distances between two center sets
    in the same periodic ``cell`` (fractional-rounding convention, as
    the engines use)."""
    a = np.asarray(centers_a, dtype=np.float64)
    b = np.asarray(centers_b, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    d = b[None, :, :] - a[:, None, :]
    frac = d @ np.linalg.inv(cell)
    d = (frac - np.round(frac)) @ cell
    return np.sqrt((d ** 2).sum(-1))


def match_sites(sn_a, sn_b, cutoff=None):
    """Optimal assignment of ``sn_a``'s sites to ``sn_b``'s sites.

    Minimizes the total minimum-image distance over all one-to-one
    pairings (rectangular Hungarian — networks may have different site
    counts).  ``cutoff`` (same length unit as the cells) discards
    matches farther than it.

    Returns ``(mapping, distances)``: ``mapping[i]`` is the index of the
    ``sn_b`` site matched to site ``i`` of ``sn_a`` (``-1`` when
    unmatched — excess sites or beyond ``cutoff``); ``distances[i]`` is
    the matched minimum-image distance (NaN when unmatched).
    """
    if sn_a.n_sites == 0 or sn_b.n_sites == 0:
        return (np.full(sn_a.n_sites, -1, dtype=np.int64),
                np.full(sn_a.n_sites, np.nan))
    cell_a = np.asarray(sn_a.structure.cell, dtype=np.float64)
    cell_b = np.asarray(sn_b.structure.cell, dtype=np.float64)
    if not np.allclose(cell_a, cell_b, rtol=1e-6, atol=1e-8):
        raise ValueError("site networks live in different cells; "
                         "map one into the other first "
                         "(ops.pbc.rescale_to_cell)")
    D = min_image_distance_matrix(sn_a.centers, sn_b.centers, cell_a)
    from scipy.optimize import linear_sum_assignment
    cost = D.copy()
    if cutoff is not None:
        # beyond-cutoff pairings allowed by the solver but priced so a
        # real pairing always wins; filtered after solving
        big = max(1.0, np.nanmax(D)) * 1e6
        cost = np.where(D > cutoff, big, D)
    rows, cols = linear_sum_assignment(cost)
    mapping = np.full(sn_a.n_sites, -1, dtype=np.int64)
    dists = np.full(sn_a.n_sites, np.nan)
    for r, c in zip(rows, cols):
        if cutoff is not None and D[r, c] > cutoff:
            continue
        mapping[r] = c
        dists[r] = D[r, c]
    return mapping, dists


def compare_site_networks(sn_a, sn_b, cutoff=None):
    """Structured comparison report between two site networks.

    Returns a dict: ``mapping``/``distances`` (as :func:`match_sites`),
    ``n_matched``, ``unmatched_a``/``unmatched_b`` (index arrays),
    ``mean_distance``/``max_distance`` over matches, and
    ``type_agreement`` — the fraction of matched pairs whose
    ``site_types`` agree (None when either network is untyped).
    """
    mapping, dists = match_sites(sn_a, sn_b, cutoff=cutoff)
    matched = mapping >= 0
    unmatched_b = np.setdiff1d(np.arange(sn_b.n_sites), mapping[matched])
    type_agreement = None
    if sn_a.site_types is not None and sn_b.site_types is not None \
            and matched.any():
        ta = sn_a.site_types[matched]
        tb = sn_b.site_types[mapping[matched]]
        type_agreement = float(np.mean(ta == tb))
    report = {
        "mapping": mapping,
        "distances": dists,
        "n_matched": int(matched.sum()),
        "unmatched_a": np.flatnonzero(~matched),
        "unmatched_b": unmatched_b,
        "mean_distance": (float(np.nanmean(dists)) if matched.any()
                          else float("nan")),
        "max_distance": (float(np.nanmax(dists)) if matched.any()
                         else float("nan")),
        "type_agreement": type_agreement,
    }
    logger.info(
        "site match: %d/%d <-> %d matched, mean %.3g max %.3g%s",
        report["n_matched"], sn_a.n_sites, sn_b.n_sites,
        report["mean_distance"], report["max_distance"],
        "" if type_agreement is None
        else f", type agreement {type_agreement:.0%}")
    return report
