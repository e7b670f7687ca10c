"""Cutoff auto-calibration.

SURVEY.md §0 item 4 flags the landmark cutoff midpoint/steepness as
system-dependent calibration constants (the reference's exact defaults are
unverifiable).  This helper derives sensible values from the data itself:
sample some frames, find each ion's nearest landmark node, and look at the
distribution of its distances to that node's vertex atoms — the cutoff must
still be "on" at those distances and "off" well before a neighboring cage's
far vertices.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.ops.pbc import PBCCalculator

logger = logging.getLogger(__name__)


def suggest_cutoff(sn, frames, n_sample_frames=16, on_quantile=0.98,
                   margin=0.5, seed=0):
    """Suggest ``(cutoff_midpoint, cutoff_steepness)`` for a seeded network.

    Parameters
    ----------
    sn : SiteNetwork with centers + vertices (the Voronoi landmark basis).
    frames : (F, n_atoms, 3) trajectory (a subsample is drawn from it).
    on_quantile : the cutoff midpoint is placed ``margin`` Å beyond this
        quantile of occupied ion→vertex distances, so the switching function
        is ≈1 over essentially all distances an ion exhibits while sitting
        in a site.
    margin : Å added beyond the quantile.

    Returns (midpoint, steepness): steepness is chosen so the cutoff decays
    from ~0.9 to ~0.1 over one vertex-distance spread (interquartile range),
    clamped to [1, 10] 1/Å.
    """
    frames = np.asarray(frames)
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(frames), min(n_sample_frames, len(frames)),
                     replace=False)
    calc = PBCCalculator(sn.structure.cell)
    mobile_idx = np.flatnonzero(sn.mobile_mask)

    dists = []
    for f in sel:
        pos = frames[f]
        for ion in mobile_idx:
            d_nodes = calc.distances(pos[ion], sn.centers)
            site = int(np.argmin(d_nodes))
            verts = sn.vertices[site]
            dists.append(calc.distances(pos[ion], pos[verts]))
    dists = np.concatenate(dists)

    q_on = float(np.quantile(dists, on_quantile))
    midpoint = q_on + margin
    iqr = float(np.quantile(dists, 0.75) - np.quantile(dists, 0.25))
    # logistic falls 0.9 -> 0.1 over ~4.4/steepness
    steepness = float(np.clip(4.4 / max(iqr, 0.2), 1.0, 10.0))
    logger.info("suggest_cutoff: occupied ion->vertex distances "
                "median %.2f A, q%.0f %.2f A -> midpoint %.2f A, "
                "steepness %.2f 1/A", float(np.median(dists)),
                100 * on_quantile, q_on, midpoint, steepness)
    return midpoint, steepness
