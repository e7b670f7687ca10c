"""Elbow-point detection for choosing cluster counts.

Reference parity: ``sitator/util/elbow.py`` (SURVEY.md §3.7, ⚠) — used by
``SiteTypeAnalysis`` to pick the number of site types from a dissimilarity
curve.  Implemented as the max-distance-to-chord ("kneedle"-style) criterion.
"""
from __future__ import annotations

import numpy as np


def elbow_index(values) -> int:
    """Index of the elbow of a monotone curve ``values`` (1-D).

    Draws the chord from the first to the last point and returns the index of
    maximum perpendicular distance to it.  Robust to overall scale/offset.
    """
    y = np.asarray(values, dtype=np.float64)
    n = len(y)
    if n < 3:
        return 0
    x = np.arange(n, dtype=np.float64)
    # chord direction, normalized
    dx, dy = x[-1] - x[0], y[-1] - y[0]
    norm = np.hypot(dx, dy)
    if norm == 0:
        return 0
    # perpendicular distance of each point to the chord
    dist = np.abs(dx * (y - y[0]) - dy * (x - x[0])) / norm
    return int(np.argmax(dist))
