"""Plotting core: the ``@plotter`` decorator and ``layers`` composition
(counterpart of ``sitator_tpu.visualization.common``).

Reference parity: ``sitator/visualization/common.py`` (SURVEY.md §3.8) —
every plotting function takes optional ``fig``/``ax`` kwargs, creates a 3D
axes when absent, and can be stacked with :func:`layers`.
"""
from __future__ import annotations

import functools

import numpy as np

# species -> display color (CPK-ish); fallback hashes the species number
SPECIES_COLORS = {
    1: "#FFFFFF", 3: "#CC80FF", 8: "#FF0D0D", 9: "#90E050", 11: "#AB5CF2",
    12: "#8AFF00", 13: "#BFA6A6", 14: "#F0C8A0", 15: "#FF8000",
    16: "#FFFF30", 17: "#1FF01F", 22: "#BFC2C7", 26: "#E06633",
}

SITE_MARKERS = ["o", "^", "s", "D", "v", "P", "*", "X"]


def species_color(z):
    if z in SPECIES_COLORS:
        return SPECIES_COLORS[z]
    rng = np.random.default_rng(int(z))
    return rng.random(3) * 0.7 + 0.15


def plotter(is3D=True, **fig_kwargs):
    """Decorator: inject ``fig``/``ax`` (creating them if needed) and return
    the figure, matching the reference's plotting convention."""

    def deco(func):
        @functools.wraps(func)
        def wrapped(*args, fig=None, ax=None, **kwargs):
            import matplotlib
            import matplotlib.pyplot as plt
            if ax is None:
                if fig is None:
                    fig = plt.figure(**fig_kwargs)
                ax = (fig.add_subplot(111, projection="3d") if is3D
                      else fig.add_subplot(111))
            elif fig is None:
                fig = ax.figure
            func(*args, fig=fig, ax=ax, **kwargs)
            return fig
        return wrapped
    return deco


def layers(*plot_calls, fig=None, ax=None, **fig_kwargs):
    """Compose plotting functions onto one 3D axes:
    ``layers((plot_atoms, dict(structure=s)), (plot_points, dict(...)))``."""
    import matplotlib.pyplot as plt
    if ax is None:
        if fig is None:
            fig = plt.figure(**fig_kwargs)
        ax = fig.add_subplot(111, projection="3d")
    for func, kwargs in plot_calls:
        func(fig=fig, ax=ax, **kwargs)
    return fig


def draw_cell(cell, ax, color="0.6", lw=0.8):
    """Wireframe of the periodic cell."""
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], dtype=float) @ cell
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    for a, b in edges:
        ax.plot(*zip(corners[a], corners[b]), color=color, lw=lw)
