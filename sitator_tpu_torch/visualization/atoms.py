"""Structure scatter plotting (counterpart of
``sitator_tpu.visualization.atoms``; reference
``sitator/visualization/atoms.py`` parity, SURVEY.md §3.8):
species-colored 3D scatter with cell outline."""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.visualization.common import draw_cell, plotter, \
    species_color


@plotter(is3D=True)
def plot_atoms(structure, mask=None, pointsize=40, alpha=1.0,
               show_cell=True, fig=None, ax=None):
    pos = structure.positions
    species = structure.species
    if mask is not None:
        pos = pos[mask]
        species = species[mask]
    for z in np.unique(species):
        sel = species == z
        ax.scatter(pos[sel, 0], pos[sel, 1], pos[sel, 2],
                   s=pointsize, alpha=alpha, color=species_color(int(z)),
                   edgecolors="k", linewidths=0.3, label=str(z))
    if show_cell:
        draw_cell(structure.cell, ax)
    ax.set_box_aspect((1, 1, 1))


@plotter(is3D=True)
def plot_points(points, color="tab:blue", pointsize=20, alpha=0.8,
                cell=None, fig=None, ax=None, **scatter_kwargs):
    points = np.asarray(points)
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=pointsize,
               alpha=alpha, color=color, **scatter_kwargs)
    if cell is not None:
        draw_cell(cell, ax)
