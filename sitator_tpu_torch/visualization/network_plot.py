"""``SiteNetworkPlotter`` and SiteTrajectory plot helpers (counterpart of
``sitator_tpu.visualization.network_plot``).

Reference parity: ``sitator/visualization/SiteNetworkPlotter.py`` and the
``SiteTrajectory.plot_*`` methods (SURVEY.md §3.8): 3D site plotting with
marker = site type, size/color mappable to site attributes, edges drawn
with minimum-image wrapping and width/color mappable to edge attributes.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.visualization.atoms import plot_atoms, plot_points
from sitator_tpu_torch.visualization.common import (SITE_MARKERS,
                                                    draw_cell, plotter)


class SiteNetworkPlotter:
    """Parameters mirror the reference: attribute names (or None) that map
    to marker size / color and edge width / color."""

    def __init__(self, site_size_attr=None, site_color_attr=None,
                 edge_attr="n_ij", edge_threshold=0, min_width=0.5,
                 max_width=5.0, site_size=60.0, cmap="viridis"):
        self.site_size_attr = site_size_attr
        self.site_color_attr = site_color_attr
        self.edge_attr = edge_attr
        self.edge_threshold = edge_threshold
        self.min_width = min_width
        self.max_width = max_width
        self.site_size = site_size
        self.cmap = cmap

    @plotter(is3D=True)
    def plot(self, sn, with_atoms=True, fig=None, ax=None):
        if with_atoms:
            plot_atoms(sn.static_structure, alpha=0.25, show_cell=False,
                       fig=fig, ax=ax)
        centers = sn.centers
        sizes = np.full(sn.n_sites, self.site_size)
        if self.site_size_attr and self.site_size_attr in sn.site_attributes:
            v = np.asarray(sn.get_site_attribute(self.site_size_attr),
                           dtype=float)
            vmax = v.max() if v.max() > 0 else 1.0
            sizes = self.site_size * (0.2 + 0.8 * v / vmax)
        colors = None
        if (self.site_color_attr
                and self.site_color_attr in sn.site_attributes):
            colors = np.asarray(
                sn.get_site_attribute(self.site_color_attr), dtype=float)
        types = (sn.site_types if sn.site_types is not None
                 else np.zeros(sn.n_sites, dtype=int))
        for t in np.unique(types):
            sel = types == t
            marker = SITE_MARKERS[int(t) % len(SITE_MARKERS)]
            kw = dict(s=sizes[sel], marker=marker, edgecolors="k",
                      linewidths=0.4)
            if colors is not None:
                kw["c"] = colors[sel]
                kw["cmap"] = self.cmap
            else:
                kw["color"] = f"C{int(t) % 10}"
            ax.scatter(centers[sel, 0], centers[sel, 1], centers[sel, 2],
                       **kw)
        self._plot_edges(sn, ax)
        draw_cell(sn.structure.cell, ax)
        ax.set_box_aspect((1, 1, 1))

    def _plot_edges(self, sn, ax):
        if not self.edge_attr or self.edge_attr not in sn.edge_attributes:
            return
        e = np.asarray(sn.get_edge_attribute(self.edge_attr), dtype=float)
        # NaN-aware symmetrization: attributes like Ea_ij are often
        # finite in only one direction (the reverse hops missed
        # min_counts) — a bare e + e.T would NaN-poison exactly the
        # edges worth drawing.  Sum where both directions are finite,
        # take the finite one where only one is, NaN when neither.
        et = e.T
        both = np.isfinite(e) & np.isfinite(et)
        sym = np.where(both, e + et,
                       np.where(np.isfinite(e), e, et))
        calc = PBCCalculator(sn.structure.cell)
        # remaining NaNs must neither poison vmax nor draw
        finite = np.isfinite(sym)
        if not finite.any():
            return
        vmax = sym[finite].max()
        if vmax <= self.edge_threshold:
            return
        ii, jj = np.nonzero(np.triu(finite
                                    & (sym > self.edge_threshold), k=1))
        if len(ii) == 0:
            return
        a = sn.centers[ii]
        # draw each edge through the minimum image of j as seen from i
        b = a + calc._min_image_disp(sn.centers[jj] - a)
        widths = (self.min_width + (self.max_width - self.min_width)
                  * sym[ii, jj] / vmax)
        from mpl_toolkits.mplot3d.art3d import Line3DCollection
        segs = np.stack([a, b], axis=1)
        ax.add_collection3d(Line3DCollection(
            segs, linewidths=widths, colors="0.3", alpha=0.7))


@plotter(is3D=True)
def plot_frame(st, frame, fig=None, ax=None):
    """One frame: static structure + mobile ions colored by site."""
    sn = st.site_network
    plot_atoms(sn.static_structure, alpha=0.25, show_cell=False,
               fig=fig, ax=ax)
    if st.real_trajectory is not None:
        mobile = st.real_trajectory[frame][sn.mobile_mask]
        labels = st.traj[frame]
        colors = ["C%d" % (l % 10) if l >= 0 else "k" for l in labels]
        ax.scatter(mobile[:, 0], mobile[:, 1], mobile[:, 2], s=80,
                   c=colors, marker="o", edgecolors="k")
    plot_points(sn.centers, color="0.5", pointsize=25, alpha=0.5,
                marker="x", fig=fig, ax=ax)
    draw_cell(sn.structure.cell, ax)


@plotter(is3D=True)
def plot_site(st, site, fig=None, ax=None):
    """One site: center, vertex atoms, and the assigned point cloud."""
    sn = st.site_network
    pts = st.real_positions_for_site(site)
    calc = PBCCalculator(sn.structure.cell)
    center = sn.centers[site]
    if len(pts):
        pts = calc.min_image(center, pts)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=8, alpha=0.4,
                   color="C0")
    ax.scatter(*center, s=150, marker="x", color="r")
    if sn.has_vertices:
        vpos = sn.structure.positions[sn.vertices[site]]
        vpos = calc.min_image(center, vpos)
        ax.scatter(vpos[:, 0], vpos[:, 1], vpos[:, 2], s=60, marker="^",
                   color="C1", edgecolors="k")
    draw_cell(sn.structure.cell, ax)


@plotter(is3D=True)
def plot_particle_trajectory(st, particle, start=0, stop=None, fig=None,
                             ax=None):
    """One ion's real-space path (unwrapped to be continuous) colored by
    its site assignment over time."""
    sn = st.site_network
    if st.real_trajectory is None:
        raise ValueError("no real trajectory attached")
    mobile_idx = np.flatnonzero(sn.mobile_mask)
    pos = st.real_trajectory[start:stop, mobile_idx[particle]]
    labels = st.traj[start:stop, particle]
    calc = PBCCalculator(sn.structure.cell)
    # unwrap: chain minimum-image displacements
    disp = calc._min_image_disp(np.diff(pos, axis=0))
    path = np.concatenate([pos[:1], pos[:1] + np.cumsum(disp, axis=0)])
    ax.plot(path[:, 0], path[:, 1], path[:, 2], color="0.7", lw=0.8)
    colors = ["C%d" % (l % 10) if l >= 0 else "k" for l in labels]
    ax.scatter(path[:, 0], path[:, 1], path[:, 2], c=colors, s=10)
    draw_cell(sn.structure.cell, ax)
