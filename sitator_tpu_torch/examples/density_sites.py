"""Density-based site seeding — the trajectory-driven complement to
Voronoi seeding.

The empty-lattice Voronoi decomposition proposes sites where geometry
says ions *could* sit; the density route finds the basins where they
actually *are* — including interstitial sites the geometric
decomposition misses, and none of the never-visited nodes.  This
walkthrough runs both seedings on the same hopping MD, shows they agree
on the occupied sites, and demonstrates an interstitial basin only the
density route discovers.

Run:  python3 -m sitator_tpu_torch.examples.density_sites
      [--device {cuda,cpu}]
"""
import sys

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork
from sitator_tpu_torch.core.structure import Structure
from sitator_tpu_torch.dynamics import JumpAnalysis
from sitator_tpu_torch.io import make_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.network import (BondValenceSiteGenerator,
                                       DensitySiteGenerator, match_sites)
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "density_sites"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device

    # --- 1. hopping MD with known ground truth
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=1500,
                                 jump_rate=0.05, seed=7)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    visited = np.unique(md.true_assignments)
    print(f"system: {md.structure}, {md.n_frames} frames; "
          f"{len(visited)} distinct sites actually visited")

    # --- 2. seed two ways: empty-lattice geometry vs occupied density
    sn_vor = VoronoiSiteGenerator(verbose=False).run(sn0)
    sn_den = DensitySiteGenerator(verbose=False, device=dev).run(sn0,
                                                                 md.traj)
    print(f"Voronoi basis: {sn_vor.n_sites} nodes (all geometric "
          "candidates)")
    print(f"density basis: {sn_den.n_sites} sites (occupied basins only)")

    # --- 3. the density sites ARE the visited ground-truth sites
    truth = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    truth.centers = md.true_sites[visited]
    mapping, dists = match_sites(sn_den, truth, cutoff=0.5)
    print(f"density vs truth: {int((mapping >= 0).sum())}/{sn_den.n_sites} "
          f"matched within 0.5 Angstrom (max {np.nanmax(dists):.3f})")
    assert (mapping >= 0).all()

    # --- 4. the density basis drops straight into the landmark engine
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False, device=dev).run(sn_den, md.traj)
    st = JumpAnalysis(verbose=False, device=dev).run(st)
    n_ij = st.site_network.n_ij
    jumps = int(n_ij.sum() - np.trace(n_ij))
    print(f"landmark on density basis: {100 * st.percent_unassigned:.2f}% "
          f"unassigned, {jumps} jumps (ground truth "
          f"{int(md.true_n_ij.sum())})")

    # --- 5. an interstitial the geometry doesn't know about: park one ion
    # in a cage the lattice Voronoi tessellation has no node near
    md2 = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=800,
                                  jump_rate=0.03, seed=11)
    off_lattice = np.array([2.0, 2.0, 2.0])    # a face/edge interstitial
    traj2 = md2.traj.copy()
    extra = off_lattice + np.random.default_rng(0).normal(
        scale=0.15, size=(md2.n_frames, 1, 3))
    traj2 = np.concatenate([traj2, extra], axis=1)
    species = np.concatenate([md2.structure.species, [3]])
    pos0 = np.concatenate([md2.structure.positions, off_lattice[None]])
    struct2 = Structure(pos0, species, md2.structure.cell)
    mobile2 = np.concatenate([md2.mobile_mask, [True]])
    sn2 = SiteNetwork(struct2, ~mobile2, mobile2)
    sn2_den = DensitySiteGenerator(verbose=False, device=dev).run(sn2, traj2)
    d_to_interstitial = np.linalg.norm(
        sn2_den.centers - off_lattice, axis=1).min()
    print(f"interstitial basin recovered by density seeding: nearest "
          f"center {d_to_interstitial:.3f} Angstrom from the parked ion")
    assert d_to_interstitial < 0.3

    # --- 6. the third seeding route: chemistry alone.  Bond-valence
    # mismatch minima need no trajectory at all — on an FCC oxygen
    # sublattice sized so octahedral holes hit the ideal Li valence, the
    # generator accepts exactly the octahedral holes and rejects the
    # tetrahedral ones (V ~ 1.44): void selection by chemistry, which pure
    # geometry cannot do.
    R0, b = 1.466, 0.37
    a_bv = 2 * (R0 + b * np.log(6.0))
    basis = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    grid = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    o_pos = ((grid[:, None, :] + basis[None]) * a_bv).reshape(-1, 3)
    pos = np.concatenate([o_pos, [[0.5 * a_bv, 0, 0]]])
    spc = np.array([8] * len(o_pos) + [3])
    s2 = Structure(pos, spc, np.eye(3) * (2 * a_bv))
    sn_bv = BondValenceSiteGenerator(v_ideal=1.0, mismatch_tol=0.3,
                                     min_distance=1.2, verbose=False,
                                     device=dev).run(
        SiteNetwork(s2, spc == 8, spc == 3))
    print(f"bond-valence seeding: {sn_bv.n_sites} sites (the 32 octahedral "
          f"holes), BV sums {sn_bv.bv_sum.min():.2f}-"
          f"{sn_bv.bv_sum.max():.2f}")
    assert sn_bv.n_sites == 32
    print("Density-seeding walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
