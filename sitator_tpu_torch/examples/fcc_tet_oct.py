"""Sixth walkthrough: the close-packed (FCC) interstitial network.

The reference paper's headline systems are Li ions in close-packed anion
frameworks, where the sites are TETRAHEDRAL (4 neighbor atoms) and
OCTAHEDRAL (6 neighbor atoms) holes — the textbook case of ragged
landmark polyhedra and of site TYPING.  This script runs the full story
on the synthetic FCC hopping trajectory:

1. Voronoi seeding discovers both hole families (4- and 6-vertex cages);
2. landmark analysis recovers the visited sites and the hop statistics;
3. SOAP + SiteTypeAnalysis separates the two coordination environments.

Run:  python3 -m sitator_tpu_torch.examples.fcc_tet_oct
      [--device {cuda,cpu}]
"""
import sys

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork
from sitator_tpu_torch.dynamics import JumpAnalysis, RemoveShortJumps
from sitator_tpu_torch.io import make_fcc_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.site_descriptors import (SiteCentersDescriptor,
                                                SiteTypeAnalysis)
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "fcc_tet_oct"


def sites(dev):
    """Steps 1 and 2: the analysed network."""
    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=5,
                                     n_frames=2000, jump_rate=0.02, seed=3)
    n_oct = int((md.true_site_types == 0).sum())
    n_tet = int((md.true_site_types == 1).sum())
    print(f"FCC host: {int(md.static_mask.sum())} atoms; interstitial "
          f"truth: {n_oct} octahedral + {n_tet} tetrahedral holes")

    # --- 1. Voronoi seeding: both hole families, ragged vertex counts ---
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05, verbose=False).run(sn0)
    vc = np.array([len(v) for v in seeds.vertices])
    sizes, counts = np.unique(vc, return_counts=True)
    print(f"Voronoi seeds: {seeds.n_sites}; vertex-count histogram: "
          f"{dict(zip(sizes.tolist(), counts.tolist()))}")

    # --- 2. landmark analysis + jump statistics -------------------------
    la = LandmarkAnalysis(cutoff_midpoint=3.2, cutoff_steepness=3.0,
                          minimum_site_occupancy=0.01, verbose=False,
                          device=dev)
    st = la.run(seeds, md.traj)
    st = RemoveShortJumps(frame_threshold=3, verbose=False).run(st)
    JumpAnalysis(verbose=False, device=dev).run(st)
    sn = st.site_network
    found = int(sn.n_ij.sum() - np.trace(sn.n_ij))
    print(f"landmark analysis: {sn.n_sites} sites, {found} jumps "
          f"(ground truth hops: {int(md.true_n_ij.sum())})")
    calc = PBCCalculator(md.structure.cell)
    visited = np.unique(md.true_assignments)
    d = calc.pairwise_distances(sn.centers, md.true_sites[visited])
    print(f"every discovered site within {d.min(axis=1).max():.2f} A of a "
          "truly visited hole")
    return sn


def typing(dev, sn):
    """Step 3: tet vs oct by SiteTypeAnalysis."""
    sta = SiteTypeAnalysis(SiteCentersDescriptor(r_cut=4.0, device=dev),
                           n_types=2, verbose=False, device=dev)
    sta.run(sn)
    for t in range(2):
        sel = sn.site_types == t
        occ = sn.occupancies[sel].mean() if sel.any() else 0.0
        print(f"type {t}: {int(sel.sum())} sites, mean occupancy {occ:.3f}")


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    sn = sites(args.device)
    typing(args.device, sn)
    print("FCC walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
