"""End-to-end walkthrough — the sitator_tpu_torch analogue of the
reference's example notebook (a Li-diffusion landmark-analysis
walkthrough).  Uses the synthetic hopping trajectory so it runs anywhere;
swap in `sitator_tpu_torch.io.open_trajectory(...)` for real MD data.

Run:  python3 -m sitator_tpu_torch.examples.landmark_walkthrough
      [--device {cuda,cpu}] [--out PATH]
"""
import os
import sys
import tempfile

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork
from sitator_tpu_torch.dynamics import (
    JumpAnalysis,
    MergeSitesByDynamics,
    RemoveShortJumps,
    RemoveUnoccupiedSites,
)
from sitator_tpu_torch.io import make_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.network import DiffusionPathwayAnalysis
from sitator_tpu_torch.util import StageTimer
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "landmark_walkthrough"


def main(argv=None):
    args = _common.parse_args(
        NAME, __doc__, argv, configure=lambda ap: ap.add_argument(
            "--out", default=os.path.join(tempfile.gettempdir(),
                                          "walkthrough_result.npz"),
            help="where the annotated result is saved (default "
                 "walkthrough_result.npz in the temporary directory)"))
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device
    timer = StageTimer("landmark walkthrough")

    # --- 1. load a trajectory (here: synthetic Li-hopping MD with known
    # truth)
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=2000,
                                 jump_rate=0.02, seed=0)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    print(f"system: {md.structure}, {md.n_frames} frames, "
          f"{md.n_ions} mobile ions")

    # --- 2. seed the landmark basis from the static lattice's Voronoi
    # nodes
    with timer.stage("voronoi seeding"):
        sn = VoronoiSiteGenerator().run(sn)
    print(f"landmark basis: {sn.n_sites} Voronoi nodes")

    # --- 3. landmark analysis: discover sites, assign every (frame, ion)
    with timer.stage("landmark analysis"):
        la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                              minimum_site_occupancy=0.01, device=dev)
        st = la.run(sn, md.traj)
    print(f"raw result: {st}")

    # --- 4. post-process: merge over-split sites, debounce flickers
    with timer.stage("merging + filters"):
        st = MergeSitesByDynamics(distance_threshold=2.0, device=dev).run(st)
        st = RemoveShortJumps(frame_threshold=2).run(st)
        st = RemoveUnoccupiedSites().run(st)
    print(f"after post-processing: {st.site_network.n_sites} sites")

    # --- 5. jump statistics + diffusion pathways
    with timer.stage("jump analysis"):
        ja = JumpAnalysis(device=dev)
        ja.run(st)
        dpa = DiffusionPathwayAnalysis(device=dev)
        dpa.run(st)
    out = st.site_network
    print(f"jumps detected: {ja.n_jumps} (ground truth: "
          f"{md.true_n_ij.sum()})")
    print(f"occupancies: {np.sort(out.occupancies)[::-1][:5].round(3)} ...")
    print(f"pathways: {dpa.n_pathways}, dimensionalities {dpa.pathway_dims}")

    # --- 6. persist the annotated result
    st.save(args.out)
    print(f"saved to {args.out}")
    print()
    print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
