"""Fourth walkthrough: variable-cell (NPT) trajectories.

MD at constant pressure lets the cell breathe, but the site-analysis data
model (one `SiteNetwork`, one cell — exactly as in the reference) wants a
fixed cell.  The bridge is `variable_cell='rescale'`: every frame is
affinely mapped into the first frame's cell, preserving fractional
coordinates exactly.  For homogeneous cell fluctuations the lattice sites
are stationary in fractional space, so the bridged trajectory is the
physically meaningful input for landmark analysis.

This script fabricates an NPT run (ions follow the breathing cell
affinely on top of their hopping dynamics), writes it as a repeated-header
XDATCAR — the format VASP produces for NPT — and shows:

1. the default policy refusing the file loudly;
2. the rescale bridge recovering the underlying fixed-cell trajectory;
3. the full pipeline running on the bridged data with jump statistics
   matching the fixed-cell ground truth.

Run:  python3 -m sitator_tpu_torch.examples.npt_variable_cell
      [--device {cuda,cpu}]
"""
import sys
import tempfile
from pathlib import Path

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork
from sitator_tpu_torch.dynamics import JumpAnalysis
from sitator_tpu_torch.io import make_hopping_trajectory, open_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "npt_variable_cell"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device
    work = Path(tempfile.mkdtemp(prefix="sitator_npt_"))

    # --- 1. a ground-truth fixed-cell run, then its NPT-dressed twin -----
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=1500,
                                 jump_rate=0.02, seed=11)
    cell0 = md.structure.cell
    F = md.traj.shape[0]
    scale = 1.0 + 0.02 * np.sin(2 * np.pi * np.arange(F) / 300.0)  # ±2%
    scale[0] = 1.0
    cells = cell0[None] * scale[:, None, None]
    frac = md.traj @ np.linalg.inv(cell0)      # dynamics in fractional space

    xdatcar = work / "XDATCAR"
    n_static = int(md.static_mask.sum())
    n_mobile = int(md.mobile_mask.sum())
    with open(xdatcar, "w") as fh:
        for t in range(F):
            fh.write("NPT demo\n1.0\n")        # header repeats every frame
            for row in cells[t]:
                fh.write("%.10f %.10f %.10f\n" % tuple(row))
            fh.write("S Li\n%d %d\n" % (n_static, n_mobile))
            fh.write("Direct configuration= %d\n" % (t + 1))
            for x in frac[t]:
                fh.write("%.10f %.10f %.10f\n" % tuple(x))
    print(f"wrote NPT XDATCAR: {F} frames, ±2% cell breathing -> {xdatcar}")

    # --- 2. the default policy refuses; the bridge recovers the dynamics -
    try:
        open_trajectory(xdatcar)
    except ValueError as e:
        print(f"default policy: {str(e)[:72]}...")

    reader = open_trajectory(xdatcar, variable_cell="rescale")
    traj = reader[0:len(reader)]
    recovery = np.abs(traj - md.traj).max()
    print(f"rescale bridge: max |bridged - fixed-cell truth| = "
          f"{recovery:.2e} A")
    assert recovery < 1e-4

    # --- 3. full pipeline on the bridged trajectory -----------------------
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(verbose=False).run(sn0)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          minimum_site_occupancy=0.01, verbose=False,
                          device=dev)
    st = la.run(seeds, traj.astype(np.float32))
    JumpAnalysis(verbose=False, device=dev).run(st)
    sn = st.site_network

    true_jumps = int(md.true_n_ij.sum())
    found_jumps = int(sn.n_ij.sum() - np.trace(sn.n_ij))
    print(f"sites discovered: {sn.n_sites} "
          f"(ground truth wells: {len(md.true_sites)})")
    print(f"off-diagonal jumps: {found_jumps} (ground truth hops: "
          f"{true_jumps})")
    print("NPT walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
