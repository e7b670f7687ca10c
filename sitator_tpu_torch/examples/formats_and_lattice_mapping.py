"""Third walkthrough: real-world trajectory formats and a self-healing
lattice.

1. Dump the synthetic MD to a LAMMPS text dump, read it back through the
   native multithreaded decoder, and convert it to the memmapped ``.npy``
   the streaming engine prefers.
2. Swap two host-lattice atoms mid-trajectory (a lattice-site exchange —
   the kind of event that invalidates a naive landmark basis) and show
   ``dynamic_lattice_mapping`` recovering statistics identical to the
   unswapped run, while the default guard raises ``StaticLatticeError``.

Run:  python3 -m sitator_tpu_torch.examples.formats_and_lattice_mapping
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
from sitator_tpu_torch.io import convert_to_npy, make_hopping_trajectory, \
    open_trajectory
from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
from sitator_tpu_torch.util.errors import StaticLatticeError
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "formats_and_lattice_mapping"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device
    work = Path(tempfile.mkdtemp(prefix="sitator_formats_"))
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=1000,
                                 jump_rate=0.02, seed=7)
    sn = VoronoiSiteGenerator(verbose=False).run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))

    # --- 1. format round trip: LAMMPS dump -> native decoder -> .npy -----
    dump = work / "run.lammpstrj"
    L = np.diag(md.structure.cell)
    with open(dump, "w") as fh:
        for t in range(md.n_frames):
            fh.write("ITEM: TIMESTEP\n%d\nITEM: NUMBER OF ATOMS\n%d\n"
                     % (t, md.structure.n_atoms))
            fh.write("ITEM: BOX BOUNDS pp pp pp\n")
            for ax in range(3):
                fh.write("0.0 %.6f\n" % L[ax])
            fh.write("ITEM: ATOMS id type x y z\n")
            for i in range(md.structure.n_atoms):
                fh.write("%d %d %.6f %.6f %.6f\n"
                         % (i + 1, md.structure.species[i], *md.traj[t, i]))
    reader = open_trajectory(dump)          # native decoder when available
    print(f"read {len(reader)} frames x {reader.n_atoms} atoms "
          f"via {type(reader).__name__}")
    _, npy = convert_to_npy(str(dump), str(work / "run.npy"))
    reader = open_trajectory(npy)           # memmapped: zero-copy blocks
    print(f"converted to {npy}")

    # --- 2. a lattice-site exchange mid-run ------------------------------
    swapped = reader[0:len(reader)].astype(np.float64)
    static_atoms = np.flatnonzero(md.static_mask)
    i, j = static_atoms[5], static_atoms[13]
    T = 493
    swapped[T:, [i, j]] = swapped[T:, [j, i]]
    print(f"swapped host atoms {i} <-> {j} at frame {T}")

    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=128,
                                    verbose=False, device=dev)
    centers = sla.fit_centers(sn, open_trajectory(npy))
    ref = sla.run(sn, open_trajectory(npy), centers=centers)

    try:
        StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=128,
            verbose=False, device=dev).run(sn, swapped, centers=centers)
    except StaticLatticeError as e:
        print(f"default guard: StaticLatticeError ({e})")

    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=128,
                                    dynamic_lattice_mapping=True,
                                    verbose=False, device=dev)
    out = dyn.run(sn, swapped, centers=centers)
    assert np.array_equal(out.n_ij, ref.n_ij)
    perm = dyn.lattice_mapping_
    moved = np.flatnonzero(perm != np.arange(len(perm)))
    print(f"dynamic_lattice_mapping: remapped slots {moved.tolist()}, "
          f"statistics identical to the unswapped run "
          f"({int(out.n_ij.sum())} jumps)")
    print("artifacts in", work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
