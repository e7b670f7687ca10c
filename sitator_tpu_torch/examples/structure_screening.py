"""Trajectory-free structure screening — from a CIF to candidate
migration sites and back, no MD required.

A common workflow before any simulation exists: take a host framework
(CIF with symmetry), expand to a supercell, propose interstitial sites
two independent ways (empty-lattice Voronoi geometry vs bond-valence
mismatch), cross-check the proposals, and export the decorated
structure for a visualizer or a DFT input pipeline.  Round-trips
entirely through sitator_tpu_torch's own structure I/O
(symmetry-expanding ``read_cif``, ``write_cif``/``write_structure``).

Run:  python3 -m sitator_tpu_torch.examples.structure_screening
      [--device {cuda,cpu}]
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
from sitator_tpu_torch.io import read_cif, read_structure, write_cif
from sitator_tpu_torch.network import BondValenceSiteGenerator
from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "structure_screening"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    workdir = tempfile.mkdtemp(prefix="screening_")

    # --- 1. a rocksalt-like O framework as a symmetry-bearing CIF ------
    # Asymmetric unit: ONE oxygen at the origin; the F m -3 m
    # face-centering translations expand it to the full 4-atom
    # conventional cell.
    a = 2 * (1.466 + 0.37 * np.log(6.0))  # softBV-consistent Li-O spacing
    cif_in = os.path.join(workdir, "host.cif")
    with open(cif_in, "w") as f:
        f.write(f"""data_host
_cell_length_a {a:.6f}
_cell_length_b {a:.6f}
_cell_length_c {a:.6f}
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
loop_
_symmetry_equiv_pos_as_xyz
'x, y, z'
'x, y+1/2, z+1/2'
'x+1/2, y, z+1/2'
'x+1/2, y+1/2, z'
loop_
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
O 0 0 0
""")
    host = read_cif(cif_in)
    print(f"host from CIF: {host.n_atoms} O atoms after symmetry expansion "
          f"(asymmetric unit had 1)")
    assert host.n_atoms == 4

    # --- 2. supercell + two independent site proposals -----------------
    sup = host * (2, 2, 2)
    print(f"supercell: {sup.n_atoms} atoms")
    sn0 = SiteNetwork(sup, np.ones(sup.n_atoms, bool),
                      np.zeros(sup.n_atoms, bool))

    sn_vor = VoronoiSiteGenerator(verbose=False).run(sn0)
    sn_bv = BondValenceSiteGenerator(cation="Li", v_ideal=1.0,
                                     mismatch_tol=0.3, verbose=False,
                                     device=args.device).run(sn0)
    print(f"Voronoi candidates: {sn_vor.n_sites}; "
          f"bond-valence sites for Li: {sn_bv.n_sites}")

    # --- 3. cross-check: every BV site is one of the geometric candidates
    calc = PBCCalculator(sup.cell)
    d = calc.pairwise_distances(sn_bv.centers, sn_vor.centers)
    worst = float(d.min(axis=1).max())
    print(f"every BV site sits on a Voronoi candidate (max offset "
          f"{worst:.3f} Angstrom)")
    assert worst < 0.3

    # --- 4. export the decorated structure through the CIF writer ------
    cif_out = os.path.join(workdir, "host_with_sites.cif")
    write_cif(cif_out, sn_bv.get_structure_with_sites())
    back = read_structure(cif_out)
    n_markers = int((np.asarray(back.species) == 0).sum())
    print(f"exported {cif_out}: {back.n_atoms} rows "
          f"({n_markers} site markers + {sup.n_atoms} host atoms) "
          "round-trip through read_structure")
    assert n_markers == sn_bv.n_sites
    assert back.n_atoms == sup.n_atoms + sn_bv.n_sites

    print("Structure-screening walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
