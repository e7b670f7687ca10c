"""Seventh walkthrough: cloud-scale chunked storage + GAP-fidelity SOAP.

1. Convert a trajectory into a **zarr store** — the frame-chunked format
   (blosc/LZ4 chunks, the metadata tensorstore writes) — and stream the
   full analysis off it, bit-identical to the in-memory run.
2. Type the discovered sites with the **Gaussian-smeared** SOAP density
   (``density='gauss'``): the exact atom-centered-Gaussian expansion via
   analytic Bessel-integral tables — the same density model quippy/GAP
   and dscribe integrate — and show it separates tetrahedral from
   octahedral holes exactly like the fast delta density does.

Run:  python3 -m sitator_tpu_torch.examples.zarr_and_smeared_soap
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

from sitator_tpu_torch import SiteNetwork, SiteTrajectory
from sitator_tpu_torch.io import (
    ArrayTrajectory,
    TensorstoreTrajectory,
    convert_to_zarr,
    make_fcc_hopping_trajectory,
    open_trajectory,
)
from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.site_descriptors import (
    SiteTypeAnalysis,
    SOAPDescriptorAverages,
)
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "zarr_and_smeared_soap"


def stream(dev, tmp):
    """Step 1: ``(md, streamed network)`` from the zarr store."""
    # --- an FCC interstitial trajectory, converted into a chunked store
    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=16,
                                     n_frames=3000, jump_rate=0.05, seed=11)
    store = os.path.join(tmp, "md.zarr")
    convert_to_zarr(ArrayTrajectory(md.traj, md.structure), store,
                    chunk_frames=256, verbose=True)
    reader = open_trajectory(store)      # dispatches on the store dir
    assert isinstance(reader, TensorstoreTrajectory)
    print(f"zarr store: {len(reader)} frames, structure sidecar "
          f"{'restored' if reader.structure is not None else 'missing'}")

    # --- stream the analysis off the store; compare against in-memory
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator().run(sn)
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=3.1, cutoff_steepness=4.0, block_frames=512,
        store_labels=os.path.join(tmp, "labels.npy"), verbose=False,
        device=dev)
    centers = sla.fit_centers(seeds, reader)
    out = sla.run(seeds, reader, centers=centers)
    out_mem = StreamingLandmarkAnalysis(
        cutoff_midpoint=3.1, cutoff_steepness=4.0, block_frames=512,
        verbose=False, device=dev).run(seeds, md.traj, centers=centers)
    assert np.array_equal(out.n_ij, out_mem.n_ij)
    print(f"streaming off zarr == in-memory: {int(out.n_ij.sum())} "
          f"jumps, {out.n_sites} sites (bit-identical)")
    return md, out


def typing(dev, tmp, md, out):
    """Step 2: both SOAP density models."""
    labels = np.load(os.path.join(tmp, "labels.npy"))
    # ground truth per discovered site: tet/oct kind of the nearest true
    # hole
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(out.centers, md.true_sites)
    true_kind = md.true_site_types[np.argmin(d, axis=1)]

    types = {}
    for density in ("delta", "gauss"):
        st = SiteTrajectory(out, labels)
        st.set_real_traj(md.traj)
        sta = SiteTypeAnalysis(
            SOAPDescriptorAverages(r_cut=4.5, averages_n=8, density=density,
                                   verbose=False, device=dev),
            n_types=2, verbose=False, device=dev)
        sta.run(st)
        types[density] = out.site_types.copy()
        agree = np.mean(types[density] == true_kind)
        print(f"{density:5s} density: typing matches tet/oct ground truth: "
              f"{100 * max(agree, 1 - agree):.0f}%")

    match = np.mean(types["delta"] == types["gauss"])
    print(f"delta vs gauss typing agreement: "
          f"{100 * max(match, 1 - match):.0f}%")


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    tmp = tempfile.mkdtemp(prefix="sitator_zarr_")
    md, out = stream(args.device, tmp)
    typing(args.device, tmp, md, out)
    print(f"artifacts in {tmp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
