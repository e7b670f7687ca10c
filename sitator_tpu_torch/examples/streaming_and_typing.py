"""Second walkthrough: out-of-core streaming analysis + SOAP site typing.

Covers BASELINE configs 4 (descriptor merging / typing) and 5 (streaming):
the trajectory is consumed from a memmapped .npy through the prefetching
feeder, statistics accumulate on device with cross-block carry chaining,
and the discovered sites are typed by their SOAP environments.

Run:  python3 -m sitator_tpu_torch.examples.streaming_and_typing
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
from sitator_tpu_torch.io import NpyTrajectory, make_hopping_trajectory
from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
from sitator_tpu_torch.site_descriptors import (
    SiteTypeAnalysis,
    SOAPDescriptorAverages,
)
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "streaming_and_typing"


def stream(dev, tmp):
    """Seed, stream from disk, merge: ``(md, merged network, remap)``."""
    # --- a "large" trajectory living on disk, never fully in RAM
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=4000,
                                 jump_rate=0.02, seed=5)
    traj_path = os.path.join(tmp, "traj.npy")
    np.save(traj_path, md.traj)
    reader = NpyTrajectory(traj_path)
    print(f"trajectory on disk: {len(reader)} frames, "
          f"{reader.n_atoms} atoms")

    # --- seed + stream
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator().run(sn)
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=512,
        store_labels=os.path.join(tmp, "labels.npy"),
        checkpoint_path=os.path.join(tmp, "run.ckpt"), checkpoint_every=2,
        device=dev)
    out = sla.run(seeds, reader)
    print(f"streamed (raw): {out.n_sites} sites, "
          f"{int(out.n_ij.sum())} jumps")

    # --- stats-level post-merge collapses the over-split landmark sites
    out, remap = StreamingLandmarkAnalysis.merge_network(
        out, distance_threshold=2.0, device=dev)
    print(f"after merge: {out.n_sites} sites, {int(out.n_ij.sum())} jumps "
          f"(truth: {md.true_n_ij.sum()})")
    return md, out, remap


def typing(dev, tmp, md, out, remap):
    """SOAP site typing of the merged sites."""
    # --- rebuild a SiteTrajectory from the spilled labels for typing
    labels = np.load(os.path.join(tmp, "labels.npy"))
    labels = np.where(labels >= 0, remap[labels], -1).astype(np.int32)
    st = SiteTrajectory(out, labels)
    st.set_real_traj(md.traj)

    sta = SiteTypeAnalysis(SOAPDescriptorAverages(r_cut=4.5, averages_n=8,
                                                  device=dev),
                           max_types=4, device=dev)
    sta.run(st)
    print(f"site types: {np.bincount(out.site_types)} (counts per type)")
    print("occupancy by type:",
          [round(float(out.occupancies[out.site_types == t].mean()), 3)
           for t in np.unique(out.site_types)])


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    tmp = tempfile.mkdtemp(prefix="sitator_stream_")
    md, out, remap = stream(args.device, tmp)
    typing(args.device, tmp, md, out, remap)
    print(f"artifacts in {tmp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
