"""Fifth walkthrough: frame-parallel analysis on a mesh.

The workload's natural parallel axis is the frame axis: landmark vectors
are embarrassingly parallel over frames, and the only cross-device
traffic is tiny per-site reductions.  One 1-D frame mesh
(`sitator_tpu_torch.parallel.frame_mesh`) therefore covers the whole
scaling story — on a host with several cards the same code spreads over
all of them.

This script demonstrates it on ONE device by giving the mesh 8 shards of
it (``frame_mesh(devices=[device] * 8)``: on a card each shard runs on its
own stream; on the CPU it is the test suite's virtual mesh), then shows:

1. `StreamingLandmarkAnalysis(mesh=...)` — the out-of-core engine
   sharding every block over all 8 shards;
2. bit-exactness: the 8-shard run reproduces the single-device run label
   for label and count for count (masked padding + sum-only stats make
   the math invariant to the shard count).

Run:  python3 -m sitator_tpu_torch.examples.multichip_mesh
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
from sitator_tpu_torch.io import NpyTrajectory, make_hopping_trajectory
from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
from sitator_tpu_torch.parallel import frame_mesh
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "multichip_mesh"
N_SHARDS = 8
# the streaming engine's settings, the prefix of the run's temporary
# directory and the file each run ("1dev", "8dev") spills its labels to
ENGINE = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=512)
TMP_PREFIX = "sitator_mesh_"
LABELS = "labels_{}.npy"


def system():
    """The hopping MD and its Voronoi seeds: ``(md, seeds)``."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=4096,
                                 jump_rate=0.02, seed=9)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    return md, VoronoiSiteGenerator(verbose=False).run(sn)


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device
    mesh = frame_mesh(devices=[dev] * N_SHARDS)   # 8 shards, frame axis
    print(f"devices: {len(mesh.devices)} x {mesh.devices[0].type}")

    tmp = tempfile.mkdtemp(prefix=TMP_PREFIX)
    md, seeds = system()
    traj_path = os.path.join(tmp, "traj.npy")
    np.save(traj_path, md.traj)

    def stream(mesh, tag):
        sla = StreamingLandmarkAnalysis(
            **ENGINE, mesh=mesh,
            store_labels=os.path.join(tmp, LABELS.format(tag)),
            verbose=False, device=dev)
        out = sla.run(seeds, NpyTrajectory(traj_path))
        labels = np.load(os.path.join(tmp, LABELS.format(tag)))
        return out, labels

    out1, labels1 = stream(None, "1dev")
    print(f"single device : {out1.n_sites} sites, "
          f"{int(out1.n_ij.sum())} jumps")

    out8, labels8 = stream(mesh, "8dev")
    print(f"8-device mesh  : {out8.n_sites} sites, "
          f"{int(out8.n_ij.sum())} jumps")

    assert np.array_equal(labels1, labels8), "labels must be bit-identical"
    assert np.array_equal(np.asarray(out1.n_ij), np.asarray(out8.n_ij))
    assert np.allclose(np.asarray(out1.occupancies),
                       np.asarray(out8.occupancies))
    print("8-device run is bit-identical to the single-device run.")
    print("On a host with several cards the identical code runs with "
          "frame_mesh() —")
    print("it picks up every visible card and blocks stream over all of "
          "them.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
