"""Validation on the card: ``StreamingLandmarkAnalysis`` through the
unique-atom kernels, on a cell large enough that the tile-preshift bound
holds, against the same engine on its dense route.

The system: ``make_hopping_trajectory(n_cells=16, n_ions=8, n_frames=750,
jump_rate=0.03, seed=17)`` (4096 body-centre sites of a 64 Å simple-cubic
host), the analytic cage basis (each site's 8 corner atoms, as the bench
builds it), cutoff midpoint 3.5 Å, steepness 5, ``logistic_r2``.  The
engine's basis (``prepare_engine_basis`` with the engine's drift budget of
1 Å) must take the preshift route.  Then the engine runs twice from the fit
on, in blocks of 125 frames with the labels spilled: ``use_fused=True``
(on a card K2 in the fit and K1 in pass 2; the plain versions on the CPU)
and ``use_fused=False`` (the dense route).

Held, as in the reference's script: labels agree on more than 0.9999 of
(frame, ion) pairs, ``n_ij`` is equal, occupancies agree within 1e-12.

Run from the root of a checkout::

    python3 -m sitator_tpu_torch.tools.validate_preshift_streaming
        [--device {cuda,cpu}]

It prints one JSON line.  Exit 1 without a card (unless ``--device
cpu``), and non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from sitator_tpu_torch.tools import bench

N_CELLS, A_LAT = 16, 4.0
MIDPOINT, STEEPNESS, CUTOFF = 3.5, 5.0, "logistic_r2"
N_FRAMES, BLOCK_FRAMES = 750, 125


def cage_network(n_frames=N_FRAMES):
    """The hopping trajectory and its ``SiteNetwork`` with the analytic cage
    basis: ``(md, sn)``."""
    from sitator_tpu_torch import SiteNetwork
    from sitator_tpu_torch.io import make_hopping_trajectory
    md = make_hopping_trajectory(n_cells=N_CELLS, a=A_LAT, n_ions=8,
                                 n_frames=n_frames, jump_rate=0.03,
                                 sigma_mobile=0.25, seed=17)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    g = np.arange(N_CELLS)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    sn.centers = (grid + 0.5) * A_LAT
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(-1, 3)
    v = (grid[:, None, :] + corners[None]) % N_CELLS       # (S, 8, 3)
    sn.vertices = list(((v[..., 0] * N_CELLS + v[..., 1]) * N_CELLS
                        + v[..., 2]).astype(np.int32))
    return md, sn


def preshift_basis(sn):
    """The engines' basis for ``sn`` at the drift budget of 1 Å, or None
    when the unique-atom route is not taken."""
    from sitator_tpu_torch.ops.landmark_mxu import prepare_engine_basis
    verts, vmask = sn.padded_vertices()
    static_idx = np.flatnonzero(sn.static_mask)
    return prepare_engine_basis(
        verts, vmask, sn.centers, sn.structure.cell, midpoint=MIDPOINT,
        steepness=STEEPNESS, cutoff_shape=CUTOFF,
        static_ref=sn.structure.positions[static_idx], drift_budget=1.0)


def run(sn, frames, use_fused, device, path, block_frames=BLOCK_FRAMES):
    """The engine from the fit on, labels spilled to ``path``: ``(result
    network, labels, engine)``."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=MIDPOINT, cutoff_steepness=STEEPNESS,
        cutoff_shape=CUTOFF, block_frames=block_frames, use_fused=use_fused,
        store_labels=path, verbose=False, device=device)
    out = sla.run(sn, frames)
    return out, np.load(path), sla


def validate(device, n_frames=N_FRAMES, block_frames=BLOCK_FRAMES):
    """Both runs and the checks; returns the result dict, raises
    :class:`bench.CheckFailed` when a check fails."""
    md, sn = cage_network(n_frames)
    basis = preshift_basis(sn)
    if basis is None or not basis["preshift"]:
        raise bench.CheckFailed("the preshift route is not active")
    with tempfile.TemporaryDirectory() as tmp:
        out_f, lab_f, eng_f = run(sn, md.traj, True, device,
                                  os.path.join(tmp, "fused.npy"),
                                  block_frames)
        out_d, lab_d, eng_d = run(sn, md.traj, False, device,
                                  os.path.join(tmp, "dense.npy"),
                                  block_frames)
    agree = float(np.mean(lab_f == lab_d))
    if not agree > 0.9999:
        raise bench.CheckFailed(f"labels agree on {agree} of (frame, ion) "
                                "pairs")
    if not np.array_equal(out_f.n_ij, out_d.n_ij):
        raise bench.CheckFailed("n_ij differs from the dense route")
    occ_err = float(np.abs(np.asarray(out_f.occupancies)
                           - np.asarray(out_d.occupancies)).max())
    if not occ_err <= 1e-12:
        raise bench.CheckFailed(f"occupancies differ by {occ_err:.3g}")
    return dict(sites=sn.n_sites, n_frames=n_frames, s_tile=basis["s_tile"],
                fitted_sites=int(out_f.n_sites), jumps=int(out_f.n_ij.sum()),
                label_agreement=agree, occupancy_err=occ_err,
                route_fused=eng_f.route_, route_dense=eng_d.route_)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.validate_preshift_streaming",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        info = {"device": "cpu", "card": "cpu", "probe_s": None}
    else:
        info = bench.tool_device("validate_preshift_streaming")
        if info is None:
            return 1
    res = validate(args.device)
    print(json.dumps(dict(res, **info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
