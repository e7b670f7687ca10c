"""Entry points of the port's analysis step and frame-sharded path
(counterpart of the repository's ``__graft_entry__.py``).

``entry()`` returns the dense analysis step (landmark vectors → assignment →
jump statistics) with small example arguments.  ``dryrun_multichip(n)``
builds an ``n``-shard frame mesh over one device (a virtual mesh: the device
repeats) and runs the whole analysis on it, each result held to its
unsharded run: the pipeline, the streaming engine on its kernel route,
checkpoint/resume under the mesh, a second mesh size, and a frame count no
mesh divides over a basis of several kd site tiles.

Run as ``python -m sitator_tpu_torch.graft_entry [--device cpu]``.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _example_system(n_cells=3, n_frames=8, n_ions=3, seed=0):
    """Tiny deterministic simple-cubic system with analytic cage vertex
    sets (the reference's, array for array)."""
    rng = np.random.default_rng(seed)
    a = 4.0
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    n_static = len(grid)
    host = grid * a
    cell = np.eye(3, dtype=np.float32) * (n_cells * a)
    # vertices of cage (i, j, k): the 8 surrounding lattice corners
    idx3 = {tuple(g): i for i, g in enumerate(grid)}
    verts = np.zeros((n_static, 8), np.int32)
    for s, g in enumerate(grid):
        k = 0
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    gg = ((g[0] + di) % n_cells, (g[1] + dj) % n_cells,
                          (g[2] + dk) % n_cells)
                    verts[s, k] = idx3[gg]
                    k += 1
    vmask = np.ones_like(verts, dtype=bool)
    static = (host[None] + rng.normal(scale=0.05,
                                      size=(n_frames, n_static, 3))
              ).astype(np.float32)
    sites = (grid + 0.5) * a
    occ = rng.choice(n_static, size=n_ions, replace=False)
    mobile = (sites[occ][None] + rng.normal(scale=0.2,
                                            size=(n_frames, n_ions, 3))
              ).astype(np.float32)
    return mobile, static, verts, vmask, cell, n_static


def _seed_network(mobile, static, verts, cell, n_static, n_cells, a=4.0):
    """The seed SiteNetwork (cage centres + vertex lists) of an
    :func:`_example_system`."""
    from sitator_tpu_torch.core import SiteNetwork, Structure

    n_ions = mobile.shape[1]
    positions = np.concatenate(
        [static[0], mobile[0]], axis=0).astype(np.float64)
    species = np.array([16] * n_static + [3] * n_ions)
    s = Structure(positions, species, np.asarray(cell, np.float64))
    static_mask = np.arange(len(positions)) < n_static
    sn = SiteNetwork(s, static_mask, ~static_mask)
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    sn.centers = (grid + 0.5) * a
    sn.vertices = [v for v in verts]  # full-structure indices == static here
    return sn


def _fit(mobile, static, verts, vmask, cell, n_static, device):
    """Cluster centres and their live mask from the system's own landmark
    vectors (landmark vectors → dot-product clustering)."""
    from sitator_tpu_torch.ops.cluster import dotprod_fit
    from sitator_tpu_torch.ops.landmark import (landmark_vectors,
                                                normalize_landmark_vectors,
                                                vertex_membership_matrix)
    A = vertex_membership_matrix(verts, vmask, n_static).to(device)
    lv = landmark_vectors(
        torch.as_tensor(mobile, device=device),
        torch.as_tensor(static, device=device), A,
        torch.as_tensor(cell, dtype=torch.float32, device=device),
        torch.as_tensor(np.linalg.inv(cell), dtype=torch.float32,
                        device=device), 4.0, 3.0)
    lvn, _ = normalize_landmark_vectors(lv)
    res = dotprod_fit(lvn.reshape(-1, A.shape[1]), k_max=32,
                      cluster_threshold=0.45, min_samples=2)
    return res["centers"].cpu().numpy(), res["active"].cpu().numpy()


def entry(device="cuda"):
    """(fn, example_args): the dense analysis step on the toy system, its
    arguments as tensors on ``device``."""
    from sitator_tpu_torch.ops.landmark import vertex_membership_matrix
    from sitator_tpu_torch.parallel.pipeline import analysis_step

    mobile, static, verts, vmask, cell, n_static = _example_system()
    A = vertex_membership_matrix(verts, vmask, n_static)
    n_landmarks = A.shape[1]
    rng = np.random.default_rng(1)
    K = 16
    centers = rng.random((K, n_landmarks)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    cell_inv = np.linalg.inv(cell).astype(np.float32)

    def fn(mobile, static, A, cell, cell_inv, centers, active):
        return analysis_step(
            mobile, static, A, cell, cell_inv, centers, active,
            4.0, 3.0, 0.35, n_sites=K)

    args = tuple(torch.as_tensor(x).to(device) for x in (
        mobile, static, A, cell, cell_inv, centers, np.ones(K, bool)))
    return fn, args


class _Interrupt(Exception):
    pass


def _flaky_reader(arr, die_after):
    """A trajectory reader that raises :class:`_Interrupt` once it has
    served ``die_after`` reads (never when None)."""
    from sitator_tpu_torch.io import ArrayTrajectory

    class FlakyReader(ArrayTrajectory):
        served = 0

        def __getitem__(self, key):
            self.served += 1
            if die_after is not None and self.served > die_after:
                raise _Interrupt()
            return super().__getitem__(key)

    return FlakyReader(arr)


def _same(got, want, what):
    for k in ("n_ij", "occupancies"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{what}: {k}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The whole frame-sharded analysis on a virtual ``n_devices``-shard
    mesh over ``device``, each result held to its unsharded run; raises
    AssertionError on a mismatch."""
    from sitator_tpu_torch.landmark.streaming import \
        StreamingLandmarkAnalysis
    from sitator_tpu_torch.ops.landmark_mxu import prepare_engine_basis
    from sitator_tpu_torch.parallel import SpmdLandmarkPipeline, frame_mesh

    def mesh_of(n):
        return frame_mesh(devices=[device] * n)

    n_frames = 4 * n_devices
    mobile, static, verts, vmask, cell, n_static = _example_system(
        n_frames=n_frames)
    n_ions = mobile.shape[1]
    centers, active = _fit(mobile, static, verts, vmask, cell, n_static,
                           device)
    sn = _seed_network(mobile, static, verts, cell, n_static, n_cells=3)
    frames = np.concatenate([static, mobile], axis=1)

    # the pipeline over the mesh == over one device
    mesh = mesh_of(n_devices)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              assignment_threshold=0.35, device=device)
    labels, confs, stats = SpmdLandmarkPipeline(
        sn, centers, active, mesh=mesh, **kw).run_block(frames)
    lab1, conf1, stats1 = SpmdLandmarkPipeline(
        sn, centers, active, mesh=mesh_of(1), **kw).run_block(frames)
    if labels.shape != (n_frames, n_ions) \
            or stats["n_ij"].shape[0] != centers.shape[0]:
        raise AssertionError(f"pipeline shapes {labels.shape}, "
                             f"{stats['n_ij'].shape}")
    np.testing.assert_array_equal(labels, lab1)
    np.testing.assert_array_equal(confs, conf1)
    for k in ("n_ij", "occ_counts", "last_sites", "last_res"):
        np.testing.assert_array_equal(stats[k], stats1[k], err_msg=k)

    # the streaming engine on its kernel route over the same mesh
    centers_act = centers[active]
    k_active = len(centers_act)
    skw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
               block_frames=n_devices * 2, use_fused=True, verbose=False,
               device=device)
    out = StreamingLandmarkAnalysis(mesh=mesh, **skw).run(
        sn, frames, centers=centers_act)
    if out.n_sites != k_active or out.n_ij.shape != (k_active, k_active):
        raise AssertionError(f"streaming: {out.n_sites} sites")
    if not np.isfinite(np.asarray(out.occupancies)).all():
        raise AssertionError("streaming: non-finite occupancies")
    _same(out, StreamingLandmarkAnalysis(**skw).run(
        sn, frames, centers=centers_act), "streaming over the mesh")

    # checkpoint/resume under the mesh: an interrupted meshed run resumed
    # from its mid-run checkpoint equals the uninterrupted meshed run
    with tempfile.TemporaryDirectory(prefix="graft_dryrun_") as tmp:
        ckpt = os.path.join(tmp, "mesh.ckpt")
        sla_ck = StreamingLandmarkAnalysis(mesh=mesh, checkpoint_path=ckpt,
                                           checkpoint_every=1, **skw)
        try:
            sla_ck.run(sn, _flaky_reader(frames, 1), centers=centers_act)
            raise AssertionError("the flaky reader did not interrupt")
        except _Interrupt:
            pass
        if not os.path.exists(ckpt):
            raise AssertionError("no mid-run checkpoint was written")
        out_ck = sla_ck.run(sn, _flaky_reader(frames, None),
                            centers=centers_act)
        _same(out_ck, out, "checkpoint/resume under the mesh")
        if os.path.exists(ckpt):
            raise AssertionError("the checkpoint was not removed")

    # a second mesh size, a frame count no mesh divides (a short last
    # block, padded only to the mesh size) and a basis of several kd site
    # tiles (343 sites)
    n_cells2 = 7
    n_frames2 = 3 * n_devices + 5
    mobile2, static2, verts2, vmask2, cell2, n_static2 = _example_system(
        n_cells=n_cells2, n_frames=n_frames2, n_ions=4, seed=2)
    sn2 = _seed_network(mobile2, static2, verts2, cell2, n_static2,
                        n_cells=n_cells2)
    basis2 = prepare_engine_basis(
        verts2, vmask2, sn2.centers, cell2, midpoint=4.0, steepness=3.0,
        cutoff_shape="logistic", static_ref=static2[0], drift_budget=1.0)
    if basis2 is None or basis2["n_st"] < 2:
        raise AssertionError("multi-tile coverage needs >= 2 kd site tiles")
    c2, a2 = _fit(mobile2[:8], static2[:8], verts2, vmask2, cell2,
                  n_static2, device)
    centers2 = c2[a2]
    frames2 = np.concatenate([static2, mobile2], axis=1)

    def stream(m):
        size = 1 if m is None else m.devices.size
        return StreamingLandmarkAnalysis(
            **dict(skw, block_frames=2 * size), mesh=m).run(
                sn2, frames2, centers=centers2)

    ref2 = stream(None)
    meshes = [mesh]
    if 2 <= n_devices // 2 < n_devices:  # a genuinely different mesh size
        meshes.append(mesh_of(n_devices // 2))
    for m in meshes:
        _same(stream(m), ref2, f"{m.devices.size}-shard mesh, "
              f"{n_frames2} frames")

    print(f"dryrun_multichip({n_devices}, {device}): OK — labels "
          f"{labels.shape}, {int(stats['n_ij'].sum())} jumps, mesh "
          f"{mesh.devices.shape}, streaming {out.n_sites} sites, meshed "
          f"checkpoint-resume equal; meshes "
          f"{[m.devices.size for m in meshes]} equal on {n_frames2} frames "
          f"(uneven blocks) over a {basis2['n_st']}-tile basis "
          f"({sn2.n_sites} sites, s_tile={basis2['s_tile']})")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-devices", type=int, default=8)
    a = p.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry OK:", {k: tuple(v.shape) for k, v in out[2].items()})
    dryrun_multichip(a.n_devices, a.device)
