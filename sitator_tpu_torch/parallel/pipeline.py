"""The per-block analysis step (counterpart of
``sitator_tpu.parallel.pipeline``), on one device or over a frame mesh.

Landmark vectors → peak evening → normalisation → site assignment → jump
statistics for a block of frames.  Three routes, dispatched as in the
reference: the unique-atom kernel (K1) when the basis shares vertices, the
gather kernel (K3) otherwise, and the dense torch step with
``use_fused=False``.  Over a mesh of several shards the route's kernel (or
the dense assignment) runs once per frame shard through
:func:`~sitator_tpu_torch.parallel.mesh.shard_map_frames`; labels and
confidences are gathered on the mesh's first device, where the label remap
and the jump statistics run once over the whole block.
"""
from __future__ import annotations

import numpy as np
import torch

from sitator_tpu_torch.ops import landmark as lmops
from sitator_tpu_torch.ops.jumps import (JumpStats, _jump_stats,
                                         _jump_stats_parallel)
from sitator_tpu_torch.parallel.mesh import (FrameMesh, bind_mesh,
                                             frame_mesh, pad_frames,
                                             place_frames, run_sharded)

__all__ = ["SpmdLandmarkPipeline", "analysis_step", "fused_analysis_step",
           "mxu_analysis_step"]


def mxu_analysis_step(mesh, mobile, static, basis, cell, centers_perm, *,
                      midpoint, steepness, threshold,
                      cutoff_shape="logistic", mxu_bf16=True,
                      active_idx=None, n_sites=None,
                      peak_evening="none", valid=None, carry=None):
    """Analysis step on the unique-atom kernel (K1), once per frame shard
    of ``mesh`` (None: the one device of the inputs).  ``mobile`` /
    ``static`` are tensors or :class:`ShardedFrames`; ``basis`` from
    ``prepare_mxu_basis`` (tensors), ``centers_perm`` with kd-ordered
    columns.  Returns (labels, confs, stats) on the mesh's first device."""
    from sitator_tpu_torch.ops.landmark_mxu import mxu_assign_blocks

    def local(mobile, static, basis, cell, centers_perm):
        return mxu_assign_blocks(
            mobile, static, basis, cell, centers_perm, midpoint=midpoint,
            steepness=steepness, threshold=threshold, mxu_bf16=mxu_bf16,
            cutoff_shape=cutoff_shape, peak_evening=peak_evening)

    labels, confs = run_sharded(local, mesh, 2, mobile, static, basis,
                                cell, centers_perm)
    return _finish(labels, confs, centers_perm, active_idx, n_sites, valid,
                   carry)


def fused_analysis_step(mesh, mobile, static, verts, vmask, cell, centers,
                        *, midpoint, steepness, threshold, s_tile=256,
                        cutoff_shape="logistic", mxu_bf16=True,
                        active_idx=None, n_sites=None, peak_evening="none",
                        full_mask=False, valid=None, carry=None):
    """Analysis step on the gather kernel (K3), once per frame shard of
    ``mesh`` (None: the one device of the inputs).  ``active_idx``
    (optional) remaps the kernel's compact labels to the caller's cluster
    indexing before the jump statistics; ``n_sites`` sizes the statistics
    in that indexing.  Returns (labels, confs, stats)."""
    from sitator_tpu_torch.ops.landmark_pallas import fused_assign_blocks

    def local(mobile, static, verts, vmask, cell, centers):
        return fused_assign_blocks(
            mobile, static, verts, vmask, cell, centers, midpoint=midpoint,
            steepness=steepness, threshold=threshold, s_tile=s_tile,
            mxu_bf16=mxu_bf16, cutoff_shape=cutoff_shape,
            peak_evening=peak_evening, full_mask=full_mask)

    labels, confs = run_sharded(local, mesh, 2, mobile, static, verts,
                                vmask, cell, centers)
    return _finish(labels, confs, centers, active_idx, n_sites, valid, carry)


def _finish(labels, confs, centers, active_idx, n_sites, valid, carry):
    if active_idx is not None:
        active_idx = (active_idx if torch.is_tensor(active_idx)
                      else torch.from_numpy(np.asarray(active_idx)))
        labels = _remap_labels(labels, active_idx.to(labels.device))
    if n_sites is None:
        n_sites = _default_n_sites(centers, active_idx)
    labels, stats = _block_stats(labels, int(n_sites), valid, carry)
    return labels, confs, stats


def _default_n_sites(centers, active_idx):
    """Statistics sizing when the caller omits ``n_sites``: with an
    ``active_idx`` remap the labels live in the caller's indexing (up to
    ``max(active_idx)``), not the kernel's compact 0..K-1."""
    if active_idx is not None and active_idx.numel():
        return int(active_idx.max()) + 1
    return int(centers.shape[0])


def _block_stats(labels, n_sites, valid, carry):
    """Jump statistics for one block.  ``valid (F,)`` masks padding frames
    to label −1 (exact no-ops under the unknown-frame policy).  ``carry =
    (last_sites, last_res)`` chains residences across blocks through the
    sequential form; without it the prefix form runs."""
    if valid is not None:
        labels = torch.where(
            torch.as_tensor(valid, device=labels.device)[:, None], labels, -1)
    if carry is not None:
        last, res = (c if torch.is_tensor(c) else torch.tensor(np.asarray(c))
                     for c in carry)
        stats = _jump_stats(labels, n_sites, init_last=last, init_res=res)
    else:
        stats = _jump_stats_parallel(labels, n_sites)
    return labels, stats


def _remap_labels(labels, active_idx):
    """Compact cluster labels → caller indexing; −1 (unknown) passes
    through."""
    mapped = active_idx.to(labels.dtype)[labels.clamp_min(0).long()]
    return torch.where(labels >= 0, mapped, -1)


def _dense_assign(mobile, static, A, cell, cell_inv, centers, active, *,
                  midpoint, steepness, threshold, peak_evening="none",
                  matmul_dtype=None, cutoff_shape="logistic"):
    """Labels and confidences of the dense route for a block (or a shard)
    of frames."""
    lv = lmops.landmark_vectors(mobile, static, A, cell, cell_inv, midpoint,
                                steepness, matmul_dtype=matmul_dtype,
                                cutoff_shape=cutoff_shape)
    lv = lmops.peak_even(lv, peak_evening)
    lv_n, _ = lmops.normalize_landmark_vectors(lv)
    return lmops.assign_to_centers(lv_n, centers, active, threshold,
                                   matmul_dtype=matmul_dtype)


def analysis_step(mobile, static, A, cell, cell_inv, centers, active,
                  cutoff_midpoint, cutoff_steepness, assignment_threshold,
                  n_sites, peak_evening="none", matmul_dtype=None,
                  cutoff_shape="logistic", valid=None, carry=None):
    """The dense analysis step: ``mobile (F, M, 3)``, ``static (F, N, 3)``,
    ``A (N, S)``, ``centers (K, S)``, ``active (K,)``.  Returns (labels
    (F, M), confs (F, M), jump statistics over ``n_sites``)."""
    labels, confs = _dense_assign(
        mobile, static, A, cell, cell_inv, centers, active,
        midpoint=cutoff_midpoint, steepness=cutoff_steepness,
        threshold=assignment_threshold, peak_evening=peak_evening,
        matmul_dtype=matmul_dtype, cutoff_shape=cutoff_shape)
    labels, stats = _block_stats(labels, n_sites, valid, carry)
    return labels, confs, stats


class SpmdLandmarkPipeline:
    """Bind a fitted analysis (landmark basis + cluster centres) to a frame
    mesh and stream frame blocks through the analysis step.

    Parameters
    ----------
    seed_sn : SiteNetwork with vertices — the landmark basis.
    centers : (K, S_landmark) fitted cluster centres (unit rows).
    active : (K,) bool — live clusters; labels use the fitted indexing.
    mesh : a :class:`~sitator_tpu_torch.parallel.mesh.FrameMesh`.  None
        builds one: ``frame_mesh()`` (every visible card) for
        ``device="cuda"``, else a mesh of ``device`` alone.  Its first
        device must be ``device``.  Blocks are padded to a multiple of the
        mesh size (padding frames are masked out of the statistics) and
        each frame shard runs the route's kernel; a one-device mesh calls
        the step directly.
    use_fused : 'auto' (the kernels on CUDA) | True | False (dense step).
    static_drift_budget : Å static atoms may drift from the seed structure;
        the tile-preshift bound budgets for it (None disables preshift).
    device : torch device (default 'cuda').

    The reference's ``interpret`` flag (its kernels' CPU emulation) is left
    out on purpose: on a CPU device the pipeline takes the plain versions.
    """

    def __init__(self, seed_sn, centers, active, *, cutoff_midpoint,
                 cutoff_steepness, assignment_threshold=0.35,
                 peak_evening="none", mesh=None, use_fused="auto",
                 cutoff_shape="logistic", static_drift_budget=3.0,
                 device="cuda"):
        from sitator_tpu_torch.ops.kernel_common import kernel_cell
        if mesh is None:
            d = torch.device(device)
            mesh = (frame_mesh() if d.type == "cuda" and d.index is None
                    else FrameMesh([d]))
        self.mesh, self.device = bind_mesh(mesh, device)
        dev = self.device
        self.n_devices = self.mesh.devices.size
        self.static_drift_budget = static_drift_budget
        self.peak_evening = peak_evening
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.assignment_threshold = float(assignment_threshold)
        self.cutoff_shape = cutoff_shape
        if use_fused == "auto":
            use_fused = dev.type == "cuda"
        self.use_fused = bool(use_fused)

        self.mobile_idx = np.flatnonzero(seed_sn.mobile_mask)
        self.static_idx = np.flatnonzero(seed_sn.static_mask)
        verts, vmask = seed_sn.padded_vertices()
        self._full_mask = bool(np.asarray(vmask).all())
        rep = self.mesh.replicate
        self.verts = rep(torch.as_tensor(verts, device=dev))
        self.vmask = rep(torch.as_tensor(vmask, device=dev))
        # a CPU tensor: the kernels read the cell on the host
        self.kcell = kernel_cell(seed_sn.structure.cell)
        centers = np.asarray(centers, np.float32)
        # the kernel routes use compacted (live-row) centres; labels are
        # remapped back to the caller's cluster indexing on the way out
        self._active_idx = np.flatnonzero(np.asarray(active))
        self._active_idx_t = torch.as_tensor(self._active_idx,
                                             dtype=torch.int32, device=dev)
        centers_compact = centers[self._active_idx]
        self._centers_compact = rep(torch.as_tensor(centers_compact,
                                                    device=dev))
        self._mxu_basis = None
        if self.use_fused:
            from sitator_tpu_torch.ops.landmark_mxu import (
                basis_from_jax, permute_centers, prepare_engine_basis)
            basis = prepare_engine_basis(
                verts, vmask, seed_sn.centers, seed_sn.structure.cell,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=seed_sn.structure.positions[self.static_idx],
                drift_budget=self.static_drift_budget)
            if basis is not None:
                self._mxu_basis = rep(basis_from_jax(basis, dev))
                self._centers_mxu = rep(torch.as_tensor(
                    permute_centers(centers_compact, basis), device=dev))
        # the dense membership matrix feeds only the dense route
        self.A = (None if self.use_fused else rep(
            lmops.vertex_membership_matrix(verts, vmask,
                                           len(self.static_idx)).to(dev)))
        self.cell = rep(torch.as_tensor(seed_sn.structure.cell,
                                        dtype=torch.float32, device=dev))
        self.cell_inv = rep(torch.as_tensor(
            np.linalg.inv(seed_sn.structure.cell), dtype=torch.float32,
            device=dev))
        self.centers = rep(torch.as_tensor(centers, device=dev))
        self.active = rep(torch.as_tensor(np.asarray(active, bool),
                                          device=dev))
        self.n_sites = int(centers.shape[0])

    @property
    def route(self):
        """'mxu' (K1), 'gather' (K3) or 'dense' — what :meth:`run_block`
        dispatches to."""
        if not self.use_fused:
            return "dense"
        return "mxu" if self._mxu_basis is not None else "gather"

    def run_block(self, frames, carry=None):
        """Run one frame block (host array ``(B, n_atoms, 3)``); B is padded
        to a multiple of the mesh size (padding frames are masked out of
        the statistics exactly).  Returns (labels, confs, JumpStats) as
        host arrays covering the original B frames.

        To chain jump statistics across consecutive blocks, pass
        ``carry=(prev_stats["last_sites"], prev_stats["last_res"])`` from
        the previous block — of this pipeline or of the reference's."""
        frames = np.asarray(frames)
        padded, n_valid = pad_frames(frames, self.n_devices)
        valid = (None if n_valid == len(padded) else
                 torch.arange(len(padded), device=self.device) < n_valid)
        mobile = place_frames(padded[:, self.mobile_idx], self.mesh,
                              self.device)
        static = place_frames(padded[:, self.static_idx], self.mesh,
                              self.device)
        kw = dict(cutoff_shape=self.cutoff_shape,
                  peak_evening=self.peak_evening, valid=valid, carry=carry)
        route = self.route
        if route == "mxu":
            labels, confs, stats = mxu_analysis_step(
                self.mesh, mobile, static, self._mxu_basis, self.kcell,
                self._centers_mxu, midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                threshold=self.assignment_threshold,
                active_idx=self._active_idx_t, n_sites=self.n_sites, **kw)
        elif route == "gather":
            labels, confs, stats = fused_analysis_step(
                self.mesh, mobile, static, self.verts, self.vmask,
                self.kcell, self._centers_compact,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                threshold=self.assignment_threshold,
                active_idx=self._active_idx_t, n_sites=self.n_sites,
                full_mask=self._full_mask, **kw)
        else:
            def local(mobile, static, A, cell, cell_inv, centers, active):
                return _dense_assign(
                    mobile, static, A, cell, cell_inv, centers, active,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    threshold=self.assignment_threshold,
                    peak_evening=self.peak_evening,
                    cutoff_shape=self.cutoff_shape)

            labels, confs = run_sharded(
                local, self.mesh, 2, mobile, static, self.A, self.cell,
                self.cell_inv, self.centers, self.active)
            labels, stats = _block_stats(labels, self.n_sites, valid, carry)
        return (labels[:n_valid].cpu().numpy(),
                confs[:n_valid].cpu().numpy(),
                JumpStats({k: v.cpu().numpy() for k, v in stats.items()}))
