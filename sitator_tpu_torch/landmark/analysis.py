"""``LandmarkAnalysis`` — the site-discovery engine (counterpart of
``sitator_tpu.landmark.analysis``).

Static-lattice drift check → landmark vectors → peak evening →
normalisation → pluggable clustering → occupancy filtering → PBC-aware site
centres → :class:`SiteTrajectory`.  Frames go through in fixed-size blocks.
On CUDA the landmark vectors come from the unique-atom kernel (K2) whenever
the basis shares enough vertices; otherwise, or with ``use_fused=False``,
from the dense log-space contraction.
"""
from __future__ import annotations

import inspect
import logging

import numpy as np
import torch

from sitator_tpu_torch.core import SiteNetwork, SiteTrajectory
from sitator_tpu_torch.landmark.cluster import get_backend
from sitator_tpu_torch.ops import landmark as lmops
from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.parallel.mesh import (bind_mesh, place_frames,
                                             run_sharded)
from sitator_tpu_torch.util.errors import (
    InsufficientSitesError,
    MultipleOccupancyError,
    StaticLatticeError,
    ZeroLandmarkError,
)
from sitator_tpu_torch.util.progress import get_progress_bar

logger = logging.getLogger(__name__)


def _takes_device(fn):
    """Whether a clustering backend's ``do_landmark_clustering`` takes a
    ``device`` keyword: the port's backends do; one written to the
    reference's contract (``landmark_vectors, clustering_params,
    min_samples, verbose``) is called without it."""
    params = inspect.signature(fn).parameters.values()
    return any(p.name == "device" or p.kind is p.VAR_KEYWORD for p in params)


class LandmarkAnalysis:
    """Unsupervised landmark analysis: discover sites and assign every
    (frame, mobile ion) to one.

    Parameters (constructor-kwargs API, as in ``sitator_tpu``):

    cutoff_midpoint, cutoff_steepness : logistic landmark cutoff ``c(d) =
        1/(1+exp(steepness (d - midpoint)))`` (Å).
    cutoff_shape : 'logistic' | 'logistic_r2' (the same switch in d²).
    minimum_site_occupancy : drop discovered sites occupied less than this
        fraction of frames.
    peak_evening : 'none' | 'clip'.
    weighted_site_positions : weight site centres by assignment confidence.
    check_for_zero_landmarks : raise :class:`ZeroLandmarkError` if any ion
        sees no landmark (else warn).
    static_movement_threshold : max drift (Å) of any static atom before
        :class:`StaticLatticeError`.
    dynamic_lattice_mapping : follow static atoms that exchange lattice
        sites (the slot→atom permutation is rebuilt at each exchange).
    max_mobile_per_site, multiple_occupancy_action : 'warn' | 'raise' |
        'ignore' when more ions than that share a site in a frame.
    clustering_algorithm, clustering_params : backend name and its params.
    batch_frames : frames per device block (rounded down to a multiple of
        the mesh size, at least one frame a shard).
    mesh : optional :class:`~sitator_tpu_torch.parallel.mesh.FrameMesh`
        whose first device is ``device``; blocks are split into frame
        shards, each shard's landmark vectors and drift computed on its
        device and gathered.  As in the reference the engine keeps the
        dense route on a mesh.
    use_fused : 'auto' (the K2 kernel on CUDA when the basis shares
        vertices) | True | False (dense route).
    device : torch device the engine runs on (default 'cuda').

    The reference's ``interpret`` flag (its kernels' CPU emulation) is left
    out on purpose: on a CPU device this engine takes the plain versions.
    """

    def __init__(self,
                 cutoff_midpoint=3.0,
                 cutoff_steepness=4.0,
                 cutoff_shape="logistic",
                 minimum_site_occupancy=0.01,
                 peak_evening="none",
                 weighted_site_positions=True,
                 check_for_zero_landmarks=True,
                 static_movement_threshold=1.0,
                 max_mobile_per_site=1,
                 multiple_occupancy_action="warn",
                 dynamic_lattice_mapping=False,
                 clustering_algorithm="dotprod",
                 clustering_params=None,
                 batch_frames=256,
                 mesh=None,
                 use_fused="auto",
                 verbose=True,
                 device="cuda"):
        self.mesh, self.device = bind_mesh(mesh, device)
        self.use_fused = use_fused
        self.dynamic_lattice_mapping = bool(dynamic_lattice_mapping)
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.cutoff_shape = cutoff_shape
        self.minimum_site_occupancy = float(minimum_site_occupancy)
        self.peak_evening = peak_evening
        self.weighted_site_positions = bool(weighted_site_positions)
        self.check_for_zero_landmarks = bool(check_for_zero_landmarks)
        self.static_movement_threshold = float(static_movement_threshold)
        self.max_mobile_per_site = max_mobile_per_site
        if multiple_occupancy_action not in ("warn", "raise", "ignore"):
            raise ValueError("multiple_occupancy_action must be "
                             "'warn' | 'raise' | 'ignore'")
        self.multiple_occupancy_action = multiple_occupancy_action
        self.clustering_algorithm = clustering_algorithm
        self.clustering_params = dict(clustering_params or {})
        self.batch_frames = int(batch_frames)
        self.verbose = verbose
        self._landmark_vectors = None
        self._landmark_dimension = None

    @property
    def landmark_vectors(self):
        if self._landmark_vectors is None:
            raise ValueError("LandmarkAnalysis has not been run")
        return self._landmark_vectors

    @property
    def landmark_dimension(self):
        if self._landmark_dimension is None:
            raise ValueError("LandmarkAnalysis has not been run")
        return self._landmark_dimension

    def _block_fn(self, sn, static_idx, verts, vmask):
        """The per-block device step: ``(mobile, static) → (lv_n, norms,
        drift)`` as host arrays, on the K2 route or the dense one; over a
        mesh of several shards once per frame shard, gathered."""
        dev = self.device
        cell = sn.structure.cell
        cell_t = torch.as_tensor(cell, dtype=torch.float32, device=dev)
        cell_inv_t = torch.as_tensor(np.linalg.inv(cell), dtype=torch.float32,
                                     device=dev)
        static_ref = torch.as_tensor(sn.structure.positions[static_idx],
                                     dtype=torch.float32, device=dev)
        use_fused = self.use_fused
        if use_fused == "auto":
            use_fused = dev.type == "cuda"
        if self.mesh is not None:
            # as in the reference: this engine keeps the dense route on a
            # mesh (the meshed production paths are the pipeline and the
            # streaming engine)
            use_fused = False
        mxu_basis = None
        if use_fused:
            from sitator_tpu_torch.ops.kernel_common import kernel_cell
            from sitator_tpu_torch.ops.landmark_mxu import (
                basis_from_jax, prepare_engine_basis)
            mxu_basis = prepare_engine_basis(
                verts, vmask, sn.centers, cell,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=sn.structure.positions[static_idx],
                drift_budget=self.static_movement_threshold)
        if mxu_basis is not None:
            from sitator_tpu_torch.ops.landmark_mxu import mxu_landmark_blocks
            mxu_basis = basis_from_jax(mxu_basis, dev)
            kcell = kernel_cell(cell)
            A = None

            def landmark_vectors(mobile, static, A, cell_t, cell_inv_t):
                return mxu_landmark_blocks(
                    mobile, static, mxu_basis, kcell,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape)
        else:
            A = lmops.vertex_membership_matrix(verts, vmask,
                                               len(static_idx)).to(dev)

            def landmark_vectors(mobile, static, A, cell_t, cell_inv_t):
                return lmops.landmark_vectors(
                    mobile, static, A, cell_t, cell_inv_t,
                    self.cutoff_midpoint, self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape)

        def local(mobile, static, A, cell_t, cell_inv_t, static_ref):
            lv = lmops.peak_even(
                landmark_vectors(mobile, static, A, cell_t, cell_inv_t),
                self.peak_evening)
            lv_n, norms = lmops.normalize_landmark_vectors(lv)
            drift = lmops.static_drift_per_frame(static, static_ref, cell_t,
                                                 cell_inv_t)
            return lv_n, norms, drift

        def block_fn(mobile, static):
            out = run_sharded(local, self.mesh, 2, mobile, static, A,
                              cell_t, cell_inv_t, static_ref, n_outputs=3)
            return tuple(o.cpu().numpy() for o in out)

        return block_fn

    def run(self, sn: SiteNetwork, frames) -> SiteTrajectory:
        frames = np.asarray(frames)
        if frames.ndim != 3 or frames.shape[1] != sn.structure.n_atoms \
                or frames.shape[2] != 3:
            raise ValueError("frames must be (n_frames, n_atoms, 3)")
        if not sn.has_vertices:
            raise ValueError(
                "input SiteNetwork has no vertices — run VoronoiSiteGenerator"
                " (or provide landmark polyhedra) first")
        n_frames = frames.shape[0]
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        static_idx = np.flatnonzero(sn.static_mask)
        n_mobile, n_static = len(mobile_idx), len(static_idx)
        n_landmarks = sn.n_sites
        self._landmark_dimension = n_landmarks
        verts, vmask = sn.padded_vertices()
        block_fn = self._block_fn(sn, static_idx, verts, vmask)

        # -- blockwise landmark computation (fixed shapes; pad last block) --
        B = min(self.batch_frames, n_frames)
        if self.mesh is not None:
            n_dev = self.mesh.devices.size
            B = max(B // n_dev, 1) * n_dev  # blocks divide the mesh
        lv_bytes = 4 * n_frames * n_mobile * n_landmarks
        if lv_bytes > 4 << 30:
            logger.warning(
                "landmark-vector matrix is %.1f GiB of host RAM; exposing "
                ".landmark_vectors needs all of it", lv_bytes / 2**30)
        lv_all = np.empty((n_frames, n_mobile, n_landmarks), dtype=np.float32)
        n_zero = 0
        first_zero = None
        max_drift = 0.0
        thr = self.static_movement_threshold
        perm = np.arange(n_static)  # slot → atom (identity until exchanges)
        n_remaps = 0
        static_ref_np = np.asarray(sn.structure.positions[static_idx],
                                   np.float64)
        pbar = get_progress_bar(total=n_frames, enabled=self.verbose,
                                desc="landmark vectors", unit="frame")
        pos = 0
        last_remap = (-1, 0)
        while pos < n_frames:
            hi = min(pos + B, n_frames)
            blk = frames[pos:hi]
            if hi - pos < B:  # pad to the block shape
                from sitator_tpu_torch.parallel.mesh import pad_frames
                blk, _ = pad_frames(blk, B)
            static_np = blk[:, static_idx]
            if self.dynamic_lattice_mapping:
                static_np = static_np[:, perm]
            lv_n, norms, drift = block_fn(
                place_frames(blk[:, mobile_idx], self.mesh, self.device),
                place_frames(static_np, self.mesh, self.device))
            drift_f = drift[: hi - pos]
            n_ok = hi - pos
            if self.dynamic_lattice_mapping and (drift_f > thr).any():
                # accept frames before the exchange, rebuild the slot→atom
                # permutation at the first offending frame, reprocess from it
                f_rel = int(np.argmax(drift_f > thr))
                if pos + f_rel == last_remap[0]:
                    if last_remap[1] >= 3:
                        raise StaticLatticeError(
                            "lattice remapping did not converge at frame "
                            f"{pos + f_rel}", frame=pos + f_rel)
                    last_remap = (pos + f_rel, last_remap[1] + 1)
                else:
                    last_remap = (pos + f_rel, 1)
                n_ok = f_rel
            if n_ok:
                lv_all[pos:pos + n_ok] = lv_n[:n_ok]
                # <= the normalise floor: below it the row could not be
                # normalised, which is exactly "saw no landmark"
                zn = norms[:n_ok] <= 1e-12
                if zn.any():
                    n_zero += int(zn.sum())
                    if first_zero is None:
                        f, m = np.argwhere(zn)[0]
                        first_zero = (int(pos + f), int(m))
                valid = drift_f[:n_ok]
                if len(valid):
                    max_drift = max(max_drift, float(valid.max()))
            if n_ok < hi - pos:
                new_perm = self._remap_lattice(
                    frames[pos + n_ok, static_idx], perm, static_ref_np,
                    sn.structure.cell, pos + n_ok)
                if np.array_equal(new_perm, perm):
                    # f32 device drift grazed the threshold but the f64
                    # matching finds no offenders: accept the frame
                    f = n_ok
                    lv_all[pos + f] = lv_n[f]
                    zrow = norms[f] <= 1e-12
                    if zrow.any():
                        n_zero += int(zrow.sum())
                        if first_zero is None:
                            first_zero = (int(pos + f),
                                          int(np.argmax(zrow)))
                    n_ok += 1
                else:
                    perm = new_perm
                    n_remaps += 1
            pbar.update(n_ok)
            pos += n_ok
        pbar.close()

        if self.dynamic_lattice_mapping:
            if n_remaps and self.verbose:
                logger.info("dynamic lattice mapping: %d slot→atom remaps",
                            n_remaps)
            self.lattice_mapping_ = perm
        elif max_drift > thr:
            raise StaticLatticeError(
                f"a static-lattice atom drifted {max_drift:.3f} Å "
                f"(> threshold {thr} Å); the host lattice moved too much "
                "for landmark analysis (see dynamic_lattice_mapping for "
                "site-exchanging lattices)",
                max_drift=max_drift)
        if n_zero:
            msg = (f"{n_zero} (frame, ion) samples "
                   f"({100.0 * n_zero / (n_frames * n_mobile):.3f}%) saw no "
                   f"landmark (first at frame {first_zero[0]}, mobile ion "
                   f"{first_zero[1]}); widen cutoff_midpoint or check masks")
            if self.check_for_zero_landmarks:
                raise ZeroLandmarkError(msg, frame=first_zero[0],
                                        mobile_index=first_zero[1])
            logger.warning(msg)

        self._landmark_vectors = lv_all.reshape(n_frames * n_mobile,
                                                n_landmarks)

        # -- clustering ----------------------------------------------------
        backend = get_backend(self.clustering_algorithm)
        min_samples = max(1, int(np.ceil(
            self.minimum_site_occupancy * n_frames)))
        kw = dict(verbose=self.verbose)
        if _takes_device(backend.do_landmark_clustering):
            kw["device"] = self.device
        counts, labels, confs, centers_vec = backend.do_landmark_clustering(
            self._landmark_vectors, self.clustering_params, min_samples, **kw)
        n_sites = len(counts)
        if n_sites == 0:
            raise InsufficientSitesError(
                "clustering found no sites above minimum_site_occupancy "
                f"({self.minimum_site_occupancy}); lower it or adjust the "
                "cutoff/clustering thresholds")
        if self.verbose:
            logger.info("LandmarkAnalysis: %d sites from %d landmarks "
                        "(%.2f%% unassigned)", n_sites, n_landmarks,
                        100.0 * np.mean(labels < 0))

        # -- site centres: PBC-aware (weighted) mean of member positions ---
        calc = PBCCalculator(sn.structure.cell)
        flat_pos = frames[:, mobile_idx, :].reshape(-1, 3)
        w = confs if self.weighted_site_positions else None
        site_centers = np.empty((n_sites, 3))
        for k in range(n_sites):
            members = labels == k
            site_centers[k] = calc.average(
                flat_pos[members], None if w is None else w[members])

        # -- assemble the output network -----------------------------------
        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = site_centers
        # each site inherits the vertex polyhedron of its dominant landmark
        dominant = np.argmax(centers_vec, axis=1)
        out.vertices = [sn.vertices[d] for d in dominant]
        out.add_site_attribute("dominant_landmark",
                               dominant.astype(np.int32))

        traj = labels.reshape(n_frames, n_mobile)
        confs2 = confs.reshape(n_frames, n_mobile)
        st = SiteTrajectory(out, traj, confs2)
        st.set_real_traj(frames)

        if self.max_mobile_per_site is not None:
            self._check_multiple_occupancy(traj, n_sites, n_frames)
        return st

    @staticmethod
    def _find_lattice_mapping(static_pos, perm, static_ref, cell, threshold):
        """Rebuild the slot→atom permutation at a site exchange: atoms that
        drifted beyond ``threshold`` from their slot are re-matched to the
        displaced slots by min-image Hungarian assignment.  Returns
        (new_perm, matched_max_distance) or (None, best_distance) when no
        consistent mapping exists."""
        calc = PBCCalculator(cell)
        d = calc.paired_distances(static_pos[perm], static_ref)
        off = d > threshold
        if not off.any():
            return perm, float(d.max())
        off_slots = np.flatnonzero(off)
        atoms = perm[off_slots]
        D = calc.pairwise_distances(static_pos[atoms],
                                    static_ref[off_slots])
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(D)
        worst = float(D[r, c].max())
        if worst > threshold:
            return None, worst
        new_perm = perm.copy()
        new_perm[off_slots[c]] = atoms[r]
        return new_perm, worst

    def _remap_lattice(self, static_pos, perm, static_ref, cell, frame):
        new_perm, worst = self._find_lattice_mapping(
            static_pos, perm, static_ref, cell,
            self.static_movement_threshold)
        if new_perm is None:
            raise StaticLatticeError(
                f"no consistent lattice mapping at frame {frame}: a "
                f"displaced static atom is {worst:.3f} Å from every "
                "vacated lattice site (> threshold "
                f"{self.static_movement_threshold} Å)", frame=frame,
                max_drift=worst)
        if self.verbose:
            n_moved = int((new_perm != perm).sum())
            logger.info("frame %d: lattice site exchange — remapped %d "
                        "slots (max residual %.3f Å)", frame, n_moved, worst)
        return new_perm

    def _check_multiple_occupancy(self, traj, n_sites, n_frames):
        if self.multiple_occupancy_action == "ignore":
            return
        ok = traj >= 0
        flat = traj.astype(np.int64) + n_sites * np.arange(n_frames)[:, None]
        counts = np.bincount(flat[ok].ravel(), minlength=n_sites * n_frames)
        n_viol = int(np.sum(counts > self.max_mobile_per_site))
        if not n_viol:
            return
        msg = (f"{n_viol} (frame, site) occupancies exceed "
               f"max_mobile_per_site={self.max_mobile_per_site} — sites may "
               "be under-resolved (consider lowering merge thresholds)")
        if self.multiple_occupancy_action == "raise":
            first = int(np.argmax(counts > self.max_mobile_per_site))
            raise MultipleOccupancyError(
                msg, frame=first // n_sites, site=first % n_sites,
                count=int(counts[first]))
        logger.warning(msg)
