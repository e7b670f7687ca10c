"""The slice end to end — ``LandmarkAnalysis`` → ``JumpAnalysis``, and
``SpmdLandmarkPipeline`` over chained blocks — in the port against the JAX
package on a synthetic hopping trajectory (the JAX kernels in interpret
mode)."""
import numpy as np
import pytest
import torch

from sitator_tpu import SiteNetwork, Structure
from sitator_tpu.dynamics import JumpAnalysis as JaxJumpAnalysis
from sitator_tpu.io.synthetic import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis as JaxLandmarkAnalysis
from sitator_tpu.landmark.cluster import dotprod as jax_dotprod
from sitator_tpu.parallel import SpmdLandmarkPipeline as JaxPipeline
from sitator_tpu.parallel import frame_mesh
from sitator_tpu.voronoi import VoronoiSiteGenerator

import sitator_tpu_torch as port
from sitator_tpu_torch.ops import landmark as port_lm

torch.set_num_threads(2)

LV_TOL = dict(rtol=1e-4, atol=1e-6)
KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
          minimum_site_occupancy=0.01, verbose=False)


@pytest.fixture(scope="module")
def system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=150,
                                 jump_rate=0.02, seed=31)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    return md.traj.astype(np.float32), seeds


@pytest.fixture(scope="module")
def fitted(system):
    frames, seeds = system
    la_j = JaxLandmarkAnalysis(use_fused=True, interpret=True, **KW)
    la_t = port.LandmarkAnalysis(use_fused=True, device="cpu", **KW)
    return la_j, la_j.run(seeds, frames), la_t, la_t.run(seeds, frames)


def _assert_same_sites(st_t, st_j):
    assert st_t.site_network.n_sites == st_j.site_network.n_sites
    np.testing.assert_array_equal(st_t.traj, st_j.traj)
    np.testing.assert_allclose(st_t.site_network.centers,
                               st_j.site_network.centers, atol=1e-5)
    np.testing.assert_allclose(st_t.confidences, st_j.confidences,
                               atol=1e-5)


def test_landmark_analysis_kernel_route(fitted):
    la_j, st_j, la_t, st_t = fitted
    _assert_same_sites(st_t, st_j)
    np.testing.assert_allclose(la_t.landmark_vectors, la_j.landmark_vectors,
                               **LV_TOL)
    np.testing.assert_array_equal(
        st_t.site_network.dominant_landmark,
        st_j.site_network.dominant_landmark)


def test_landmark_analysis_dense_route(system):
    frames, seeds = system
    la_j = JaxLandmarkAnalysis(use_fused=False, **KW)
    la_t = port.LandmarkAnalysis(use_fused=False, device="cpu", **KW)
    st_j = la_j.run(seeds, frames[:60])
    st_t = la_t.run(seeds, frames[:60])
    _assert_same_sites(st_t, st_j)
    np.testing.assert_allclose(la_t.landmark_vectors, la_j.landmark_vectors,
                               **LV_TOL)


@pytest.mark.parametrize("policy", ["persist", "break"])
def test_jump_analysis(fitted, policy):
    _, st_j, _, st_t = fitted
    ja_j = JaxJumpAnalysis(unknown_policy=policy, verbose=False)
    ja_t = port.JumpAnalysis(unknown_policy=policy, verbose=False,
                             device="cpu")
    ja_j.run(st_j)
    ja_t.run(st_t)
    sj, stt = st_j.site_network, st_t.site_network
    np.testing.assert_array_equal(stt.n_ij, sj.n_ij)
    np.testing.assert_array_equal(stt.total_corrected_residences,
                                  sj.total_corrected_residences)
    for name in ("occupancies", "residence_times", "p_ij", "jump_lag"):
        np.testing.assert_array_equal(getattr(stt, name), getattr(sj, name),
                                      err_msg=name)
    assert ja_t.n_jumps == ja_j.n_jumps > 0


def _run_blocks(pipe, blocks, carry=None):
    out = []
    for blk in blocks:
        labels, confs, stats = pipe.run_block(blk, carry)
        carry = (stats["last_sites"], stats["last_res"])
        out.append((labels, confs, stats))
    return out


def _assert_same_blocks(got, want, conf_atol):
    for (lt, ct, st), (lj, cj, sj) in zip(got, want):
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_allclose(ct, cj, atol=conf_atol)
        for k in ("n_ij", "occ_counts", "lag_sum", "res_sum", "last_sites",
                  "last_res"):
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


@pytest.mark.parametrize("use_fused", [True, False])
def test_pipeline_chained_blocks(system, fitted, use_fused):
    frames, seeds = system
    la_j = fitted[0]
    _, _, _, centers = jax_dotprod.do_landmark_clustering(
        la_j.landmark_vectors, {}, min_samples=2)
    active = np.ones(len(centers), bool)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              use_fused=use_fused)
    pj = JaxPipeline(seeds, centers, active, mesh=frame_mesh(n_devices=1),
                     interpret=True, **kw)
    pt = port.SpmdLandmarkPipeline(seeds, centers, active, device="cpu",
                                   **kw)
    if use_fused:
        assert pj._mxu_basis is not None and pt.route == "mxu"
    else:
        assert pt.route == "dense"
    blocks = (frames[:50], frames[50:100])
    want = _run_blocks(pj, blocks)
    got = _run_blocks(pt, blocks)
    # bf16 similarity operands on the kernel route, f32 on the dense one
    _assert_same_blocks(got, want, 1e-2 if use_fused else 1e-5)
    assert sum(int(o[2]["n_ij"].sum()) for o in got) > 0
    # the port takes the reference's carry
    carry = (want[0][2]["last_sites"], want[0][2]["last_res"])
    _assert_same_blocks(_run_blocks(pt, blocks[1:], carry), want[1:],
                        1e-2 if use_fused else 1e-5)


def _no_sharing_system(seed=13, n_frames=16, n_ions=10):
    """48 sites, each a tetrahedron of its own 4 static atoms (no vertex is
    shared, so the pipelines take the gather kernel), ions hopping among
    them; centres from the landmark vector of an ion on each site."""
    r = np.random.default_rng(seed)
    a = 5.0
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    cell = np.diag([4 * a, 4 * a, 3 * a])
    sites = (g + 0.5) * a
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 1.2
    host = (sites[:, None, :] + tet[None]).reshape(-1, 3)
    occ = r.choice(len(sites), n_ions, replace=False)
    site_of = np.empty((n_frames, n_ions), int)
    for f in range(n_frames):
        hop = r.random(n_ions) < 0.1
        free = np.setdiff1d(np.arange(len(sites)), occ)
        occ = np.where(hop, r.choice(free, n_ions, replace=False), occ)
        site_of[f] = occ
    frames = np.concatenate([
        host[None] + r.normal(scale=0.05, size=(n_frames,) + host.shape),
        sites[site_of] + r.normal(scale=0.3, size=(n_frames, n_ions, 3))],
        axis=1).astype(np.float32)
    n_host = len(host)
    species = np.r_[np.full(n_host, 16), np.full(n_ions, 3)]
    mask = np.arange(n_host + n_ions) < n_host
    sn = SiteNetwork(Structure(frames[0], species, cell), mask, ~mask)
    sn.centers = sites
    sn.vertices = list(np.arange(n_host).reshape(len(sites), 4))
    verts, vmask = sn.padded_vertices()
    lv = port_lm.landmark_vectors(
        torch.from_numpy(sites[None].astype(np.float32)),
        torch.from_numpy(host[None].astype(np.float32)),
        port_lm.vertex_membership_matrix(verts, vmask, n_host),
        torch.from_numpy(cell.astype(np.float32)),
        torch.from_numpy(np.linalg.inv(cell).astype(np.float32)), 4.0, 3.0)
    centers = port_lm.normalize_landmark_vectors(lv)[0][0].numpy()
    return frames, sn, centers


def test_pipeline_gather_route_chained_blocks():
    frames, sn, centers = _no_sharing_system()
    active = np.ones(len(centers), bool)
    active[5] = False                 # an inactive centre is never chosen
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, use_fused=True)
    pj = JaxPipeline(sn, centers, active, mesh=frame_mesh(n_devices=1),
                     interpret=True, **kw)
    pt = port.SpmdLandmarkPipeline(sn, centers, active, device="cpu", **kw)
    assert pj._mxu_basis is None and pt.route == "gather"
    blocks = (frames[:8], frames[8:])
    want = _run_blocks(pj, blocks)
    got = _run_blocks(pt, blocks)
    _assert_same_blocks(got, want, 1e-2)
    labels = np.concatenate([o[0] for o in got])
    assert (labels >= 0).mean() > 0.5 and not (labels == 5).any()


@pytest.mark.parametrize("engine", ["landmark", "pipeline", "streaming"])
def test_engines_accept_mesh_none_and_refuse_a_mesh(system, engine):
    """``mesh=None`` is what a reference script passes on one device, and
    every engine takes it; every engine takes the port's frame meshes too,
    one device or eight shards.  A mesh of the reference's (a JAX mesh) is
    refused with a ``TypeError``, and so is a mesh whose first device is
    not the engine's.  ``interpret`` stays out of the port."""
    frames, seeds = system
    n_landmarks = int(seeds.static_mask.sum())
    if engine == "pipeline":
        def make(**kw):
            return port.SpmdLandmarkPipeline(
                seeds, np.eye(n_landmarks, dtype=np.float32)[:4],
                np.ones(4, bool), cutoff_midpoint=4.0, cutoff_steepness=3.0,
                device="cpu", **kw)
    else:
        cls = (port.LandmarkAnalysis if engine == "landmark"
               else port.StreamingLandmarkAnalysis)

        def make(**kw):
            return cls(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                       verbose=False, device="cpu", **kw)
    from sitator_tpu_torch.parallel import frame_mesh as port_frame_mesh
    assert make(mesh=None) is not None
    for n in (1, 8):
        mesh = port_frame_mesh(devices=["cpu"] * n)
        eng = make(mesh=mesh)
        assert eng.mesh is mesh and eng.mesh.devices.size == n
        assert eng.device == torch.device("cpu")
    with pytest.raises(TypeError, match="FrameMesh"):
        make(mesh=frame_mesh(n_devices=1))
    with pytest.raises(ValueError, match="first device"):
        make(mesh=port_frame_mesh(devices=["meta"] * 2))
    with pytest.raises(TypeError, match="interpret"):
        make(interpret=True)
    if engine == "landmark":
        # and the reference does take the same keyword
        assert JaxLandmarkAnalysis(mesh=None, **KW) is not None
