"""Frame sharding in the port (``sitator_tpu_torch.parallel.mesh`` and the
``mesh=`` of ``SpmdLandmarkPipeline``, ``LandmarkAnalysis`` and
``StreamingLandmarkAnalysis``) against the reference on its 8 virtual CPU
devices.  The port runs on ``frame_mesh(devices=["cpu"] * 8)`` and on a
one-device mesh, on the same seeded inputs.

Tolerances: integers (labels, n_ij, residences, occupancy counts) equal;
the port's 8-shard runs equal its one-device runs bit for bit (each frame's
work depends on that frame alone); confidences within 1e-5 of the
reference's on the f32 dense route; with bf16 similarity operands (the
kernel routes' plain versions) labels equal wherever the reference's f32
top-2 margin exceeds 8e-3.  Also here: the repair of short blocks in pass 2
(a short block runs on its own frames, padded only to the mesh size), and
the port's ``graft_entry``.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis as JaxLandmarkAnalysis
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.ops.cluster import dotprod_fit as jax_dotprod_fit
from sitator_tpu.ops.jumps import jump_stats as jax_jump_stats
from sitator_tpu.ops.jumps import jump_stats_parallel as jax_jsp
from sitator_tpu.parallel import SpmdLandmarkPipeline as JaxPipeline
from sitator_tpu.parallel import frame_mesh as jax_frame_mesh
from sitator_tpu.parallel import shard_frames as jax_shard_frames
from sitator_tpu.voronoi import VoronoiSiteGenerator

import sitator_tpu_torch as port
from sitator_tpu_torch.landmark import streaming as tst
from sitator_tpu_torch.ops import landmark as tlm
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops.jumps import _jump_stats, _jump_stats_parallel
from sitator_tpu_torch.parallel import mesh as tmesh
from sitator_tpu_torch.parallel.pipeline import (analysis_step,
                                                 fused_analysis_step)

from tests._torch_common import first_math_calls_on_one_thread

torch.set_num_threads(2)

first_math_calls_on_one_thread()

STAT_KEYS = ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts",
             "last_sites", "last_res")
KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
          assignment_threshold=0.35)
SKW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False)


def mesh8():
    return port.parallel.frame_mesh(devices=["cpu"] * 8)


def mesh1():
    return port.parallel.frame_mesh(devices=["cpu"])


def _stats_equal(a, b, keys=STAT_KEYS):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# -- the helpers ------------------------------------------------------------

def test_mesh_helpers_semantics():
    """The port's counterpart of the reference's helper contract
    (``tests/test_api_surface.py::test_mesh_helpers_semantics``)."""
    mesh = mesh8()
    assert mesh.devices.size == 8 and mesh.axis_names == ("frames",)
    assert mesh.streams == [None] * 8          # no stream for a CPU shard
    assert tmesh.__all__[:8] == ["FRAME_AXIS", "frame_mesh",
                                 "frame_sharding", "replicated",
                                 "shard_frames", "shard_frames_local",
                                 "pad_frames", "shard_map_frames"]
    import sitator_tpu.parallel as jpar
    assert port.parallel.__all__ == jpar.__all__

    arr = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    padded, n_valid = tmesh.pad_frames(arr, 8)
    assert padded.shape == (16, 2) and n_valid == 10
    np.testing.assert_array_equal(padded[10:], np.broadcast_to(arr[-1:],
                                                               (6, 2)))
    same, n_same = tmesh.pad_frames(arr[:8], 8)
    assert same.shape == (8, 2) and n_same == 8

    fs, rep = tmesh.frame_sharding(mesh), tmesh.replicated(mesh)
    assert fs.mesh is mesh and rep.mesh is mesh
    assert fs.spec != rep.spec

    x = torch.arange(16.0).reshape(16, 1)
    w = torch.tensor(2.0)

    def fn(xb, wrep):
        assert xb.shape == (2, 1)              # one shard at a time
        return xb + 1.0, xb * wrep

    a, b = tmesh.shard_map_frames(fn, mesh, 1, x, w)
    assert isinstance(a, tmesh.ShardedFrames) and len(a.shards) == 8
    assert a.offsets == list(range(0, 16, 2))
    np.testing.assert_allclose(np.asarray(a), x.numpy() + 1.0)
    np.testing.assert_allclose(np.asarray(b), x.numpy() * 2.0)
    np.testing.assert_array_equal(tmesh.gather_frames(b).numpy(),
                                  x.numpy() * 2.0)
    # a one-device mesh whose device holds the inputs calls fn directly
    seen = []
    one = tmesh.shard_map_frames(lambda xb: (seen.append(xb) or xb,),
                                 mesh1(), 1, x, n_outputs=1)[0]
    assert seen[0] is x and tmesh.gather_frames(one) is x
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_frames(arr, mesh)
    with pytest.raises(TypeError, match="FrameMesh"):
        tmesh.shard_frames(arr, jax_frame_mesh())


def test_frame_mesh_needs_a_card_or_devices():
    """Without a card ``frame_mesh()`` raises: the mesh never falls back to
    the CPU.  ``n_devices`` takes the first cards; ``devices`` may repeat."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: frame_mesh() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.parallel.frame_mesh()
    m = port.parallel.frame_mesh(n_devices=3, devices=["cpu"] * 2)
    assert m.devices.size == 2
    assert all(d == torch.device("cpu") for d in m.devices)


def test_shard_frames_local_matches_global():
    """``shard_frames_local`` (the per-process feeding form) equals
    ``shard_frames`` in one process, through a computation too; a mesh not
    in process order raises the reference's error."""
    mesh = mesh8()
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    a = tmesh.shard_frames(x, mesh)
    b = tmesh.shard_frames_local(x, mesh)
    assert a.offsets == b.offsets
    for sa, sb in zip(a.shards, b.shards):
        assert torch.equal(sa, sb)
    np.testing.assert_array_equal(np.asarray(b), x)

    def f(v):
        return ((v * v).sum(dim=(1, 2)),)

    fa = tmesh.shard_map_frames(f, mesh, 1, a, n_outputs=1)[0]
    fb = tmesh.shard_map_frames(f, mesh, 1, b, n_outputs=1)[0]
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    want = np.asarray(jax_shard_frames(x, jax_frame_mesh(n_devices=8)))
    np.testing.assert_array_equal(np.asarray(a), want)
    scrambled = tmesh.FrameMesh(["cpu"] * 8)
    assert scrambled.process_indices == (0,) * 8      # one process
    scrambled.process_indices = (1, 1, 0, 0, 2, 2, 3, 3)
    with pytest.raises(ValueError, match="process-contiguous"):
        tmesh.shard_frames_local(x, scrambled)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parallel_jump_stats_over_sharded_labels(seed):
    """Labels sharded over 8 devices and gathered give the jump statistics
    of the sequential scan, as the reference's sharded prefix form does."""
    rng = np.random.default_rng(seed)
    S = 5
    traj = rng.integers(-1, S, size=(160, 4)).astype(np.int32)
    want = jax_jump_stats(jnp.asarray(traj), S)
    ref = jax_jsp(jax_shard_frames(traj, jax_frame_mesh()), S)
    sh = tmesh.shard_frames(traj, mesh8())
    got = _jump_stats_parallel(tmesh.gather_frames(sh), S)
    seq = _jump_stats(torch.from_numpy(traj), S)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), seq[k].numpy(),
                                      err_msg=k)


# -- SpmdLandmarkPipeline -----------------------------------------------------

@pytest.fixture(scope="module")
def fitted_system():
    """The reference's mesh-test system, its sites and fitted centres."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=400,
                                 jump_rate=0.03, seed=3)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    la = JaxLandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                             verbose=False)
    la.run(seeds, md.traj)
    res = jax_dotprod_fit(jnp.asarray(la.landmark_vectors), k_max=128,
                          cluster_threshold=0.45, min_samples=4)
    return (md, seeds, np.asarray(res["centers"]),
            np.asarray(res["active"]))


def _pipes(seeds, centers, active, **kw):
    """(port on 8 shards, port on one device, reference on 8 devices)."""
    return (port.SpmdLandmarkPipeline(seeds, centers, active, mesh=mesh8(),
                                      device="cpu", **KW, **kw),
            port.SpmdLandmarkPipeline(seeds, centers, active, mesh=mesh1(),
                                      device="cpu", **KW, **kw),
            JaxPipeline(seeds, centers, active, mesh=jax_frame_mesh(),
                        **KW, **kw))


def test_sharded_pipeline_matches_single_device(fitted_system):
    """Frame-shard invariance: 8 shards == one device bit for bit, and
    both == the reference's 8-device run (dense route)."""
    md, seeds, centers, active = fitted_system
    p8, p1, pj = _pipes(seeds, centers, active)
    assert p8.route == "dense" and p8.n_devices == 8
    lab8, conf8, stats8 = p8.run_block(md.traj)
    lab1, conf1, stats1 = p1.run_block(md.traj)
    labj, confj, statsj = pj.run_block(md.traj)
    np.testing.assert_array_equal(lab8, lab1)
    np.testing.assert_array_equal(conf8, conf1)
    _stats_equal(stats8, stats1)
    np.testing.assert_array_equal(lab8, labj)
    np.testing.assert_allclose(conf8, confj, atol=1e-5)
    _stats_equal(stats8, statsj)
    assert stats8["n_ij"].sum() > 0


def test_pipeline_padding_correction(fitted_system):
    """A block whose length does not divide the mesh (395 frames on 8
    shards) gives exact statistics: the padding frames are masked."""
    md, seeds, centers, active = fitted_system
    p8, p1, pj = _pipes(seeds, centers, active)
    odd = md.traj[:395]
    lab8, conf8, stats8 = p8.run_block(odd)
    lab1, conf1, stats1 = p1.run_block(odd)
    labj, _, statsj = pj.run_block(odd)
    assert lab8.shape[0] == conf8.shape[0] == 395
    np.testing.assert_array_equal(lab8, lab1)
    np.testing.assert_array_equal(conf8, conf1)
    _stats_equal(stats8, stats1)
    np.testing.assert_array_equal(lab8, labj)
    _stats_equal(stats8, statsj)


def test_pipeline_matches_landmark_ops(fitted_system):
    """The meshed pipeline's labels are those of the dense landmark ops on
    one device with the same centres."""
    md, seeds, centers, active = fitted_system
    labels, confs, _ = _pipes(seeds, centers, active)[0].run_block(
        md.traj[:64])
    verts, vmask = seeds.padded_vertices()
    A = tlm.vertex_membership_matrix(verts, vmask,
                                     int(md.static_mask.sum()))
    cell = torch.as_tensor(md.structure.cell, dtype=torch.float32)
    cinv = torch.as_tensor(np.linalg.inv(md.structure.cell),
                           dtype=torch.float32)
    mobile = torch.as_tensor(md.traj[:64][:, md.mobile_mask],
                             dtype=torch.float32)
    static = torch.as_tensor(md.traj[:64][:, md.static_mask],
                             dtype=torch.float32)
    lv = tlm.landmark_vectors(mobile, static, A, cell, cinv, 4.0, 3.0)
    lvn, _ = tlm.normalize_landmark_vectors(lv)
    want_lab, want_conf = tlm.assign_to_centers(
        lvn, torch.as_tensor(centers), torch.as_tensor(active), 0.35)
    np.testing.assert_array_equal(labels, want_lab.numpy())
    np.testing.assert_array_equal(confs, want_conf.numpy())


def test_gather_step_on_the_mesh_matches_dense(fitted_system):
    """K3's step per shard of the 8-shard mesh (its plain version, f32
    operands, frames sharded by ``shard_frames``) equals the dense step,
    and the reference's K3 step on its 8 devices (interpret mode)."""
    from sitator_tpu.parallel.pipeline import \
        fused_analysis_step as jax_fused_step
    md, seeds, centers, active = fitted_system
    mesh = mesh8()
    F = 64
    frames = md.traj[:F]
    mobile = frames[:, md.mobile_mask].astype(np.float32)
    static = frames[:, md.static_mask].astype(np.float32)
    verts, vmask = seeds.padded_vertices()
    cell = md.structure.cell
    live = centers[active]
    K = len(live)
    cell_diag = np.diag(cell).astype(np.float32)
    kw = dict(midpoint=4.0, steepness=3.0, threshold=0.35, s_tile=128,
              mxu_bf16=False)
    labels_f, confs_f, stats_f = fused_analysis_step(
        mesh, tmesh.shard_frames(mobile, mesh),
        tmesh.shard_frames(static, mesh), torch.as_tensor(verts),
        torch.as_tensor(vmask), torch.as_tensor(cell_diag),
        torch.as_tensor(live), **kw)
    A = tlm.vertex_membership_matrix(verts, vmask, int(md.static_mask.sum()))
    labels_x, confs_x, stats_x = analysis_step(
        torch.as_tensor(mobile), torch.as_tensor(static), A,
        torch.as_tensor(cell, dtype=torch.float32),
        torch.as_tensor(np.linalg.inv(cell), dtype=torch.float32),
        torch.as_tensor(live), torch.ones(K, dtype=torch.bool), 4.0, 3.0,
        0.35, n_sites=K)
    np.testing.assert_array_equal(labels_f.numpy(), labels_x.numpy())
    np.testing.assert_allclose(confs_f.numpy(), confs_x.numpy(), atol=1e-5)
    _stats_equal({k: v.numpy() for k, v in stats_f.items()},
                 {k: v.numpy() for k, v in stats_x.items()})
    jmesh = jax_frame_mesh()
    labels_j, confs_j, stats_j = jax_fused_step(
        jmesh, jax_shard_frames(mobile, jmesh),
        jax_shard_frames(static, jmesh), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(live),
        interpret=True, **kw)
    np.testing.assert_array_equal(labels_f.numpy(), np.asarray(labels_j))
    np.testing.assert_allclose(confs_f.numpy(), np.asarray(confs_j),
                               atol=1e-5)
    np.testing.assert_array_equal(stats_f["n_ij"].numpy(),
                                  np.asarray(stats_j["n_ij"]))


def _margin_gate(md, seeds, live, frames):
    """True where the f32 top-2 margin of the dense route is inside the
    bf16 gate (8e-3) or the best similarity within 1e-2 of the
    threshold."""
    verts, vmask = seeds.padded_vertices()
    lv = tlm.landmark_vectors(
        torch.as_tensor(frames[:, md.mobile_mask], dtype=torch.float32),
        torch.as_tensor(frames[:, md.static_mask], dtype=torch.float32),
        tlm.vertex_membership_matrix(verts, vmask,
                                     int(md.static_mask.sum())),
        torch.as_tensor(md.structure.cell, dtype=torch.float32),
        torch.as_tensor(np.linalg.inv(md.structure.cell),
                        dtype=torch.float32), 4.0, 3.0)
    sims = tlm.normalize_landmark_vectors(lv)[0].numpy() @ live.T
    top = -np.sort(-sims, axis=-1)[..., :2]
    return (top[..., 0] - top[..., 1] <= 8e-3) | (
        np.abs(top[..., 0] - 0.35) <= 1e-2)


def test_pipeline_kernel_route_matches_dense_route(fitted_system):
    """On the mesh, the pipeline's K1 route (its plain version, bf16
    operands) against the dense route: labels equal outside the margin
    gate; 8 shards == one device bit for bit; and the reference's K1 route
    on its mesh (interpret mode) gives the same labels outside the gate."""
    md, seeds, centers, active = fitted_system
    f8, f1, fj = _pipes(seeds, centers, active, use_fused=True)
    d8 = _pipes(seeds, centers, active, use_fused=False)[0]
    assert f8.route == "mxu" and d8.route == "dense"
    block = md.traj[:64]
    lab_f, conf_f, stats_f = f8.run_block(block)
    lab_1, conf_1, stats_1 = f1.run_block(block)
    lab_d, conf_d, _ = d8.run_block(block)
    np.testing.assert_array_equal(lab_f, lab_1)
    np.testing.assert_array_equal(conf_f, conf_1)
    _stats_equal(stats_f, stats_1)
    gate = _margin_gate(md, seeds, centers[active], block)
    assert (~gate).mean() > 0.5
    np.testing.assert_array_equal(lab_f[~gate], lab_d[~gate])
    np.testing.assert_allclose(conf_f, conf_d, atol=1e-2)
    fj.interpret = True
    lab_j, conf_j, stats_j = fj.run_block(block)
    np.testing.assert_array_equal(lab_f[~gate], lab_j[~gate])
    np.testing.assert_allclose(conf_f, conf_j, atol=1e-2)
    if np.array_equal(lab_f, lab_j):
        _stats_equal(stats_f, stats_j)


def test_run_block_carry_chains_across_blocks(fitted_system):
    """``carry=(last_sites, last_res)`` between meshed blocks (179 frames,
    padded on 8 shards, then the rest) connects boundary jumps and
    residences exactly, as in the reference."""
    md, seeds, centers, active = fitted_system
    p8, _, pj = _pipes(seeds, centers, active)
    lab_all, _, s_all = p8.run_block(md.traj)
    l1, _, s1 = p8.run_block(md.traj[:179])
    l2, _, s2 = p8.run_block(md.traj[179:],
                             carry=(s1["last_sites"], s1["last_res"]))
    np.testing.assert_array_equal(np.concatenate([l1, l2]), lab_all)
    for k in ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts"):
        np.testing.assert_array_equal(s1[k] + s2[k], s_all[k], err_msg=k)
    np.testing.assert_array_equal(s2["last_sites"], s_all["last_sites"])
    np.testing.assert_array_equal(s2["last_res"], s_all["last_res"])
    # the reference's second block from the same carry
    _, _, sj = pj.run_block(md.traj[179:],
                            carry=(s1["last_sites"], s1["last_res"]))
    _stats_equal(s2, sj)
    _, _, s2n = p8.run_block(md.traj[179:])
    assert (s1["n_ij"] + s2n["n_ij"]).sum() <= s_all["n_ij"].sum()


def test_pipeline_device_and_mesh_must_agree(fitted_system):
    md, seeds, centers, active = fitted_system
    with pytest.raises(ValueError, match="first device"):
        port.SpmdLandmarkPipeline(seeds, centers, active, mesh=mesh8(),
                                  device="cuda:1", **KW)
    # mesh=None on a CPU device: a one-device mesh of that device
    p = port.SpmdLandmarkPipeline(seeds, centers, active, device="cpu",
                                  **KW)
    assert p.n_devices == 1 and p.mesh.devices[0] == torch.device("cpu")


# -- LandmarkAnalysis ---------------------------------------------------------

def test_landmark_analysis_under_mesh():
    """``LandmarkAnalysis`` on the 8-shard mesh (the dense route, as in the
    reference; 150 frames in blocks of 32, the last one padded) equals the
    unsharded dense run bit for bit and the reference's run on its 8
    devices."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=150,
                                 jump_rate=0.02, seed=31)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    frames = md.traj.astype(np.float32)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False,
              batch_frames=37)
    la8 = port.LandmarkAnalysis(mesh=mesh8(), use_fused=True, device="cpu",
                                **kw)
    st8 = la8.run(seeds, frames)
    la1 = port.LandmarkAnalysis(use_fused=False, device="cpu", **kw)
    st1 = la1.run(seeds, frames)
    np.testing.assert_array_equal(la8.landmark_vectors, la1.landmark_vectors)
    np.testing.assert_array_equal(st8.traj, st1.traj)
    np.testing.assert_array_equal(st8.confidences, st1.confidences)
    laj = JaxLandmarkAnalysis(mesh=jax_frame_mesh(), **kw)
    stj = laj.run(seeds, frames)
    np.testing.assert_allclose(la8.landmark_vectors, laj.landmark_vectors,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(st8.traj, stj.traj)
    np.testing.assert_allclose(st8.confidences, stj.confidences, atol=1e-5)
    np.testing.assert_allclose(st8.site_network.centers,
                               stj.site_network.centers, atol=1e-5)


# -- StreamingLandmarkAnalysis ------------------------------------------------

@pytest.fixture(scope="module")
def md_system():
    """The reference's streaming test system and its fitted centres."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=700,
                                 jump_rate=0.03, seed=9)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    centers = JaxStreaming(block_frames=100, **SKW).fit_centers(
        seeds, ArrayTrajectory(md.traj))
    return md, seeds, np.asarray(centers)


def _port(**kw):
    return port.StreamingLandmarkAnalysis(device="cpu", **{**SKW, **kw})


def _same_result(got, want, centre_atol=1e-4):
    np.testing.assert_array_equal(got.n_ij, want.n_ij)
    np.testing.assert_array_equal(got.total_corrected_residences,
                                  want.total_corrected_residences)
    np.testing.assert_array_equal(got.occupancies, want.occupancies)
    for name in ("p_ij", "jump_lag", "residence_times"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.centers, want.centers, atol=centre_atol)


@pytest.mark.parametrize("depth", [0, 2])
def test_streaming_mesh_matches_single_device(md_system, tmp_path, depth):
    """Pass 2 on the 8-shard mesh (dense route; 300 frames in 64-frame
    blocks, the last one short) at run-ahead depth 0 and 2: labels and
    statistics equal the unsharded run's (floats bit for bit on the CPU)
    and the reference's on its 8 devices."""
    md, seeds, centers = md_system
    traj = md.traj[:300]
    got8 = _port(block_frames=64, mesh=mesh8(), pipeline_depth=depth,
                 store_labels=str(tmp_path / "m.npy")).run(
        seeds, traj, centers=centers)
    got1 = _port(block_frames=64, pipeline_depth=depth,
                 store_labels=str(tmp_path / "o.npy")).run(
        seeds, traj, centers=centers)
    _same_result(got8, got1, centre_atol=0.0)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  np.load(tmp_path / "o.npy"))
    want = JaxStreaming(block_frames=64, mesh=jax_frame_mesh(n_devices=8),
                        store_labels=str(tmp_path / "j.npy"), **SKW).run(
        seeds, traj, centers=centers)
    _same_result(got8, want)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  np.load(tmp_path / "j.npy"))


def test_streaming_mesh_kernel_route(md_system):
    """Pass 2 through K1 (its plain version) on the 8-shard mesh equals the
    unsharded K1 run bit for bit, and the reference's meshed K1 run
    (interpret mode) wherever their labels agree, as
    ``test_streaming.py::test_streaming_mesh_fused_matches_single_device``
    runs it."""
    md, seeds, centers = md_system
    traj = md.traj[:256]
    eng = _port(block_frames=64, mesh=mesh8(), use_fused=True)
    got8 = eng.run(seeds, traj, centers=centers)
    assert eng.route_ == "mxu"
    got1 = _port(block_frames=64, use_fused=True).run(seeds, traj,
                                                      centers=centers)
    _same_result(got8, got1, centre_atol=0.0)
    want = JaxStreaming(block_frames=64, mesh=jax_frame_mesh(n_devices=8),
                        use_fused=True, interpret=True, **SKW).run(
        seeds, traj, centers=centers)
    np.testing.assert_array_equal(got8.n_ij, want.n_ij)
    np.testing.assert_allclose(got8.occupancies, want.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(got8.centers, want.centers, atol=1e-4)


def _swapped(md, T, a, b, n):
    traj = md.traj[:n].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[a], sa[b]
    traj[T:, i], traj[T:, j] = (md.traj[T:n, j].copy(),
                                md.traj[T:n, i].copy())
    return traj


@pytest.mark.parametrize("depth", [0, 2])
def test_streaming_dynamic_mapping_under_mesh(md_system, depth):
    """Lattice remapping composes with the mesh: an exchange of two static
    atoms at frame 210 (inside the third of five 80-frame blocks) on the
    8-shard mesh gives the unswapped run's statistics, at depth 2 through a
    rollback, as the reference's meshed engine does."""
    md, seeds, centers = md_system
    swapped = _swapped(md, 210, 3, 9, 400)
    want = _port(block_frames=80).run(seeds, md.traj[:400], centers=centers)
    eng = _port(block_frames=80, mesh=mesh8(), dynamic_lattice_mapping=True,
                pipeline_depth=depth)
    got = eng.run(seeds, swapped, centers=centers)
    _same_result(got, want, centre_atol=1e-6)
    assert (eng.lattice_mapping_ != np.arange(len(eng.lattice_mapping_))
            ).sum() == 2
    assert eng.rollbacks_ == (1 if depth else 0)
    ref = JaxStreaming(block_frames=80, mesh=jax_frame_mesh(n_devices=8),
                       dynamic_lattice_mapping=True, **SKW).run(
        seeds, swapped, centers=centers)
    _same_result(got, ref)


class Interrupt(Exception):
    pass


class FlakyReader(ArrayTrajectory):
    """Raises :class:`Interrupt` after serving ``die_after`` blocks."""

    def __init__(self, arr, die_after):
        super().__init__(arr)
        self.served = 0
        self.die_after = die_after

    def __getitem__(self, key):
        self.served += 1
        if self.die_after is not None and self.served > self.die_after:
            raise Interrupt()
        return super().__getitem__(key)


def test_checkpoint_resume_under_mesh(md_system, tmp_path):
    """An interrupted meshed run resumes from its checkpoint to the
    uninterrupted meshed run's result, which is the unsharded one; the
    reference's engine resumes from the same checkpoint to it too."""
    md, seeds, centers = md_system
    traj = md.traj[:480]
    want = _port(block_frames=96, mesh=mesh8()).run(seeds, traj,
                                                    centers=centers)
    _same_result(want, _port(block_frames=96).run(seeds, traj,
                                                  centers=centers),
                 centre_atol=0.0)
    ckpt = str(tmp_path / "mesh.ckpt")
    eng = _port(block_frames=96, mesh=mesh8(), checkpoint_path=ckpt,
                checkpoint_every=2)
    with pytest.raises(Interrupt):
        eng.run(seeds, FlakyReader(traj, die_after=3), centers=centers)
    with np.load(ckpt) as d:
        assert int(d["next_lo"]) == 192
    saved = open(ckpt, "rb").read()
    got = eng.run(seeds, FlakyReader(traj, die_after=None), centers=centers)
    assert not os.path.exists(ckpt)
    _same_result(got, want, centre_atol=1e-6)
    with open(ckpt, "wb") as f:
        f.write(saved)
    ref = JaxStreaming(block_frames=96, mesh=jax_frame_mesh(n_devices=8),
                       checkpoint_path=ckpt, **SKW).run(seeds, traj,
                                                        centers=centers)
    _same_result(got, ref)


def test_block_frames_must_divide_the_mesh(md_system):
    """Both packages refuse a block the mesh does not divide, with the same
    message."""
    md, seeds, centers = md_system
    msg = "block_frames must be a multiple of the mesh size"
    with pytest.raises(ValueError, match=msg):
        JaxStreaming(block_frames=100, mesh=jax_frame_mesh(n_devices=8),
                     **SKW).run(seeds, md.traj[:200], centers=centers)
    with pytest.raises(ValueError, match=msg):
        _port(block_frames=100, mesh=mesh8()).run(seeds, md.traj[:200],
                                                  centers=centers)


# -- short blocks in pass 2 ---------------------------------------------------

def _spy_k1(monkeypatch):
    """Record the frame count of every call of K1's wrapper."""
    seen = []
    real = tmx.mxu_assign_blocks

    def spy(mobile, *a, **k):
        seen.append(mobile.shape[0])
        return real(mobile, *a, **k)

    monkeypatch.setattr(tmx, "mxu_assign_blocks", spy)
    return seen


@pytest.mark.parametrize("depth", [0, 2])
def test_short_input_runs_on_its_own_frames(md_system, monkeypatch, depth):
    """100 frames at ``block_frames=1024``: K1's wrapper sees 100 frames,
    not 1024, and the result equals the run in one 100-frame block and
    the reference's, which pads the block to 1024 frames."""
    md, seeds, centers = md_system
    traj = md.traj[:100]
    seen = _spy_k1(monkeypatch)
    got = _port(block_frames=1024, use_fused=True,
                pipeline_depth=depth).run(seeds, traj, centers=centers)
    assert seen == [100]
    want = _port(block_frames=100, use_fused=True).run(seeds, traj,
                                                       centers=centers)
    _same_result(got, want, centre_atol=0.0)
    ref = JaxStreaming(block_frames=1024, **SKW).run(seeds, traj,
                                                     centers=centers)
    dense = _port(block_frames=1024).run(seeds, traj, centers=centers)
    _same_result(dense, ref)


@pytest.mark.parametrize("depth", [0, 2])
def test_short_last_block_runs_on_its_own_frames(md_system, tmp_path,
                                                 monkeypatch, depth):
    """250 frames in 100-frame blocks: the last block runs on 50 frames;
    on the 8-shard mesh in 104-frame blocks the last one (42 frames) is
    padded only to 48 (6 frames a shard).  Labels and statistics equal the
    reference's padded run."""
    md, seeds, centers = md_system
    traj = md.traj[:250]
    seen = _spy_k1(monkeypatch)
    got = _port(block_frames=100, use_fused=True, pipeline_depth=depth,
                store_labels=str(tmp_path / "t.npy")).run(
        seeds, traj, centers=centers)
    assert seen == [100, 100, 50]
    seen.clear()
    got8 = _port(block_frames=104, use_fused=True, pipeline_depth=depth,
                 mesh=mesh8(), store_labels=str(tmp_path / "m.npy")).run(
        seeds, traj, centers=centers)
    assert seen == [13] * 8 + [13] * 8 + [6] * 8
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "m.npy"))
    _same_result(got8, got, centre_atol=1e-6)
    dense = _port(block_frames=100, pipeline_depth=depth,
                  store_labels=str(tmp_path / "d.npy")).run(
        seeds, traj, centers=centers)
    ref = JaxStreaming(block_frames=100, store_labels=str(tmp_path / "j.npy"),
                       **SKW).run(seeds, traj, centers=centers)
    _same_result(dense, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"),
                                  np.load(tmp_path / "j.npy"))


def test_lanes_upload_shards_from_the_slot():
    """On a CPU device the lanes hand a meshed block out as frame shards of
    a copy of the slot; a short block fills only its frames."""
    mesh = tmesh.FrameMesh(["cpu"] * 4)
    lanes = tst._Lanes(torch.device("cpu"), 2, 8, mesh)
    block = np.random.default_rng(1).normal(size=(4, 5, 3)).astype(
        np.float32)
    mob, sta = lanes.upload(block, (np.array([0, 3]), np.array([4, 1, 2])))
    assert isinstance(mob, tmesh.ShardedFrames) and len(mob.shards) == 4
    assert [s.shape[0] for s in mob.shards] == [1] * 4
    np.testing.assert_array_equal(np.asarray(mob), block[:, [0, 3]])
    np.testing.assert_array_equal(np.asarray(sta), block[:, [4, 1, 2]])
    assert lanes.slots[0][0].shape == (8, 2, 3)


# -- the entry points ---------------------------------------------------------

def test_entry_matches_reference():
    """``graft_entry.entry()``: the dense step on the toy system, equal to
    the reference's ``__graft_entry__.entry()``."""
    import __graft_entry__ as jentry
    from sitator_tpu_torch import graft_entry
    fn, args = graft_entry.entry(device="cpu")
    labels, confs, stats = fn(*args)
    jfn, jargs = jentry.entry()
    jl, jc, js = jfn(*jargs)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_allclose(confs.numpy(), np.asarray(jc), atol=1e-5)
    _stats_equal({k: v.numpy() for k, v in stats.items()},
                 {k: np.asarray(v) for k, v in js.items()})


def test_dryrun_multichip_on_a_virtual_cpu_mesh(capsys):
    from sitator_tpu_torch import graft_entry
    graft_entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4, cpu): OK" in capsys.readouterr().out
