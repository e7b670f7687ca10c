"""``StreamingLandmarkAnalysis`` in the port against the JAX package's, on
the CPU: the same ``SiteNetwork`` and frames (the reference's streaming test
system) through both engines, the JAX kernels in interpret mode where a
fused route runs.

Tolerances: integer results (labels on the f32 dense route, n_ij,
occupancies, residence counts) exactly equal; ``p_ij``, ``jump_lag`` and
``residence_times`` (ratios of equal integers) ``rtol=1e-6``; fitted
centres ``atol=1e-5`` (f32 landmark vectors summed in another order);
toroidal site centres ``atol=1e-4`` (float sums in another order and
precision).  On the fused route the similarities use bf16 operands, so
labels are held equal wherever the reference's f32 top-2 margin exceeds
8e-3 and the best similarity is not within 1e-2 of the threshold.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.landmark import streaming as jst
from sitator_tpu.ops import landmark as jlm
from sitator_tpu.voronoi import VoronoiSiteGenerator

import sitator_tpu_torch as port
from sitator_tpu_torch.landmark import streaming as tst
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
from sitator_tpu_torch.util.errors import (MultipleOccupancyError,
                                           StaticLatticeError)

from tests._torch_common import first_math_calls_on_one_thread

torch.set_num_threads(2)


first_math_calls_on_one_thread()

KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False)
THR = 0.35


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=700,
                                 jump_rate=0.03, seed=9)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    return md, seeds


@pytest.fixture(scope="module")
def centers(md_system):
    """The reference's fitted centres (dense route)."""
    md, seeds = md_system
    return JaxStreaming(block_frames=100, **KW).fit_centers(
        seeds, ArrayTrajectory(md.traj))


def _port(**kw):
    return port.StreamingLandmarkAnalysis(device="cpu", **{**KW, **kw})


def _swapped(md, T, a, b, n):
    traj = md.traj[:n].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[a], sa[b]
    traj[T:, i], traj[T:, j] = (md.traj[T:n, j].copy(),
                                md.traj[T:n, i].copy())
    return traj, i, j


def _assert_same_result(got, want, *, centre_atol=1e-4):
    np.testing.assert_array_equal(got.n_ij, want.n_ij)
    np.testing.assert_array_equal(got.total_corrected_residences,
                                  want.total_corrected_residences)
    np.testing.assert_array_equal(got.occupancies, want.occupancies)
    for name in ("p_ij", "jump_lag"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.residence_times, want.residence_times,
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.centers, want.centers, atol=centre_atol)


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


# -- pass 1 ------------------------------------------------------------------

@pytest.mark.parametrize("use_fused", [False, True])
def test_fit_centers_matches_reference(md_system, use_fused):
    md, seeds = md_system
    want = JaxStreaming(use_fused=use_fused, interpret=True, **KW) \
        .fit_centers(seeds, ArrayTrajectory(md.traj))
    before = tmx.mxu_landmark_blocks.launches
    got = _port(use_fused=use_fused).fit_centers(seeds,
                                                 ArrayTrajectory(md.traj))
    assert tmx.mxu_landmark_blocks.launches == before    # CPU: plain K2
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fit_centers_follows_lattice_exchange(md_system):
    """With dynamic_lattice_mapping the fit on a swapped trajectory equals
    the fit on the unswapped one, as in the reference."""
    md, seeds = md_system
    swapped, _, _ = _swapped(md, 310, 4, 11, len(md.traj))
    want = _port().fit_centers(seeds, ArrayTrajectory(md.traj))
    got = _port(dynamic_lattice_mapping=True).fit_centers(
        seeds, ArrayTrajectory(swapped))
    np.testing.assert_array_equal(got, want)
    ref = JaxStreaming(dynamic_lattice_mapping=True, **KW).fit_centers(
        seeds, ArrayTrajectory(swapped))
    np.testing.assert_allclose(got, ref, atol=1e-5)


# -- pass 2 ------------------------------------------------------------------

def test_run_dense_matches_reference(md_system, centers, tmp_path):
    md, seeds = md_system
    want = JaxStreaming(block_frames=100, store_labels=str(tmp_path / "j.npy"),
                        **KW).run(seeds, md.traj, centers=centers)
    eng = _port(block_frames=100, store_labels=str(tmp_path / "t.npy"))
    got = eng.run(seeds, md.traj, centers=centers)
    assert eng.route_ == "dense"
    _assert_same_result(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))


def _margin_gate(md, seeds, centers):
    """True where the reference's f32 top-2 margin is inside the bf16 gate
    or the best similarity is within 1e-2 of the threshold."""
    mob = md.traj[:, seeds.mobile_mask]
    sta = md.traj[:, seeds.static_mask]
    verts, vmask = seeds.padded_vertices()
    cell = seeds.structure.cell.astype(np.float32)
    lv = jlm.landmark_vectors(
        jnp.asarray(mob, jnp.float32), jnp.asarray(sta, jnp.float32),
        jlm.vertex_membership_matrix(verts, vmask, sta.shape[1]),
        jnp.asarray(cell), jnp.asarray(np.linalg.inv(cell), jnp.float32),
        4.0, 3.0)
    sims = np.asarray(jlm.normalize_landmark_vectors(lv)[0]) @ centers.T
    sims = np.concatenate(
        [sims, np.zeros(sims.shape[:-1] + ((-len(centers)) % 128,))], -1)
    top = -np.sort(-sims, axis=-1)[..., :2]
    return (top[..., 0] - top[..., 1] <= 8e-3) | (np.abs(top[..., 0] - THR)
                                                   <= 1e-2)


def test_run_fused_matches_reference(md_system, centers, tmp_path):
    """The K1 route (plain version on the CPU) against the reference's K1 in
    interpret mode."""
    md, seeds = md_system
    want = JaxStreaming(block_frames=100, use_fused=True, interpret=True,
                        store_labels=str(tmp_path / "j.npy"), **KW).run(
        seeds, md.traj, centers=centers)
    eng = _port(block_frames=100, use_fused=True,
                store_labels=str(tmp_path / "t.npy"))
    got = eng.run(seeds, md.traj, centers=centers)
    assert eng.route_ == "mxu"
    lt, lj = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    gate = _margin_gate(md, seeds, centers)
    assert (~gate).any()
    np.testing.assert_array_equal(lt[~gate], lj[~gate])
    if np.array_equal(lt, lj):
        _assert_same_result(got, want)
    # whatever the gated rows hold, the statistics are those of the labels
    st, _, _ = _jump_stats_block_int64(
        lt, len(centers), np.full(lt.shape[1], -1, np.int64),
        np.zeros(lt.shape[1], np.int64), "persist")
    np.testing.assert_array_equal(got.n_ij, st["n_ij"])
    np.testing.assert_array_equal(got.total_corrected_residences,
                                  st["occ_counts"])


def test_run_gather_route_matches_reference(md_system, centers,
                                            monkeypatch):
    """A basis the unique-atom gate declines runs the gather route (K3's
    plain version), against the reference's gather kernel in interpret
    mode."""
    md, seeds = md_system
    import sitator_tpu.ops.landmark_mxu as jmx
    monkeypatch.setattr(jmx, "prepare_engine_basis", lambda *a, **k: None)
    monkeypatch.setattr(tmx, "_engine_gate", lambda *a, **k: (None, None))
    eng = _port(block_frames=128, use_fused=True)
    got = eng.run(seeds, md.traj[:256], centers=centers)
    assert eng.route_ == "gather"
    want = JaxStreaming(block_frames=128, use_fused=True, interpret=True,
                        **KW).run(seeds, md.traj[:256], centers=centers)
    _assert_same_result(got, want)


def test_block_size_invariance(md_system, centers):
    md, seeds = md_system
    out1 = _port(block_frames=701).run(seeds, md.traj, centers=centers)
    out2 = _port(block_frames=96).run(seeds, md.traj, centers=centers)
    _assert_same_result(out1, out2, centre_atol=1e-6)


def test_streaming_agrees_with_pipeline(md_system, centers, tmp_path):
    """Cross-engine: the spilled labels equal the port's
    SpmdLandmarkPipeline labels with the same centres."""
    md, seeds = md_system
    _port(block_frames=100, store_labels=str(tmp_path / "l.npy")).run(
        seeds, md.traj[:300], centers=centers)
    pipe = port.SpmdLandmarkPipeline(
        seeds, centers, np.ones(len(centers), bool), cutoff_midpoint=4.0,
        cutoff_steepness=3.0, use_fused=False, device="cpu")
    labels, _, _ = pipe.run_block(md.traj[:300])
    np.testing.assert_array_equal(np.load(tmp_path / "l.npy"), labels)


@pytest.mark.parametrize("K,egress,runs", [
    (4095, "pack12", True), (4096, "int16", True), (32767, "int16", False),
    (32768, "int32", False)])
def test_egress_follows_site_count(md_system, centers, tmp_path, monkeypatch,
                                   K, egress, runs):
    """The labels leave the device in the narrowest format the site count
    allows: the 12-bit pack below 4096 sites, int16 below 2^15, else int32.
    Where the accumulators of K sites are small enough to run, the spilled
    labels equal those of an int32 egress; the fitted centres are the last
    of the K (the others random unit vectors), so the labels reach the top
    of the format's range."""
    md, seeds = md_system
    rng = np.random.default_rng(K)
    extra = rng.standard_normal((K - len(centers), centers.shape[1]))
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    big = np.concatenate([extra, centers]).astype(np.float32)
    kw = dict(block_frames=100, static_movement_threshold=None)
    assert _port(**kw)._assign_setup(seeds, big)[1]["egress"] == egress
    if not runs:
        return
    _port(store_labels=str(tmp_path / "v.npy"), **kw).run(
        seeds, md.traj[:200], centers=big)
    real = tst.StreamingLandmarkAnalysis._assign_setup

    def int32(self, *a, **k):
        route, plan = real(self, *a, **k)
        return route, dict(plan, egress="int32")

    monkeypatch.setattr(tst.StreamingLandmarkAnalysis, "_assign_setup",
                        int32)
    _port(store_labels=str(tmp_path / "ref.npy"), **kw).run(
        seeds, md.traj[:200], centers=big)
    lab = np.load(tmp_path / "v.npy")
    assert lab.max() >= K - len(centers)
    np.testing.assert_array_equal(lab, np.load(tmp_path / "ref.npy"))


def test_phase_times_populated(md_system, centers, tmp_path):
    md, seeds = md_system
    eng = _port(block_frames=128, store_labels=str(tmp_path / "l.npy"))
    eng.run(seeds, md.traj, centers=centers)
    pt = eng.phase_times_
    for name in ("setup", "feeder", "upload", "dispatch_assign",
                 "dispatch_fold", "drift_fetch", "labels_fetch",
                 "labels_memmap_write", "epoch_spill", "finalize"):
        assert name in pt and pt[name] > 0.0, (name, pt)


# -- guards --------------------------------------------------------------------

def test_static_drift_raises(md_system, centers):
    md, seeds = md_system
    bad = md.traj[:200].copy()
    bad[120:, np.flatnonzero(md.static_mask)[0]] += 3.0
    with pytest.raises(StaticLatticeError) as ei:
        _port(block_frames=64).run(seeds, bad, centers=centers)
    assert ei.value.frame == 120
    out = _port(block_frames=64, static_movement_threshold=None).run(
        seeds, bad, centers=centers)
    assert out.n_sites > 0


def test_dynamic_lattice_mapping_in_run(md_system, centers):
    """Two static atoms exchange sites inside a block: with
    dynamic_lattice_mapping the result equals the unswapped run and the
    reference's; without it, StaticLatticeError."""
    md, seeds = md_system
    swapped, i, j = _swapped(md, 233, 2, 17, 500)
    want = _port(block_frames=100).run(seeds, md.traj[:500],
                                       centers=centers)
    with pytest.raises(StaticLatticeError):
        _port(block_frames=100).run(seeds, swapped, centers=centers)
    dyn = _port(block_frames=100, dynamic_lattice_mapping=True)
    got = dyn.run(seeds, swapped, centers=centers)
    sidx = np.flatnonzero(seeds.static_mask)
    si, sj = np.flatnonzero(sidx == i)[0], np.flatnonzero(sidx == j)[0]
    assert dyn.lattice_mapping_[si] == sj and dyn.lattice_mapping_[sj] == si
    _assert_same_result(got, want, centre_atol=1e-6)
    ref = JaxStreaming(block_frames=100, dynamic_lattice_mapping=True,
                       **KW).run(seeds, swapped, centers=centers)
    _assert_same_result(got, ref)


def test_dynamic_mapping_without_consistent_perm_raises(md_system, centers):
    md, seeds = md_system
    broken = md.traj[:500].copy()
    broken[233:, np.flatnonzero(md.static_mask)[2]] += 2.0
    with pytest.raises(StaticLatticeError,
                       match="no consistent lattice mapping") as ei:
        _port(block_frames=100, dynamic_lattice_mapping=True).run(
            seeds, broken, centers=centers)
    assert ei.value.frame == 233


def test_multiple_occupancy_modes(md_system, centers):
    md, seeds = md_system
    traj = md.traj[:200].copy()
    mob = np.flatnonzero(md.mobile_mask)
    traj[:, mob[1]] = traj[:, mob[0]]          # ion 1 shadows ion 0
    with pytest.raises(MultipleOccupancyError) as ei:
        _port(block_frames=64, multiple_occupancy_action="raise").run(
            seeds, traj, centers=centers)
    assert ei.value.count > 0
    out_warn = _port(block_frames=64).run(seeds, traj, centers=centers)
    out_ign = _port(block_frames=64, multiple_occupancy_action="ignore").run(
        seeds, traj, centers=centers)
    out_off = _port(block_frames=64, max_mobile_per_site=None).run(
        seeds, traj, centers=centers)
    for out in (out_ign, out_off):
        np.testing.assert_array_equal(out.n_ij, out_warn.n_ij)
    ref = JaxStreaming(block_frames=64, **KW).run(seeds, traj,
                                                  centers=centers)
    _assert_same_result(out_warn, ref)


# -- checkpoint / resume -----------------------------------------------------

def test_checkpoint_resume(md_system, centers, tmp_path):
    """An interrupted run resumes from its checkpoint and equals an
    uninterrupted one; the checkpoint carries the reference's keys, so the
    JAX engine resumes from it to the same result."""
    md, seeds = md_system
    want = _port(block_frames=100).run(seeds, md.traj, centers=centers)
    ckpt = str(tmp_path / "run.ckpt")
    eng = _port(block_frames=100, checkpoint_path=ckpt, checkpoint_every=2)
    with pytest.raises(Interrupt):
        eng.run(seeds, FlakyReader(md.traj, die_after=4), centers=centers)
    assert os.path.exists(ckpt)
    with np.load(ckpt) as d:
        assert {"n_frames", "K", "next_lo", "carry_last", "carry_res",
                "perm", "hacc/n_ij", "hacc/occ", "hacc/cos"} <= set(d.files)
        assert int(d["next_lo"]) == 400
    saved = open(ckpt, "rb").read()
    got = eng.run(seeds, FlakyReader(md.traj, die_after=None),
                  centers=centers)
    assert not os.path.exists(ckpt)
    _assert_same_result(got, want, centre_atol=1e-6)
    with open(ckpt, "wb") as f:
        f.write(saved)
    ref = JaxStreaming(block_frames=100, checkpoint_path=ckpt, **KW).run(
        seeds, md.traj, centers=centers)
    _assert_same_result(got, ref)


def test_checkpoint_resume_across_lattice_swap(md_system, centers, tmp_path):
    md, seeds = md_system
    swapped, _, _ = _swapped(md, 150, 6, 20, 600)
    want = _port(block_frames=100, dynamic_lattice_mapping=True).run(
        seeds, swapped, centers=centers)
    ckpt = str(tmp_path / "swap.ckpt")
    eng = _port(block_frames=100, dynamic_lattice_mapping=True,
                checkpoint_path=ckpt, checkpoint_every=1)
    with pytest.raises(Interrupt):
        eng.run(seeds, FlakyReader(swapped, die_after=3), centers=centers)
    with np.load(ckpt) as d:
        assert (d["perm"] != np.arange(len(d["perm"]))).sum() == 2
    got = eng.run(seeds, FlakyReader(swapped, die_after=None),
                  centers=centers)
    _assert_same_result(got, want, centre_atol=1e-6)


def test_checkpoint_mismatch_raises(md_system, centers, tmp_path):
    md, seeds = md_system
    ckpt = str(tmp_path / "stale.npz")
    np.savez(ckpt, n_frames=12345, K=3, next_lo=64,
             carry_last=np.zeros(4, np.int64),
             carry_res=np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="checkpoint does not match"):
        _port(block_frames=64, checkpoint_path=ckpt).run(
            seeds, md.traj[:128], centers=centers)


# -- pieces and arguments ------------------------------------------------------

def test_pack12_words_match_reference():
    rng = np.random.default_rng(7)
    for n in (1, 3, 4, 7, 739, 128):
        lab = rng.integers(-1, 4095, size=(5, n)).astype(np.int32)
        lab.flat[0], lab.flat[-1] = -1, 4094
        got = tst._pack12(torch.from_numpy(lab)).numpy()
        want = np.asarray(jst._pack12(jnp.asarray(lab)))
        assert got.dtype == np.int16
        assert got.shape == (5, tst.pack12_width(n))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tst._unpack12(got, n),
                                      lab.astype(np.int16))


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(pipeline_depth=2)])
def test_not_ported_arguments_raise(kw):
    """A ``mesh`` that is not a frame mesh raises (frame meshes are taken:
    ``tests/test_torch_mesh.py``); the run-ahead arguments, which raised
    until the dispatcher was ported, are accepted and kept."""
    if "mesh" in kw:
        with pytest.raises(TypeError, match="FrameMesh"):
            port.StreamingLandmarkAnalysis(device="cpu", **kw)
        return
    eng = port.StreamingLandmarkAnalysis(device="cpu", **kw)
    for k, v in kw.items():
        assert getattr(eng, k) == v
    assert port.StreamingLandmarkAnalysis(device="cpu").pipeline_depth == 2


def test_constructor_validation():
    with pytest.raises(ValueError, match="multiple_occupancy_action"):
        _port(multiple_occupancy_action="explode")
    with pytest.raises(ValueError, match="static_movement_threshold"):
        _port(dynamic_lattice_mapping=True, static_movement_threshold=None)
