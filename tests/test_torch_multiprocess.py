"""The port's frame mesh across processes (the multi-process form of
``sitator_tpu_torch.parallel.mesh`` and the three analysis steps of
``sitator_tpu_torch.parallel.pipeline``) against the reference's
single-process result on the global frames.

Each rank is a fresh ``python -m tests._torch_mp_worker`` process (torch
and the port only; it fails if ``jax`` or ``sitator_tpu`` is imported) in a
gloo group that meets through a ``file://`` rendezvous in ``tmp_path``.
Three groups, each spawned once for the module: 2 ranks x 1 CPU shard, 4
ranks x 2 CPU shards (8 global shards, the reference's virtual mesh size),
and 2 ranks holding 2 and 1 shards (the gather pads the short rank with
zero rows, which must not reach the result).  The
parent waits with a deadline and kills the group when it passes or when a
rank fails, so no test outlasts its limit.

Tolerances, as ``tests/test_torch_mesh.py`` states them: every rank's
labels, confidences and jump tallies bit-equal to rank 0's and to the port's
unmeshed step on the same frames; against the reference (its steps on its 8
virtual devices, the Pallas kernels in interpret mode) integers equal,
confidences within 1e-5 in f32 (the dense step, K3's with f32 operands) and
1e-2 with bf16 operands (K1's).  With bf16 operands labels may part where
the f32 top-2 margin is under 8e-3; on these frames none does, so labels
and tallies are held equal on every route.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis as JaxLandmarkAnalysis
from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu.ops.cluster import dotprod_fit as jax_dotprod_fit
from sitator_tpu.ops.landmark import \
    vertex_membership_matrix as jax_membership
from sitator_tpu.ops.landmark_pallas import kernel_cell as jax_kernel_cell
from sitator_tpu.parallel import frame_mesh as jax_frame_mesh
from sitator_tpu.parallel import shard_frames as jax_shard_frames
from sitator_tpu.parallel import pipeline as jpipe
from sitator_tpu.voronoi import VoronoiSiteGenerator

from sitator_tpu_torch.parallel import mesh as tmesh

from tests._torch_common import first_math_calls_on_one_thread
from tests._torch_mp_worker import BLOCKS, MID, STAT_KEYS, STEEP, THR

torch.set_num_threads(2)

first_math_calls_on_one_thread()

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 120           # seconds a group may run before the parent kills it
STEPS = ("mxu", "fused", "dense")
CONF_ATOL = {"mxu": 1e-2, "fused": 1e-5, "dense": 1e-5}


def spawn(tmp, world, shards, data):
    """Run one group of ``world`` ranks, each holding ``shards[r]`` CPU
    shards (``data`` one path for every rank, or a path a rank).  Returns
    ``(return codes, logs, seconds)``; a rank still running when another
    has failed or the deadline has passed is killed."""
    data = data if isinstance(data, list) else [data] * world
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    t0 = time.monotonic()
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests._torch_mp_worker", str(r),
                     str(world), ",".join(map(str, shards)),
                     str(tmp / "rendezvous"),
                     str(data[r]), str(tmp / f"rank{r}.npz")],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() - t0 > LIMIT:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return ([p.returncode for p in procs], [log.read_text() for log in logs],
            time.monotonic() - t0)


# -- the system and the reference's results ---------------------------------

@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """The mesh tests' system (``tests/test_torch_mesh.py::fitted_system``),
    its first 104 frames in float32, written for the ranks."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=400,
                                 jump_rate=0.03, seed=3)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    la = JaxLandmarkAnalysis(cutoff_midpoint=MID, cutoff_steepness=STEEP,
                             verbose=False)
    la.run(seeds, md.traj)
    res = jax_dotprod_fit(jnp.asarray(la.landmark_vectors), k_max=128,
                          cluster_threshold=0.45, min_samples=4)
    verts, vmask = seeds.padded_vertices()
    sy = dict(traj=md.traj[:BLOCKS[-1][1]].astype(np.float32),
              mobile_mask=np.asarray(md.mobile_mask),
              static_mask=np.asarray(md.static_mask),
              positions=md.structure.positions,
              species=np.asarray(md.structure.species),
              cell=np.asarray(md.structure.cell), verts=np.asarray(verts),
              vmask=np.asarray(vmask), site_centers=seeds.centers,
              centers=np.asarray(res["centers"]),
              active=np.asarray(res["active"]))
    path = tmp_path_factory.mktemp("mp_system") / "system.npz"
    np.savez(path, **sy)
    return sy, path


def jax_steps(sy):
    """The reference's three steps as ``step(mesh, mobile, static, valid,
    carry)``, with the arguments the ranks give the port's."""
    verts, vmask, cell = sy["verts"], sy["vmask"], sy["cell"]
    centers, active = sy["centers"], sy["active"]
    live = centers[active]
    K = len(centers)
    kcell = jax_kernel_cell(cell)
    basis = jmx.prepare_engine_basis(
        verts, vmask, sy["site_centers"], cell, midpoint=MID,
        steepness=STEEP, cutoff_shape="logistic",
        static_ref=sy["positions"][sy["static_mask"]], drift_budget=3.0)
    perm = jnp.asarray(jmx.permute_centers(live, basis))
    A = jax_membership(verts, vmask, int(sy["static_mask"].sum()))
    kw = dict(midpoint=MID, steepness=STEEP, threshold=THR, interpret=True,
              active_idx=np.flatnonzero(active), n_sites=K)
    return dict(
        mxu=lambda m, mob, sta, valid, carry: jpipe.mxu_analysis_step(
            m, mob, sta, basis, kcell, perm, valid=valid, carry=carry, **kw),
        fused=lambda m, mob, sta, valid, carry: jpipe.fused_analysis_step(
            m, mob, sta, jnp.asarray(verts), jnp.asarray(vmask), kcell,
            jnp.asarray(live), s_tile=128, mxu_bf16=False,
            full_mask=bool(vmask.all()), valid=valid, carry=carry, **kw),
        dense=lambda m, mob, sta, valid, carry: jpipe.analysis_step(
            mob, sta, A, jnp.asarray(cell, jnp.float32),
            jnp.asarray(np.linalg.inv(cell), jnp.float32),
            jnp.asarray(centers), jnp.asarray(active), MID, STEEP, THR, K,
            valid=valid, carry=carry))


@pytest.fixture(scope="module")
def reference(system):
    """The reference's step results on each block (padded to its 8 virtual
    devices, the carry chained), by step name: [(labels, confs, stats)]."""
    sy, _ = system
    mesh = jax_frame_mesh()
    out = {}
    for name, step in jax_steps(sy).items():
        carry, runs = None, []
        for lo, hi in BLOCKS:
            padded, n_valid = tmesh.pad_frames(sy["traj"][lo:hi], 8)
            valid = jnp.asarray(np.arange(len(padded)) < n_valid)
            labels, confs, stats = step(
                mesh, jax_shard_frames(padded[:, sy["mobile_mask"]], mesh),
                jax_shard_frames(padded[:, sy["static_mask"]], mesh), valid,
                carry)
            stats = {k: np.asarray(stats[k]) for k in STAT_KEYS}
            runs.append((np.asarray(labels)[:n_valid],
                         np.asarray(confs)[:n_valid], stats))
            carry = (stats["last_sites"], stats["last_res"])
        out[name] = runs
    return out


@pytest.fixture(scope="module", params=[(1, 1), (2, 2, 2, 2), (2, 1)],
                ids=["2ranks_x1", "4ranks_x2", "2ranks_2and1"])
def group(request, system, tmp_path_factory):
    """One group run: (world, each rank's shard count, [each rank's
    results])."""
    shards = request.param
    world = len(shards)
    tmp = tmp_path_factory.mktemp(f"mp{world}")
    rcs, logs, sec = spawn(tmp, world, shards, system[1])
    assert rcs == [0] * world and sec < LIMIT, \
        f"ranks exited {rcs} after {sec:.1f} s:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))
    ranks = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as d:
            ranks.append({k: d[k] for k in d.files})
    return world, shards, ranks


# -- the mesh ---------------------------------------------------------------

def test_mesh_spans_every_rank(group):
    """``frame_mesh`` spans every rank's devices in rank order; each rank
    holds its own shards."""
    world, shards, ranks = group
    for r, got in enumerate(ranks):
        assert int(got["size"]) == sum(shards)
        np.testing.assert_array_equal(got["procs"],
                                      np.repeat(np.arange(world), shards))
        np.testing.assert_array_equal(got["local"], _local(shards, r))
        assert bool(got["spans"])


def _local(shards, r):
    """The global indices of rank ``r``'s shards."""
    return np.arange(sum(shards[:r]), sum(shards[:r + 1]))


def test_placements_match_the_reference(group):
    """``shard_frames_local`` (each rank its slab) and cross-process
    ``shard_frames`` (the global array on every rank) place the same shards
    at the same global offsets, those of the reference's ``shard_frames``
    of the global array on its 8 devices; the gather, and a computation
    through ``shard_map_frames``, give every rank the whole array."""
    world, shards, ranks = group
    glob = np.arange(24 * 4 * 3, dtype=np.float32).reshape(24, 4, 3)
    ref = jax_shard_frames(glob, jax_frame_mesh(n_devices=8))
    ref_shards = {s.index[0].start: np.asarray(s.data)
                  for s in ref.addressable_shards}
    m = 24 // sum(shards)
    for r, got in enumerate(ranks):
        offsets = [i * m for i in _local(shards, r)]
        np.testing.assert_array_equal(got["local_offsets"], offsets)
        np.testing.assert_array_equal(got["global_offsets"], offsets)
        np.testing.assert_array_equal(got["local_shards"],
                                      got["global_shards"])
        for o, shard in zip(offsets, got["local_shards"]):
            np.testing.assert_array_equal(shard, np.asarray(ref)[o:o + m])
            if m == 3:                       # 8 shards: the reference's own
                np.testing.assert_array_equal(shard, ref_shards[o])
        np.testing.assert_array_equal(got["gathered"], glob)
        np.testing.assert_array_equal(got["mapped"], (glob * glob).sum((1, 2)))


def test_errors_reach_every_rank(group):
    """A slab whose length disagrees across ranks, a mesh out of process
    order and a rank without devices raise on every rank (no rank is left
    waiting); ``np.asarray`` of a sharded array that spans processes
    raises, as the reference's fetch of a non-addressable array does."""
    world, _, ranks = group
    for got in ranks:
        assert "the ranks' frame slabs disagree" in str(got["slab_error"])
        assert "process-contiguous" in str(got["order_error"])
        assert f"rank {world - 1}: a frame mesh needs at least one device" \
            in str(got["mesh_error"])
        assert "call gather_frames on every rank" in str(got["asarray_error"])


def test_engines_refuse_a_multiprocess_mesh(group):
    """``SpmdLandmarkPipeline``, ``LandmarkAnalysis`` and
    ``StreamingLandmarkAnalysis`` raise ValueError on a mesh that spans
    processes: an engine never runs on one rank's frames alone."""
    _, _, ranks = group
    for got in ranks:
        assert len(got["engine_errors"]) == 3
        for msg in got["engine_errors"]:
            assert "this frame mesh spans processes" in str(msg)


# -- the steps --------------------------------------------------------------

@pytest.mark.parametrize("name", STEPS)
def test_step_across_ranks(group, reference, name):
    """Each step on the two blocks (61 frames without a carry, placed by
    ``shard_frames_local``; 43 with the first block's carry, placed by
    ``shard_frames``; both padded to the global mesh size): every rank
    returns the whole block's labels, confidences and tallies, bit-equal to
    rank 0's and to the unmeshed step, and held to the reference's; K1 and
    K3 run once per local shard, blocks x global shards in all."""
    world, shards, ranks = group
    n_dev = sum(shards)
    for b, (lo, hi) in enumerate(BLOCKS):
        key = f"{name}__{b}"
        for r, got in enumerate(ranks):
            for part in ("labels", "confs") + STAT_KEYS:
                np.testing.assert_array_equal(
                    got[f"{key}__{part}"], ranks[0][f"{key}__{part}"],
                    err_msg=f"rank {r}, block {b}, {part}")
        for part in ("labels", "confs") + STAT_KEYS:
            np.testing.assert_array_equal(
                ranks[0][f"{key}__{part}"],
                ranks[0][f"{key}__unmeshed__{part}"],
                err_msg=f"unmeshed, block {b}, {part}")
        want_lab, want_conf, want_stats = reference[name][b]
        got = ranks[0]
        np.testing.assert_array_equal(got[f"{key}__labels"], want_lab)
        np.testing.assert_allclose(got[f"{key}__confs"], want_conf,
                                   atol=CONF_ATOL[name])
        for k in STAT_KEYS:
            np.testing.assert_array_equal(got[f"{key}__{k}"], want_stats[k],
                                          err_msg=f"block {b}, {k}")
        padded = hi - lo + (-(hi - lo)) % n_dev
        kernel = {"mxu": "mxu_assign_blocks",
                  "fused": "fused_assign_blocks"}.get(name)
        for got, own in zip(ranks, shards):
            frames = got[f"{key}__frames"]
            if kernel is None:
                assert frames.size == 0
            else:
                assert list(got[f"{key}__kernels"]) == [kernel] * own
                assert list(frames) == [padded // n_dev] * own


# -- in one process ---------------------------------------------------------

def test_a_mesh_of_several_processes_without_a_group():
    """A mesh whose ``process_indices`` name several processes is refused
    by the engines' ``bind_mesh`` and by ``np.asarray`` of its arrays, with
    no process group in sight; a mesh built in one process is that
    process's alone."""
    mesh = tmesh.FrameMesh(["cpu"] * 2)
    assert mesh.process_indices == (0, 0) and mesh.local == [0, 1]
    assert not mesh.spans_processes
    mesh.process_indices = (0, 1)
    assert mesh.spans_processes and mesh.local == [0]
    with pytest.raises(ValueError, match="spans processes"):
        tmesh.bind_mesh(mesh, "cpu")
    sharded = tmesh.ShardedFrames(mesh, [torch.zeros(2, 3)], [0])
    with pytest.raises(RuntimeError, match="gather_frames on every rank"):
        np.asarray(sharded)


def test_a_failing_rank_ends_the_group(system, tmp_path):
    """A rank that dies before a collective (rank 1 cannot read its system,
    while rank 0 goes on to the first collective of the steps) does not
    leave rank 0 waiting out the group's 60 s timeout: the group ends
    within seconds of the failure, and the failure is reported."""
    rcs, logs, sec = spawn(tmp_path, 2, (1, 1),
                           [system[1], tmp_path / "no.npz"])
    assert rcs[0] != 0 and rcs[1] != 0
    assert "no.npz" in logs[1]
    assert sec < 45
