"""The run-ahead dispatcher of the port's ``StreamingLandmarkAnalysis`` on
the CPU, where the same window, retirement and rollback logic runs without
streams and events.

Contract held here: at every ``pipeline_depth`` and ``retire_group`` the
spilled labels, every integer statistic, the lattice permutation and the
checkpoint cursor are IDENTICAL to the synchronous loop (depth 0), and on a
CPU device so are the float sums (site centres, ratios): every comparison
between depths is ``assert_array_equal``.  Against the JAX engine (at its
own default depth) integers and labels are equal; ratios ``rtol=1e-6`` and
toroidal centres ``atol=1e-4`` (float sums in another order and precision).
"""
import os

import numpy as np
import pytest
import torch

from sitator_tpu import SiteNetwork
from sitator_tpu.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.voronoi import VoronoiSiteGenerator

import sitator_tpu_torch as port
from sitator_tpu_torch.landmark import streaming as tst
from sitator_tpu_torch.util.errors import StaticLatticeError

torch.set_num_threads(2)

KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False)
ATTRS = ("n_ij", "total_corrected_residences", "occupancies", "p_ij",
         "jump_lag", "residence_times", "centers")
# (pipeline_depth, retire_group)
WINDOWS = [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (6, 3)]


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=700,
                                 jump_rate=0.03, seed=9)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    return md, seeds


@pytest.fixture(scope="module")
def centers(md_system):
    md, seeds = md_system
    return port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=100, **KW).fit_centers(
        seeds, ArrayTrajectory(md.traj))


def _swapped(md, swaps, n):
    """``md.traj[:n]`` with static atoms ``a`` and ``b`` exchanged from
    frame ``T`` on, for every ``(T, a, b)`` of ``swaps``."""
    traj = md.traj[:n].copy()
    sa = np.flatnonzero(md.static_mask)
    for T, a, b in swaps:
        i, j = sa[a], sa[b]
        traj[T:, i], traj[T:, j] = traj[T:, j].copy(), traj[T:, i].copy()
    return traj


def _run(seeds, traj, centers, path, **kw):
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=100, store_labels=str(path),
        **{**KW, **kw})
    out = eng.run(seeds, traj, centers=centers)
    return eng, out, np.load(path)


def _assert_identical(got, want):
    for name in ATTRS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


TRAJS = {
    "plain": [],
    # one exchange inside block 2
    "swap": [(233, 2, 17)],
    # two exchanges, in blocks 1 and 3: by the window's length the second
    # offender is met by the first rollback's replay or by a block
    # dispatched optimistically after it
    "two_swaps": [(150, 6, 20), (333, 2, 17)],
}


@pytest.fixture(scope="module")
def baselines(md_system, centers, tmp_path_factory):
    """Depth 0 on each trajectory: (engine, result, labels)."""
    md, seeds = md_system
    d = tmp_path_factory.mktemp("base")
    return {name: _run(seeds, _swapped(md, swaps, 500), centers,
                       d / f"{name}.npy", pipeline_depth=0,
                       dynamic_lattice_mapping=True)
            for name, swaps in TRAJS.items()}


@pytest.mark.parametrize("name", list(TRAJS))
@pytest.mark.parametrize("depth,group", WINDOWS)
def test_depth_and_group_invariance(md_system, centers, baselines, tmp_path,
                                    name, depth, group):
    md, seeds = md_system
    eng0, want, lab0 = baselines[name]
    eng, got, lab = _run(seeds, _swapped(md, TRAJS[name], 500), centers,
                         tmp_path / "l.npy", pipeline_depth=depth,
                         retire_group=group, dynamic_lattice_mapping=True)
    np.testing.assert_array_equal(lab, lab0)
    _assert_identical(got, want)
    np.testing.assert_array_equal(eng.lattice_mapping_, eng0.lattice_mapping_)
    assert eng0.rollbacks_ == 0
    # an exchange met by an optimistic fold rolls back; one that falls
    # into the blocks being replayed is handled by the replay itself
    n = len(TRAJS[name])
    assert min(n, 1) <= eng.rollbacks_ <= n
    if depth == 1:
        assert eng.rollbacks_ == n


def test_default_depth_matches_reference_engine(md_system, centers,
                                                tmp_path):
    """The port at its shipped defaults (depth 2) against the JAX engine at
    its own (depth 2), dense route, across a lattice exchange."""
    md, seeds = md_system
    traj = _swapped(md, TRAJS["swap"], 500)
    eng, got, lab = _run(seeds, traj, centers, tmp_path / "t.npy",
                         dynamic_lattice_mapping=True)
    assert eng.pipeline_depth == 2 and eng.rollbacks_ == 1
    ref = JaxStreaming(block_frames=100, dynamic_lattice_mapping=True,
                       store_labels=str(tmp_path / "j.npy"), **KW)
    want = ref.run(seeds, traj, centers=centers)
    assert ref.pipeline_depth == 2
    np.testing.assert_array_equal(lab, np.load(tmp_path / "j.npy"))
    np.testing.assert_array_equal(eng.lattice_mapping_, ref.lattice_mapping_)
    for name in ("n_ij", "total_corrected_residences", "occupancies"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("p_ij", "jump_lag", "residence_times"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-4)


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("depth,group", [(0, 1)] + WINDOWS)
def test_drift_offender_raises_at_same_frame(md_system, centers, tmp_path,
                                             depth, group, store):
    """Without dynamic mapping an offender found at retirement raises the
    synchronous loop's error: the same frame, which is the JAX engine's."""
    md, seeds = md_system
    bad = md.traj[:500].copy()
    bad[233:, np.flatnonzero(md.static_mask)[0]] += 3.0
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=100, pipeline_depth=depth,
        retire_group=group,
        store_labels=str(tmp_path / "l.npy") if store else None, **KW)
    with pytest.raises(StaticLatticeError) as ei:
        eng.run(seeds, bad, centers=centers)
    assert ei.value.frame == 233
    assert eng.rollbacks_ == (1 if depth else 0)
    if depth == 2 and group == 1 and store:
        with pytest.raises(Exception) as ej:
            JaxStreaming(block_frames=100, **KW).run(seeds, bad,
                                                     centers=centers)
        assert ej.value.frame == ei.value.frame
        # the blocks before the offender's were spilled
        ok = _run(seeds, md.traj[:500], centers, tmp_path / "ok.npy",
                  pipeline_depth=0)[2]
        np.testing.assert_array_equal(np.load(tmp_path / "l.npy")[:200],
                                      ok[:200])


def test_no_consistent_mapping_raises_at_same_frame(md_system, centers):
    md, seeds = md_system
    broken = md.traj[:500].copy()
    broken[233:, np.flatnonzero(md.static_mask)[2]] += 2.0
    for depth in (0, 2):
        with pytest.raises(StaticLatticeError,
                           match="no consistent lattice mapping") as ei:
            port.StreamingLandmarkAnalysis(
                device="cpu", block_frames=100, pipeline_depth=depth,
                dynamic_lattice_mapping=True, **KW).run(
                seeds, broken, centers=centers)
        assert ei.value.frame == 233


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


@pytest.mark.parametrize("depth,group,name", [(3, 1, "plain"), (2, 2, "swap"),
                                              (1, 1, "two_swaps")])
def test_checkpoint_resume_under_run_ahead(md_system, centers, baselines,
                                           tmp_path, depth, group, name):
    """A checkpoint drains the window first, so its cursor and state are
    the synchronous loop's, and the resumed run equals the uninterrupted
    depth-0 run."""
    md, seeds = md_system
    traj = _swapped(md, TRAJS[name], 500)
    _, want, lab0 = baselines[name]
    ckpt = str(tmp_path / "run.ckpt")
    cks = {}
    for d, g in ((0, 1), (depth, group)):
        eng = port.StreamingLandmarkAnalysis(
            device="cpu", block_frames=100, checkpoint_path=ckpt,
            checkpoint_every=2, pipeline_depth=d, retire_group=g,
            dynamic_lattice_mapping=True,
            store_labels=str(tmp_path / f"l{d}.npy"), **KW)
        with pytest.raises(Interrupt):
            eng.run(seeds, FlakyReader(traj, die_after=4), centers=centers)
        with np.load(ckpt) as f:
            cks[d] = {k: f[k].copy() for k in f.files}
        got = eng.run(seeds, FlakyReader(traj, die_after=None),
                      centers=centers)
        assert not os.path.exists(ckpt)
        _assert_identical(got, want)
        np.testing.assert_array_equal(np.load(tmp_path / f"l{d}.npy"), lab0)
    assert int(cks[depth]["next_lo"]) == 400
    assert set(cks[depth]) == set(cks[0])
    for k in cks[0]:
        np.testing.assert_array_equal(cks[depth][k], cks[0][k], err_msg=k)


@pytest.mark.parametrize("depth", [0, 2])
def test_async_label_copy_acts_and_changes_nothing(md_system, centers,
                                                   baselines, tmp_path,
                                                   monkeypatch, depth):
    md, seeds = md_system
    started = []
    real = tst._Lanes.start_download

    def spy(self, t, produced=None):
        started.append(tuple(t.shape))
        return real(self, t, produced)

    monkeypatch.setattr(tst._Lanes, "start_download", spy)
    _, want, lab0 = baselines["swap"]
    eng, got, lab = _run(seeds, _swapped(md, TRAJS["swap"], 500), centers,
                         tmp_path / "l.npy", pipeline_depth=depth,
                         async_label_copy=True, dynamic_lattice_mapping=True)
    np.testing.assert_array_equal(lab, lab0)
    _assert_identical(got, want)
    # one eager egress copy per assignment: 5 blocks, and the blocks
    # assigned again after the exchange
    width = tst.pack12_width(lab.shape[1])
    assert sum(s == (100, width) for s in started) >= 6


def test_fused_route_identical_across_depths(md_system, centers, tmp_path):
    """The K1 route (its plain version on the CPU) under run-ahead."""
    md, seeds = md_system
    traj = _swapped(md, TRAJS["swap"], 300)
    res = {}
    for depth in (0, 2):
        res[depth] = _run(seeds, traj, centers, tmp_path / f"l{depth}.npy",
                          pipeline_depth=depth, use_fused=True,
                          dynamic_lattice_mapping=True)
        assert res[depth][0].route_ == "mxu"
    np.testing.assert_array_equal(res[2][2], res[0][2])
    _assert_identical(res[2][1], res[0][1])
    assert res[2][0].rollbacks_ == 1


def test_snapshot_only_with_drift_guard(md_system, centers, tmp_path):
    """The accumulators are copied before an optimistic fold only when the
    drift guard is on (nothing else rolls back); a partial last block is
    masked the same way at every depth."""
    md, seeds = md_system
    res = {}
    for depth in (0, 2):
        res[depth] = _run(seeds, md.traj[:450], centers,
                          tmp_path / f"l{depth}.npy", pipeline_depth=depth,
                          static_movement_threshold=None)
    assert "snapshot" not in res[2][0].phase_times_
    assert "drift_fetch" not in res[2][0].phase_times_
    np.testing.assert_array_equal(res[2][2], res[0][2])
    _assert_identical(res[2][1], res[0][1])
    guarded = _run(seeds, md.traj[:450], centers, tmp_path / "g.npy",
                   pipeline_depth=2)
    assert guarded[0].phase_times_["snapshot"] > 0.0
    _assert_identical(guarded[1], res[0][1])


def test_lanes_on_cpu_copy_out_of_the_staging_ring():
    """On a CPU device an upload is a copy, so rewriting a slot later does
    not reach a tensor handed out earlier; downloads hand the tensor
    through.  A block shorter than the slots goes up as its own frames."""
    lanes = tst._Lanes(torch.device("cpu"), 2, 4)
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(4, 6, 3)).astype(np.float32)
              for _ in range(3)]
    blocks.append(rng.normal(size=(4, 6, 3)))          # float64 source
    blocks.append(rng.normal(size=(3, 6, 3)).astype(np.float32))  # short
    idx = (np.array([0, 2]), np.array([5, 1, 3]))
    ups = [lanes.upload(b, idx) for b in blocks]
    for b, (mob, sta) in zip(blocks, ups):
        assert mob.dtype == sta.dtype == torch.float32
        np.testing.assert_array_equal(mob.numpy(),
                                      b[:, idx[0]].astype(np.float32))
        np.testing.assert_array_equal(sta.numpy(),
                                      b[:, idx[1]].astype(np.float32))
    t = torch.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(
        tst._Lanes.wait(lanes.start_download(t)), t.numpy())


# Staging cases over blocks of 6W columns, W the slab copies' least mean
# run width: (block kind, (mobile, static) index arrays, whether each goes
# by slab copies)
W = tst.SLAB_MIN_COLUMNS
N_COLS = 6 * W
STAGING = {
    "one_run": ("float32", (np.arange(5 * W, N_COLS), np.arange(5 * W)),
                (True, True)),
    "several_runs": ("float32", (np.r_[5 * W:N_COLS, 2 * W:3 * W],
                                 np.r_[0:2 * W, 3 * W:5 * W]),
                     (True, True)),
    "interleaved": ("float32", (np.arange(1, N_COLS, 2),
                                np.arange(0, N_COLS, 2)), (False, False)),
    "permuted": ("float32", (np.arange(5 * W, N_COLS),
                             np.random.default_rng(3).permutation(5 * W)),
                 (True, False)),
    "float64": ("float64", (np.arange(5 * W, N_COLS), np.arange(5 * W)),
                (True, True)),
    "short": ("short", (np.arange(5 * W, N_COLS), np.arange(5 * W)),
              (True, True)),
    "strided": ("strided", (np.r_[5 * W:N_COLS, 2 * W:3 * W],
                            np.r_[0:2 * W, 3 * W:5 * W]), (True, True)),
}


def _staging_blocks(kind, rng):
    """Three blocks of 4 frames (3 for ``short``) over ``N_COLS`` columns,
    with a NaN and a negative zero: float32, float64, or a view with
    strided frames and reversed columns (``strided``)."""
    if kind == "strided":
        blocks = [rng.normal(size=(8, N_COLS, 3)).astype(np.float32)[::2, ::-1]
                  for _ in range(3)]
    else:
        shape = (3 if kind == "short" else 4, N_COLS, 3)
        dt = np.float64 if kind == "float64" else np.float32
        blocks = [rng.normal(size=shape).astype(dt) for _ in range(3)]
    blocks[0][0, 0, 0] = np.nan
    blocks[0][1, 1, 1] = -0.0
    return blocks


@pytest.mark.parametrize("case", list(STAGING))
def test_lanes_stage_runs_as_slabs_bit_equal_to_take(case):
    """Staging by runs of consecutive columns (one slab copy a run) or by
    ``np.take`` leaves the slot's buffers and the uploaded frames bit-equal
    to ``np.take`` of the block (``block[:, idx]`` cast to float32 for
    another dtype), and the counter splits the staged bytes by route."""
    kind, columns, slabs = STAGING[case]
    lanes = tst._Lanes(torch.device("cpu"), 2, 4)
    blocks = _staging_blocks(kind, np.random.default_rng(1))
    slab_bytes = take_bytes = 0
    for k, b in enumerate(blocks):
        ups = lanes.upload(b, columns)
        slot = lanes.slots[k % 2]
        for i, (idx, up, slab) in enumerate(zip(columns, ups, slabs)):
            want = (np.take(b, idx, axis=1, mode="clip")
                    if b.dtype == np.float32 else
                    b[:, idx].astype(np.float32))
            staged = slot[i][:len(b)].numpy()
            assert up.dtype == torch.float32
            for got in (up.numpy(), staged):
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
            if slab:
                slab_bytes += want.nbytes
            else:
                take_bytes += want.nbytes
    assert lanes.stage["slab_bytes"] == slab_bytes
    assert lanes.stage["take_bytes"] == take_bytes
    assert lanes.stage["copy_s"] > 0.0
    # the runs are found once an index array
    assert len(lanes.runs) == len({i.tobytes() for i in columns})


def _interleaved(md, seeds):
    """The system with its atoms reordered so that the mobile atoms sit
    among the static ones (each kind keeps its own order), and the map of
    old atom indices to new ones (``traj[:, order]`` is its trajectory)."""
    static, mobile = (np.flatnonzero(md.static_mask),
                      np.flatnonzero(md.mobile_mask))
    key = np.r_[np.arange(len(static)) / len(static),
                (np.arange(len(mobile)) + 0.5) / len(mobile)]
    order = np.r_[static, mobile][np.argsort(key, kind="stable")]
    new = np.empty_like(order)
    new[order] = np.arange(len(order))
    sn = SiteNetwork(md.structure[order], md.static_mask[order],
                     md.mobile_mask[order])
    sn.centers = seeds.centers
    sn.vertices = [new[v] for v in seeds.vertices]
    return sn, order


@pytest.mark.parametrize("depth,name", [(0, "swap"), (2, "plain"),
                                        (2, "swap"), (3, "two_swaps")])
def test_interleaved_atom_order_changes_nothing(md_system, centers,
                                                baselines, tmp_path,
                                                monkeypatch, depth, name):
    """Pass 2 over the same system with its static atoms first and with the
    atoms interleaved (so the upload's mobile columns are no longer runs of
    consecutive columns and stage by ``np.take``) gives the same labels,
    integer tallies, float sums and carry, at every depth.  The system's
    27 static and 4 mobile atoms are narrower than the slab copies' least
    mean run width, which is lowered here so that both routes run."""
    monkeypatch.setattr(tst, "SLAB_MIN_COLUMNS", 4)
    md, seeds = md_system
    traj = _swapped(md, TRAJS[name], 500)
    eng0, want, lab0 = baselines[name]
    sn, order = _interleaved(md, seeds)
    assert not np.array_equal(order, np.arange(len(order)))
    runs = {}
    for tag, system, frames in (("static_first", seeds, traj),
                                ("interleaved", sn, traj[:, order])):
        eng, got, lab = _run(system, frames, centers,
                             tmp_path / f"{tag}.npy", pipeline_depth=depth,
                             dynamic_lattice_mapping=True)
        np.testing.assert_array_equal(lab, lab0, err_msg=tag)
        _assert_identical(got, want)
        np.testing.assert_array_equal(eng.lattice_mapping_,
                                      eng0.lattice_mapping_)
        for k in ("carry_last", "carry_res"):
            np.testing.assert_array_equal(eng.final_state_[k],
                                          eng0.final_state_[k], err_msg=k)
        runs[tag] = eng.run_trace_["stage"]
    if depth:
        assert runs["interleaved"]["take_bytes"] > 0
        if name == "plain":     # static and mobile atoms: a run each
            assert runs["static_first"]["take_bytes"] == 0
            assert runs["static_first"]["slab_bytes"] == 500 * 3 * 4 * 31
    else:   # the synchronous loop stages nothing
        assert runs["interleaved"] == runs["static_first"] == dict(
            slab_bytes=0, take_bytes=0, copy_s=0.0)
