"""The carried jump scan as the streaming engine folds it
(``ops/jumps.py::jump_fold``, ``landmark/streaming.py::_accum_block``) on
CPU tensors, held to the int64 oracle ``_jump_stats_block_int64``: chained
blocks of uneven length, partial folds, blocks that start inside an unknown
gap, both unknown-frame policies, the carry left unwritten, the engine's
snapshot and restore, and the plain route taken (no kernel launch)."""
import numpy as np
import pytest
import torch

import sitator_tpu_torch as port
from sitator_tpu_torch.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu_torch.landmark import streaming as tst
from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.ops import jumps as tj
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

from tests._torch_common import first_math_calls_on_one_thread

torch.set_num_threads(2)

first_math_calls_on_one_thread()

S, M = 7, 9
TALLIES = ("n_ij", "lag_sum", "res_sum", "res_cnt")
BLOCKS = (37, 64, 5, 1, 50)          # uneven lengths, chained


def _labels(seed, F, p_unknown=0.15, p_stay=0.8):
    """Label runs with -1 frames, and an unknown gap of every ion across
    each block boundary of :data:`BLOCKS` (so blocks start inside one)."""
    r = np.random.default_rng(seed)
    traj = np.empty((F, M), np.int32)
    cur = r.integers(0, S, M)
    for f in range(F):
        move = r.random(M) > p_stay
        cur = np.where(move, r.integers(0, S, M), cur)
        traj[f] = np.where(r.random(M) < p_unknown, -1, cur)
    for cut in np.cumsum(BLOCKS)[:-1]:
        gap = r.random(M) < 0.5
        traj[max(0, cut - 2):cut + 3, gap] = -1
    return traj


def _carry(seed):
    r = np.random.default_rng(seed + 100)
    last = r.integers(-1, S, M).astype(np.int64)
    res = np.where(last >= 0, r.integers(1, 9, M), 0).astype(np.int64)
    return last, res


def _cuts(seed, n):
    """A block of ``n`` frames split into 1–3 consecutive folds [a, b)."""
    r = np.random.default_rng(seed + n)
    inner = sorted(set(r.integers(1, n, r.integers(0, 3)).tolist())) \
        if n > 1 else []
    edges = [0, *inner, n]
    return list(zip(edges[:-1], edges[1:]))


def _tallies():
    return tuple(torch.zeros((S, S) if k in ("n_ij", "lag_sum") else S,
                             dtype=torch.int64) for k in TALLIES)


def _assert_state(tallies, carry, want, last, res, occ=None):
    for k, t in zip(TALLIES, tallies):
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(carry[0].numpy(), last, err_msg="last")
    np.testing.assert_array_equal(carry[1].numpy(), res, err_msg="res")
    if occ is not None:
        np.testing.assert_array_equal(occ, want["occ_counts"],
                                      err_msg="occ")


@pytest.mark.parametrize("policy", ["persist", "break"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jump_fold_chained_partial_blocks_match_int64_scan(policy, seed):
    F = sum(BLOCKS)
    traj = _labels(seed, F)
    last0, res0 = _carry(seed)
    want, last, res = tj._jump_stats_block_int64(traj, S, last0, res0,
                                                 policy)
    tallies = _tallies()
    carry = (torch.from_numpy(last0), torch.from_numpy(res0))
    lo = 0
    for n in BLOCKS:
        for a, b in _cuts(seed, n):
            carry = tj.jump_fold(torch.from_numpy(traj[lo + a:lo + b]), S,
                                 carry, tallies, unknown_policy=policy)
        lo += n
    _assert_state(tallies, carry, want, last, res)


def _accum_inputs(traj_block, seed):
    r = np.random.default_rng(seed)
    n = len(traj_block)
    confs = torch.from_numpy(r.random((n, M)).astype(np.float32))
    mobile = torch.from_numpy(r.random((n, M, 3)).astype(np.float32) * 8)
    return torch.from_numpy(traj_block), confs, mobile


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accum_block_chained_partial_folds_match_int64_scan(seed):
    """The engine's fold (policy 'persist', frames outside ``valid`` made
    unknown) over chained blocks in partial folds: every tally, the
    occupancy (counted once, by the per-site sums) and the carry."""
    F = sum(BLOCKS)
    traj = _labels(seed, F)
    last0, res0 = _carry(seed)
    want, last, res = tj._jump_stats_block_int64(traj, S, last0, res0,
                                                 "persist")
    acc = tst._zero_accumulators(S)
    cell_inv = torch.eye(3) / 8.0
    carry = (torch.from_numpy(last0), torch.from_numpy(res0))
    lo = 0
    for n in BLOCKS:
        labels, confs, mobile = _accum_inputs(traj[lo:lo + n], seed + lo)
        ids = torch.arange(n)
        for a, b in _cuts(seed, n):
            carry = tst._accum_block(labels, confs, mobile, cell_inv,
                                     (ids >= a) & (ids < b), carry, acc,
                                     n_sites=S)
        lo += n
    _assert_state(tuple(acc[k] for k in TALLIES), carry, want, last, res,
                  acc["occ"][:S].numpy())
    assert int(acc["occ"][S]) == int((traj < 0).sum()) + sum(
        (len(_cuts(seed, n)) - 1) * n * M for n in BLOCKS)


@pytest.mark.parametrize("policy", ["persist", "break"])
def test_fold_leaves_the_input_carry_unchanged(policy):
    traj = _labels(5, 40)
    last0, res0 = _carry(5)
    carry = (torch.from_numpy(last0.copy()), torch.from_numpy(res0.copy()))
    new = tj.jump_fold(torch.from_numpy(traj), S, carry, _tallies(),
                       unknown_policy=policy)
    np.testing.assert_array_equal(carry[0].numpy(), last0)
    np.testing.assert_array_equal(carry[1].numpy(), res0)
    _, last, res = tj._jump_stats_block_int64(traj, S, last0, res0, policy)
    np.testing.assert_array_equal(new[0].numpy(), last)
    np.testing.assert_array_equal(new[1].numpy(), res)


@pytest.mark.parametrize("max_mobile", [None, 1])
def test_snapshot_and_restore_give_back_the_state_before_the_fold(
        max_mobile):
    """The run-ahead's rollback: ``(carry, _snapshot(acc))`` taken before a
    fold restores the state before it, and folding again from it gives the
    first fold's state."""
    traj = _labels(6, 30)
    last0, res0 = _carry(6)
    acc = tst._zero_accumulators(S, max_mobile)
    labels, confs, mobile = _accum_inputs(traj, 6)
    valid = torch.ones(len(traj), dtype=torch.bool)
    cell_inv = torch.eye(3) / 8.0
    kw = dict(n_sites=S, max_mobile=max_mobile)
    carry = tst._accum_block(labels[:10], confs[:10], mobile[:10], cell_inv,
                             valid[:10], (torch.from_numpy(last0),
                                          torch.from_numpy(res0)), acc, **kw)
    before = {k: v.clone() for k, v in acc.items()}
    before_carry = tuple(c.clone() for c in carry)
    snap = (carry, tst._snapshot(acc))
    new = tst._accum_block(labels, confs, mobile, cell_inv, valid, carry,
                           acc, **kw)
    assert int(acc["n_ij"].sum()) > int(before["n_ij"].sum())
    after = {k: v.clone() for k, v in acc.items()}
    carry, acc = snap
    for k, v in before.items():
        assert torch.equal(acc[k], v), k
    for c, b in zip(carry, before_carry):
        assert torch.equal(c, b)
    again = tst._accum_block(labels, confs, mobile, cell_inv, valid, carry,
                             acc, **kw)
    for k, v in after.items():
        assert torch.equal(acc[k], v), k
    for c, b in zip(again, new):
        assert torch.equal(c, b)


@pytest.mark.parametrize("how", ["jump_fold", "jump_stats", "accum_block",
                                 "jump_stats_exact"])
def test_cpu_tensors_take_the_plain_route(how):
    """CPU tensors run the frame loop: the kernel's launch count stays 0,
    and the result is the oracle's."""
    traj = _labels(7, 45)
    last0, res0 = _carry(7)
    want, last, res = tj._jump_stats_block_int64(traj, S, last0, res0,
                                                 "persist")
    n0 = tj.jump_fold.launches
    t = torch.from_numpy(traj)
    carry = (torch.from_numpy(last0), torch.from_numpy(res0))
    if how == "jump_fold":
        tallies = _tallies()
        carry = tj.jump_fold(t, S, carry, tallies)
        got = dict(zip(TALLIES, tallies))
    elif how == "accum_block":
        acc = tst._zero_accumulators(S)
        _, confs, mobile = _accum_inputs(traj, 7)
        carry = tst._accum_block(t, confs, mobile, torch.eye(3),
                                 torch.ones(len(traj), dtype=torch.bool),
                                 carry, acc, n_sites=S)
        got = acc
    else:
        fn = tj.jump_stats if how == "jump_stats" else tj.jump_stats_exact
        kw = dict(device="cpu", block_frames=8) if how != "jump_stats" \
            else {}
        st = fn(traj if kw else t, S, init_last=last0, init_res=res0, **kw)
        got = {k: torch.as_tensor(np.asarray(st[k])) for k in TALLIES}
        carry = tuple(torch.as_tensor(np.asarray(st[k])).to(torch.int64)
                      for k in ("last_sites", "last_res"))
    _assert_state(tuple(got[k] for k in TALLIES), carry, want, last, res)
    assert tj.jump_fold.launches == n0
    assert sum(tj.jump_fold.launches_by_card.values()) == n0


def test_the_launcher_refuses_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; the wrapper routes
    CPU tensors to the plain version before it."""
    t = torch.zeros((4, M), dtype=torch.int32)
    last, res = torch.full((M,), -1, dtype=torch.int64), \
        torch.zeros(M, dtype=torch.int64)
    with pytest.raises(ValueError, match="a CUDA tensor is needed"):
        _cuda.jump_fold(t, last, res, *_tallies(), unknown_policy="persist")


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=300,
                                 jump_rate=0.05, seed=11)
    sn0 = port.SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False)
    centers = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=64, **kw).fit_centers(
        seeds, ArrayTrajectory(md.traj))
    return md, seeds, centers, kw


@pytest.mark.parametrize("depth", [2, 0])
def test_run_record_counts_the_folds_and_jumps(md_system, tmp_path, depth):
    md, seeds, centers, kw = md_system
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=64, pipeline_depth=depth,
        store_labels=str(tmp_path / "l.npy"), **kw)
    out = eng.run(seeds, md.traj, centers=centers)
    labels = np.load(tmp_path / "l.npy")
    K = len(centers)
    want, _, _ = tj._jump_stats_block_int64(
        labels, K, np.full(labels.shape[1], -1, np.int64),
        np.zeros(labels.shape[1], np.int64), "persist")
    assert eng.run_trace_["fold"] == dict(launches=0,
                                          jumps=int(want["n_ij"].sum()))
    assert int(want["n_ij"].sum()) > 0
    np.testing.assert_array_equal(out.n_ij, want["n_ij"])
