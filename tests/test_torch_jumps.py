"""The port's jump statistics against the JAX reference: every tally equal
(the port's tallies are int64; every value must match the reference's)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from sitator_tpu.ops import jumps as jj
from sitator_tpu_torch.ops import jumps as tj

torch.set_num_threads(2)

KEYS = ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts", "last_sites",
        "last_res")


def _labels(seed, F=40, M=6, S=5, p_unknown=0.2, p_stay=0.7):
    """Label runs with -1 gaps: each frame an ion keeps its site with
    probability ``p_stay``, else draws one (or -1)."""
    r = np.random.default_rng(seed)
    traj = np.empty((F, M), np.int32)
    cur = r.integers(0, S, M)
    for f in range(F):
        move = r.random(M) > p_stay
        cur = np.where(move, r.integers(0, S, M), cur)
        traj[f] = np.where(r.random(M) < p_unknown, -1, cur)
    return traj


def _assert_equal(got, want, keys=KEYS):
    for k in keys:
        g = got[k]
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("policy", ["persist", "break"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_scan_matches_reference(policy, with_carry):
    traj = _labels(1)
    S, M = 5, traj.shape[1]
    carry = {}
    if with_carry:
        r = np.random.default_rng(2)
        carry = dict(init_last=r.integers(-1, S, M).astype(np.int32),
                     init_res=r.integers(0, 9, M).astype(np.int32))
    want = jj._jump_stats(jnp.asarray(traj), S,
                          **{k: jnp.asarray(v) for k, v in carry.items()},
                          unknown_policy=policy)
    got = tj._jump_stats(torch.from_numpy(traj), S,
                         **{k: torch.from_numpy(v) for k, v in carry.items()},
                         unknown_policy=policy)
    _assert_equal(got, want)
    assert got["n_ij"].dtype == torch.int64


@pytest.mark.parametrize("policy", ["persist", "break"])
def test_prefix_form_matches_reference(policy):
    traj = _labels(3)
    want = jj._jump_stats_parallel(jnp.asarray(traj), 5,
                                   unknown_policy=policy)
    got = tj._jump_stats_parallel(torch.from_numpy(traj), 5,
                                  unknown_policy=policy)
    _assert_equal(got, want)
    # and the two forms agree with each other from an empty carry
    _assert_equal(tj._jump_stats(torch.from_numpy(traj), 5,
                                 unknown_policy=policy), want)


@pytest.mark.parametrize("policy", ["persist", "break"])
def test_chained_blocks_match_one_scan(policy):
    """Three blocks chained through the carry equal one scan, and each
    block equals the reference's chained block."""
    traj = _labels(4, F=45)
    S, M = 5, traj.shape[1]
    last_t = last_j = None
    res_t = res_j = None
    tot_t = tot_j = None
    for blk in np.split(traj, 3):
        bt = tj._jump_stats(torch.from_numpy(blk), S, last_t, res_t,
                            unknown_policy=policy)
        bj = jj._jump_stats(jnp.asarray(blk), S, last_j, res_j,
                            unknown_policy=policy)
        _assert_equal(bt, bj)
        last_t, res_t = bt["last_sites"], bt["last_res"]
        last_j, res_j = bj["last_sites"], bj["last_res"]
        tot_t = {k: bt[k] for k in KEYS[:5]} if tot_t is None else {
            k: tot_t[k] + bt[k] for k in KEYS[:5]}
        tot_j = {k: np.asarray(bj[k]) for k in KEYS[:5]} if tot_j is None \
            else {k: tot_j[k] + np.asarray(bj[k]) for k in KEYS[:5]}
    _assert_equal(tot_t, tot_j, KEYS[:5])
    whole = tj._jump_stats(torch.from_numpy(traj), S, unknown_policy=policy)
    _assert_equal(tot_t, whole, KEYS[:5])
    _assert_equal(dict(last_sites=last_t, last_res=res_t), whole,
                  KEYS[5:])


@pytest.mark.parametrize("policy", ["persist", "break"])
@pytest.mark.parametrize("block_frames", [None, 7])
def test_jump_stats_exact_matches_reference(policy, block_frames):
    traj = _labels(5, F=50)
    r = np.random.default_rng(6)
    init = dict(init_last=r.integers(-1, 5, 6), init_res=r.integers(0, 4, 6))
    want = jj.jump_stats_exact(traj, 5, unknown_policy=policy,
                               block_frames=block_frames, **init)
    got = tj.jump_stats_exact(traj, 5, unknown_policy=policy,
                              block_frames=block_frames, device="cpu",
                              **init)
    _assert_equal(got, want)
    for k in KEYS[:5]:
        assert got[k].dtype == np.int64


def test_int64_oracle_matches_reference_oracle():
    traj = _labels(7)
    last = np.full(6, -1, np.int64)
    res = np.zeros(6, np.int64)
    for policy in ("persist", "break"):
        want, wl, wr = jj._jump_stats_block_int64(traj, 5, last, res, policy)
        got, gl, gr = tj._jump_stats_block_int64(traj, 5, last, res, policy)
        _assert_equal(got, want, KEYS[:5])
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)


def test_large_carried_residence_is_exact():
    """A residence beyond int32 carried in: the int64 tallies hold it."""
    traj = np.array([[0, 1], [1, 1], [1, 0]], np.int32)
    big = np.array([3_000_000_000, 5], np.int64)
    got = tj.jump_stats_exact(traj, 2, init_last=np.array([0, 1]),
                              init_res=big, device="cpu")
    want, _, res = tj._jump_stats_block_int64(traj, 2, np.array([0, 1]),
                                              big, "persist")
    _assert_equal(got, want, KEYS[:5])
    assert got["lag_sum"][0, 1] == 3_000_000_001
    np.testing.assert_array_equal(got["last_res"], res)


def test_invalid_policy_raises():
    with pytest.raises(ValueError, match="unknown_policy"):
        tj.jump_stats(torch.zeros((2, 2), dtype=torch.int64), 2,
                      unknown_policy="forget")
    with pytest.raises(ValueError, match="unknown_policy"):
        tj._jump_stats_parallel(torch.zeros((2, 2), dtype=torch.int64), 2,
                                unknown_policy="forget")


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(-1, 3), min_size=8 * 4, max_size=8 * 4),
       st.sampled_from(["persist", "break"]))
def test_property_scan_and_prefix_match_reference(flat, policy):
    traj = np.asarray(flat, np.int32).reshape(8, 4)
    want = jj._jump_stats(jnp.asarray(traj), 4, unknown_policy=policy)
    _assert_equal(tj._jump_stats(torch.from_numpy(traj), 4,
                                 unknown_policy=policy), want)
    _assert_equal(tj._jump_stats_parallel(torch.from_numpy(traj), 4,
                                          unknown_policy=policy), want)


@pytest.mark.parametrize("policy", ["persist", "break"])
@pytest.mark.parametrize("seed", [3, 8])
def test_jump_stats_parallel_is_exported_and_equal(policy, seed):
    """The public prefix-form entry point, as the reference exports it: a
    ``JumpStats`` with every tally equal, on both policies."""
    assert sorted(tj.__all__) == sorted(jj.__all__)
    traj = _labels(seed, F=60, M=7)
    want = jj.jump_stats_parallel(jnp.asarray(traj), 5,
                                  unknown_policy=policy)
    got = tj.jump_stats_parallel(torch.from_numpy(traj), 5,
                                 unknown_policy=policy)
    assert isinstance(got, tj.JumpStats)
    _assert_equal(got, want)
    assert got.n_ij.dtype == torch.int64 and int(got.n_ij.sum()) > 0
    # equal to the sequential scan from an empty carry
    _assert_equal(tj.jump_stats(torch.from_numpy(traj), 5,
                                unknown_policy=policy), got)
    with pytest.raises(ValueError, match="unknown_policy"):
        tj.jump_stats_parallel(torch.from_numpy(traj), 5,
                               unknown_policy="forget")
