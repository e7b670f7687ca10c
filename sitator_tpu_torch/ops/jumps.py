"""Jump statistics (counterpart of ``sitator_tpu.ops.jumps``).

The per-ion "last known site" carry runs over the frames of a ``(F, M)``
label block with vectorised per-ion state, and every per-event tally (hop
counts ``n_ij``, residence sums, jump-lag sums) is a scatter-add into dense
``(S+1, S+1)`` accumulators (slot ``S`` is the dummy for non-events).  The
tallies are int64, so no block bound or wrap guard is needed; every value
equals the reference's int64 oracle (:func:`_jump_stats_block_int64`).

Unknown frames (``-1``) follow ``unknown_policy``: 'persist' (default —
an ion's previous site persists across unknown gaps, and unknown frames
neither emit jumps nor advance residence) or 'break' (an unknown frame
forgets the previous site; the next assignment starts a fresh residence).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["jump_stats", "jump_stats_exact", "jump_stats_parallel",
           "JumpStats"]


class JumpStats(dict):
    """n_ij (S,S), lag_sum (S,S), res_sum (S,), res_cnt (S,), occ_counts (S,),
    last_sites (M,), last_res (M,)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _check_policy(unknown_policy):
    if unknown_policy not in ("persist", "break"):
        raise ValueError("unknown_policy must be 'persist' or 'break'")


def _occupancy(traj, S):
    occ = torch.zeros(S + 1, dtype=torch.int64, device=traj.device)
    return occ.index_put_((torch.where(traj >= 0, traj, S).reshape(-1),),
                          torch.ones(traj.numel(), dtype=torch.int64,
                                     device=traj.device), accumulate=True)


def _tally(S, i_from, i_to, one, resv, device):
    n_ij = torch.zeros((S + 1, S + 1), dtype=torch.int64, device=device)
    lag = torch.zeros_like(n_ij)
    res_sum = torch.zeros(S + 1, dtype=torch.int64, device=device)
    res_cnt = torch.zeros_like(res_sum)
    n_ij.index_put_((i_from, i_to), one, accumulate=True)
    lag.index_put_((i_from, i_to), resv, accumulate=True)
    res_sum.index_put_((i_from,), resv, accumulate=True)
    res_cnt.index_put_((i_from,), one, accumulate=True)
    return n_ij, lag, res_sum, res_cnt


def jump_stats(traj, n_sites, init_last=None, init_res=None,
               unknown_policy="persist"):
    """Scan a ``(F, M)`` site trajectory (integer tensor) into dense jump
    statistics; ``init_last``/``init_res`` chain blocks.  Returns a
    :class:`JumpStats` of tensors over the true site indices."""
    return JumpStats(_jump_stats(traj, n_sites, init_last, init_res,
                                 unknown_policy=unknown_policy))


def _jump_stats(traj, n_sites, init_last=None, init_res=None,
                unknown_policy="persist"):
    """The sequential form: a loop over frames carrying ``(last, res)``."""
    _check_policy(unknown_policy)
    traj = traj.to(torch.int64)
    F, M = traj.shape
    S = n_sites
    dev = traj.device
    last = (torch.full((M,), -1, dtype=torch.int64, device=dev)
            if init_last is None
            else torch.as_tensor(init_last, device=dev).to(torch.int64))
    res = (torch.zeros(M, dtype=torch.int64, device=dev) if init_res is None
           else torch.as_tensor(init_res, device=dev).to(torch.int64))
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    rows_from, rows_to, rows_one, rows_res = [empty], [empty], [empty], [empty]
    for f in range(F):
        s_f = traj[f]
        known = s_f >= 0
        have_last = last >= 0
        jump = known & have_last & (s_f != last)
        stay = known & have_last & (s_f == last)
        first = known & ~have_last
        rows_from.append(torch.where(jump, last, S))
        rows_to.append(torch.where(jump, s_f, S))
        rows_one.append(jump.to(torch.int64))
        rows_res.append(torch.where(jump, res, 0))
        res = torch.where(jump | first, 1, torch.where(stay, res + 1, res))
        if unknown_policy == "break":
            last = torch.where(known, s_f, -1)
            res = torch.where(known, res, 0)  # carry is void after a gap
        else:
            last = torch.where(known, s_f, last)
    n_ij, lag, res_sum, res_cnt = _tally(
        S, torch.cat(rows_from), torch.cat(rows_to), torch.cat(rows_one),
        torch.cat(rows_res), dev)
    occ = _occupancy(traj, S)
    return dict(n_ij=n_ij[:S, :S], lag_sum=lag[:S, :S], res_sum=res_sum[:S],
                res_cnt=res_cnt[:S], occ_counts=occ[:S], last_sites=last,
                last_res=res)


def _jump_stats_block_int64(traj, S, last, res, unknown_policy):
    """Pure-NumPy int64 scan over one frame block — the oracle every device
    tally is held to.  Returns (stats, last, res)."""
    F, M = traj.shape
    n_ij = np.zeros((S + 1, S + 1), np.int64)
    lag = np.zeros((S + 1, S + 1), np.int64)
    res_sum = np.zeros(S + 1, np.int64)
    res_cnt = np.zeros(S + 1, np.int64)
    occ = np.zeros(S + 1, np.int64)
    one = np.ones(M, np.int64)
    for f in range(F):
        s_f = traj[f].astype(np.int64)
        known = s_f >= 0
        have = last >= 0
        jump = known & have & (s_f != last)
        stay = known & have & (s_f == last)
        first = known & ~have
        i_from = np.where(jump, last, S)
        i_to = np.where(jump, s_f, S)
        jv = jump.astype(np.int64)
        np.add.at(n_ij, (i_from, i_to), jv)
        np.add.at(lag, (i_from, i_to), np.where(jump, res, 0))
        np.add.at(res_sum, i_from, np.where(jump, res, 0))
        np.add.at(res_cnt, i_from, jv)
        np.add.at(occ, np.where(known, s_f, S), one)
        res = np.where(jump | first, 1, np.where(stay, res + 1, res))
        if unknown_policy == "break":
            last = np.where(known, s_f, -1)
            res = np.where(known, res, 0)
        else:
            last = np.where(known, s_f, last)
    return dict(n_ij=n_ij[:S, :S], lag_sum=lag[:S, :S],
                res_sum=res_sum[:S], res_cnt=res_cnt[:S],
                occ_counts=occ[:S]), last, res


def jump_stats_exact(traj, n_sites, init_last=None, init_res=None,
                     unknown_policy="persist", block_frames=None,
                     device="cuda"):
    """:func:`jump_stats` over a host ``(F, M)`` label array, in frame blocks
    of ``block_frames`` (bounding device memory) chained through the
    ``(last, res)`` carry.  Returns NumPy int64 statistics; ``last_sites``
    int32 and ``last_res`` int64 from the final carry."""
    traj = np.asarray(traj)
    F, M = traj.shape
    S = n_sites
    if block_frames is None:
        block_frames = max(1, (1 << 26) // max(1, M))
    last = (np.full((M,), -1, np.int64) if init_last is None
            else np.asarray(init_last).astype(np.int64))
    res = (np.zeros((M,), np.int64) if init_res is None
           else np.asarray(init_res).astype(np.int64))
    host = dict(n_ij=np.zeros((S, S), np.int64),
                lag_sum=np.zeros((S, S), np.int64),
                res_sum=np.zeros(S, np.int64),
                res_cnt=np.zeros(S, np.int64),
                occ_counts=np.zeros(S, np.int64))
    for lo in range(0, F, block_frames):
        blk = _jump_stats(torch.from_numpy(traj[lo:lo + block_frames]).to(
            device), S, init_last=torch.from_numpy(last).to(device),
            init_res=torch.from_numpy(res).to(device),
            unknown_policy=unknown_policy)
        last = blk.pop("last_sites").cpu().numpy()
        res = blk.pop("last_res").cpu().numpy()
        for k, v in blk.items():
            host[k] += v.cpu().numpy()
    host["last_sites"] = last.astype(np.int32)
    host["last_res"] = res
    return JumpStats(host)


def _shift_down(x, fill):
    """``x`` moved one frame later along axis 0, ``fill`` in frame 0."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]], dim=0)


def jump_stats_parallel(traj, n_sites, unknown_policy="persist"):
    """Order-dependent jump statistics of a ``(F, M)`` integer label tensor
    WITHOUT a sequential frame scan: the "last known site" carry is
    re-expressed as prefix operations (forward fill, ``cumsum``,
    ``cummax``).  Returns the same :class:`JumpStats` as :func:`jump_stats`
    from an empty carry, with equal statistics for either
    ``unknown_policy``."""
    return JumpStats(_jump_stats_parallel(traj, n_sites,
                                          unknown_policy=unknown_policy))


def _jump_stats_parallel(traj, n_sites, unknown_policy="persist"):
    """The prefix form: forward fill of known sites, running known-frame
    count ``K`` (cumsum) and, at each run start, ``K`` just before it —
    nondecreasing, so its forward fill is a cummax.  The residence closed by
    a jump at frame ``f`` is ``K[f-1] - cummax_start_K[f-1]``."""
    _check_policy(unknown_policy)
    traj = traj.to(torch.int64)
    F, M = traj.shape
    S = n_sites
    dev = traj.device
    known = traj >= 0
    occ = _occupancy(traj, S)

    if unknown_policy == "break":
        # a jump needs two consecutive known frames; a run ends at any
        # unknown frame or site change
        prev_raw = _shift_down(traj, -1)
        jump = known & (prev_raw >= 0) & (traj != prev_raw)
        start = known & ((prev_raw < 0) | (traj != prev_raw))
        idx = torch.arange(F, device=dev)[:, None].expand(F, M)
        run_base = torch.where(start, idx, -1).cummax(dim=0).values
        prev_base = _shift_down(run_base, -1)
        res = (idx - 1) - prev_base + 1
        n_ij, lag, res_sum, res_cnt = _tally(
            S, torch.where(jump, prev_raw, S).reshape(-1),
            torch.where(jump, traj, S).reshape(-1),
            jump.to(torch.int64).reshape(-1),
            torch.where(jump, res, 0).reshape(-1), dev)
        last_known = known[-1]
        return dict(n_ij=n_ij[:S, :S], lag_sum=lag[:S, :S],
                    res_sum=res_sum[:S], res_cnt=res_cnt[:S],
                    occ_counts=occ[:S],
                    last_sites=torch.where(last_known, traj[-1], -1),
                    last_res=torch.where(last_known,
                                         (F - 1) - run_base[-1] + 1, 0))

    # forward fill of known sites: the site at the latest known frame
    fidx = torch.where(known, torch.arange(F, device=dev)[:, None], -1)
    fidx = fidx.cummax(dim=0).values
    filled = torch.where(fidx >= 0,
                         traj.gather(0, fidx.clamp_min(0)), -1)
    K = known.to(torch.int64).cumsum(dim=0)                  # inclusive
    prev = _shift_down(filled, -1)
    start = known & (filled != prev)
    run_base = torch.where(start, K - 1, -1).cummax(dim=0).values
    prev_base = _shift_down(run_base, -1)
    prev_K = _shift_down(K, 0)
    jump = (filled != prev) & (prev >= 0)
    res = prev_K - prev_base                                 # valid at jumps
    n_ij, lag, res_sum, res_cnt = _tally(
        S, torch.where(jump, prev, S).reshape(-1),
        torch.where(jump, filled, S).reshape(-1),
        jump.to(torch.int64).reshape(-1),
        torch.where(jump, res, 0).reshape(-1), dev)
    return dict(n_ij=n_ij[:S, :S], lag_sum=lag[:S, :S], res_sum=res_sum[:S],
                res_cnt=res_cnt[:S], occ_counts=occ[:S],
                last_sites=filled[-1],
                last_res=torch.where(filled[-1] >= 0, K[-1] - run_base[-1],
                                     0))
