"""Jump statistics, occupancies and weighted sums of a label sequence, in
NumPy int64 and float64.

For each ion, over frames in order: a frame whose label is known (≥ 0) and
differs from the ion's last known label is a jump from that label to this
one, and closes a residence whose length is the number of known frames
since the last change (or since the first known frame); a frame with the
same label lengthens the residence; an unknown frame (−1) changes nothing.
``n_ij[i, j]`` counts jumps from ``i`` to ``j``, ``lag_sum[i, j]`` sums
the residences they close, ``res_sum[i]`` / ``res_cnt[i]`` sum and count
the residences closed in ``i``; the carry is each ion's last known label
(−1 if none) and the open residence.  ``occ[s]`` counts the (frame, ion)
pairs labelled ``s``, ``occ[K]`` the unknown ones; ``mo_viol`` counts the
(frame, site) pairs holding more than one ion."""
import numpy as np


def tally(labels, K):
    """The statistics of ``labels (F, M)`` from an empty carry."""
    labels = np.asarray(labels)
    F, M = labels.shape
    last = np.full(M, -1, np.int64)
    res = np.zeros(M, np.int64)
    frm, to, closed = [], [], []
    for f in range(F):
        s = labels[f].astype(np.int64)
        known = s >= 0
        have = last >= 0
        jump = known & have & (s != last)
        stay = known & have & (s == last)
        first = known & ~have
        if jump.any():
            frm.append(last[jump])
            to.append(s[jump])
            closed.append(res[jump])
        res = np.where(jump | first, 1, np.where(stay, res + 1, res))
        last = np.where(known, s, last)
    frm = np.concatenate(frm) if frm else np.zeros(0, np.int64)
    to = np.concatenate(to) if to else np.zeros(0, np.int64)
    closed = np.concatenate(closed) if closed else np.zeros(0, np.int64)
    pair = frm * K + to
    known = labels >= 0
    cells = (np.arange(F, dtype=np.int64)[:, None] * K
             + np.where(known, labels, 0))[known]
    per_cell = np.bincount(cells, minlength=F * K)
    return dict(
        occ=np.bincount(np.where(known, labels, K).ravel(),
                        minlength=K + 1).astype(np.int64),
        n_ij=np.bincount(pair, minlength=K * K).reshape(K, K).astype(
            np.int64),
        lag_sum=np.bincount(pair, weights=closed, minlength=K * K).reshape(
            K, K).astype(np.int64),
        res_sum=np.bincount(frm, weights=closed, minlength=K).astype(
            np.int64),
        res_cnt=np.bincount(frm, minlength=K).astype(np.int64),
        carry_last=last, carry_res=res,
        mo_viol=np.int64((per_cell > 1).sum()))


def sums(labels, conf, mobile, cell, mult, K):
    """Float64 per-site sums over frames each taken ``mult[f]`` times:
    ``conf (K + 1)`` of the confidences, ``cos`` / ``sin (K + 1, 3)`` of
    the confidence-weighted cos and sin of 2π times each ion's fractional
    coordinates; unknown labels go to row ``K`` with weight 0."""
    labels = np.asarray(labels)
    known = labels >= 0
    idx = np.where(known, labels, K).ravel()
    w = (np.where(known, np.asarray(conf, np.float64), 0.0)
         * np.asarray(mult, np.float64)[:, None]).ravel()
    theta = (np.asarray(mobile, np.float64).reshape(-1, 3)
             @ np.linalg.inv(np.asarray(cell, np.float64))) * (2 * np.pi)
    out = dict(conf=np.bincount(idx, weights=w, minlength=K + 1))
    for name, fn in (("cos", np.cos), ("sin", np.sin)):
        v = fn(theta) * w[:, None]
        out[name] = np.stack([np.bincount(idx, weights=v[:, c],
                                          minlength=K + 1)
                              for c in range(3)], axis=1)
    return out


def centres_from_sums(cos, sin, cell):
    """Site centres (cartesian) from the toroidal sums: the circular mean
    of each fractional coordinate."""
    frac = (np.arctan2(sin, cos) / (2 * np.pi)) % 1.0
    return frac @ np.asarray(cell, np.float64)
