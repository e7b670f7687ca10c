"""The comparison that decides ``correct``: what the timed passes produced
against the plain reference on the same frames and centres.

The reference labels every (frame, ion) of the pool; where its margin (the
top similarity's distance from a decision: a second centre, the
threshold) is within ``margin_gate``, either label is right, and the
program's stands.  Over each pass the reference then recounts its own
labels, so gated, in int64, and sums its own confidences and positions in
float64.  Numbers, each held to the limit of the configuration's
``limits``:

- ``labels_off``: (frame, ion) labels of the passes' label memmaps that
  differ from the reference's outside the gate (``labels_gated`` counts a
  pass's labels within it);
- ``stats_off``: entries of any pass's integer tallies (occupancies with
  the unknown slot, ``n_ij``, ``lag_sum``, ``res_sum``, ``res_cnt``, the
  final carry, the multiple-occupancy count) that differ from the
  reference's recount over that pass;
- ``conf_err``: the largest, over passes and sites the reference occupies,
  of the gap between the pass's confidence sum and the reference's, over
  the site's reference count: the mean confidence's error;
- ``center_err_A``: the largest minimum-image distance, over passes and
  occupied sites, between the pass's site centres and those of the
  reference's toroidal sums;
- ``jumps``: the jumps the last pass tallied, at least 1 (the traffic
  hops);
- ``route``: the assignment route the passes took, the configuration's
  (a cell times and judges the kernel its ``why`` names)."""
import numpy as np

_INT_KEYS = ("occ", "n_ij", "lag_sum", "res_sum", "res_cnt")
NUMBERS = ("labels_off", "stats_off", "conf_err", "center_err_A")


def _stats_off(state, ref):
    n = 0
    for k in _INT_KEYS:
        n += int((np.asarray(state[k]) != ref[k]).sum())
    n += int((np.asarray(state["carry_last"]) != ref["carry_last"]).sum())
    n += int((np.asarray(state["carry_res"]) != ref["carry_res"]).sum())
    n += int(int(state.get("mo_viol", 0)) != int(ref["mo_viol"]))
    return n


def _min_image(a, b, cell):
    inv = np.linalg.inv(cell)
    d = (np.asarray(a, np.float64) - b) @ inv
    d = (d - np.round(d)) @ cell
    return np.sqrt((d * d).sum(-1))


def _pass_sums(ref, refmod, want, labels, cell, K):
    """The reference's float64 sums over a pass whose labels are
    ``labels``: its sums over ``want`` (its own labels, cycled), with the
    entries where ``labels`` differ moved to their label."""
    fr, io = np.nonzero(labels != want)
    out = {k: v.copy() for k, v in ref["pass_sums"].items()}
    if len(fr):
        pf = fr % len(ref["labels"])
        conf = ref["conf"][pf, io][None]
        mobile = ref["mobile"][pf, io][None]
        one = np.ones(1)
        old = refmod.sums(want[fr, io][None], conf, mobile, cell, one, K)
        new = refmod.sums(labels[fr, io][None], conf, mobile, cell, one, K)
        for k in out:
            out[k] += new[k] - old[k]
    return out


def numbers(ref, refmod, passes, cell, gate):
    """The compared numbers: ``ref`` holds the reference's ``labels``,
    ``conf``, ``margin`` and ``mobile`` over the pool and ``pass_sums``
    (its sums over a pass of its own labels); ``refmod`` is the reference
    module (``tally``, ``sums``, ``centres_from_sums``); each of
    ``passes`` a pass's ``state`` (the engine's ``final_state_``),
    ``centres`` and ``labels_path`` (its label memmap)."""
    K = int(np.asarray(passes[-1]["state"]["n_ij"]).shape[0])
    P = len(ref["labels"])
    labels_off = gated = stats_off = 0
    conf_err = center_err = 0.0
    last = None
    for p in passes:
        got = np.asarray(np.load(p["labels_path"], mmap_mode="r"))
        order = np.arange(len(got)) % P
        want = ref["labels"][order]
        open_ = ref["margin"][order] > gate
        labels_off += int(((got != want) & open_).sum())
        gated = int((~open_).sum())
        labels = np.where(open_, want, got)
        if last is None or not np.array_equal(labels, last[0]):
            stats = refmod.tally(labels, K)
            sums = _pass_sums(ref, refmod, want, labels, cell, K)
            centres = refmod.centres_from_sums(sums["cos"][:K],
                                               sums["sin"][:K], cell)
            last = (labels, stats, sums, centres)
        _, stats, sums, centres = last
        st = p["state"]
        stats_off += _stats_off(st, stats)
        occ = stats["occ"][:K]
        seen = occ > 0
        gap = np.abs(np.asarray(st["conf"], np.float64)[:K]
                     - sums["conf"][:K])
        conf_err = max(conf_err, float((gap[seen] / occ[seen]).max(
            initial=0.0)))
        dist = _min_image(p["centres"], centres, cell)
        center_err = max(center_err, float(dist[seen].max(initial=0.0)))
    return dict(labels_off=labels_off, labels_gated=gated,
                stats_off=stats_off, conf_err=conf_err,
                center_err_A=center_err,
                jumps=int(np.asarray(passes[-1]["state"]["n_ij"]).sum()),
                ref_jumps=int(stats["n_ij"].sum()),
                ref_unknown=int(stats["occ"][K]))


def checks(nums, limits, route=None, want_route=None):
    """``(correct, [(name, value, op, limit), ...])``: a number with no
    limit set fails; so does a route other than ``want_route``."""
    rows = []
    for name in NUMBERS:
        rows.append((name, nums[name], "<=", limits.get(name)))
    rows.append(("jumps", nums["jumps"], ">=", 1))
    rows.append(("route", route, "==", want_route))
    ok = all(lim is not None and (v <= lim if op == "<=" else
                                  v >= lim if op == ">=" else v == lim)
             for _, v, op, lim in rows)
    return ok, rows
