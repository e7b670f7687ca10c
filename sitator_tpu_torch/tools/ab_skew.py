"""Same-process A/B on the card: K1 against K1s, the skewed kernel that
keeps the landmark vectors on chip (``mxu_assign_blocks(skew=True)``), on
the bench basis at ``s_tile=128`` over ``--blocks`` blocks of ``--frames``
frames, with centres on real sites (:func:`bench.site_centers`: under the
bench's random centres every label is −1 and the labels would hold
nothing).

Held: labels equal wherever the f32 top-2 similarity margin exceeds 8e-3
and the best similarity is not within 1e-2 of the threshold
(:func:`bench.gated`), confidences within 1e-2 (both routes round the
products' operands to bf16 and sum them in their own order); whether the
two are bit-equal is reported.  Then ``--reps`` rounds of timed reps in
turn (K1, K1s, K1, ...); a rep sums ``labels`` and ``1000 · confs``
(truncated) over its blocks.

Run from the root of a checkout::

    python3 -m sitator_tpu_torch.tools.ab_skew [--reps 6] [--blocks 8]
        [--frames 32]

It prints one JSON line.  Exit 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sitator_tpu_torch.tools import bench, bench_config


def _rep(assign, blocks):
    def rep():
        total = None
        for static, mobile in blocks:
            labels, confs = assign(static, mobile)
            part = labels.sum() + (confs * 1000).to(torch.int32).sum()
            total = part if total is None else total + part
        return total
    return rep


def sides(system, device, centers, blocks):
    """K1 (``plain``) and K1s (``skew``) on ``system``'s basis at
    ``s_tile=128`` with ``centers (K, S)`` over ``blocks``
    (:func:`bench.device_blocks`): ``{name: (labels, confs)}`` as NumPy
    ``(F, M)`` arrays, and ``{name: rep}`` for :func:`bench.alternate`."""
    basis = bench.mxu_basis(system, 128)
    steps, got = {}, {}
    for name, skew in (("plain", False), ("skew", True)):
        assign, _ = bench.mxu_assigner(system, device, centers, basis=basis,
                                       skew=skew)
        out = [assign(static, mobile) for static, mobile in blocks]
        got[name] = (torch.cat([o[0] for o in out]).cpu().numpy(),
                     torch.cat([o[1] for o in out]).cpu().numpy())
        steps[name] = _rep(assign, blocks)
    return got, steps


def ab(system, device, *, centers, blocks, reps=6):
    """The A/B of :func:`sides`.  Returns the result dict; raises
    :class:`bench.CheckFailed` when a check fails."""
    got, steps = sides(system, device, centers, blocks)
    margin, top1 = bench.top2_margin(system, blocks, centers)
    (la, ca), (lb, cb) = got["plain"], got["skew"]
    gate = bench.gated(margin, top1)
    bad = np.argwhere((la != lb) & ~gate)
    if len(bad):
        raise bench.CheckFailed(f"{len(bad)} labels differ outside the "
                                f"margin gate (first at {bad[0].tolist()})")
    err = float(np.abs(ca - cb).max())
    if not (np.isfinite(cb).all() and err <= bench.CONF_TOL[True]):
        raise bench.CheckFailed(f"confidences differ by {err:.3g}")
    bit_equal = bool(np.array_equal(la, lb)
                     and np.array_equal(ca.view(np.int32),
                                        cb.view(np.int32)))
    n_frames = sum(len(s) for s, _ in blocks)
    rates, segments = bench.alternate(steps, n_frames, reps)
    med = {k: float(np.median(v)) for k, v in rates.items()}
    return {
        "metric": "mxu_kernel_skew_ab",
        "segments": segments,
        "plain_fps": med["plain"],
        "skew_fps": med["skew"],
        "ratio": med["skew"] / med["plain"],
        "bitwise_equal": bit_equal,
        "labels_compared": int((~gate).sum()),
        "labels_gated": int(gate.sum()),
        "labels_differ_in_gate": int((la != lb).sum()),
        "max_conf_diff": err,
        "assigned": float((la >= 0).mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.ab_skew",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6,
                    help="alternating timed segments per variant")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args(argv)
    info = bench.tool_device("ab_skew")
    if info is None:
        return 1
    system = bench_config.build_system()
    blocks = bench.bench_blocks(system, "cuda", args.blocks, args.frames)
    res = ab(system, "cuda", reps=args.reps, blocks=blocks,
             centers=bench.site_centers(system, "cuda"))
    print(json.dumps(dict(res, **info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
