"""Same-process A/B on the card: K1 with the centres padded in f32 and cast
to bf16 on every call (``centers_store_f32=True``, the default) against
the centres rounded to their bf16 operand once and kept
(``centers_store_f32=False``), on the bench basis at ``s_tile=128`` with
the preshift bound (:mod:`~sitator_tpu_torch.tools.bench`'s ``mxu`` step
over 8 blocks of 32 frames).  The product reads the same bf16 values
either way, so labels and confidences are held bit-equal, and the
checksums equal.  Then 6 rounds of timed reps in turn.

Run from the root of a checkout::

    python3 -m sitator_tpu_torch.tools.ab_centers_bf16

The last line is ``RESULT`` and a JSON object.  Exit 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from sitator_tpu_torch.tools import bench, bench_config

VARIANTS = (("f32_centers", True), ("bf16_centers", False))
ROUNDS = 6


def ab(system, device, *, centers=None, blocks=None, rounds=ROUNDS):
    """The A/B on ``system`` (defaults as :func:`ab_s_tile.ab`).  Returns
    the result dict; raises :class:`bench.CheckFailed` when a check
    fails."""
    if blocks is None:
        blocks = bench.bench_blocks(system, device)
    n_sites = len(bench.centers_of(system, centers))
    basis = bench.mxu_basis(system, 128)
    if not basis["preshift"]:
        raise bench.CheckFailed("the preshift bound does not hold on this "
                                "basis")
    got, steps = {}, {}
    for name, store_f32 in VARIANTS:
        assign, _ = bench.mxu_assigner(system, device, centers, basis=basis,
                                       centers_store_f32=store_f32)
        out, total = bench.run_blocks(assign, blocks, n_sites)
        got[name] = (torch.cat([o[0] for o in out]),
                     torch.cat([o[1] for o in out]), total.item())
        steps[name] = (lambda a=assign: bench.run_blocks(a, blocks,
                                                         n_sites)[1])
        print(f"{name}: checksum {got[name][2]}", flush=True)
    (la, ca, sa), (lb, cb, sb) = (got[name] for name, _ in VARIANTS)
    if not (torch.equal(la, lb) and torch.equal(ca, cb)):
        raise bench.CheckFailed(
            f"not bit-equal: {int((la != lb).sum())} labels and "
            f"{int((ca != cb).sum())} confidences differ")
    if sa != sb:
        raise bench.CheckFailed(f"checksums differ: {sa} and {sb}")
    n_frames = sum(len(s) for s, _ in blocks)
    rates, segments = bench.alternate(steps, n_frames, rounds)
    out = {name: bench.summary(rates[name]) for name, _ in VARIANTS}
    out.update(
        speedup_bf16=(out["bf16_centers"]["median"]
                      / out["f32_centers"]["median"]),
        segments=segments, checksum=sa, checksums_equal=True,
        bit_equal=True, assigned=float((la >= 0).float().mean()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.ab_centers_bf16",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    info = bench.tool_device("ab_centers_bf16")
    if info is None:
        return 1
    res = ab(bench_config.build_system(), "cuda")
    print("RESULT " + json.dumps(dict(res, **info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
