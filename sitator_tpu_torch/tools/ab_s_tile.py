"""Same-process A/B on the card: K1 at ``s_tile`` 128 against 256 on the
bench basis (:mod:`~sitator_tpu_torch.tools.bench`'s ``mxu`` step: K1,
then the prefix-form jump statistics and the checksum, over 8 blocks of 32
frames), the measurement behind ``choose_s_tile``'s ``{128, 256}``
candidates.  Both tilings must keep the preshift bound.

Held: the labels of the two tilings are equal (the tile order differs, but
labels index centre rows), the confidences agree within 1e-2 (bf16
products summed in another order), and the checksums are equal.  Then 6
rounds of timed reps in turn (128, 256, 128, ...).

Run from the root of a checkout::

    python3 -m sitator_tpu_torch.tools.ab_s_tile

The last line is ``RESULT`` and a JSON object: the medians and spreads of
frames/s, their ratio, and the checks.  Exit 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from sitator_tpu_torch.tools import bench, bench_config

TILES = (128, 256)
ROUNDS = 6


def ab(system, device, *, centers=None, blocks=None, rounds=ROUNDS):
    """The A/B on ``system`` (default centres ``system.centers``, default
    frames :func:`bench.bench_blocks`).  Returns the result dict; raises
    :class:`bench.CheckFailed` when a check fails."""
    if blocks is None:
        blocks = bench.bench_blocks(system, device)
    n_sites = len(bench.centers_of(system, centers))
    got, steps, shape = {}, {}, {}
    for st in TILES:
        assign, basis = bench.mxu_assigner(system, device, centers,
                                           s_tile=st)
        if not basis["preshift"]:
            raise bench.CheckFailed(f"s_tile={st}: the preshift bound does "
                                    "not hold on this basis")
        out, total = bench.run_blocks(assign, blocks, n_sites)
        got[st] = (torch.cat([o[0] for o in out]),
                   torch.cat([o[1] for o in out]), total.item())
        shape[st] = dict(n_st=basis["n_st"], UP=basis["UP"])
        steps[st] = (lambda a=assign: bench.run_blocks(a, blocks,
                                                       n_sites)[1])
        print(f"s_tile={st}: n_st={basis['n_st']} UP={basis['UP']} "
              f"checksum {got[st][2]}", flush=True)
    (la, ca, sa), (lb, cb, sb) = got[TILES[0]], got[TILES[1]]
    if not torch.equal(la, lb):
        raise bench.CheckFailed(f"{int((la != lb).sum())} labels differ "
                                "between the tilings")
    err = float((ca - cb).abs().max())
    if not err <= bench.CONF_TOL[True]:
        raise bench.CheckFailed(f"confidences differ by {err:.3g} between "
                                "the tilings")
    if sa != sb:
        raise bench.CheckFailed(f"checksums differ: {sa} and {sb}")
    n_frames = sum(len(s) for s, _ in blocks)
    rates, segments = bench.alternate(steps, n_frames, rounds)
    out = {f"s_tile_{st}": bench.summary(rates[st]) for st in TILES}
    out.update(
        ratio_256_over_128=(out["s_tile_256"]["median"]
                            / out["s_tile_128"]["median"]),
        segments=segments, tiles=shape, checksum=sa, checksums_equal=True,
        labels_equal=True, max_conf_diff=err,
        assigned=float((la >= 0).float().mean()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.ab_s_tile",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    info = bench.tool_device("ab_s_tile")
    if info is None:
        return 1
    res = ab(bench_config.build_system(), "cuda")
    print("RESULT " + json.dumps(dict(res, **info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
