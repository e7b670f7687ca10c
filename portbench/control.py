"""The readings the correctness limits are set from, at a cell's own size:
the program's numbers over many seeds, and the control's over a few.

    python3 portbench/control.py --workload <name> --seeds <n> ...
        [--control-seeds <n> ...] [--out FILE]

For each of ``--seeds`` the program runs one pass of the cell through its
timed path (the engine over the cell's traffic) and is compared with the
reference, as a run's check does.  For each of ``--control-seeds`` the
control takes the program's place: the reference itself with the
similarity operands one precision below the configuration's (float8 e4m3
for bfloat16), its labels tallied by the reference's own recount, compared
the same way.  One JSON line a reading, then a summary: the largest
program reading and the smallest control reading of each number.  Needs a
card; ``run_readings`` takes ``device="cpu"`` for the tests.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the nearest precision below the configuration's similarity operands
LOWER = {"bfloat16": "float8_e4m3fn"}


def program_reading(cfg, traffic, data, ref, device):
    """The program's numbers on one seed: one pass of the timed path."""
    from portbench.harness import cell, sources, system
    workdir = tempfile.mkdtemp(prefix="portbench-")
    close = None
    try:
        source, close = sources.open_source(traffic, data["pool"], workdir)
        engine = cell.make_engine(cfg, device)
        p = cell.one_pass(engine, system.site_network(data),
                          sources.Cycled(source, cfg["n_frames"]),
                          data["centres"],
                          os.path.join(workdir, "labels.npy"))
        del engine
        nums, _ = cell.judged(cfg, ref, [p], data["geo"]["cell"])
        nums["route"] = p["route"]
        return nums
    finally:
        if close is not None:
            close()
        shutil.rmtree(workdir, ignore_errors=True)


def control_reading(cfg, data, ref, device):
    """The control's numbers on one seed: the reference one precision
    below the configuration's, in the program's place."""
    import numpy as np
    from portbench.harness import cell, spec
    refmod = spec.module("reference", cfg["reference"])
    low = cell.reference(cfg, data, device, operand=LOWER[
        cfg["precision"]["similarity_operands"]])
    F, P, K = int(cfg["n_frames"]), len(data["pool"]), int(cfg["n_centres"])
    labels = low["labels"][np.arange(F) % P]
    sums = low["pass_sums"]
    cell_ = np.asarray(data["geo"]["cell"], np.float64)
    state = dict(refmod.tally(labels, K), conf=sums["conf"])
    centres = refmod.centres_from_sums(sums["cos"][:K], sums["sin"][:K],
                                       cell_)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        labels_path = os.path.join(workdir, "labels.npy")
        np.save(labels_path, labels)
        nums, _ = cell.judged(cfg, ref, [dict(state=state, centres=centres,
                                              labels_path=labels_path)],
                              cell_)
        return nums
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_readings(workload, seeds, control_seeds, device, overrides=None,
                 emit=print):
    """Every reading, emitted as JSON lines; returns the summary."""
    import torch
    from portbench.harness import cell, spec, system
    from portbench.harness.judge import NUMBERS
    _, _, cfg, traffic = spec.cell(workload, overrides)
    dev = torch.device(device)
    prog, ctrl = [], []
    for seed in list(dict.fromkeys(list(seeds) + list(control_seeds))):
        data = system.make(cfg, traffic, seed, dev)
        ref = cell.reference(cfg, data, dev)
        if seed in seeds:
            r = program_reading(cfg, traffic, data, ref, dev)
            prog.append(r)
            emit(json.dumps(dict(side="program", seed=seed, **r)))
        if seed in control_seeds:
            r = control_reading(cfg, data, ref, dev)
            ctrl.append(r)
            emit(json.dumps(dict(side="control", seed=seed, **r)))
    summary = dict(workload=workload, n_program=len(prog),
                   n_control=len(ctrl))
    for k in NUMBERS:
        if prog:
            summary[f"program_max_{k}"] = max(r[k] for r in prog)
        if ctrl:
            summary[f"control_min_{k}"] = min(r[k] for r in ctrl)
    emit(json.dumps(dict(side="summary", **summary)))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        run_readings(args.workload, args.seeds, args.control_seeds, "cuda",
                     emit=emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
