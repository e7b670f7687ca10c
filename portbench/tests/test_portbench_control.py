"""The control and the faults: each has to come out as not correct.

- The control (``control.py``): the reference, one precision below the
  configuration's similarity operands (float8 e4m3 for bfloat16), in the
  program's place, fails the configuration's limits, where the program
  passes them, on three seeds each.
- A run with the timed path broken underneath reads ``correct`` false: a
  fold that leaves the statistics unchanged, a fold of half of each block,
  an answer (a label) altered where it is produced.  The exchange between
  chips is not a fault these one-chip cells can have."""
import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from _small import SEED, SIZES, WORKLOADS
from portbench.control import run_readings
from portbench.harness import spec
from portbench.harness.judge import NUMBERS
from portbench.harness.cell import run_cell


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_control_fails_where_the_program_passes(workload):
    name = WORKLOADS[workload]
    limits = spec.cell(workload)[2]["limits"]
    lines = []
    s = run_readings(workload, [SEED, SEED + 1, SEED + 2],
                     [SEED, SEED + 1, SEED + 2], "cpu", SIZES[name],
                     emit=lines.append)
    nums = NUMBERS
    assert all(s[f"program_max_{k}"] <= limits[k] for k in nums), s
    ctrl = [json.loads(line) for line in lines if '"control"' in line]
    assert len(ctrl) == 3
    for r in ctrl:
        assert any(r[k] > limits[k] for k in nums), r


def _fold_unchanged(orig):
    def fold(labels, confs, mobile, cell_inv, valid, carry, acc, **kw):
        return carry
    return fold


def _fold_half(orig):
    def fold(labels, confs, mobile, cell_inv, valid, carry, acc, **kw):
        half = torch.arange(len(valid), device=valid.device) < \
            len(valid) // 2
        return orig(labels, confs, mobile, cell_inv, valid & half, carry,
                    acc, **kw)
    return fold


def _answer_altered(orig):
    def assign(*args, **kw):
        labels, confs = orig(*args, **kw)
        labels = labels.clone()
        labels[0, 0] = labels[0, 0] + 1
        return labels, confs
    return assign


FAULTS = {
    "state_unchanged": ("sitator_tpu_torch.landmark.streaming",
                        ["_accum_block"], _fold_unchanged),
    "half_batch": ("sitator_tpu_torch.landmark.streaming",
                   ["_accum_block"], _fold_half),
    "answer_altered": (None, [("sitator_tpu_torch.ops.landmark_mxu",
                               "mxu_assign_blocks"),
                              ("sitator_tpu_torch.ops.landmark_pallas",
                               "fused_assign_blocks")], _answer_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_fault_reads_not_correct(fault, workload, monkeypatch):
    mod_name, targets, make = FAULTS[fault]
    for t in targets:
        mod, fn = (mod_name, t) if mod_name else t
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, fn, make(getattr(m, fn)))
    res, _ = run_cell(workload, SEED, 0.2, False, device="cpu",
                      overrides=SIZES[WORKLOADS[workload]])
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    off = {k: c["value"] for k, c in res["checks"].items()}
    if fault == "answer_altered":
        assert off["labels_off"] > 0
    else:
        assert off["stats_off"] > 0


@pytest.mark.card
def test_cell_on_the_card():
    """One short run of the headline cell through ``run.py`` on a card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sc10k-hop-mem",
         "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and np.isfinite(
        res["metrics"]["pass2_frames_per_s"]["value"])
