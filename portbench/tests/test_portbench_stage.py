"""The upload ring's staging counter (the run record's ``stage``) and its
reader ``stage_ms_per_kframe``: on synthetic run records, and the
program's own record of each cell at a small size on the CPU.  Every
cell's index arrays (static atoms, then ions) are one run of columns
each, so at the configurations' sizes they stage as slabs alone."""
import collections

import numpy as np
import pytest
import torch

from _small import SEED, SIZES
from _small_lfp10k import SMALL
from portbench.harness import spec
from portbench.harness.cell import run_cell

CELLS = {"lfp10k-hop-mem": SMALL, "sc10k-hop-mem": SIZES["sc10k"],
         "sc10k-hop-h5": SIZES["sc10k"]}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def records(monkeypatch):
    """A clean process-wide list of the program's run records."""
    from sitator_tpu_torch.util import timing
    q = collections.deque(maxlen=timing.RECENT_RUNS)
    monkeypatch.setattr(timing, "_recent", q)
    return q


def _read():
    return spec.module("metrics", "stage_ms_per_kframe").read({})


def _record(profiled, stage=None, device=None, frames=2048):
    empty = np.zeros(0, np.int64)
    rec = dict(phases=[], spans=dict(phase=empty, block=empty,
                                     start_ns=empty, end_ns=empty),
               device=device, frames=frames, wall_s=1.0, profiled=profiled)
    if stage is not None:
        rec["stage"] = stage
    return rec


def test_reader_on_synthetic_records(records):
    dev = dict(block=np.array([0, 1024]), assign_ms=np.array([30., 32.]),
               fold_ms=np.array([1., 1.]))
    stage = dict(slab_bytes=2 * 125_000_000, take_bytes=0, copy_s=0.03)
    # no records, then a program without the counter (the parent)
    assert _read() is None
    records.extend([_record(False, device=dev), _record(True, device=dev)])
    assert _read() is None
    # the untraced pass's counter: 30 ms over 2048 frames
    records.extend([_record(False, stage, dev),
                    _record(True, dict(stage, copy_s=9.0), dev)])
    assert _read() == pytest.approx(30.0 / 2.048)
    # a CPU device: nothing goes up to a card
    records.extend([_record(False, stage), _record(True, stage)])
    assert _read() is None


@pytest.mark.parametrize("workload", list(CELLS))
def test_every_cell_stages_as_slabs(workload, records):
    from sitator_tpu_torch.landmark.streaming import SLAB_MIN_COLUMNS
    full = spec.cell(workload)[2]
    assert min(full["n_static"], full["n_ions"]) >= SLAB_MIN_COLUMNS
    res, _ = run_cell(workload, SEED, 0.2, False, device="cpu",
                      overrides=CELLS[workload])
    assert res["correct"], res["checks"]
    stage = records[-1]["stage"]
    cfg = spec.cell(workload, CELLS[workload])[2]
    # at the small size an index array narrower than the least mean run
    # width goes by np.take
    widths = (cfg["n_static"], cfg["n_ions"])
    frame_bytes = records[-1]["frames"] * 3 * 4
    assert stage["slab_bytes"] == frame_bytes * sum(
        w for w in widths if w >= SLAB_MIN_COLUMNS)
    assert stage["take_bytes"] == frame_bytes * sum(
        w for w in widths if w < SLAB_MIN_COLUMNS)
    assert stage["slab_bytes"] > 0 and stage["copy_s"] > 0.0
