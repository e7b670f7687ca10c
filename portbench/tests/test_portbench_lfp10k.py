"""The ``lfp10k-hop-mem`` cell (olivine Li0.6FePO4 on the gather route, K3)
at a small size on the CPU, and the readers of the landmark stage's
metrics (``lv_span_ms_per_kframe``, ``lv_roofline_pct``) on synthetic run
records and traces."""
import collections
import json

import numpy as np
import pytest
import torch

from _small import SEED, SIZES
from _small_lfp10k import SMALL
from portbench.control import run_readings
from portbench.harness import roofline, spec
from portbench.harness.cell import run_cell
from portbench.harness.judge import NUMBERS

WORKLOAD = "lfp10k-hop-mem"
SC_SMALL = SIZES["sc10k"]
NEW = ("lv_span_ms_per_kframe", "lv_roofline_pct")


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


def _metric(name):
    return spec.module("metrics", name)


@pytest.mark.parametrize("trace_on", [False, True])
def test_cell_end_to_end(trace_on, records):
    res, lines = run_cell(WORKLOAD, SEED, 0.3, trace_on, device="cpu",
                          overrides=SMALL)
    assert res["correct"], res["checks"]
    assert res["route"] == "gather"
    assert res["checks"]["jumps"]["value"] >= 1
    bench = spec.benchmark()
    if trace_on:
        # a CPU trace has no device operations and no device brackets:
        # the cell's per-layer metrics all read nothing
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {m["name"]
                                       for m in bench["end_to_end"]}
    assert records[-1]["gate"]["route"] == "gather"
    assert records[-1]["gate"]["cost_ratio"] > 0.75
    assert "lv_ms" not in (records[-1]["device"] or {})
    assert any(line.startswith("# jumps tallied") for line in lines)


def test_sc10k_records_the_gate_taking_k1(records):
    res, _ = run_cell("sc10k-hop-mem", SEED, 0.2, False, device="cpu",
                      overrides=SC_SMALL)
    assert res["correct"] and res["route"] == "mxu"
    gate = records[-1]["gate"]
    assert gate["route"] == "mxu" and gate["cost_ratio"] <= 0.75


def test_control_fails_where_the_program_passes():
    limits = spec.cell(WORKLOAD)[2]["limits"]
    lines = []
    seeds = [SEED, SEED + 1, SEED + 2]
    s = run_readings(WORKLOAD, seeds, seeds, "cpu", SMALL,
                     emit=lines.append)
    assert all(s[f"program_max_{k}"] <= limits[k] for k in NUMBERS), s
    ctrl = [json.loads(line) for line in lines if '"control"' in line]
    assert len(ctrl) == 3
    for r in ctrl:
        assert any(r[k] > limits[k] for k in NUMBERS), r


def _record(profiled, device=None, gate=None, frames=2048):
    empty = np.zeros(0, np.int64)
    return dict(phases=[], spans=dict(phase=empty, block=empty,
                                      start_ns=empty, end_ns=empty),
                device=device, gate=gate, frames=frames, wall_s=1.0,
                profiled=profiled)


def _trace(ops):
    return dict(ops=ops, window_ns=(0, 10**9))


def test_readers_on_synthetic_records(records):
    cfg = spec.cell(WORKLOAD)[2]
    pk = roofline.PEAKS["H100"]
    dev = dict(block=np.array([0, 1024]), assign_ms=np.array([30., 32.]),
               fold_ms=np.array([1., 1.]), lv_ms=np.array([20., 22.]))
    gate = dict(route="gather", cost_ratio=0.9)
    records.extend([_record(False, device=dev, gate=gate),
                    _record(True, gate=gate)])
    # lv_gather 4 ms + 6 ms in the assignment span; a K1 kernel, an
    # lv_gather launched outside the span and a copy do not count
    ops = [("(anonymous namespace)::lv_gather_kernel<true, false, true, "
            "true>(float const*)", "kernel", 0, 4_000_000, "assign", None),
           ("lv_gather_kernel", "kernel", 5_000_000, 11_000_000, "assign",
            None),
           ("lv_gather_kernel_v2", "kernel", 0, 7_000_000, "assign", None),
           ("row_prep_kernel", "kernel", 0, 9_000_000, "assign", None),
           ("lv_gather_kernel", "kernel", 0, 5_000_000, "stats", None),
           ("Memcpy HtoD", "memcpy", 0, 3_000_000, "assign", None)]
    ctx = dict(cfg=cfg, frames=2048, trace=_trace(ops), peaks=pk)
    assert _metric("lv_span_ms_per_kframe").read(ctx) == pytest.approx(
        42.0 / 2.048)
    # the work of the 6160 O, the only vertex atoms: not of the Fe and P
    ops_core, unit = roofline.assign_work(dict(cfg, n_static=6160),
                                          2048)["core"]
    assert unit == "float32"
    assert _metric("lv_roofline_pct").read(ctx) == pytest.approx(
        100.0 * ops_core / pk["float32"] / 10e-3)
    # K1's stage: lv_tile and row_prep
    records.append(_record(True, gate=dict(route="mxu", cost_ratio=0.2)))
    ops.append(("(anonymous namespace)::lv_tile_kernel(float const*)",
                "kernel", 0, 1_000_000, "assign", None))
    assert _metric("lv_roofline_pct").read(ctx) == pytest.approx(
        100.0 * ops_core / pk["float32"] / 10e-3)


@pytest.mark.parametrize("workload,n_vertex,n_static", [
    ("lfp10k-hop-mem", 6160, 9240), ("sc10k-hop-mem", 9261, 9261)])
def test_roofline_counts_only_vertex_atoms(workload, n_vertex, n_static):
    cfg = spec.cell(workload)[2]
    assert cfg["n_static"] == n_static
    assert _metric("lv_roofline_pct").vertex_atoms(cfg) == n_vertex


def test_readers_read_nothing_without_the_program_s_records(records):
    cfg = spec.cell(WORKLOAD)[2]
    ops = [("lv_gather_kernel", "kernel", 0, 4_000_000, "assign", None)]
    ctx = dict(cfg=cfg, frames=2048, trace=_trace(ops),
               peaks=roofline.PEAKS["H100"])
    assert {n: _metric(n).read(ctx) for n in NEW} == dict.fromkeys(NEW)
    # a program with device brackets but no landmark stage's, and no gate
    # (the parent of these metrics)
    dev = dict(block=np.array([0]), assign_ms=np.array([30.]),
               fold_ms=np.array([1.]))
    records.extend([_record(False, device=dev), _record(True)])
    assert {n: _metric(n).read(ctx) for n in NEW} == dict.fromkeys(NEW)
    # a CPU run: no device brackets, no trace operations, no peaks
    gate = dict(route="gather", cost_ratio=0.9)
    records.extend([_record(False, gate=gate), _record(True, gate=gate)])
    cpu = dict(cfg=cfg, frames=2048, trace=_trace([]), peaks=None)
    assert {n: _metric(n).read(cpu) for n in NEW} == dict.fromkeys(NEW)
    # the dense route: no landmark stage kernels to read
    records.append(_record(True, gate=None))
    assert _metric("lv_roofline_pct").read(ctx) is None
