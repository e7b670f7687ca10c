"""The port's pass-2 instrument on the CPU: the spans and counters of
``StreamingLandmarkAnalysis.run`` (``phase_times_``, ``run_trace_``,
``util.timing.recent_runs``), their profiler ranges, the I/O pool's
counters, the ``ctypes`` launch ranges, and the benchmark's readers of
them (``portbench/metrics``)."""
import collections
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sitator_tpu_torch as port
from sitator_tpu_torch.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu_torch.io import _shared
from sitator_tpu_torch.landmark import streaming as tst
from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.util import timing
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

from tests._torch_common import first_math_calls_on_one_thread

torch.set_num_threads(2)

first_math_calls_on_one_thread()

KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False)
B, F = 100, 500
PIPELINED = ("feeder", "upload", "snapshot", "dispatch_assign",
             "dispatch_fold", "drift_fetch", "labels_fetch",
             "labels_memmap_write")
NO_BLOCK_PHASES = ("setup", "epoch_spill", "finalize")


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=F,
                                 jump_rate=0.03, seed=9)
    sn0 = port.SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    centers = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=B, **KW).fit_centers(
        seeds, ArrayTrajectory(md.traj))
    return md, seeds, centers


def _run(md_system, path, traj=None, **kw):
    md, seeds, centers = md_system
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=B, store_labels=str(path), **{**KW, **kw})
    eng.run(seeds, md.traj if traj is None else traj, centers=centers)
    return eng


def _spans(rec, phase=None, loop=True):
    """``[(phase, block, start, end)]`` of a run record by start time: one
    phase's, or the loop's (every phase but the feeder thread's reads)."""
    sp = rec["spans"]
    out = []
    for p, b, s, e in zip(sp["phase"], sp["block"], sp["start_ns"],
                          sp["end_ns"]):
        name = rec["phases"][p]
        if (phase is None and not (loop and name == "read")) \
                or name == phase:
            out.append((name, int(b), int(s), int(e)))
    return sorted(out, key=lambda r: r[2])


def _swapped(md, T, a, b):
    """The trajectory with static atoms ``a`` and ``b`` exchanged from
    frame ``T`` on: a lattice exchange the drift guard meets."""
    traj = md.traj.copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[a], sa[b]
    traj[T:, i], traj[T:, j] = traj[T:, j].copy(), traj[T:, i].copy()
    return traj


@pytest.mark.parametrize("depth", [2, 0])
def test_phase_times_are_the_span_sums(md_system, tmp_path, depth):
    eng = _run(md_system, tmp_path / "l.npy", pipeline_depth=depth)
    rec = eng.run_trace_
    sp = rec["spans"]
    sums = collections.defaultdict(int)
    for p, s, e in zip(sp["phase"], sp["start_ns"], sp["end_ns"]):
        sums[rec["phases"][p]] += int(e - s)
    sums.pop("read")
    assert set(sums) == set(eng.phase_times_)
    for name, ns in sums.items():
        assert eng.phase_times_[name] == pytest.approx(ns * 1e-9, rel=1e-12)
    assert rec["wall_s"] >= sum(eng.phase_times_.values())


def test_every_block_carries_each_pipelined_phase_and_a_read(md_system,
                                                            tmp_path):
    rec = _run(md_system, tmp_path / "l.npy").run_trace_
    blocks = list(range(0, F, B))
    assert rec["blocks"].tolist() == blocks
    assert rec["frames"] == F and rec["block_frames"] == B
    assert rec["device"] is None and not rec["profiled"]
    per = collections.Counter((n, b) for n, b, _, _ in
                              _spans(rec, loop=False))
    for b in blocks:
        for name in PIPELINED + ("read",):
            assert per[(name, b)] == 1, (name, b)
    ids = {b for _, b in per}
    assert ids <= set(blocks) | {timing.NO_BLOCK}
    for name in NO_BLOCK_PHASES:
        assert per[(name, timing.NO_BLOCK)] == 1
    # the feeder's last wait, for its end, is of no block
    assert _spans(rec, "feeder")[-1][1] == timing.NO_BLOCK
    # a read ends before the wait that hands its block over does
    read_end = {b: e for _, b, _, e in _spans(rec, "read")}
    for _, b, _, e in _spans(rec, "feeder")[:-1]:
        assert read_end[b] <= e


@pytest.mark.parametrize("case", ["pipelined", "depth0", "rollback"])
def test_loop_spans_are_disjoint(md_system, tmp_path, case):
    md = md_system[0]
    if case == "rollback":
        eng = _run(md_system, tmp_path / "l.npy", traj=_swapped(md, 233, 2,
                                                                17),
                   dynamic_lattice_mapping=True)
        assert eng.rollbacks_ == 1
    else:
        eng = _run(md_system, tmp_path / "l.npy",
                   pipeline_depth=0 if case == "depth0" else 2)
    rows = _spans(eng.run_trace_)
    assert len(rows) > 3 * (F // B)
    for (_, _, s0, e0), (_, _, s1, e1) in zip(rows, rows[1:]):
        assert s0 <= e0 <= s1 <= e1
    assert eng.run_trace_["start_ns"] <= rows[0][2]


def test_each_span_has_its_profiler_range(md_system, tmp_path):
    # the first range a process opens costs PyTorch about 1 ms
    with timing.record_function("warm-up"):
        pass
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=timing._all_threads()) as prof:
        eng = _run(md_system, tmp_path / "l.npy")
    rec = eng.run_trace_
    assert rec["profiled"]
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(timing.RANGE_PREFIX):
            ranges[e.name()[len(timing.RANGE_PREFIX):]].append(e.start_ns())
    names = {n for n, _, _, _ in _spans(rec, loop=False)}
    assert set(ranges) == names
    for name in names:
        starts = sorted(ranges[name])
        spans = _spans(rec, name, loop=False)
        assert len(starts) == len(spans), name
        for t, (_, _, s, _) in zip(starts, spans):
            assert abs(s - t) < 1_000_000, name


def test_no_range_without_a_profiler(md_system, tmp_path, monkeypatch):
    opened = []
    real = timing.record_function

    def spy(*args):
        opened.append(args)
        return real(*args)
    monkeypatch.setattr(timing, "record_function", spy)
    eng = _run(md_system, tmp_path / "l.npy")
    assert opened == [] and not eng.run_trace_["profiled"]
    with profile(activities=[ProfilerActivity.CPU]):
        _run(md_system, tmp_path / "m.npy")
    assert ("sitator.pass2.dispatch_fold", "block=0") in opened


def test_recent_runs_keep_the_last_eight(md_system, tmp_path, monkeypatch):
    monkeypatch.setattr(timing, "_recent",
                        collections.deque(maxlen=timing.RECENT_RUNS))
    md, seeds, centers = md_system
    short = md.traj[:2 * B]
    engines = []
    for i in range(10):
        eng = port.StreamingLandmarkAnalysis(device="cpu", block_frames=B,
                                             **KW)
        if i == 6:
            with profile(activities=[ProfilerActivity.CPU]):
                eng.run(seeds, short, centers=centers)
        else:
            eng.run(seeds, short, centers=centers)
        engines.append(eng)
    runs = timing.recent_runs()
    assert len(runs) == 8
    assert [r is e.run_trace_ for r, e in zip(runs, engines[2:])] == \
        [True] * 8
    assert [r["profiled"] for r in runs] == [False] * 4 + [True] + \
        [False] * 3


def _h5_file(path, frames, chunk):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        f.create_dataset("positions", data=frames,
                         chunks=(chunk,) + frames.shape[1:],
                         compression="gzip", compression_opts=4,
                         shuffle=True)


def test_decode_tasks_count_chunks(md_system, tmp_path):
    from sitator_tpu_torch.io import open_trajectory
    md = md_system[0]
    path = tmp_path / "t.h5"
    frames = md.traj[:64].astype(np.float32)
    _h5_file(path, frames, 8)
    reader = open_trajectory(str(path))
    try:
        assert reader._h5py is None
        for lo, hi, k in [(0, 24, 3), (24, 25, 1), (32, 64, 4)]:
            t0, s0 = _shared.pool_counters()
            got = reader[lo:hi]
            t1, s1 = _shared.pool_counters()
            np.testing.assert_array_equal(got, frames[lo:hi])
            assert t1 - t0 == k and s1 > s0
    finally:
        reader.close()
    t0 = _shared.pool_counters()[0]
    ArrayTrajectory(md.traj)[0:100]
    assert _shared.pool_counters()[0] == t0


def test_pool_counters_lose_no_task_across_threads():
    """More callers than cores, switching threads every microsecond: every
    task of every caller is counted once."""
    import sys
    import threading
    callers, items = 4 * (os.cpu_count() or 1), 50
    t0 = _shared.pool_counters()[0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_shared.pool_map,
                                    args=(abs, list(range(items))))
                   for _ in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _shared.pool_counters()[0] - t0 == callers * items


def test_run_record_counts_the_decode_of_its_reads(md_system, tmp_path):
    from sitator_tpu_torch.io import open_trajectory
    md, seeds, centers = md_system
    path = tmp_path / "t.h5"
    _h5_file(path, md.traj.astype(np.float32), 20)
    reader = open_trajectory(str(path))
    try:
        eng = port.StreamingLandmarkAnalysis(device="cpu", block_frames=B,
                                             **KW)
        eng.run(seeds, reader, centers=centers)
    finally:
        reader.close()
    d = eng.run_trace_["decode"]
    assert d["tasks"] == F // 20 and d["busy_s"] > 0
    assert d["threads"] == _shared.N_THREADS
    mem = _run(md_system, tmp_path / "l.npy").run_trace_["decode"]
    assert mem["tasks"] == 0 and mem["busy_s"] == 0


def test_ctypes_launch_range_only_under_a_profiler(monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(sit_fake_entry=entry)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cuda._call("sit_fake_entry", 1, 2)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("sit_fake_entry") == 1
    opened = []
    monkeypatch.setattr(_cuda, "record_function",
                        lambda *a: opened.append(a))
    _cuda._call("sit_fake_entry", 3)
    assert opened == [] and calls == [(1, 2), (3,)]


def test_device_brackets_sum_by_block():
    class Ev:
        def __init__(self, t):
            self.t = t
            self.waited = False

        def elapsed_time(self, end):
            return end.t - self.t

        def synchronize(self):
            self.waited = True

    e = [Ev(t) for t in (0.0, 1.5, 4.0, 5.0, 5.25, 7.0, 9.0)]
    got = tst._bracket_ms([(0, 0, e[0], e[1]), (0, 1, e[1], e[2]),
                           (100, 0, e[3], e[4]), (100, 1, e[4], e[5]),
                           (0, 1, e[5], e[6])])     # block 0 folded again
    assert got["block"].tolist() == [0, 100]
    assert got["assign_ms"].tolist() == [1.5, 0.25]
    assert got["fold_ms"].tolist() == [4.5, 1.75]
    assert e[6].waited
    assert tst._bracket_ms([]) is None


def test_device_brackets_with_the_landmark_stage():
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

        def synchronize(self):
            pass

    e = [Ev(t) for t in (0.0, 1.0, 1.5, 4.0, 5.0, 5.75, 6.0, 7.0)]
    got = tst._bracket_ms([(0, 0, e[0], e[2]), (0, 2, e[0], e[1]),
                           (0, 1, e[2], e[3]), (100, 0, e[4], e[6]),
                           (100, 2, e[4], e[5]), (100, 1, e[6], e[7])])
    assert got["lv_ms"].tolist() == [1.0, 0.75]
    assert got["assign_ms"].tolist() == [1.5, 1.0]
    assert got["fold_ms"].tolist() == [2.5, 1.0]
    # no landmark stage bracketed (a mesh, the dense route): no lv_ms
    assert "lv_ms" not in tst._bracket_ms([(0, 0, e[0], e[1]),
                                           (0, 1, e[1], e[2])])


def test_stage_marks_reach_their_own_thread_only():
    import threading
    seen = []
    timing.stage_mark()                        # outside: nothing happens
    with timing.stage_marks(lambda: seen.append("outer")):
        timing.stage_mark()
        with timing.stage_marks(lambda: seen.append("inner")):
            timing.stage_mark()
            t = threading.Thread(target=timing.stage_mark)
            t.start()
            t.join()
        timing.stage_mark()
    timing.stage_mark()
    assert seen == ["outer", "inner", "outer"]


def test_engine_brackets_its_landmark_stage(md_system, tmp_path,
                                            monkeypatch):
    """With events (a card's; stand-ins here) the engine brackets each
    block's assignment from its start to the landmark stage's mark."""
    class Ev:
        clock = [0.0]

        def __init__(self):
            Ev.clock[0] += 1.0
            self.t = Ev.clock[0]

        def elapsed_time(self, end):
            return end.t - self.t

        def synchronize(self):
            pass

    monkeypatch.setattr(tst._Lanes, "mark", lambda self: Ev())
    real = tst._assign_block

    def assign(*args, **kw):
        out = real(*args, **kw)
        timing.stage_mark()   # where a kernel route marks
        timing.stage_mark()   # a second mark is not kept
        return out
    monkeypatch.setattr(tst, "_assign_block", assign)
    dev = _run(md_system, tmp_path / "l.npy").run_trace_["device"]
    assert dev["block"].tolist() == list(range(0, F, B))
    # start, the stage's first mark, end: one tick to the mark, two to
    # the end
    assert dev["lv_ms"].tolist() == [1.0] * (F // B)
    assert dev["assign_ms"].tolist() == [2.0] * (F // B)


@pytest.mark.parametrize("fused", [True, False])
def test_run_record_keeps_the_gate(md_system, tmp_path, fused):
    from sitator_tpu_torch.ops import landmark_mxu as tmx
    eng = _run(md_system, tmp_path / "l.npy", use_fused=fused)
    gate = eng.run_trace_["gate"]
    if not fused:
        assert gate is None and eng.route_ == "dense"
        return
    sn = md_system[1]
    verts, vmask = sn.padded_vertices()
    static = sn.static_mask
    basis, want = tmx._engine_gate(
        verts, vmask, sn.centers, sn.structure.cell,
        midpoint=eng.cutoff_midpoint,
        steepness=eng.cutoff_steepness, cutoff_shape=eng.cutoff_shape,
        static_ref=sn.structure.positions[static],
        drift_budget=eng.static_movement_threshold)
    assert gate == want
    assert (basis is None) == (eng.route_ == "gather")
    assert gate["route"] == eng.route_
    assert (gate["cost_ratio"] <= gate["max_cost_ratio"]) == (
        eng.route_ == "mxu")
    assert gate["n_sites"] == len(md_system[1].centers)
    assert set(gate) == {"route", "cost_ratio", "max_cost_ratio", "s_tile",
                         "UP", "n_sites", "vertex_slots"}


def test_benchmark_capture_still_sees_each_phase(md_system, tmp_path):
    from portbench.harness import spec, trace
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", block_frames=B, store_labels=str(tmp_path / "l.npy"),
        **KW)
    md, seeds, centers = md_system
    _, _, tr = trace.capture(lambda: eng.run(seeds, md.traj,
                                             centers=centers),
                             spec.spans(), False)
    got = collections.Counter(
        name for rows in tr["phases"].by_tid.values()
        for _, _, name in rows)
    want = collections.Counter(n for n, _, _, _ in _spans(eng.run_trace_))
    assert got == want
    assert set(got) == set(eng.phase_times_)
    assert tst._Phase.__name__ == "_Phase"    # restored
    assert eng.run_trace_["profiled"]


# -- the benchmark's readers of the run records ------------------------


def _record(phases, spans, profiled, device=None, decode=None, frames=1000,
            wall_s=2.0):
    cols = np.array(spans, np.int64).reshape(-1, 4).T
    return dict(phases=list(phases),
                spans=dict(phase=cols[0], block=cols[1], start_ns=cols[2],
                           end_ns=cols[3]),
                device=device, decode=decode, frames=frames, wall_s=wall_s,
                profiled=profiled)


@pytest.fixture
def records(monkeypatch):
    """A clean process-wide record list; returns it."""
    q = collections.deque(maxlen=timing.RECENT_RUNS)
    monkeypatch.setattr(timing, "_recent", q)
    return q


def _metric(name):
    from portbench.harness import spec
    return spec.module("metrics", name)


NEW = ("fold_idle_pct", "fold_span_ms_per_kframe",
       "assign_span_ms_per_kframe", "block_period_max_pct",
       "decode_busy_pct")


def test_metric_readers_on_synthetic_records(records):
    phases = ["feeder", "dispatch_fold", "read"]
    # feeder waits start at 0, 100, 210, 300, 400, 520 (the last for the
    # feeder's end): periods 100, 110, 90, 100, 120; inner ones 110, 90, 100
    waits = [0, 100, 210, 300, 400, 520]
    untraced = _record(
        phases, [(0, b, t, t + 5) for b, t in zip(
            [0, 100, 200, 300, 400, -1], waits)], False,
        device=dict(block=np.array([0, 100]), assign_ms=np.array([10., 20.]),
                    fold_ms=np.array([30., 50.])),
        decode=dict(tasks=40, busy_s=4.0, threads=8), frames=2000,
        wall_s=1.0)
    # fold spans 100-300 and 500-600 of a window 0-1000 whose device
    # operations run 0-150 and 250-550: idle in a fold 150-250, 550-600
    profiled = _record(phases, [(1, 0, 100, 300), (1, 100, 500, 600),
                                (2, 0, 120, 800)], True)
    ctx = dict(trace=dict(ops=[("k", "kernel", 0, 150, None, None),
                               ("k", "kernel", 250, 550, None, None)],
                          window_ns=(0, 1000)))
    # the untraced pass: the newest unprofiled run before the profiled one
    records.extend([_record(phases, [], False), untraced, profiled])
    got = {n: _metric(n).read(ctx) for n in NEW}
    assert got["fold_idle_pct"] == pytest.approx(15.0)
    assert got["fold_span_ms_per_kframe"] == pytest.approx(40.0)
    assert got["assign_span_ms_per_kframe"] == pytest.approx(15.0)
    assert got["block_period_max_pct"] == pytest.approx(100 * (110 / 100
                                                               - 1))
    assert got["decode_busy_pct"] == pytest.approx(50.0)
    # a run after the profiled one is not the untraced pass
    records.append(_record(phases, [], False))
    assert _metric("fold_span_ms_per_kframe").read(ctx) == \
        pytest.approx(40.0)


def test_metric_readers_without_records(records):
    ctx = dict(trace=dict(ops=[("k", "kernel", 0, 150, None, None)],
                          window_ns=(0, 1000)))
    assert {n: _metric(n).read(ctx) for n in NEW} == dict.fromkeys(NEW)
    # unprofiled runs alone: no traced run to read
    records.append(_record(["feeder"], [(0, 0, 0, 1)], False))
    assert {n: _metric(n).read(ctx) for n in NEW} == dict.fromkeys(NEW)


def test_traced_cell_on_the_cpu_reports_the_host_span_metrics():
    from portbench.harness.cell import run_cell
    from portbench.tests._small import SEED, SIZES, WORKLOADS
    for workload in sorted(WORKLOADS):
        res, _ = run_cell(workload, SEED, 0.5, True, device="cpu",
                          overrides=SIZES[WORKLOADS[workload]])
        assert res["correct"], res["checks"]
        h5 = workload == "sc10k-hop-h5"
        # a CPU trace has no device operations and no device brackets:
        # only the host clocks and the program's host spans read
        want = {"host_fold_pct", "block_period_max_pct"} | (
            {"feeder_wait_pct", "decode_busy_pct"} if h5 else set())
        assert set(res["metrics"]) == want
