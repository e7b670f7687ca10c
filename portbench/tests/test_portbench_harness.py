"""The harness end to end at a tiny size on the CPU (the port's plain
versions of K1 and K3 in the kernels' place), and the contract of
``BENCHMARK.json``."""
import json
import re

import numpy as np
import pytest
import torch

from _small import SEED, SIZES, WORKLOADS
from portbench.harness import sources, spec, trace
from portbench.harness.cell import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_cell_end_to_end(workload, trace_on):
    res, lines = run_cell(workload, SEED, 0.5, trace_on, device="cpu",
                          overrides=SIZES[WORKLOADS[workload]])
    assert res["correct"], res["checks"]
    assert res["checks"]["jumps"]["value"] >= 1
    assert list(res)[-1] == "checks"
    bench = spec.benchmark()
    if trace_on:
        # a CPU trace has no device operations: only host clocks read
        want = {"host_fold_pct"} | (
            {"feeder_wait_pct"} if workload == "sc10k-hop-h5" else set())
        assert set(res["metrics"]) == want
    else:
        assert set(res["metrics"]) == {m["name"]
                                       for m in bench["end_to_end"]}
        assert res["metrics"]["pass2_frames_per_s"]["value"] > 0
    assert any(line.startswith("# jumps tallied") for line in lines)
    json.dumps(res)


def test_same_seed_same_inputs():
    from portbench.harness import system
    _, _, cfg, traffic = spec.cell("sc10k-hop-mem", SIZES["sc10k"])
    a = system.make(cfg, traffic, SEED, torch.device("cpu"))
    b = system.make(cfg, traffic, SEED, torch.device("cpu"))
    c = system.make(cfg, traffic, SEED + 1, torch.device("cpu"))
    assert np.array_equal(a["pool"], b["pool"])
    assert np.array_equal(a["centres"], b["centres"])
    assert not np.array_equal(a["pool"], c["pool"])
    # the ions really hop in the pool
    assert (a["path"][1:] != a["path"][:-1]).any()


def test_hops_go_to_neighbours_through_transit_frames():
    from portbench.geometry import cube_corners
    from portbench.harness import system
    cfg = dict(n_cells=9, a_lattice=4.0)
    geo = cube_corners.build(cfg)
    block = [[0, 8, 2], [0, 8, 2], [0, 8, 1]]
    centred, nbr = system.centred_sites(geo, block)
    assert len(centred) == 4 * 4 * 8
    sites = geo["sites"][centred]
    # neighbours: 8 A apart along x and y, 4 A along z, inside the block
    for k in range(len(centred)):
        for d in range(6):
            if nbr[k, d] >= 0:
                gap = np.abs(sites[nbr[k, d]] - sites[k])
                assert gap.sum() == (4.0 if d >= 4 else 8.0)
    rng = np.random.default_rng(SEED)
    start, path = system.hop_paths(rng, sites, nbr, 90, 601, 0.05, 2.0)
    assert np.array_equal(path[0], sites[start])
    # the second half is the first run backwards: no jump at the wrap
    assert np.array_equal(path[301:], path[:301][::-1][:300])
    on_site = np.isclose(np.linalg.norm(
        path[:, :, None] - sites[None, None], axis=-1), 0).any(-1)
    assert 0 < (~on_site).sum() < 0.1 * on_site.size
    step = np.linalg.norm(np.diff(path[np.r_[:601, 0]], axis=0), axis=-1)
    assert step.max() <= 2.0 + 1e-9          # transit_step_A a frame
    # single occupancy: no two settled ions on one site
    for f in range(len(path)):
        pts = path[f][on_site[f]]
        assert len(np.unique(np.round(pts, 6), axis=0)) == len(pts)


def test_cycled_reader():
    pool = np.arange(7 * 2 * 3, dtype=np.float32).reshape(7, 2, 3)
    r = sources.Cycled(pool, 30)
    assert len(r) == 30
    for lo, hi in ((0, 7), (3, 12), (5, 30), (14, 21), (29, 30)):
        assert np.array_equal(r[lo:hi], pool[np.arange(lo, hi) % 7])
    assert np.shares_memory(r[7:10], pool)


def test_h5_copy_reads_back_through_the_port(tmp_path):
    frames = np.random.default_rng(0).normal(size=(21, 13, 3)).astype(
        np.float32)
    traffic = spec.cell("sc10k-hop-h5")[3]
    rd, close = sources.open_source(traffic, frames, str(tmp_path))
    try:
        assert rd._h5py is None
        assert np.array_equal(rd[0:21], frames)
        assert np.array_equal(rd[5:19], frames[5:19])
    finally:
        close()
    mem, _ = sources.open_source(spec.cell("sc10k-hop-mem")[3], frames,
                                 str(tmp_path))
    assert mem is frames


def test_another_route_reads_not_correct():
    res, _ = run_cell("sc10k-hop-mem", SEED, 0.2, False, device="cpu",
                      overrides=dict(SIZES["sc10k"], route="gather"))
    assert not res["correct"]
    assert res["checks"]["route"] == dict(value="mxu", limit="gather",
                                          op="==")


def test_geometry_matches_bench_config():
    from portbench.geometry import cube_corners
    from sitator_tpu_torch.tools import bench_config
    g = cube_corners.build(spec.cell("sc10k-hop-mem")[2])
    s = bench_config.build_system()
    assert np.array_equal(g["verts"], s.verts)
    assert np.allclose(g["static"], s.host) and np.allclose(g["sites"],
                                                            s.sites)


class _Ev:
    """A stand-in for a profiler event."""

    def __init__(self, name, dev, act, start, end, corr, linked=0, tid=1,
                 ua=False):
        self.v = (name, dev, act, start, end, corr, linked, tid, ua)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def activity_type(self):
        return self.v[2]

    def start_ns(self):
        return self.v[3]

    def end_ns(self):
        return self.v[4]

    def correlation_id(self):
        return self.v[5]

    def linked_correlation_id(self):
        return self.v[6]

    def start_thread_id(self):
        return self.v[7]

    def is_user_annotation(self):
        return self.v[8]

    def device_resource_id(self):
        return 7


def test_trace_attribution_and_idle():
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [
        _Ev(trace.WINDOW, CPU, "user_annotation", 0, 1000, 1, ua=True),
        _Ev("pb.phase.dispatch_assign", CPU, "user_annotation", 10, 100, 2,
            ua=True),
        _Ev("pb.span.assign", CPU, "user_annotation", 20, 90, 3, ua=True),
        _Ev("pb.phase.dispatch_fold", CPU, "user_annotation", 100, 400, 4,
            ua=True),
        _Ev("pb.span.stats", CPU, "user_annotation", 110, 390, 5, ua=True),
        _Ev("aten::add", CPU, "cpu_op", 120, 130, 6),
        _Ev("cudaLaunchKernel", CPU, "cuda_runtime", 30, 31, 900, linked=3),
        _Ev("cudaLaunchKernel", CPU, "cuda_runtime", 121, 122, 901,
            linked=6),
        _Ev("cudaLaunchKernel", CPU, "cuda_runtime", 450, 451, 902),
        _Ev("lv_tile_kernel", CUDA, "kernel", 200, 300, 900, linked=3),
        _Ev("index_put_kernel", CUDA, "kernel", 300, 500, 901, linked=6),
        _Ev("pack", CUDA, "kernel", 600, 700, 902),
        _Ev("sims_wgmma_kernel", CUDA, "kernel", 250, 260, 950),
        _Ev("Memcpy HtoD", CUDA, "gpu_memcpy", 650, 800, 903),
        _Ev("pb.span.stats", CUDA, "gpu_user_annotation", 300, 500, 5,
            ua=True),
    ]
    tr = trace.extract(ev)
    got = {o[0]: (o[1], o[4], o[5]) for o in tr["ops"]}
    assert got["lv_tile_kernel"] == ("kernel", "assign", "dispatch_assign")
    assert got["index_put_kernel"] == ("kernel", "stats", "dispatch_fold")
    assert got["pack"] == ("kernel", None, None)
    # no launch recorded (a ctypes launch): the span of the one before it
    assert got["sims_wgmma_kernel"] == ("kernel", "assign",
                                        "dispatch_assign")
    assert got["Memcpy HtoD"] == ("memcpy", None, None)
    assert tr["unlaunched"] == 2 and len(tr["ops"]) == 5
    s = trace.summary(tr)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(500e-9)    # 200-500, 600-800
    idle = dict(s["idle_gaps"])
    assert idle["outside the engine's phases"] == pytest.approx(500e-9)


def test_benchmark_json_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert 1 <= len(c["source"]) <= 200
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and data[k] != data["published"][k]
            assert not re.search(r"(_dim|_rank)$", k)
        assert None not in data["limits"].values()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in cfgs and len(w["why"]) <= 200
        assert (spec.PKG / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(spec.module("metrics", m["name"]).read)
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for span, targets in spec.spans().items():
        for mod, fn in targets:
            import importlib
            assert callable(getattr(importlib.import_module(mod), fn))
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
