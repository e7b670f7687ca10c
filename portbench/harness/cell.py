"""One run of one cell: set-up, the timed passes or the traced ones, then
the comparison with the plain reference."""
import gc
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from portbench.harness import judge, roofline, sources, spec, system, trace


def make_engine(cfg, device):
    """The port's streaming engine at the configuration's settings, its
    labels stored to a memmap (the path set a pass).  On a CPU device the
    kernels' plain versions serve (``use_fused=True``); on a card the
    kernels themselves."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    return StreamingLandmarkAnalysis(
        cutoff_midpoint=float(cfg["cutoff_midpoint"]),
        cutoff_steepness=float(cfg["cutoff_steepness"]),
        cutoff_shape=cfg["cutoff_shape"],
        assignment_threshold=float(cfg["assignment_threshold"]),
        block_frames=int(cfg["block_frames"]),
        pipeline_depth=int(cfg["pipeline_depth"]),
        verbose=False, device=device,
        use_fused=True if device.type == "cpu" else "auto")


def one_pass(engine, sn, reader, centres, labels_path):
    """``engine.run`` over ``reader``, its labels stored to
    ``labels_path``; what the comparison and the metrics read of it."""
    engine.store_labels = labels_path
    t0 = time.perf_counter()
    out = engine.run(sn, reader, centers=centres)
    wall = time.perf_counter() - t0
    return dict(state=engine.final_state_, centres=np.asarray(out.centers),
                phase_times=dict(engine.phase_times_), wall=wall,
                route=engine.route_, frames=len(reader),
                labels_path=labels_path)


def _power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def reference(cfg, data, device, operand=None):
    """The reference's labels, confidences and margins over the pool, the
    pool's ions, and its float64 sums over a pass of its own labels."""
    ref = spec.module("reference", cfg["reference"])
    labels, conf, margin = ref.label_pool(
        data["pool"], data["n_static"], data["geo"], data["centres"], cfg,
        device, operand)
    F, P = int(cfg["n_frames"]), len(data["pool"])
    mobile = data["pool"][:, data["n_static"]:]
    cell = np.asarray(data["geo"]["cell"], np.float64)
    s = ref.sums(labels, conf, mobile, cell,
                 np.bincount(np.arange(F) % P, minlength=P),
                 int(cfg["n_centres"]))
    return dict(labels=labels, conf=conf, margin=margin, mobile=mobile,
                pass_sums=s)


def judged(cfg, ref, passes, cell):
    """``(numbers, (correct, rows))`` of ``passes`` against ``ref``."""
    nums = judge.numbers(ref, spec.module("reference", cfg["reference"]),
                         passes, np.asarray(cell, np.float64),
                         float(cfg["limits"]["margin_gate"]))
    return nums, judge.checks(nums, cfg["limits"], passes[-1].get("route"),
                              cfg["route"])


def timed(run_pass, seconds):
    """Passes back to back, a new one started while the time so far plus
    half a mean pass is under ``seconds``: ``(passes, frames/s)`` over all
    the frames and the whole time of those passes.  ``run_pass(i)`` runs
    the ``i``-th."""
    passes = []
    t0 = time.perf_counter()
    while True:
        passes.append(run_pass(len(passes)))
        el = time.perf_counter() - t0
        if el + 0.5 * el / len(passes) >= seconds:
            break
    window = time.perf_counter() - t0
    return passes, sum(p["frames"] for p in passes) / window


def traced(bench, workload, cfg, dev, run_pass):
    """One untraced pass (its phase clocks), then one under the profiler:
    ``(passes, per-layer metrics, extra)``, ``extra`` the busy and window
    seconds, the breakdown and a note on the trace."""
    cuda = dev.type == "cuda"
    first = run_pass(0)
    second, _, tr = trace.capture(lambda: run_pass(1), spec.spans(), cuda)
    summ = trace.summary(tr)
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = dict(cfg=cfg, workload=workload, frames=second["frames"],
               phase_times=first["phase_times"], phase_wall_s=first["wall"],
               trace=tr, summary=summ,
               peaks=roofline.peaks(name) if cuda else None,
               device_name=name)
    metrics = {}
    for m in spec.per_layer(bench, workload):
        v = spec.module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    extra = {}
    if summ:
        extra = dict(busy_s=summ["busy_s"], window_s=summ["window_s"],
                     breakdown=dict(device_ops=summ["device_ops"],
                                    idle_gaps=summ["idle_gaps"]))
    extra["trace_note"] = (
        f"{len(tr['ops'])} device operations, {tr['unlaunched']} without a "
        f"launch found; read in {tr['extract_s']:.1f} s")
    return [first, second], metrics, extra


def run_cell(workload, seed, seconds, trace_on, device="cuda",
             overrides=None, t_start=None, marks=()):
    """Run the cell once.  Returns ``(result, lines)``: the result object
    of the line the run prints last, and the lines to print before it.
    ``t_start`` is when the process started, ``marks`` ``(name, time)``
    pairs of the set-up before this call, for the set-up's breakdown."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = list(marks) + [("imports", time.perf_counter())]
    bench, _, cfg, traffic = spec.cell(workload, overrides)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        marks.append(("CUDA init", time.perf_counter()))
    data = system.make(cfg, traffic, seed, dev)
    sn = system.site_network(data)
    centres = data["centres"]
    marks.append(("inputs", time.perf_counter()))
    workdir = tempfile.mkdtemp(prefix="portbench-")
    close = None
    try:
        source, close = sources.open_source(traffic, data["pool"], workdir)
        reader = sources.Cycled(source, cfg["n_frames"])
        engine = make_engine(cfg, dev)
        marks.append(("store", time.perf_counter()))
        # warm-up: one turn of the pool, every block shape of the pass
        one_pass(engine, sn, sources.Cycled(source, len(data["pool"])),
                 centres, os.path.join(workdir, "labels-warm.npy"))
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append(("warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        def run_pass(i):
            return one_pass(engine, sn, reader, centres,
                            os.path.join(workdir, f"labels-{i}.npy"))
        if trace_on:
            passes, metrics, extra = traced(bench, workload, cfg, dev,
                                            run_pass)
        else:
            passes, rate = timed(run_pass, seconds)
            values = dict(pass2_frames_per_s=rate, setup_s=setup_s)
            metrics = {m["name"]: dict(value=values[m["name"]],
                                       unit=m["unit"])
                       for m in spec.end_to_end(bench, workload)}
            extra = {}
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
        route = passes[-1]["route"]
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        ref = reference(cfg, data, dev)
        nums, (ok, rows) = judged(cfg, ref, passes, data["geo"]["cell"])
        check_s = time.perf_counter() - t_check
    finally:
        if close is not None:
            close()
        shutil.rmtree(workdir, ignore_errors=True)

    frames = sum(p["frames"] for p in passes)
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(dev) if cuda
                       else "cpu", count=1, memory_peak_bytes=peak)
    if trace_on and "busy_s" in extra:
        device_info.update(busy_s=extra["busy_s"],
                           window_s=extra["window_s"])
    if cuda:
        device_info["power_limit_w"] = _power_limit_w()
    result = dict(correct=bool(ok), attempted=frames,
                  failed=0 if ok else frames, metrics=metrics,
                  device=device_info)
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["route"] = route
    result["checks"] = {name: dict(value=v, limit=lim, op=op)
                        for name, v, op, lim in rows}
    lines = [f"# {workload} seed {seed}: route {route}, "
             f"{len(passes)} passes of {passes[-1]['frames']} frames, "
             f"walls " + ", ".join(f"{p['wall']:.3f}" for p in passes)
             + f" s; check {check_s:.1f} s; labels of a pass gated "
             f"{nums['labels_gated']}, unknown {nums['ref_unknown']}",
             "# jumps tallied by pass: " + ", ".join(
                 str(int(np.asarray(p["state"]["n_ij"]).sum()))
                 for p in passes)
             + f" (reference {nums['ref_jumps']})"]
    lines.append("# setup " + ", ".join(
        f"{name} {t - t0:.2f} s" for (name, t), t0 in zip(
            marks, [t_start] + [m[1] for m in marks[:-1]])))
    if "trace_note" in extra:
        lines.append("# trace: " + extra["trace_note"])
    pk = roofline.peaks(device_info["kind"]) if trace_on and cuda else None
    if pk:
        frames = passes[-1]["frames"]
        bound, which, times = roofline.assign_bound(cfg, frames, pk)
        lines.append(
            f"# roofline of the assignment: {bound * 1e3:.3f} ms for "
            f"{frames} frames, bound by {which} ("
            + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in times.items())
            + f"); card power limit {device_info.get('power_limit_w')} W")
    return result, lines
