"""Share (%) of the float32 roofline that the landmark stage's kernels
reach: the least time of the landmark-vector work over the device time of
the landmark stage's kernels launched inside the assignment wrappers in
the profiled pass: ``lv_gather_kernel`` on K3, ``lv_tile_kernel`` and
``row_prep_kernel`` on K1, the route the program's gate took
(``run_trace_["gate"]["route"]`` of the profiled pass).  The work is
``harness/roofline.py::assign_work``'s ``core`` term at the card's float32
peak, counted over the static atoms that are a vertex of some site, the
only ones whose terms the stage needs (on ``sc10k`` every static atom; on
``lfp10k`` the O alone, not the Fe and P).  None on a program that records
no gate."""
import re

import numpy as np

from portbench.harness import spec
from portbench.harness.roofline import assign_work
from portbench.metrics.fold_span_ms_per_kframe import runs

STAGE_KERNELS = {"gather": ("lv_gather_kernel",),
                 "mxu": ("lv_tile_kernel", "row_prep_kernel")}


def stage_seconds(ops, route):
    """Device seconds of the landmark-stage kernels of ``route`` among the
    trace's operations ``ops`` launched in the assignment span."""
    pat = re.compile(r"(^|[^A-Za-z0-9_])(%s)([^A-Za-z0-9_]|$)"
                     % "|".join(STAGE_KERNELS[route]))
    return sum(o[3] - o[2] for o in ops if o[1] == "kernel"
               and o[4] == "assign" and pat.search(o[0])) * 1e-9


def vertex_atoms(cfg):
    """The number of distinct static atoms that are a vertex of some site
    in the configuration's geometry."""
    geo = spec.module("geometry", cfg["geometry"]).build(cfg)
    verts = np.concatenate([np.ravel(v) for v in geo["verts"]])
    return len(np.unique(verts[verts >= 0]))


def read(ctx):
    _, run = runs()
    tr, pk = ctx.get("trace"), ctx.get("peaks")
    gate = (run or {}).get("gate")
    if (not gate or gate.get("route") not in STAGE_KERNELS or not tr
            or not tr["ops"] or not pk):
        return None
    busy = stage_seconds(tr["ops"], gate["route"])
    if not busy:
        return None
    cfg = dict(ctx["cfg"], n_static=vertex_atoms(ctx["cfg"]))
    ops, unit = assign_work(cfg, ctx["frames"])["core"]
    return 100.0 * ops / pk[unit] / busy
