#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sitator_tpu_torch``) once on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result lines:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA and
   ``nvcc`` versions;
2. build: compiles ``sitator_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``build/`` (skipped when a library for these sources is there), prints
   each kernel's registers and spills from ``ptxas``, and counts the
   tensor-core (``HGMMA``) instructions of each kernel in the library's
   SASS (fails when ``sims_wgmma`` or the cluster K1s has none);
3. the tail's partition: the tensor-core and the FMA similarity kernels
   with their per-block arg-max and the merge, bit for bit against their
   plain twin on exact (dyadic) inputs with ties across block borders;
   then every kernel against its plain PyTorch version on the same inputs
   on the card, at the bench width of ``bench.py`` (9261 static + 739
   mobile atoms, 9261 landmarks x 8 vertices, 1024 centres) with its
   random centres (timed, each stage of K1 and of K3 timed alone, the
   bound of each kernel and stage reckoned from these inputs, and the bf16
   ``torch.matmul`` of the similarity product timed as the library
   yardstick) and with site centres; then at reduced widths a
   ``peak_evening='clip'`` case in f32 (the FMA tail), an f32 case without
   the clip (the FMA K1s), a triclinic case and cases with 384 and 2176
   centres (K1s clusters of 1, 2, 4 and 8 CTAs, the last in two passes).
   In each case K1 is held to K3 and K1s to K1 (labels outside the gate;
   whether they are bit-equal is printed), and K3's bf16 route (the
   gather stage writes the norm and the bf16 copy) bit for bit to its f32
   route + ``row_prep``;
4. the slice end to end through the user entry points, with the launch
   counters reset first and read after: ``LandmarkAnalysis`` (K2) then
   ``JumpAnalysis``; ``SpmdLandmarkPipeline`` over 8 blocks x 32 frames with
   the carry (K1), timed, and one pass under ``torch.profiler`` (device
   time by op); the pipeline on a small basis without vertex
   sharing (K3), and the dense route on the same input as its reference.
   The ions hop among 1024 sites, and the pipeline's 1024 centres are the
   unit landmark vectors of an ion on each of them: under ``bench.py``'s
   random centres every similarity is far below the threshold, every label
   is -1 and no jump would be recorded, at the same work per frame;
5. the K1s path: ``mxu_assign_blocks(skew=True)`` against ``skew=False``
   over 8 bench blocks through the public wrapper (the A/B of
   ``tools/ab_skew.py``), counters reset first and read after;
6. ``StreamingLandmarkAnalysis`` at the bench width over 1024 frames:
   ``fit_centers`` (K2) then ``run`` (K1) in 256-frame blocks with the labels
   spilled to a memmap, timed; its statistics against the int64 oracle on
   the spilled labels, its labels bit for bit against
   ``SpmdLandmarkPipeline`` on the same frames and centres, and the run
   again without the memmap, counters reset first and read after;
7. K3's own path at the bench width: the bench's sites, each with a
   tetrahedron of its own 4 static atoms (no vertex shared, 37,044 static
   atoms): ``SpmdLandmarkPipeline`` (route 'gather', 8 x 32 frames with the
   carry, timed, profiled) held to the dense route and the int64 oracle,
   then ``StreamingLandmarkAnalysis`` fit and pass 2 (route 'gather', 1024
   frames in 256-frame blocks, timed) held to the oracle and to the
   pipeline;
8. one JSON line of per-kernel results, then the ``ok`` line, last.

Label comparisons are gated on the reference's top-2 margin: labels must be
equal wherever the best and second-best cosine similarities (f32, from the
kernel-checked landmark vectors) differ by more than 8e-3 with bf16 operands
(about 2 bf16 ulps near 1) or 1e-5 in f32, and the best one is not within
the confidence tolerance of the threshold.  K1, K3 and K1s sum the bf16
similarity on the tensor cores, the plain versions on the CPU's or the
card's f32 matmul: f32 sums of the same bf16 products in other orders.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

LV_RTOL, LV_ATOL = 1e-4, 1e-6        # f32 sums in another order, then exp
CONF_ATOL = {True: 1e-2, False: 1e-5}  # bf16 / f32 similarity operands
MARGIN = {True: 8e-3, False: 1e-5}
MID, STEEP, THR, CUTOFF = 4.0, 3.0, 0.35, "logistic_r2"   # bench.py
# NVIDIA H100 SXM data-sheet peaks (dense), for the bounds
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
# f32 operations counted for one (ion, atom) pair: the difference and the
# squared distance, the logistic argument, and the log-sigmoid (or the
# linear-space product) with each transcendental counted as one
PAIR_OPS = 16


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# -- timing and comparison --------------------------------------------------

def timed(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, timed with CUDA
    events after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def sync():
    import torch
    torch.cuda.synchronize()


def top2_margin(lv, centers, peak_evening):
    """Reference top-1 minus top-2 cosine similarity and top-1 value of
    every (frame, ion), in f32 from landmark vectors ``lv (B, M, S)`` in the
    caller's site order and unit ``centers (K, S)``; zero similarities of
    the kernels' padded centre columns included."""
    import torch
    from sitator_tpu_torch.ops import landmark as lmops
    c = torch.as_tensor(centers, device=lv.device, dtype=torch.float32)
    lv_n, _ = lmops.normalize_landmark_vectors(lmops.peak_even(
        lv, peak_evening))
    sims = lv_n @ c.T
    pad = (-c.shape[0]) % 128
    if pad:
        sims = torch.nn.functional.pad(sims, (0, pad))
    top = sims.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy(), \
        top[..., 0].cpu().numpy()


def compare_assign(name, got, want, margin, top1, bf16):
    """Labels equal outside the margin gate; confidences within tolerance.
    Returns the max confidence error."""
    gl, gc = (np.asarray(x.cpu()) for x in got)
    wl, wc = (np.asarray(x.cpu()) for x in want)
    check(gl.shape == wl.shape == margin.shape,
          f"{name}: shapes {gl.shape} {wl.shape} {margin.shape}")
    check(np.isfinite(gc).all(), f"{name}: non-finite confidences")
    err = float(np.abs(gc - wc).max())
    check(err <= CONF_ATOL[bf16], f"{name}: conf error {err:.3g} > "
          f"{CONF_ATOL[bf16]}")
    gated = (margin <= MARGIN[bf16]) | (np.abs(top1 - THR) <= CONF_ATOL[bf16])
    bad = np.argwhere((gl != wl) & ~gated)
    check(not len(bad), f"{name}: {len(bad)} labels differ outside the "
          f"margin gate (first at {bad[:1].tolist()})")
    print(f"  {name}: labels equal on {int((~gated).sum())} ungated rows "
          f"({int(gated.sum())} gated, {int((gl != wl).sum())} differ "
          f"there); max conf err {err:.3g}", flush=True)
    return err


def compare_lv(name, got, want):
    import torch
    check(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite lv")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= LV_ATOL + LV_RTOL * want.abs()).all())
    check(ok, f"{name}: lv outside rtol={LV_RTOL}, atol={LV_ATOL} "
          f"(max abs err {err:.3g})")
    print(f"  {name}: lv within rtol={LV_RTOL}, atol={LV_ATOL}; max abs err "
          f"{err:.3g}", flush=True)
    return err


# -- systems ------------------------------------------------------------------

def lattice_system(n_c, n_ions, n_frames, n_centres, *, seed, shear=None,
                   a=4.0, hop=0.01):
    """The bench geometry at ``n_c`` cells a side: a simple-cubic host
    lattice, sites at the cube centres with their 8 corner atoms as
    vertices.  ``n_centres`` sites carry a centre; ions start on the first
    ``n_ions`` of them and, each frame with probability ``hop``, hop to a
    free one.  ``shear`` (3, 3) makes the cell triclinic.  Centres are
    filled in later (:func:`add_site_centres`); ``random_centres`` are
    random positive unit rows as in ``bench.py``."""
    rng = np.random.default_rng(seed)
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cell = np.eye(3) * a * n_c if shear is None \
        else (np.eye(3) + shear) * a * n_c
    verts = np.zeros((len(grid), 8), np.int32)
    for j, d in enumerate(np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                               indexing="ij"),
                                   -1).reshape(-1, 3)):
        v = (grid + d) % n_c
        verts[:, j] = (v[:, 0] * n_c + v[:, 1]) * n_c + v[:, 2]
    host = (grid / n_c) @ cell
    sites = ((grid + 0.5) / n_c) @ cell
    return hopping(rng, cell, host, verts, sites, n_ions, n_frames,
                   n_centres, hop, sigma=0.25)


def hopping(rng, cell, host, verts, sites, n_ions, n_frames, n_centres, hop,
            sigma):
    """Thermal jitter on the host lattice; ions on ``n_centres`` randomly
    chosen ("centred") sites, hopping to a free one with probability
    ``hop`` per frame."""
    centred = rng.choice(len(sites), n_centres, replace=False)
    occ = centred[:n_ions].copy()
    free = list(centred[n_ions:])
    site_of = np.empty((n_frames, n_ions), np.int64)
    for f in range(n_frames):
        for i in np.flatnonzero(rng.random(n_ions) < hop):
            j = int(rng.integers(len(free)))
            occ[i], free[j] = free[j], occ[i]
        site_of[f] = occ
    static = host[None] + rng.normal(scale=0.05,
                                     size=(n_frames,) + host.shape)
    mobile = sites[site_of] + rng.normal(scale=sigma,
                                         size=(n_frames, n_ions, 3))
    random_centres = rng.random((n_centres, len(sites)))
    random_centres /= np.linalg.norm(random_centres, axis=1, keepdims=True)
    return dict(cell=np.asarray(cell, np.float32), verts=verts,
                site_pos=sites, static_ref=host,
                static=static.astype(np.float32),
                mobile=mobile.astype(np.float32), centred=centred,
                random_centres=random_centres.astype(np.float32))


def bench_system(n_frames, seed):
    """The bench width of ``bench.build_system``: its cell, vertices and
    1024 random centres, with ions hopping among 1024 centred sites."""
    import bench
    cell, verts, _, centres, _ = bench.build_system()
    sy = lattice_system(bench.N_CELLS, bench.N_IONS, n_frames,
                        bench.K_CENTERS, seed=seed, a=bench.A_LAT)
    check(np.array_equal(sy["verts"], verts)
          and np.allclose(sy["cell"], cell), "bench geometry differs")
    sy["random_centres"] = centres
    return sy


def add_site_centres(sy, device):
    """Fitted-like centres: the unit landmark vector of an ion sitting
    exactly on each centred site of the reference lattice (K2 on the card,
    its plain version on the CPU)."""
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    basis = mx.prepare_mxu_basis(sy["verts"], np.ones_like(sy["verts"], bool),
                                 sy["site_pos"], sy["cell"], s_tile=128)
    probes = torch.as_tensor(sy["site_pos"][sy["centred"]][None],
                             dtype=torch.float32, device=device)
    ref = torch.as_tensor(sy["static_ref"][None], dtype=torch.float32,
                          device=device)
    lv = mx.mxu_landmark_blocks(probes, ref, mx.basis_from_jax(basis, device),
                                kernel_cell(sy["cell"]), midpoint=MID,
                                steepness=STEEP, cutoff_shape=CUTOFF)[0]
    sy["centers"] = (lv / lv.norm(dim=1, keepdim=True)).cpu().numpy()
    return sy


def site_network(sy):
    """A SiteNetwork over ``sy``: static atoms first, then the ions (frame-0
    positions), the sites with their vertex polyhedra."""
    from sitator_tpu_torch import SiteNetwork, Structure
    n_static = len(sy["static_ref"])
    n_ions = sy["mobile"].shape[1]
    pos = np.concatenate([sy["static_ref"], sy["mobile"][0]])
    species = np.concatenate([np.full(n_static, 16), np.full(n_ions, 3)])
    mask = np.arange(n_static + n_ions) < n_static
    sn = SiteNetwork(Structure(pos, species, sy["cell"]), mask, ~mask)
    sn.centers = sy["site_pos"]
    sn.vertices = list(sy["verts"])
    return sn


def frames_of(sy):
    return np.concatenate([sy["static"], sy["mobile"]], axis=1)


# -- phases -------------------------------------------------------------------

def phase_device():
    import torch
    from sitator_tpu_torch.ops import _cuda
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1]}", flush=True)
    # the plain versions hold full f32 where the reference does
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    """Build (or find) the kernel library; print each kernel's registers
    and spills from ptxas and the count of tensor-core instructions
    (HGMMA) in its SASS, which must not be 0."""
    import re
    from sitator_tpu_torch.ops import _cuda
    path, seconds, log = _cuda.build()
    _cuda.library()
    print(f"build: {path.relative_to(ROOT)} in {seconds:.1f} s "
          f"({'compiled' if seconds else 'already built'})", flush=True)
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            fn = k.group(1) if k else m.group(1)
            t = re.findall(r"L[ib](\d+)E", m.group(1))
            if t:
                fn = f"{fn}<{','.join(t)}>"
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    by_fn, fn = {}, "?"
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            fn = k.group(1) if k else m.group(1)
            t = re.findall(r"L[ib](\d+)E", m.group(1))
            if t:
                fn = f"{fn}<{','.join(t)}>"
        elif "HGMMA" in line:
            by_fn[fn] = by_fn.get(fn, 0) + 1
    n_hgmma = sum(by_fn.values())
    print(f"SASS: {n_hgmma} HGMMA instructions in {path.name}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(by_fn.items())), flush=True)
    for kernel in ("sims_wgmma_kernel", "assign_skew_wgmma_kernel"):
        check(any(k.startswith(kernel) for k in by_fn),
              f"no HGMMA (tensor-core) instruction in {kernel}")
    return n_hgmma


def bound(nbytes, tc_flop=0.0, f32_flop=0.0):
    """(bound_ms, bound_by): the least time for this work on an H100 SXM,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type (tensor-core bf16, f32 off the tensor
    cores; the larger of the two, since the pipes run side by side)."""
    t = {"bytes": nbytes / HBM_BPS,
         "operations": max(tc_flop / PEAK_BF16, f32_flop / PEAK_F32)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def unique_atom_work(a, M, K=None):
    """(bytes, tensor-core flop, f32 flop) of K2 (``K`` None: the lv out)
    or K1 / K1s (the assignment to ``K`` centres) on these kernel inputs,
    counting the ``M`` real ions, the real unique atoms of each tile and
    the nonzeros of the membership: each input read once, each output
    written once."""
    A = a["A"]
    B = a["mob"].shape[0]
    n_st, _, s_tile = A.shape
    nz = A != 0
    rows, S = B * M, int((a["kill"] == 0).sum())
    f32 = rows * (PAIR_OPS * int(nz.any(2).sum()) + 2 * int(nz.sum())
                  + 2 * S)
    nbytes = 4 * (a["mob"].numel() + a["vpu"].numel() + a["kill"].numel()
                  + 2 * a["members"][0].numel())
    if K is None:
        return nbytes + 4 * rows * S, 0.0, f32
    nbytes += 4 * S * K + 8 * rows
    return nbytes, 2.0 * rows * S * K, f32 + 2 * rows * S


def gather_work(a, M, S, V, K):
    """(bytes, tensor-core flop, f32 flop) of K3 on these kernel inputs."""
    rows = a["mob"].shape[0] * M
    nbytes = 4 * (a["mob"].numel() + a["vp"].numel() + a["mask"].numel()
                  + S * K) + 8 * rows
    return nbytes, 2.0 * rows * S * K, rows * S * (PAIR_OPS * V + 2)


def k1_stages(a, M, reps):
    """Each stage of K1 timed alone on these inputs (CUDA events, ms): the
    lv tiles, row prep (norm and the bf16 copy), the centres' bf16 copy,
    the tensor-core product with its per-block arg-max, the merge; and the
    bf16 ``torch.matmul`` of the same product (the library yardstick)."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = a["mob"].shape
    n_st, _, s_tile = a["A"].shape
    SP = n_st * s_tile
    lv = torch.empty((B, MP, SP), device="cuda")
    rows = lv.view(B * MP, SP)
    col_map = torch.arange(SP, dtype=torch.int32, device="cuda")

    def lv_tile():
        _cuda.lv_tile(a["mob"], a["vpu"], *a["members"], a["kill"],
                      a["anchors"], col_map, lv, a["params"],
                      triclinic=a["triclinic"], r2_cutoff=a["r2_cutoff"],
                      preshift=a["preshift"])

    lv_tile()
    inv, lvb = _cuda.row_prep(rows, peak_clip=False, bf16_copy=True)
    cb = _cuda.centers_bf16(a["cpad"])
    pv, pi = _cuda.sims_argmax(lvb, inv, a["cpad"], cb)
    ms = dict(
        lv_tile=timed(lv_tile, reps),
        row_prep=timed(lambda: _cuda.row_prep(rows, peak_clip=False,
                                              bf16_copy=True), reps),
        centers_bf16=timed(lambda: _cuda.centers_bf16(a["cpad"]), reps),
        sims_wgmma=timed(lambda: _cuda.sims_argmax(lvb, inv, a["cpad"], cb),
                         reps),
        argmax_merge=timed(lambda: _cuda.argmax_merge(pv, pi, THR), reps))
    library = timed(lambda: torch.matmul(lvb, cb.t()), reps)
    R, KP = B * MP, a["cpad"].shape[1]
    bounds = dict(                      # each stage as a function of its own
        lv_tile=bound(*unique_atom_work(a, M)),     # inputs and outputs
        row_prep=bound(6 * R * SP),     # f32 read, bf16 write
        centers_bf16=bound(6 * SP * KP),
        sims_wgmma=bound(2 * (R + KP) * SP, 2.0 * R * SP * KP),
        argmax_merge=bound(16 * R * -(-KP // 256)))
    print("K1 stages at the bench width (ms per 32-frame block, CUDA "
          "events; the stage's bound in brackets): " + ", ".join(
              f"{k} {v:.3f} [{bounds[k][0]:.3f} {bounds[k][1]}]"
              for k, v in ms.items())
          + f"; bf16 torch.matmul of the same product {library:.3f}",
          flush=True)
    return ms, library


def gather_rows(a, bf16):
    """K3's gather stage alone on these kernel inputs: ``(lvb, inv_norm)``
    with the bf16 output, else the f32 rows."""
    from sitator_tpu_torch.ops import _cuda
    return _cuda.lv_gather(a["mob"], a["vp"], a["mask"], a["params"],
                           triclinic=a["triclinic"], r2_cutoff=a["r2_cutoff"],
                           full_mask=a["full_mask"], bf16=bf16)


def k3_routes(a, label):
    """K3's bf16 route (the gather stage forms the norm and the bf16 copy)
    bit for bit against its f32 route + ``row_prep``: inv_norm, the bf16
    copy, and the labels and confidences of the tail on each."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    lvb, inv = gather_rows(a, True)
    lv = gather_rows(a, False)
    inv2, lvb2 = _cuda.row_prep(lv, peak_clip=False, bf16_copy=True)
    thr = float(a["params"][-1])
    got = _cuda.argmax_merge(*_cuda.sims_argmax(lvb, inv, a["cpad"]), thr)
    want = _cuda.assign_tail(lv, a["cpad"], thr, peak_clip=False,
                             mxu_bf16=True)
    sync()
    same = dict(inv_norm=torch.equal(inv.view(torch.int32),
                                     inv2.view(torch.int32)),
                bf16_copy=torch.equal(lvb.view(torch.int16),
                                      lvb2.view(torch.int16)),
                labels=torch.equal(got[0], want[0]),
                confs=torch.equal(got[1].view(torch.int32),
                                  want[1].view(torch.int32)))
    check(all(same.values()), f"{label}: K3's bf16 route differs from its "
          f"f32 route + row_prep: {same}")
    print(f"  {label} K3 bf16 route == f32 route + row_prep bit for bit "
          f"(inv_norm, bf16 copy, labels, confs over {lv.shape[0]} rows)",
          flush=True)


def k3_stages(a, M, S, V, reps):
    """Each stage of K3's default (bf16) route timed alone (CUDA events,
    ms): the gather stage (lv, norm, bf16 copy), the centres' bf16 copy,
    the tensor-core product with its per-block arg-max, the merge; and the
    bf16 ``torch.matmul`` of the same product (the library yardstick)."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = a["mob"].shape
    SP = a["vp"].shape[3]
    lvb, inv = gather_rows(a, True)
    cb = _cuda.centers_bf16(a["cpad"])
    pv, pi = _cuda.sims_argmax(lvb, inv, a["cpad"], cb)
    ms = dict(
        lv_gather=timed(lambda: gather_rows(a, True), reps),
        centers_bf16=timed(lambda: _cuda.centers_bf16(a["cpad"]), reps),
        sims_wgmma=timed(lambda: _cuda.sims_argmax(lvb, inv, a["cpad"], cb),
                         reps),
        argmax_merge=timed(lambda: _cuda.argmax_merge(pv, pi, THR), reps))
    library = timed(lambda: torch.matmul(lvb, cb.t()), reps)
    R, KP = B * MP, a["cpad"].shape[1]
    rows = B * M
    bounds = dict(
        lv_gather=bound(4 * (a["mob"].numel() + a["vp"].numel()
                             + a["mask"].numel()) + 2 * rows * S + 4 * rows,
                        0.0, rows * S * (PAIR_OPS * V + 2)),
        centers_bf16=bound(6 * SP * KP),
        sims_wgmma=bound(2 * (R + KP) * SP, 2.0 * R * SP * KP),
        argmax_merge=bound(16 * R * -(-KP // 256)))
    print("K3 stages at the bench width (ms per 32-frame block, CUDA "
          "events; the stage's bound in brackets): " + ", ".join(
              f"{k} {v:.3f} [{bounds[k][0]:.3f} {bounds[k][1]}]"
              for k, v in ms.items())
          + f"; bf16 torch.matmul of the same product {library:.3f}",
          flush=True)
    return dict(ms=ms, bounds=bounds), library


def tail_partition_cases():
    """The tensor-core tail (and the f32 FMA tail) against their plain twin
    ``blocked_assign_plain`` bit for bit, on dyadic inputs (multiples of
    1/16: exact in bf16, every sum exact in f32 in any order) with ties
    placed inside blocks, across 256-column borders and with the odd last
    block of 128 columns."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    from sitator_tpu_torch.ops.kernel_common import blocked_assign_plain
    g = torch.Generator().manual_seed(0)
    for rows, SP, KP in ((128, 64, 256), (256, 192, 384), (384, 640, 1024),
                         (128, 9344, 128)):
        lv = (torch.randint(0, 17, (rows, SP), generator=g) / 16).cuda()
        C = torch.randint(0, 17, (SP, KP), generator=g) / 16
        if KP > 256:
            C[:, 256] = C[:, 255]
        C[:, KP - 1] = C[:, 3]
        C[:, 100] = C[:, 99]
        C = C.cuda()
        thr = 0.75
        for bf16 in (True, False):
            rows_lv = lv.clone()
            inv, lvb = _cuda.row_prep(rows_lv, peak_clip=False,
                                      bf16_copy=bf16)
            got = _cuda.argmax_merge(*_cuda.sims_argmax(
                lvb if bf16 else rows_lv, inv, C), thr)
            want = blocked_assign_plain(lv, inv, C, thr, mxu_bf16=bf16)
            check(torch.equal(got[0], want[0]) and torch.equal(
                got[1].view(torch.int32), want[1].view(torch.int32)),
                f"tail partition rows={rows} SP={SP} KP={KP} bf16={bf16}: "
                f"{int((got[0] != want[0]).sum())} labels differ")
    print("tail partition: the tensor-core and FMA tails bit-equal to "
          "their blocked twin in 4 shapes (ties across block borders, "
          "an odd last block)", flush=True)


def kernel_cases(sy, centers, device, *, peak_evening, n_lv_frames,
                 s_tile_gather, full_mask, label, reps, bf16=True):
    """K2, K1, K1s (``peak_evening='none'`` only) and K3 against their plain
    versions on one system with the given centres; K1 against K3, and K1s
    against K1.  Returns {kernel: {err, ms, plain_ms, bound_ms, bound_by,
    library_ms}} (all but err only when ``reps``)."""
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    from sitator_tpu_torch.ops.kernel_common import kernel_cell

    kcell = kernel_cell(sy["cell"])
    basis = mx.prepare_engine_basis(
        sy["verts"], np.ones_like(sy["verts"], bool), sy["site_pos"],
        sy["cell"], midpoint=MID, steepness=STEEP, cutoff_shape=CUTOFF,
        static_ref=sy["static_ref"], drift_budget=3.0)
    check(basis is not None, f"{label}: basis shares too few vertices")
    basis = mx.basis_from_jax(basis, device)
    mobile = torch.as_tensor(sy["mobile"], device=device)
    static = torch.as_tensor(sy["static"], device=device)
    M, (S, V), K = mobile.shape[1], sy["verts"].shape, len(centers)
    print(f"{label}: B={mobile.shape[0]} M={M} N={static.shape[1]} S={S} "
          f"K={K} s_tile={basis['s_tile']} n_st={basis['n_st']} "
          f"UP={basis['UP']} preshift={basis['preshift']} "
          f"peak={peak_evening} bf16={bf16}", flush=True)
    out = {}

    def timings(key, kernel, plain, work, library_ms):
        if reps:
            b_ms, b_by = bound(*work)
            out[key].update(ms=timed(kernel, reps), plain_ms=timed(plain, 2),
                            bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms)

    a2 = mx._lv_inputs(mobile[:n_lv_frames], static[:n_lv_frames], basis,
                       kcell, midpoint=MID, steepness=STEEP,
                       cutoff_shape=CUTOFF)
    lv_k = mx._mxu_lv_cuda(**a2)
    sync()
    lv_p = mx._mxu_lv_plain(**a2)
    out["K2"] = dict(err=compare_lv(f"{label} K2", lv_k, lv_p))
    del lv_p
    timings("K2", lambda: mx._mxu_lv_cuda(**a2),
            lambda: mx._mxu_lv_plain(**a2), unique_atom_work(a2, M), None)

    # reference margins from the kernel-checked landmark vectors
    lv_all = torch.cat([mx._mxu_lv_cuda(**mx._lv_inputs(
        mobile[i:i + n_lv_frames], static[i:i + n_lv_frames], basis, kcell,
        midpoint=MID, steepness=STEEP, cutoff_shape=CUTOFF))
        for i in range(0, mobile.shape[0], n_lv_frames)])
    margin, top1 = top2_margin(lv_all, centers, peak_evening)
    del lv_all, lv_k

    a1 = mx._assign_inputs(mobile, static, basis, kcell,
                           mx.permute_centers(centers, basis),
                           midpoint=MID, steepness=STEEP, threshold=THR,
                           mxu_bf16=bf16, cutoff_shape=CUTOFF,
                           peak_evening=peak_evening)
    k1 = [x[:, :M] for x in mx._mxu_assign_cuda(**a1)]
    sync()
    p1 = [x[:, :M] for x in mx._mxu_assign_plain(**a1)]
    out["K1"] = dict(err=compare_assign(f"{label} K1", k1, p1, margin, top1,
                                        bf16))
    if reps:
        out["stages"], library = k1_stages(a1, M, reps)
    timings("K1", lambda: mx._mxu_assign_cuda(**a1),
            lambda: mx._mxu_assign_plain(**a1),
            unique_atom_work(a1, M, K), library if reps else None)

    if peak_evening == "none":
        ks = [x[:, :M] for x in mx._mxu_assign_skew_cuda(**a1)]
        sync()
        out["K1s"] = dict(err=compare_assign(f"{label} K1s", ks, p1, margin,
                                             top1, bf16))
        compare_assign(f"{label} K1s vs K1", ks, k1, margin, top1, bf16)
        same = torch.equal(ks[0], k1[0]) and torch.equal(
            ks[1].view(torch.int32), k1[1].view(torch.int32))
        out["K1s"]["bit_equal_k1"] = same
        if bf16:
            from sitator_tpu_torch.ops import _cuda
            KP = a1["cpad"].shape[1]
            nc = _cuda.skew_cluster_size(KP)
            occ = _cuda.skew_occupancy(nc, basis["UP"], basis["s_tile"],
                                       a1["members"][0].shape[2])
            out["K1s"]["cluster"] = dict(occ, size=nc,
                                         passes=-(-KP // (256 * nc)))
            route = (f"tensor-core cluster of {nc} CTAs "
                     f"({-(-KP // (256 * nc))} pass(es), {occ['stages']} "
                     f"stages, {occ['smem']} B of shared memory a CTA, "
                     f"{occ['clusters']} clusters active at once)")
        else:
            route = "f32 FMA kernel"
        print(f"  {label} K1s ({route}) bit-equal to K1: {same}", flush=True)
        timings("K1s", lambda: mx._mxu_assign_skew_cuda(**a1),
                lambda: mx._mxu_assign_plain(**a1),
                unique_atom_work(a1, M, K), library if reps else None)
        del ks
    else:
        # K1s has no two-pass (clip) form: the public wrapper must refuse
        try:
            mx.mxu_assign_blocks(mobile, static, basis, kcell,
                                 mx.permute_centers(centers, basis),
                                 midpoint=MID, steepness=STEEP,
                                 threshold=THR, cutoff_shape=CUTOFF,
                                 peak_evening=peak_evening, skew=True)
        except ValueError as e:
            check("skew" in str(e), f"{label}: skew with clip raised {e!r}")
            print(f"  {label}: skew=True with peak_evening='clip' raises "
                  "ValueError", flush=True)
        else:
            raise SmokeError(f"{label}: mxu_assign_blocks(skew=True, "
                             "peak_evening='clip') did not raise")

    a3 = lp._gather_inputs(mobile, static, sy["verts"],
                           np.ones_like(sy["verts"], bool), kcell,
                           centers, midpoint=MID, steepness=STEEP,
                           threshold=THR, s_tile=s_tile_gather,
                           mxu_bf16=bf16, cutoff_shape=CUTOFF,
                           peak_evening=peak_evening, full_mask=full_mask)
    k3 = [x[:, :M] for x in lp._gather_assign_cuda(**a3)]
    sync()
    p3 = [x[:, :M] for x in lp._gather_assign_plain(**a3)]
    out["K3"] = dict(err=compare_assign(f"{label} K3", k3, p3, margin, top1,
                                        bf16))
    if bf16 and peak_evening == "none":
        k3_routes(a3, label)
    if reps:
        out["k3_stages"], library = k3_stages(a3, M, S, V, reps)
    timings("K3", lambda: lp._gather_assign_cuda(**a3),
            lambda: lp._gather_assign_plain(**a3),
            gather_work(a3, M, S, V, K), library if reps else None)
    compare_assign(f"{label} K1 vs K3", k1, k3, margin, top1, bf16)
    return out


def phase_kernels(device):
    """Every kernel against its plain version: at the bench width with
    bench.py's 1024 random centres (timed) and with site centres (labels
    that mean something), then the clip case (f32 operands, the FMA tail)
    and the triclinic case at n_c = 8.  Returns the timed case's results
    with the largest error of the bench cases."""
    shear = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [-0.1, 0.15, 0.0]])
    tail_partition_cases()
    sy = add_site_centres(bench_system(32, seed=7), device)
    kw = dict(n_lv_frames=4, s_tile_gather=256, full_mask=True)
    res = kernel_cases(sy, sy["random_centres"], device,
                       peak_evening="none", label="bench random centres",
                       reps=5, **kw)
    site = kernel_cases(sy, sy["centers"], device, peak_evening="none",
                        label="bench site centres", reps=0, **kw)
    for k in KERNELS:
        res[k]["err"] = max(res[k]["err"], site[k]["err"])
    res["K1s"]["bit_equal_k1"] = (res["K1s"]["bit_equal_k1"]
                                  and site["K1s"]["bit_equal_k1"])

    # the clip case in f32 similarities: clipping flattens the rows, so
    # most top-2 margins sit inside the bf16 gate; f32 without the clip (the
    # FMA K1s); K1s clusters of 1 (triclinic, 128 centres), 2 (384) and 8
    # CTAs in two passes (2176)
    for label, sy, peak, bf16 in (
            ("clip f32 n_c=8", lattice_system(8, 64, 8, 128, seed=3), "clip",
             False),
            ("f32 K=384 n_c=8", lattice_system(8, 64, 8, 384, seed=4),
             "none", False),
            ("triclinic n_c=8",
             lattice_system(8, 64, 8, 128, seed=5, shear=shear), "none",
             True),
            ("K=384 n_c=8", lattice_system(8, 64, 8, 384, seed=6), "none",
             True),
            ("K=2176 n_c=14", lattice_system(14, 128, 4, 2176, seed=8),
             "none", True)):
        add_site_centres(sy, device)
        kernel_cases(sy, sy["centers"], device, peak_evening=peak,
                     n_lv_frames=8, s_tile_gather=128, full_mask=False,
                     label=label, reps=0, bf16=bf16)
    for name in KERNELS:
        r = res[name]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        print(f"time {name} at the bench width: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {lib}", flush=True)
    return res


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    mx.mxu_assign_blocks.launches = 0
    mx.mxu_assign_blocks.skew_launches = 0
    mx.mxu_landmark_blocks.launches = 0
    lp.fused_assign_blocks.launches = 0


def read_launches():
    """The launch counts by kernel, after a synchronise."""
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    sync()
    return dict(K1=mx.mxu_assign_blocks.launches,
                K2=mx.mxu_landmark_blocks.launches,
                K3=lp.fused_assign_blocks.launches,
                K1s=mx.mxu_assign_blocks.skew_launches)


def phase_slice(device):
    """The main path through the user entry points.  Returns the launch
    counts and the pipeline's frames/s."""
    from sitator_tpu_torch import (JumpAnalysis, LandmarkAnalysis,
                                   SpmdLandmarkPipeline)
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64

    run = add_site_centres(bench_system(8 * 32, seed=11), device)
    small = lattice_system(5, 12, 24, 64, seed=9)
    no_share = add_site_centres(no_sharing_system(seed=13), device)
    sn_bench = site_network(run)
    frames = frames_of(run)
    n_ions = run["mobile"].shape[1]
    reset_launches()

    # LandmarkAnalysis (K2) -> JumpAnalysis on 16 frames at the bench width
    t0 = time.perf_counter()
    la = LandmarkAnalysis(cutoff_midpoint=MID, cutoff_steepness=STEEP,
                          cutoff_shape=CUTOFF, verbose=False,
                          clustering_params={"k_max": 1024}, device=device)
    st = la.run(sn_bench, frames[:16])
    ja = JumpAnalysis(verbose=False, device=device)
    ja.run(st)
    sync()
    sn_out = st.site_network
    check(st.traj.shape == (16, n_ions), f"traj shape {st.traj.shape}")
    check(np.isfinite(st.confidences).all(), "non-finite confidences")
    check(np.isfinite(la.landmark_vectors).all(), "non-finite lv")
    check(np.isclose(sn_out.occupancies.sum() * 16, (st.traj >= 0).sum()),
          "occupancies disagree with the labels")
    print(f"LandmarkAnalysis + JumpAnalysis (16 bench frames): "
          f"{sn_out.n_sites} sites, {100 * np.mean(st.traj < 0):.2f}% "
          f"unassigned, {ja.n_jumps} jumps, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the same engine against its dense route on a small input
    kw = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, verbose=False, device=device)
    la_k, la_d = LandmarkAnalysis(**kw), LandmarkAnalysis(use_fused=False,
                                                          **kw)
    sn_small = site_network(small)
    st_k = la_k.run(sn_small, frames_of(small))
    st_d = la_d.run(sn_small, frames_of(small))
    err = float(np.abs(la_k.landmark_vectors - la_d.landmark_vectors).max())
    agree = float(np.mean(st_k.traj == st_d.traj))
    check(err <= 5e-5, f"small LandmarkAnalysis: lv error {err:.3g}")
    check(st_k.site_network.n_sites == st_d.site_network.n_sites
          and agree >= 0.995, "small LandmarkAnalysis: kernel and dense "
          f"routes disagree ({agree:.4f} of labels)")
    print(f"small LandmarkAnalysis: K2 route vs dense route: "
          f"{st_k.site_network.n_sites} sites both, labels agree on "
          f"{100 * agree:.2f}%, lv err {err:.3g}", flush=True)

    # SpmdLandmarkPipeline through K1 at the bench width, timed
    pipe = SpmdLandmarkPipeline(
        sn_bench, run["centers"], np.ones(len(run["centers"]), bool),
        cutoff_midpoint=MID, cutoff_steepness=STEEP, cutoff_shape=CUTOFF,
        assignment_threshold=THR, device=device)
    check(pipe.route == "mxu", f"bench pipeline route {pipe.route}")
    blocks = [frames[i:i + 32] for i in range(0, len(frames), 32)]
    one_pass(pipe, blocks)                        # warm-up
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = one_pass(pipe, blocks)
        reps.append(len(frames) / (time.perf_counter() - t0))
    fps = float(np.median(reps))
    labels = np.concatenate([o[0] for o in out])
    check(np.isfinite(np.concatenate([o[1] for o in out])).all(),
          "pipeline: non-finite confidences")
    K = len(run["centers"])
    want, _, _ = _jump_stats_block_int64(
        labels, K, np.full(n_ions, -1, np.int64), np.zeros(n_ions, np.int64),
        "persist")
    n_ij = sum(o[2]["n_ij"] for o in out)
    check(np.array_equal(n_ij, want["n_ij"]) and np.array_equal(
        sum(o[2]["occ_counts"] for o in out), want["occ_counts"]),
        "pipeline: chained jump statistics differ from the int64 oracle")
    check(n_ij.sum() > 0, "pipeline: no jumps")
    print(f"pipeline (K1, 8 x 32 bench frames, carry): {fps:.1f} frames/s, "
          f"median of 5 [{min(reps):.1f}, {max(reps):.1f}]; "
          f"{100 * np.mean(labels >= 0):.2f}% assigned; {int(n_ij.sum())} "
          "jumps == int64 oracle", flush=True)
    profile_pass(pipe, blocks)

    # the pipeline on a basis without vertex sharing: K3, held to the dense
    # route on the same frames
    sn_ns = site_network(no_share)
    ctr = no_share["centers"]
    pk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, assignment_threshold=THR, device=device)
    pipe_g = SpmdLandmarkPipeline(sn_ns, ctr, np.ones(len(ctr), bool), **pk)
    pipe_d = SpmdLandmarkPipeline(sn_ns, ctr, np.ones(len(ctr), bool),
                                  use_fused=False, **pk)
    check(pipe_g.route == "gather", f"no-sharing route {pipe_g.route}")
    fr = frames_of(no_share)
    got = one_pass(pipe_g, (fr[:8], fr[8:]))
    ref = one_pass(pipe_d, (fr[:8], fr[8:]))
    gl, rl = (np.concatenate([o[0] for o in x]) for x in (got, ref))
    gc, rc = (np.concatenate([o[1] for o in x]) for x in (got, ref))
    check(np.isfinite(gc).all(), "K3 pipeline: non-finite confidences")
    cerr = float(np.abs(gc - rc).max())
    agree = float(np.mean(gl == rl))
    check(cerr <= CONF_ATOL[True], f"K3 pipeline: conf error {cerr:.3g}")
    check(agree >= 0.99, f"K3 pipeline vs dense: labels agree on {agree:.4f}")
    print(f"pipeline (K3, no vertex sharing): labels agree with the dense "
          f"route on {100 * agree:.2f}% ({100 * np.mean(gl >= 0):.1f}% "
          f"assigned), max conf err {cerr:.3g}", flush=True)

    launches = read_launches()
    print(f"launches on the main path: {launches}", flush=True)
    for k in ("K1", "K2", "K3"):
        check(launches[k] > 0, f"{k} was not launched on the main path")
    return launches, fps


def phase_skew(device):
    """The K1s path: ``mxu_assign_blocks`` with ``skew=True`` and with
    ``skew=False`` through the public wrapper over 8 bench blocks of 32
    frames (what ``tools/ab_skew.py`` does on the TPU), labels held equal
    outside the margin gate and confidences within tolerance.  Returns the
    launch counts."""
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops.kernel_common import kernel_cell

    sy = add_site_centres(bench_system(8 * 32, seed=17), device)
    basis = mx.prepare_engine_basis(
        sy["verts"], np.ones_like(sy["verts"], bool), sy["site_pos"],
        sy["cell"], midpoint=MID, steepness=STEEP, cutoff_shape=CUTOFF,
        static_ref=sy["static_ref"], drift_budget=1.0)
    basis = mx.basis_from_jax(basis, device)
    centers = torch.as_tensor(mx.permute_centers(sy["centers"], basis),
                              device=device)
    kcell = kernel_cell(sy["cell"])
    kw = dict(midpoint=MID, steepness=STEEP, threshold=THR,
              cutoff_shape=CUTOFF)
    blocks = [(torch.as_tensor(sy["mobile"][lo:lo + 32], device=device),
               torch.as_tensor(sy["static"][lo:lo + 32], device=device))
              for lo in range(0, 8 * 32, 32)]
    margins = [top2_margin(mx._mxu_lv_cuda(**mx._lv_inputs(
        mobile, static, basis, kcell, midpoint=MID, steepness=STEEP,
        cutoff_shape=CUTOFF)), sy["centers"], "none")
        for mobile, static in blocks]
    reset_launches()
    runs = [(mx.mxu_assign_blocks(mobile, static, basis, kcell, centers,
                                  skew=False, **kw),
             mx.mxu_assign_blocks(mobile, static, basis, kcell, centers,
                                  skew=True, **kw))
            for mobile, static in blocks]
    launches = read_launches()
    cat = [[torch.cat([r[i][j] for r in runs]) for j in (0, 1)]
           for i in (0, 1)]
    margin, top1 = (np.concatenate([m[i] for m in margins]) for i in (0, 1))
    err = compare_assign("K1s path (8 x 32 bench frames through "
                         "mxu_assign_blocks, skew vs not)", cat[1], cat[0],
                         margin, top1, True)
    print(f"K1s path: {100 * float((cat[1][0] >= 0).float().mean()):.2f}% "
          f"assigned; max conf difference {err:.3g}; launches {launches}",
          flush=True)
    for k in ("K1", "K1s"):
        check(launches[k] > 0, f"{k} was not launched on the K1s path")
    return launches


def phase_gather(device):
    """K3 on its own main path at the bench width: the bench's sites with
    no vertex shared (:func:`no_sharing_bench_system`).
    ``SpmdLandmarkPipeline`` (route 'gather') over 8 x 32 frames with the
    carry, timed, its labels held to the dense route outside the margin
    gate and its statistics to the int64 oracle; then
    ``StreamingLandmarkAnalysis`` fit (the dense route on an 8-frame
    subsample) and pass 2 (route 'gather') over 1024 frames in 256-frame
    blocks, timed, held to the oracle and bit for bit to the pipeline.
    Returns the launch counts and both frames/s."""
    import tempfile
    import torch
    from sitator_tpu_torch import (SpmdLandmarkPipeline,
                                   StreamingLandmarkAnalysis)
    from sitator_tpu_torch.io import ArrayTrajectory
    from sitator_tpu_torch.ops import landmark_pallas as lp
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
    from sitator_tpu_torch.ops.kernel_common import kernel_cell

    t0 = time.perf_counter()
    sy = add_site_centres(no_sharing_bench_system(1024, seed=23), device)
    sn = site_network(sy)
    frames = frames_of(sy)
    n_frames, n_ions = len(frames), sy["mobile"].shape[1]
    K = len(sy["centers"])
    print(f"no-sharing bench system: {len(sy['verts'])} sites x 4 own "
          f"vertices, {len(sy['static_ref'])} static atoms, {n_ions} ions, "
          f"{K} centres, {n_frames} frames ({time.perf_counter() - t0:.1f} "
          "s to make)", flush=True)
    pk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, assignment_threshold=THR, device=device)
    reset_launches()
    pipe = SpmdLandmarkPipeline(sn, sy["centers"], np.ones(K, bool), **pk)
    check(pipe.route == "gather", f"no-sharing bench route {pipe.route}")
    run = frames[:256]
    blocks = [run[i:i + 32] for i in range(0, len(run), 32)]
    one_pass(pipe, blocks)                        # warm-up
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = one_pass(pipe, blocks)
        reps.append(len(run) / (time.perf_counter() - t0))
    fps = float(np.median(reps))
    labels = np.concatenate([o[0] for o in out])
    confs = np.concatenate([o[1] for o in out])
    want, _, _ = _jump_stats_block_int64(
        labels, K, np.full(n_ions, -1, np.int64), np.zeros(n_ions, np.int64),
        "persist")
    n_ij = sum(o[2]["n_ij"] for o in out)
    check(np.array_equal(n_ij, want["n_ij"]) and np.array_equal(
        sum(o[2]["occ_counts"] for o in out), want["occ_counts"]),
        "K3 pipeline: chained jump statistics differ from the int64 oracle")
    check(n_ij.sum() > 0, "K3 pipeline: no jumps")
    profile_pass(pipe, blocks)

    # the dense route on the same frames, in blocks of 8 (its (frames x
    # ions x atoms x 3) intermediates), and the margins from K3's f32 lv
    pipe_d = SpmdLandmarkPipeline(sn, sy["centers"], np.ones(K, bool),
                                  use_fused=False, **pk)
    ref = one_pass(pipe_d, [run[i:i + 8] for i in range(0, len(run), 8)])
    kcell = kernel_cell(sy["cell"])
    margins = []
    for lo in range(0, len(run), 32):
        a = lp._gather_inputs(
            torch.as_tensor(sy["mobile"][lo:lo + 32], device=device),
            torch.as_tensor(sy["static"][lo:lo + 32], device=device),
            sy["verts"], np.ones_like(sy["verts"], bool), kcell,
            sy["centers"], midpoint=MID, steepness=STEEP, threshold=THR,
            s_tile=256, cutoff_shape=CUTOFF, full_mask=True)
        lv = gather_rows(a, False).view(a["mob"].shape[0], -1,
                                        a["vp"].shape[3])
        margins.append(top2_margin(lv[:, :n_ions, :len(sy["verts"])],
                                   sy["centers"], "none"))
        del lv, a
    margin, top1 = (np.concatenate([m[i] for m in margins]) for i in (0, 1))
    compare_assign(
        "K3 pipeline vs the dense route (256 bench frames, no vertex "
        "sharing)", [torch.as_tensor(labels), torch.as_tensor(confs)],
        [torch.as_tensor(np.concatenate([o[i] for o in ref]))
         for i in (0, 1)], margin, top1, True)
    print(f"pipeline (K3, 8 x 32 bench frames without vertex sharing, "
          f"carry): {fps:.1f} frames/s, median of 3 [{min(reps):.1f}, "
          f"{max(reps):.1f}]; {100 * np.mean(labels >= 0):.2f}% assigned; "
          f"{int(n_ij.sum())} jumps == int64 oracle", flush=True)

    kw = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, block_frames=256,
              fit_max_samples=8 * n_ions,
              clustering_params={"k_max": 1024}, verbose=False,
              device=device)
    with tempfile.TemporaryDirectory() as tmp:
        sla = StreamingLandmarkAnalysis(
            store_labels=str(Path(tmp) / "labels.npy"), **kw)
        t0 = time.perf_counter()
        centers = sla.fit_centers(sn, ArrayTrajectory(frames))
        sync()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = sla.run(sn, frames, centers=centers)
        sync()
        t_run = time.perf_counter() - t0
        check(sla.route_ == "gather", f"streaming route {sla.route_}")
        slabels = np.array(np.load(Path(tmp) / "labels.npy"))
    sfps = n_frames / t_run
    Ks = len(centers)
    want, _, _ = _jump_stats_block_int64(
        slabels, Ks, np.full(n_ions, -1, np.int64),
        np.zeros(n_ions, np.int64), "persist")
    check(np.array_equal(res.n_ij, want["n_ij"]),
          "K3 streaming n_ij differs from the int64 oracle on its labels")
    check(res.n_ij.sum() > 0, "K3 streaming: no jumps")
    pipe_s = SpmdLandmarkPipeline(sn, centers, np.ones(Ks, bool),
                                  static_drift_budget=1.0, **pk)
    got = one_pass(pipe_s, [frames[i:i + 256]
                            for i in range(0, n_frames, 256)])
    n_diff = int((np.concatenate([o[0] for o in got]) != slabels).sum())
    check(n_diff == 0, f"K3 streaming labels differ from the pipeline's on "
          f"{n_diff} rows")
    launches = read_launches()
    print(f"streaming (K3 pass 2, {n_frames} bench frames without vertex "
          f"sharing in 256-frame blocks): fit {Ks} centres in {t_fit:.2f} s; "
          f"pass 2 {sfps:.1f} frames/s ({t_run:.3f} s); "
          f"{100 * np.mean(slabels >= 0):.2f}% assigned, "
          f"{int(res.n_ij.sum())} jumps == int64 oracle, labels == "
          f"SpmdLandmarkPipeline on all {slabels.size} rows; launches "
          f"{launches}", flush=True)
    check(launches["K3"] > 0, "K3 was not launched on its path")
    return launches, fps, sfps


def phase_streaming(device):
    """``StreamingLandmarkAnalysis`` at the bench width: fit (K2) and pass 2
    (K1) over 1024 frames in 256-frame blocks.  Returns the launch counts
    and pass 2's frames/s."""
    import tempfile
    from sitator_tpu_torch import SpmdLandmarkPipeline
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    from sitator_tpu_torch.io import ArrayTrajectory
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64

    sy = add_site_centres(bench_system(1024, seed=19), device)
    sn = site_network(sy)
    frames = frames_of(sy)
    n_frames, n_ions = len(frames), sy["mobile"].shape[1]
    kw = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, block_frames=256,
              clustering_params={"k_max": 1024}, verbose=False,
              device=device)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        sla = StreamingLandmarkAnalysis(
            store_labels=str(Path(tmp) / "labels.npy"), **kw)
        t0 = time.perf_counter()
        centers = sla.fit_centers(sn, ArrayTrajectory(frames))
        sync()
        t_fit = time.perf_counter() - t0
        fit_launches = read_launches()
        check(fit_launches["K2"] > 0, "fit_centers did not launch K2")
        t0 = time.perf_counter()
        out = sla.run(sn, frames, centers=centers)
        sync()
        t_run = time.perf_counter() - t0
        launches = read_launches()
        check(sla.route_ == "mxu", f"streaming route {sla.route_}")
        check(launches["K1"] > 0, "streaming run did not launch K1")
        labels = np.array(np.load(Path(tmp) / "labels.npy"))
        phases = dict(sla.phase_times_)
    fps = n_frames / t_run
    K = len(centers)
    print(f"streaming fit (K2): {K} centres from the subsample in "
          f"{t_fit:.2f} s; launches {fit_launches}", flush=True)
    print(f"streaming pass 2 (K1, {n_frames} bench frames in 256-frame "
          f"blocks, labels spilled): {fps:.1f} frames/s ({t_run:.3f} s); "
          f"launches after fit + run {launches}", flush=True)
    print("streaming pass 2 phase_times_ (s): " + json.dumps(
        {k: round(v, 4) for k, v in phases.items()}), flush=True)

    check(labels.shape == (n_frames, n_ions), f"labels {labels.shape}")
    check(np.isfinite(out.occupancies).all()
          and np.isfinite(out.centers).all(), "non-finite streaming result")
    want, _, _ = _jump_stats_block_int64(
        labels, K, np.full(n_ions, -1, np.int64), np.zeros(n_ions, np.int64),
        "persist")
    check(np.array_equal(out.n_ij, want["n_ij"]),
          "streaming n_ij differs from the int64 oracle on its labels")
    check(out.n_ij.sum() > 0, "streaming: no jumps")
    check(np.array_equal(out.occupancies,
                         np.bincount(labels[labels >= 0], minlength=K)
                         / n_frames),
          "streaming occupancies differ from the label counts")

    pipe = SpmdLandmarkPipeline(
        sn, centers, np.ones(K, bool), cutoff_midpoint=MID,
        cutoff_steepness=STEEP, cutoff_shape=CUTOFF,
        assignment_threshold=THR, static_drift_budget=1.0, device=device)
    check(pipe.route == "mxu", f"pipeline route {pipe.route}")
    got = one_pass(pipe, [frames[i:i + 256] for i in range(0, n_frames,
                                                           256)])
    lab_pipe = np.concatenate([o[0] for o in got])
    n_diff = int((lab_pipe != labels).sum())
    check(n_diff == 0, f"streaming labels differ from the pipeline's on "
          f"{n_diff} rows")

    again = StreamingLandmarkAnalysis(**kw).run(sn, frames, centers=centers)
    sync()
    check(np.array_equal(again.n_ij, out.n_ij)
          and np.array_equal(again.occupancies, out.occupancies)
          and np.allclose(again.centers, out.centers, atol=1e-6),
          "streaming run without store_labels differs")
    print(f"streaming: {100 * np.mean(labels >= 0):.2f}% assigned, "
          f"{int(out.n_ij.sum())} jumps == int64 oracle; labels == "
          f"SpmdLandmarkPipeline on all {labels.size} rows; the run without "
          f"store_labels gives the same statistics; launches with the "
          f"checks {read_launches()}", flush=True)
    return launches, fps


def one_pass(pipe, blocks):
    """Run consecutive frame blocks through a pipeline, chaining the jump
    carry.  Returns [(labels, confs, stats)] per block."""
    carry, out = None, []
    for blk in blocks:
        labels, confs, stats = pipe.run_block(blk, carry)
        carry = (stats["last_sites"], stats["last_res"])
        out.append((labels, confs, stats))
    return out


def profile_pass(pipe, blocks):
    """One pass of ``blocks`` through ``pipe`` under ``torch.profiler``:
    the wall time, the device's kernels and copies by name (the 8 largest)
    and their sum against the wall, all per block.  The profiler's own
    overhead is in the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass(pipe, blocks)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    n = len(blocks)
    dev = sum(t for _, t in ops)
    print(f"profile (one pass of {n} blocks under torch.profiler), per "
          f"block: wall {wall / n:.2f} ms, device kernels and copies "
          f"{dev / n:.2f} ms ({100 * dev / wall:.1f}% of the wall); by "
          "name: " + "; ".join(f"{k[:60]} {t / n:.3f}"
                               for k, t in ops[:8]), flush=True)


def no_sharing_bench_system(n_frames, seed):
    """The bench scale without vertex sharing: each of the bench's 21^3 =
    9261 simple-cubic sites is the centre of a tetrahedron of its own 4
    static atoms (37,044 static atoms); 739 ions hop among 1024 centred
    sites."""
    import bench
    rng = np.random.default_rng(seed)
    n_c, a = bench.N_CELLS, bench.A_LAT
    g = np.stack(np.meshgrid(*(np.arange(n_c),) * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    cell = np.eye(3) * a * n_c
    sites = (g + 0.5) * a
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 1.0
    host = (sites[:, None, :] + tet[None]).reshape(-1, 3)
    verts = np.arange(len(host), dtype=np.int32).reshape(len(sites), 4)
    return hopping(rng, cell, host, verts, sites, bench.N_IONS, n_frames,
                   bench.K_CENTERS, 0.01, sigma=0.25)


def no_sharing_system(seed):
    """48 sites on a 4 x 4 x 3 grid, each a tetrahedron of its own 4 static
    atoms (no vertex is shared); 24 ions hopping among them, 16 frames."""
    rng = np.random.default_rng(seed)
    a = 5.0
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    cell = np.diag([4 * a, 4 * a, 3 * a])
    sites = (g + 0.5) * a
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 1.2
    host = (sites[:, None, :] + tet[None]).reshape(-1, 3)
    verts = np.arange(len(host), dtype=np.int32).reshape(len(sites), 4)
    return hopping(rng, cell, host, verts, sites, 24, 16, len(sites), 0.05,
                   sigma=0.3)


KERNELS = {
    "K1": dict(name="K1 unique-atom assign (lv_tile + assign_tail with "
                    "sims_wgmma)",
               source="sitator_tpu_torch/csrc/lv_tile.cu",
               also=["sitator_tpu_torch/csrc/assign_tail.cu",
                     "sitator_tpu_torch/csrc/sims_wgmma.cu"],
               replaces="sitator_tpu/ops/landmark_mxu.py:419"),
    "K2": dict(name="K2 unique-atom landmark vectors (lv_tile)",
               source="sitator_tpu_torch/csrc/lv_tile.cu",
               replaces="sitator_tpu/ops/landmark_mxu.py:667"),
    "K3": dict(name="K3 gather assign (lv_gather with the norm and bf16 "
                    "copy, sims_wgmma, merge; f32 or clip: lv_gather + "
                    "assign_tail)",
               source="sitator_tpu_torch/csrc/lv_gather.cu",
               also=["sitator_tpu_torch/csrc/sims_wgmma.cu",
                     "sitator_tpu_torch/csrc/assign_tail.cu"],
               replaces="sitator_tpu/ops/landmark_pallas.py:82"),
    "K1s": dict(name="K1s skewed unique-atom assign (assign_skew_wgmma: a "
                     "cluster splitting the centres, wgmma, the lv on chip; "
                     "f32: assign_skew)",
                source="sitator_tpu_torch/csrc/assign_skew_wgmma.cu",
                also=["sitator_tpu_torch/csrc/assign_skew.cu",
                      "sitator_tpu_torch/csrc/hopper_common.cuh"],
                replaces="sitator_tpu/ops/landmark_mxu.py:473"),
}


def main():
    if not (ROOT / "sitator_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "bench.py").is_file():
        print("chip_smoke: run from the root of a repository checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a GPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    res = phase_kernels("cuda")
    paths = {}
    paths["slice"], fps = phase_slice("cuda")
    paths["K1s"] = phase_skew("cuda")
    paths["streaming"], stream_fps = phase_streaming("cuda")
    paths["gather"], gather_fps, gather_stream_fps = phase_gather("cuda")
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    check(not any(m == "sitator_tpu" or m.startswith("sitator_tpu.")
                  for m in sys.modules), "sitator_tpu was imported")
    kernels = []
    for key, meta in KERNELS.items():
        r = res[key]
        n = sum(p[key] for p in paths.values())
        check(n > 0, f"{key} was launched on no path")
        extra = {k: r[k] for k in ("bit_equal_k1", "cluster") if k in r}
        kernels.append(dict(meta, route="cuda", launches=n,
                            max_abs_err=r["err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], **extra))
    print(f"pipeline frames/s: K1 {fps:.1f}, K3 {gather_fps:.1f}; streaming "
          f"pass 2 frames/s: K1 {stream_fps:.1f}, K3 {gather_stream_fps:.1f}; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
