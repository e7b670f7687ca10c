#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sitator_tpu_torch``) once on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

``python3 chip_smoke.py cards`` runs only phases 1, 2 and 6 (the context)
and the real-card mesh of phase 12, for a machine with several cards;
``python3 chip_smoke.py examples`` only phases 1, 2 and 11.

Phases; any failure exits non-zero before the result lines:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA and
   ``nvcc`` versions, and which of ``sklearn``, ``tensorstore``,
   ``networkx``, ``h5py``, ``matplotlib``, ``ase`` and ``tqdm`` the machine
   has (``importlib.util.find_spec``); then (``phase_zarr_layouts``, after the build, without arguments
   only) whether ``libz.so.1`` and ``libzstd.so.1`` load and ``bz2`` and
   ``lzma`` import, the Blosc cnames decoded and whether a ``libsnappy``
   is there (never loaded), and every store of
   ``tests/data/torch_zarr_layouts/`` (zarr v2, zarr v3 and n5 with every
   codec tensorstore writes, Blosc-snappy too, written by it) read by the
   port bit-equal to its ``.npy``; then (``phase_h5_layouts``) whether the
   HDF5 codec is built and ``libz.so.1`` loads, whether a ``libsz`` or
   ``libaec`` is there (never loaded), and every layout of
   ``tests/data/torch_h5_layouts/`` (every libver, storage layout, chunk
   index and filter h5py writes, n-bit and szip included, virtual
   datasets, external links and storage, shared messages; written by it)
   read through ``H5Trajectory`` on the port's own reader, not h5py,
   bit-equal to its ``.npy``, the plugin filters and the compound type
   refused by name; a layout the machine cannot open fails the run;
2. build: compiles ``sitator_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``build/`` (skipped when a library for these sources is there), prints
   each kernel's registers and spills from ``ptxas``, and counts the
   tensor-core (``HGMMA``) instructions of each kernel in the library's
   SASS (fails when ``sims_wgmma`` or the cluster K1s has none);
3. the tail's partition: the tensor-core and the FMA similarity kernels
   with their per-block arg-max and the merge, bit for bit against their
   plain twin on exact (dyadic) inputs with ties across block borders;
   then every kernel against its plain PyTorch version on the same inputs
   on the card, at the bench width of
   ``sitator_tpu_torch/tools/bench_config.py`` (9261 static + 739
   mobile atoms, 9261 landmarks x 8 vertices, 1024 centres) with its
   random centres (a timing-only case: every row is inside the margin
   gate, so only confidences are compared and the output says so; timed,
   each stage of K1 and of K3 timed alone, the
   bound of each kernel and stage reckoned from these inputs, and the bf16
   ``torch.matmul`` of the similarity product timed as the library
   yardstick) and with site centres (the label check: it must leave rows
   outside the gate); then at reduced widths a
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
   unit landmark vectors of an ion on each of them: under the bench's
   random centres every similarity is far below the threshold, every label
   is -1 and no jump would be recorded, at the same work per frame;
5. the K1s path: ``mxu_assign_blocks(skew=True)`` against ``skew=False``
   over 8 bench blocks through the public wrapper, by the A/B of
   ``sitator_tpu_torch/tools/ab_skew.py`` on the site-centre system,
   counters reset first and read after; then the chip-measurement tools
   (``phase_bench``), counters read by difference: ``tools/bench.py``'s
   ``main`` (its JSON line: K1 over 8 x 32 bench frames with the
   prefix-form jump statistics, 5 timed reps, the NumPy baseline, the
   share of the card's bf16 peak), ``gpu_fps`` in ``fused`` (K3) and
   ``xla`` (dense) mode with the same checksum, each mode's host
   synchronisations and host-to-device copies in one timed rep (fewer
   copies than blocks), the step on site centres (the modes' labels equal
   outside the margin gate, ``n_ij`` equal to the int64 oracle),
   ``ab_s_tile`` and ``ab_skew`` at their defaults
   and ``validate_preshift_streaming`` (K2 in the fit, K1 in pass 2,
   against the dense route);
6. ``StreamingLandmarkAnalysis`` at the bench width over 1024 frames:
   ``fit_centers`` (K2) then ``run`` (K1) in 256-frame blocks with the labels
   spilled to a memmap, timed; its statistics against the int64 oracle on
   the spilled labels, its labels bit for bit against
   ``SpmdLandmarkPipeline`` on the same frames and centres, and the run
   again without the memmap, counters reset first and read after; then the
   north-star tool's path (``sitator_tpu_torch.tools.northstar_run``,
   ``phase_northstar``), counters reset first and read after: a pool of 4
   blocks of 512 frames generated on the card, ``fit_centers`` (K2) on one
   of them, and pass 2 (K1) over 6 blocks through its ``CycleReader``, so
   that the pool wraps, from the card and from the same pool as host
   arrays: labels periodic, the two runs equal (labels and integer tallies
   exactly, float sums within 1e-12 relative), the host int64 recount
   equal to the engine, 12 K1 launches, and no block of the card's pool
   staged through host memory;
7. the seed → stream → merge → network path at the bench width (K2 in
   ``fit_centers``, K1 in pass 2), counters reset first and read after:
   ``StreamingLandmarkAnalysis`` at its shipped defaults (the run-ahead
   dispatcher, ``pipeline_depth=2``) against ``pipeline_depth=0`` on the
   same centres over 1024 frames (runs in the order 2, 0, 0, 2; label
   memmaps and every integer statistic equal, float attributes within
   1e-9, tallies equal to the int64 oracle; frames/s and ``phase_times_``
   of both printed), the count of host synchronisations PyTorch reports
   for a depth-2 run (it must not grow with the number of blocks), one
   pass at each depth under ``torch.profiler``, a short run with two
   static atoms exchanged inside the second of four blocks
   (``dynamic_lattice_mapping``: depth 2 equals depth 0 and the unswapped
   run, the permutation included, after one rollback), the accumulator
   copy taken before each optimistic fold; ``merge_network`` on the streamed result
   and ``DiffusionPathwayAnalysis`` on the merged network;
   ``ConductionBottleneckAnalysis`` on the merged network (its Brandes,
   no networkx) held to a plain-Python float64 Brandes in the same process
   (betweenness within 1e-9; base dimension, candidates, removal
   dimensions and critical sites equal); Markov
   clustering on the card against ``device="cpu"`` (equal partitions,
   converged matrices within 1e-5; iterations and time printed); a classic
   run ``LandmarkAnalysis`` → ``JumpAnalysis`` → ``MergeSitesByDynamics`` →
   ``RemoveUnoccupiedSites`` → ``DiffusionPathwayAnalysis``; the mergers
   with their distance guard on, on an engineered over-split copy of the
   streamed result (64 sites given a near-duplicate centre that their ions
   flicker onto): ``MergeSitesByDynamics`` and ``merge_network`` must give
   the streamed labels, hop counts and occupancies back, held to NumPy
   reductions over the expected groups; and ``VoronoiSiteGenerator`` on the
   bench's static lattice (SciPy on the host), its network carried through
   ``prepare_engine_basis`` and K2;
8. descriptors and the other seeds, after the passes, on the same system
   (no hand-written kernel runs here; every check is against a host
   oracle, each sub-step's seconds on its own line):
   ``SiteCentersDescriptor`` on the 1024 streamed sites and
   ``SOAPDescriptorAverages(averages_n=16)`` on the card, equal within 2e-5
   to ``device="cpu"`` on 64 sites, unchanged within 1e-4 under a rotation
   of the whole system, refused with TF32 products on; ``SiteTypeAnalysis``
   (no sklearn) on both descriptor matrices through the elbow and at 4
   types, the card against the CPU on the same matrix (labels equal,
   ``reduced`` within 1e-9 of its scale, ``distances_`` within 1e-9
   relative);
   ``MergeSitesByDescriptors`` on the over-split input against the
   components of the thresholded similarity matrix; ``density_grid`` of the
   ions (total, and every count that differs from a float64 histogram
   traced to an atom within 16 float32 ulp of a bin seam) and
   ``DensitySiteGenerator`` matched to the lattice sites;
   ``bv_mismatch_grid`` against float64 NumPy on 4096 points (within the
   float32 minimum image's rounding over the 84 Å cell), with its peak
   device memory; ``refine_string_paths`` along the pathways' edges, card
   against CPU within 1e-3 Å on every edge after 20 iterations, and the
   default 300 by their last step (the card's and the CPU's step 300 from
   the card's nodes after 299; whole runs part where a node meets a kink of
   the landscape within rounding, and how many did is printed);
9. the transport and kinetics layer, after the passes, on the same system
   (no hand-written kernel; seconds and peak device memory a step):
   ``RDFAnalysis`` ion–ion over 1024 frames, ion–lattice over 64 and with
   27 images over 8, each held to a float64 histogram on the card (counts
   may differ only by pairs within 4 float32 ulp of a bin edge), and
   ion–lattice on the card equal to the CPU's; ``VanHoveAnalysis`` at lags
   1–256 over every origin, its distinct part equal to the CPU's on 6
   origins, its self part a density of the displacements; ρ_q(t) for
   5,000–10,000 modes around the lattice's first reciprocal shell, card
   against CPU within 1e-4 on 64 frames, and S(q) there; the host
   diffusion, Onsager and conductivity engines finite;
   ``KineticMonteCarlo`` with 739 walkers x 10,000 frames on the merged
   network (a 64-frame run's noise drawn again from the same seeded
   generator and replayed on the CPU gives its labels; every transition
   frequency of a row with 1,000 visits within 5 binomial σ of P by the
   binomial tail; no step where P = 0); density barriers along relaxed
   strings on at most 256 edges of the jump graph, finite exactly where
   the profile is positive;
10. the command line (the ``cli`` path) on 256 of the same frames,
   written as extended XYZ (about 97 MB) and repeated to 2048 frames: the
   native decoder's index and decode rates alone (it must build: g++),
   then ``sitator_tpu_torch.cli.main`` in this process with the counters
   reset first and read after: ``info``, ``convert`` to ``.npy`` with its
   sidecar, ``analyze --streaming --out`` at the CLI's defaults (two
   1024-frame blocks) on the ``.npy`` (memmap) and on the XYZ (the native
   decoder on the feeder thread), seeded from the reference lattice
   (``--structure``), so K2 in the fit and K1 in pass 2 on the bench's 9261
   sites; eager ``analyze`` on 64 frames (K2), ``sites``, ``doctor``;
   meanwhile ``python3 -m sitator_tpu_torch analyze --streaming`` in a
   subprocess (exit 0, its summary line).  The networks and labels both
   streamed runs save are held to an engine built directly with the CLI's
   parameters on the decoded frames, its tallies to the int64 oracle; then
   pass 2's frames/s and ``phase_times_`` from memory, memmap and XYZ in
   1024- and 256-frame blocks (each reader twice), and 256 frames in one
   block of 1024 (the CLI's default) against one of 256; then zarr stores
   (``zarr_passes``): the frames twice over (4096) converted by the port's
   ``convert_to_zarr`` to zarr v2 (blosc/LZ4) and v3 (raw) in 256-frame
   chunks and by this script's writers to a zarr v3 sharded store (zstd
   inner chunks, crc32c index) and a zarr v2 Blosc/zstd/bitshuffle store
   (seconds, bytes on disk), each codec's decode alone (MB/s), and the
   streaming fit (K2) and pass 2 (K1) in 16 blocks of 256 from memory,
   memmap and the four stores in turns (frames/s beside the memmap's,
   feeder wait), each run's centres, labels and ``n_ij`` equal to the
   memory run's; then HDF5 files (``h5_passes``): the same 4096 frames
   written by this script's writer contiguous and in chunks of 8 frames
   with shuffle and deflate (seconds, bytes on disk), and read through the
   committed headers of ``tests/data/torch_h5_bench/``: a virtual dataset
   over four ring segments this script writes (one chunked), external
   storage in four raw segments (read from their directory) and an
   external link to the chunked file; each input read whole by the port's
   reader (MB/s), and the fit and pass 2 from memory, memmap and the five
   inputs in turns, as for the zarr stores;
11. the walkthroughs of ``sitator_tpu_torch/examples`` (the 12 scripts of
   ``examples/`` on the port, ``phase_examples``): each runs here on the
   card (``main(["--device", "cuda", ...])``, output captured, counters
   reset before and read after) while the same script runs as a
   ``--device cpu`` subprocess (one thread, four at a time, no card
   visible); every step of every example runs (site typing and the zarr
   store need no library beyond torch, numpy and scipy).  For each:
   seconds on the card and on the CPU, the
   engines' routes, K1, K2, K3 and K1s launches, peak device memory, the
   first launch of K2 and of K1 at the example's shapes (a partly filled
   site tile, ragged vertex lists, ion rows padded) held to its plain
   version on the same inputs on the card, the reference's key lines
   (``tests/test_examples.py``) present, and the card's lines held to the
   CPU's by ``sitator_tpu_torch/examples/_parity.py``: the same words,
   integers equal, floats within one unit of the last printed digit;
   exempt are timings, device names, temporary paths (masked) and the KMC
   closure line.  A difference in the numbers of an example whose labels
   are spilled (``multichip_mesh``) is accepted only when every label that
   differs lies inside the precision gate (``label_gate``).  Every example
   runs; each fault is printed, and the phase fails after the last if any
   was, or if K1 or K2 was not launched;
12. frame sharding (``mesh=``) on the card, counters read by difference:
   virtual meshes of 2 and 4 shards over the card (each shard on its own
   stream) and the one-card ``frame_mesh()``, each against the unmeshed
   run.  ``SpmdLandmarkPipeline`` through K1 over 8 x 32 frames with the
   carry and a 30-frame block on 4 shards, and through K3 on 2 x 32 frames
   without vertex sharing (labels and every jump statistic equal, whether
   the confidences are bit-equal printed, launches == blocks x shards);
   pass 2 through K1 over the 1024 frames in 256-frame blocks at depths 2
   and 0 on 2 and 4 shards (labels, integers equal, floats within 1e-9), a
   lattice exchange on 4 shards (one rollback), the host synchronisations
   of a pass (no more a block on 4 shards); frames/s of both at each mesh
   size, median of 5 in turns; ``graft_entry.dryrun_multichip(4)`` on the
   card; 256 frames at ``block_frames=1024`` against 256 (time and peak
   device memory, equal results); then (``phase_cards``) the mesh on 2 and
   4 real cards, where the machine has them, held to the unmeshed run of
   the same process in the same way (confidences bit-equal), launches
   counted per card (== blocks x the card's shards, by the wrappers'
   ``launches_by_card`` and by the profiler's kernels on each card): the
   pipeline through K1 and K3, pass 2 through K1 at depths 2 and 0, a
   lattice exchange with its rollback, ``LandmarkAnalysis`` on 16 frames,
   a replicated argument written in place between two sharded calls;
   frames/s on 1, 2 and 4 cards against the unmeshed run (median of 5 in
   turns), device time by kernel per card for one pass of each engine;
   then ``LandmarkAnalysis`` (K2), the pipeline and pass 2 (K1) on the
   last card alone (``device="cuda:N"``), held to card 0.  Every step
   runs, a fault is printed as it is found, and the phase fails after the
   last step if any step failed;
13. frame sharding across processes (``phase_multiprocess``): 2 ranks in a
   gloo group on the one card, each a fresh interpreter with a one-shard
   ``frame_mesh``, run the step through K1 over the pipeline's 8 x 32
   frames with the carry (16 frames a rank a block, placed by
   ``shard_frames_local``) and through K3 over 2 x 32 frames of K3's
   system; with two or more cards also an NCCL group, rank r on cuda:r (4
   ranks with four cards).  Every rank's labels, confidences and tallies
   bit-equal to the unmeshed pipeline run here, launches == blocks x
   global shards, frames/s against the unmeshed pipeline; a rank that
   fails, hangs past 300 s or imports jax fails the phase;
14. K3's own path at the bench width: the bench's sites, each with a
   tetrahedron of its own 4 static atoms (no vertex shared, 37,044 static
   atoms): ``SpmdLandmarkPipeline`` (route 'gather', 8 x 32 frames with the
   carry, timed, profiled) held to the dense route and the int64 oracle,
   then ``StreamingLandmarkAnalysis`` fit and pass 2 (route 'gather', 1024
   frames in 256-frame blocks, timed) held to the oracle and to the
   pipeline;
15. one JSON line of per-kernel results, then the ``ok`` line, last.

Label comparisons are gated on the reference's top-2 margin: labels must be
equal wherever the best and second-best cosine similarities (f32, from the
kernel-checked landmark vectors) differ by more than 8e-3 with bf16 operands
(about 2 bf16 ulps near 1) or 1e-5 in f32, and the best one is not within
the confidence tolerance of the threshold.  K1, K3 and K1s sum the bf16
similarity on the tensor cores, the plain versions on the CPU's or the
card's f32 matmul: f32 sums of the same bf16 products in other orders.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

LV_RTOL, LV_ATOL = 1e-4, 1e-6        # f32 sums in another order, then exp
MID, STEEP, THR, CUTOFF = 4.0, 3.0, 0.35, "logistic_r2"   # the bench's
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
    the kernels' padded centre columns included
    (``tools/bench.py::margin_top1``)."""
    import torch
    from sitator_tpu_torch.ops import landmark as lmops
    from sitator_tpu_torch.tools.bench import margin_top1
    c = torch.as_tensor(centers, device=lv.device, dtype=torch.float32)
    lv_n, _ = lmops.normalize_landmark_vectors(lmops.peak_even(
        lv, peak_evening))
    return margin_top1(lv_n, c)


def compare_assign(name, got, want, margin, top1, bf16, labels="check"):
    """Labels equal outside the margin gate; confidences within tolerance
    (both ``tools/bench.py``'s, ``gated`` and ``CONF_TOL``, for bf16 or f32
    operands).  Returns the max confidence error.  ``labels='require'`` fails when the
    gate leaves no row to compare; ``labels='timing'`` marks a case kept for
    its timings, whose rows all sit inside the gate (random centres: every
    similarity is far below the threshold and the top two are close), so
    that only its confidences are compared."""
    from sitator_tpu_torch.tools.bench import CONF_TOL, gated as gate_of
    gl, gc = (np.asarray(x.cpu()) for x in got)
    wl, wc = (np.asarray(x.cpu()) for x in want)
    check(gl.shape == wl.shape == margin.shape,
          f"{name}: shapes {gl.shape} {wl.shape} {margin.shape}")
    check(np.isfinite(gc).all(), f"{name}: non-finite confidences")
    err = float(np.abs(gc - wc).max())
    check(err <= CONF_TOL[bf16], f"{name}: conf error {err:.3g} > "
          f"{CONF_TOL[bf16]}")
    gated = gate_of(margin, top1, bf16)
    bad = np.argwhere((gl != wl) & ~gated)
    check(not len(bad), f"{name}: {len(bad)} labels differ outside the "
          f"margin gate (first at {bad[:1].tolist()})")
    n_open = int((~gated).sum())
    if labels == "timing":
        print(f"  {name}: timing-only case, {n_open} ungated rows of "
              f"{gated.size}: no label is compared here (the site-centre "
              f"case is the label check); max conf err {err:.3g}", flush=True)
        return err
    check(labels != "require" or n_open > 0,
          f"{name}: every row is inside the margin gate, no label compared")
    print(f"  {name}: labels equal on {n_open} ungated rows "
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
    random positive unit rows as in the bench."""
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
    """The bench width of ``bench_config.build_system``: its cell, vertices
    and 1024 random centres, with ions hopping among 1024 centred sites."""
    from sitator_tpu_torch.tools import bench_config as bc
    ref = bc.build_system()
    sy = lattice_system(bc.N_CELLS, bc.N_IONS, n_frames, bc.K_CENTERS,
                        seed=seed, a=bc.A_LAT)
    check(np.array_equal(sy["verts"], ref.verts)
          and np.allclose(sy["cell"], ref.cell), "bench geometry differs")
    sy["random_centres"] = ref.centers
    return sy


def add_site_centres(sy, device):
    """Fitted-like centres: the unit landmark vector of an ion sitting
    exactly on each centred site of the reference lattice
    (``tools/bench.py::site_centers``: K2 on the card, its plain version on
    the CPU)."""
    from sitator_tpu_torch.tools import bench
    sy["centers"] = bench.site_centers(as_bench_system(sy), device)
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

# libraries some of the reference's steps use; the port needs none of them
# (only its exports to networkx, ASE and HDF5 files, its plots and progress
# bars reach for them)
CENSUS = ("sklearn", "tensorstore", "networkx", "h5py", "matplotlib", "ase",
          "tqdm")


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
    import importlib.util
    print("libraries here (importlib.util.find_spec): " + ", ".join(
        f"{lib} {'present' if importlib.util.find_spec(lib) else 'absent'}"
        for lib in CENSUS), flush=True)
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
    the tensor-core product with its per-block arg-max (``sims_argmax``,
    which makes the centres' bf16 copy first, as every call does), the
    merge; and the bf16 ``torch.matmul`` of the same product (the library
    yardstick)."""
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
    pv, pi = _cuda.sims_argmax(lvb, inv, a["cpad"])
    ms = dict(
        lv_tile=timed(lv_tile, reps),
        row_prep=timed(lambda: _cuda.row_prep(rows, peak_clip=False,
                                              bf16_copy=True), reps),
        centers_bf16=timed(lambda: _cuda.centers_bf16(a["cpad"]), reps),
        sims_wgmma=timed(lambda: _cuda.sims_argmax(lvb, inv, a["cpad"]),
                         reps),
        argmax_merge=timed(lambda: _cuda.argmax_merge(pv, pi, THR), reps))
    library = timed(lambda: torch.matmul(lvb, cb.t()), reps)
    R, KP = B * MP, a["cpad"].shape[1]
    bounds = dict(                      # each stage as a function of its own
        lv_tile=bound(*unique_atom_work(a, M)),     # inputs and outputs
        row_prep=bound(6 * R * SP),     # f32 read, bf16 write
        centers_bf16=bound(6 * SP * KP),
        sims_wgmma=bound(2 * R * SP + 4 * SP * KP, 2.0 * R * SP * KP),
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
    the tensor-core product with its per-block arg-max (``sims_argmax``,
    which makes the centres' bf16 copy first, as every call does), the
    merge; and the bf16 ``torch.matmul`` of the same product (the library
    yardstick)."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = a["mob"].shape
    SP = a["vp"].shape[3]
    lvb, inv = gather_rows(a, True)
    cb = _cuda.centers_bf16(a["cpad"])
    pv, pi = _cuda.sims_argmax(lvb, inv, a["cpad"])
    ms = dict(
        lv_gather=timed(lambda: gather_rows(a, True), reps),
        centers_bf16=timed(lambda: _cuda.centers_bf16(a["cpad"]), reps),
        sims_wgmma=timed(lambda: _cuda.sims_argmax(lvb, inv, a["cpad"]),
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
        sims_wgmma=bound(2 * R * SP + 4 * SP * KP, 2.0 * R * SP * KP),
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
                 s_tile_gather, full_mask, label, reps, bf16=True,
                 labels="check"):
    """K2, K1, K1s (``peak_evening='none'`` only) and K3 against their plain
    versions on one system with the given centres; K1 against K3, and K1s
    against K1.  Returns {kernel: {err, ms, plain_ms, bound_ms, bound_by,
    library_ms}} (all but err only when ``reps``).  ``labels`` as in
    :func:`compare_assign`."""
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
                                        bf16, labels))
    if reps:
        out["stages"], library = k1_stages(a1, M, reps)
    timings("K1", lambda: mx._mxu_assign_cuda(**a1),
            lambda: mx._mxu_assign_plain(**a1),
            unique_atom_work(a1, M, K), library if reps else None)

    if peak_evening == "none":
        ks = [x[:, :M] for x in mx._mxu_assign_skew_cuda(**a1)]
        sync()
        out["K1s"] = dict(err=compare_assign(f"{label} K1s", ks, p1, margin,
                                             top1, bf16, labels))
        compare_assign(f"{label} K1s vs K1", ks, k1, margin, top1, bf16,
                       labels)
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
                                        bf16, labels))
    if bf16 and peak_evening == "none":
        k3_routes(a3, label)
    if reps:
        out["k3_stages"], library = k3_stages(a3, M, S, V, reps)
    timings("K3", lambda: lp._gather_assign_cuda(**a3),
            lambda: lp._gather_assign_plain(**a3),
            gather_work(a3, M, S, V, K), library if reps else None)
    compare_assign(f"{label} K1 vs K3", k1, k3, margin, top1, bf16, labels)
    return out


def phase_kernels(device):
    """Every kernel against its plain version: at the bench width with
    the bench's 1024 random centres (timing and confidences only: every row
    is inside the margin gate) and with site centres (the label check; it
    must leave rows outside the gate), then the clip case (f32 operands,
    the FMA tail) and the triclinic case at n_c = 8.  Returns the timed case's results
    with the largest error of the bench cases."""
    shear = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [-0.1, 0.15, 0.0]])
    tail_partition_cases()
    sy = add_site_centres(bench_system(32, seed=7), device)
    kw = dict(n_lv_frames=4, s_tile_gather=256, full_mask=True)
    res = kernel_cases(sy, sy["random_centres"], device,
                       peak_evening="none", label="bench random centres",
                       reps=5, labels="timing", **kw)
    site = kernel_cases(sy, sy["centers"], device, peak_evening="none",
                        label="bench site centres", reps=0,
                        labels="require", **kw)
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


def hop_labels(rng, F, M, S, p_hop, p_unknown):
    """``(F, M)`` int32 labels of ions that hop to a random site with
    probability ``p_hop`` a frame, unknown (-1) with ``p_unknown``."""
    cur = rng.integers(0, S, M)
    out = np.empty((F, M), np.int32)
    for f in range(F):
        cur = np.where(rng.random(M) < p_hop, rng.integers(0, S, M), cur)
        out[f] = np.where(rng.random(M) < p_unknown, -1, cur)
    return out


def phase_jumps(device):
    """The jump-scan kernel (``csrc/jump_fold.cu`` through
    ``ops/jumps.py::jump_fold``) against its plain version (the frame loop,
    ``_jump_scan``) on the card and the host int64 oracle: at the engine's
    shape (1024 frames x 739 ions, 1024 sites, with a carry) under both
    policies, with hops at the benchmark's rate and on every frame; then
    random chained blocks of uneven length (a strided label view among
    them).  Integers must be equal.  Times the kernel a 1024-frame block
    beside its bound and the plain version's time.  Returns the row of the
    kernel table."""
    import torch
    from sitator_tpu_torch.ops import _cuda
    from sitator_tpu_torch.ops import jumps as tj
    dev = torch.device(device)
    rng = np.random.default_rng(22)
    keys = ("n_ij", "lag_sum", "res_sum", "res_cnt")

    def zeros(S):
        return tuple(torch.zeros((S, S) if k in ("n_ij", "lag_sum") else S,
                                 dtype=torch.int64, device=dev)
                     for k in keys)

    def carry_of(M, S):
        last = rng.integers(-1, S, M).astype(np.int64)
        res = np.where(last >= 0, rng.integers(1, 500, M), 0)
        return last, res.astype(np.int64)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(name, tallies, carry, want, last, res):
        for k, t in zip(keys, tallies):
            got = t.cpu().numpy() if torch.is_tensor(t) else t
            check(np.array_equal(got, want[k]), f"jump fold {name}: {k} "
                  "differs")
        check(np.array_equal(carry[0].cpu().numpy(), last)
              and np.array_equal(carry[1].cpu().numpy(), res),
              f"jump fold {name}: the carry differs")

    F, M, S = 1024, 739, 1024
    n0 = tj.jump_fold.launches
    for policy in ("persist", "break"):
        for label, p_hop in (("benchmark rate", 0.003), ("every frame", 1.0)):
            traj = hop_labels(rng, F, M, S, p_hop, 0.003)
            last0, res0 = carry_of(M, S)
            want, last, res = tj._jump_stats_block_int64(
                traj, S, last0.copy(), res0.copy(), policy)
            t_lab, c_in = on_card(traj), (on_card(last0), on_card(res0))
            tallies = zeros(S)
            carry = tj.jump_fold(t_lab, S, c_in, tallies,
                                 unknown_policy=policy)
            sync()
            check(np.array_equal(c_in[0].cpu().numpy(), last0)
                  and np.array_equal(c_in[1].cpu().numpy(), res0),
                  "jump fold: the input carry was written")
            same(f"{policy}, {label}", tallies, carry, want, last, res)
            *plain, p_last, p_res = tj._jump_scan(
                t_lab.long(), S, c_in[0], c_in[1], policy)
            same(f"{policy}, {label}, plain version on the card",
                 [v[:S, :S] if v.dim() == 2 else v[:S] for v in plain],
                 (p_last, p_res), want, last, res)
            print(f"jump fold {F} x {M}, S {S}, carry, {policy}, hops at "
                  f"{label}: {int(want['n_ij'].sum())} jumps, every tally "
                  "and the carry == the plain version on the card == the "
                  "int64 oracle", flush=True)

    n_cases = 0
    for i in range(24):
        policy = ("persist", "break")[i % 2]
        Mi = int(rng.choice([1, 31, 33, 739, 1000]))
        Si = int(rng.choice([2, 64, 1024]))
        tallies = zeros(Si)
        last, res = carry_of(Mi, Si)
        carry = (on_card(last), on_card(res))
        tot = {k: 0 for k in keys}
        for Fi in rng.integers(1, 130, 3):
            traj = hop_labels(rng, int(Fi), Mi, Si, 0.2, 0.2)
            traj[:int(rng.integers(0, Fi))] = -1    # starts inside a gap
            blk, last, res = tj._jump_stats_block_int64(traj, Si, last, res,
                                                        policy)
            tot = {k: tot[k] + blk[k] for k in keys}
            t_lab = on_card(traj)
            if i % 3 == 0:    # a strided view: rows of a wider block
                wide = torch.full((len(traj), Mi + 5), -7,
                                  dtype=torch.int32, device=dev)
                wide[:, :Mi] = t_lab
                t_lab = wide[:, :Mi]
            carry = tj.jump_fold(t_lab, Si, carry, tallies,
                                 unknown_policy=policy)
        same(f"chained case {i} (M {Mi}, S {Si}, {policy})", tallies, carry,
             tot, last, res)
        n_cases += 1
    print(f"jump fold: {n_cases} random chained cases (3 blocks of 1-129 "
          "frames, each starting inside an unknown gap, strided views "
          "among them) == the int64 oracle", flush=True)
    for bad, err in ((torch.zeros((4, M), dtype=torch.int64, device=dev),
                      TypeError),
                     (torch.zeros((4, M + 1), dtype=torch.int32, device=dev),
                      ValueError)):
        raised = False
        try:
            tj.jump_fold(bad, S, (on_card(last0), on_card(res0)), zeros(S))
        except err:
            raised = True
        check(raised, f"jump fold took labels {bad.dtype} {tuple(bad.shape)} "
              f"with a carry of {M}")

    traj = hop_labels(rng, F, M, S, 0.003, 0.003)
    last0, res0 = carry_of(M, S)
    t_lab, c_in = on_card(traj), (on_card(last0), on_card(res0))
    tallies = zeros(S)
    n_jumps = int(tj._jump_stats_block_int64(
        traj, S, last0.copy(), res0.copy(), "persist")[0]["n_ij"].sum())
    ms = timed(lambda: _cuda.jump_fold(t_lab, *c_in, *tallies,
                                       unknown_policy="persist"), 50)
    plain_ms = timed(lambda: tj._jump_scan(t_lab.long(), S, *c_in,
                                           "persist"), 3)
    bound_ms, bound_by = bound(4 * F * M + 32 * M + 32 * n_jumps)
    launches = tj.jump_fold.launches - n0
    print(f"time jump fold a {F}-frame block ({M} ions, {n_jumps} jumps): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); launches here {launches}",
          flush=True)
    return dict(name="jump fold (carried jump scan, int64 atomics at the "
                     "jumps)",
                source="sitator_tpu_torch/csrc/jump_fold.cu",
                replaces="none: the hot-path form of the reference's "
                         "lax.scan, sitator_tpu/ops/jumps.py:99",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from sitator_tpu_torch.ops import jumps as tj
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    mx.mxu_assign_blocks.launches = 0
    mx.mxu_assign_blocks.skew_launches = 0
    mx.mxu_landmark_blocks.launches = 0
    lp.fused_assign_blocks.launches = 0
    tj.jump_fold.launches = 0
    for fn in (mx.mxu_assign_blocks, mx.mxu_landmark_blocks,
               lp.fused_assign_blocks, tj.jump_fold):
        fn.launches_by_card.clear()


def read_launches():
    """The launch counts by kernel, after a synchronise."""
    from sitator_tpu_torch.ops import jumps as tj
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    sync()
    return dict(K1=mx.mxu_assign_blocks.launches,
                K2=mx.mxu_landmark_blocks.launches,
                K3=lp.fused_assign_blocks.launches,
                K1s=mx.mxu_assign_blocks.skew_launches,
                fold=tj.jump_fold.launches)


def read_launches_by_card():
    """K1's, K2's and K3's launches by card index, after every card has
    synchronised."""
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops import landmark_pallas as lp
    sync_cards()
    return dict(K1=dict(mx.mxu_assign_blocks.launches_by_card),
                K2=dict(mx.mxu_landmark_blocks.launches_by_card),
                K3=dict(lp.fused_assign_blocks.launches_by_card))


def phase_slice(device):
    """The main path through the user entry points.  Returns the launch
    counts and the pipeline's frames/s."""
    from sitator_tpu_torch import (JumpAnalysis, LandmarkAnalysis,
                                   SpmdLandmarkPipeline)
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
    from sitator_tpu_torch.tools.bench import CONF_TOL

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
    check(cerr <= CONF_TOL[True], f"K3 pipeline: conf error {cerr:.3g}")
    check(agree >= 0.99, f"K3 pipeline vs dense: labels agree on {agree:.4f}")
    print(f"pipeline (K3, no vertex sharing): labels agree with the dense "
          f"route on {100 * agree:.2f}% ({100 * np.mean(gl >= 0):.1f}% "
          f"assigned), max conf err {cerr:.3g}", flush=True)

    launches = read_launches()
    print(f"launches on the main path: {launches}", flush=True)
    for k in ("K1", "K2", "K3"):
        check(launches[k] > 0, f"{k} was not launched on the main path")
    return launches, fps


def as_bench_system(sy):
    """``sy`` (:func:`hopping`) as the bench tools' system: its cell,
    vertices, centres (the random ones until :func:`add_site_centres`),
    reference lattice, sites and centred sites."""
    from sitator_tpu_torch.tools.bench_config import BenchSystem
    return BenchSystem(cell=sy["cell"], verts=sy["verts"], frames=None,
                       centers=sy.get("centers", sy["random_centres"]),
                       n_static=len(sy["static_ref"]), host=sy["static_ref"],
                       sites=sy["site_pos"], occ=sy["centred"])


def phase_skew(device):
    """The K1s path: the A/B of ``sitator_tpu_torch/tools/ab_skew.py``
    (``mxu_assign_blocks`` with ``skew=False`` and ``skew=True`` over 8
    bench blocks of 32 frames, labels held equal outside the margin gate
    and confidences within tolerance, then 6 timed rounds in turn) on the
    site-centre system, counters reset first and read after.  Returns the
    launch counts."""
    from sitator_tpu_torch.tools import ab_skew, bench

    sy = add_site_centres(bench_system(8 * 32, seed=17), device)
    blocks = bench.device_blocks(sy["static"], sy["mobile"], device)
    reset_launches()
    res = ab_skew.ab(as_bench_system(sy), device, centers=sy["centers"],
                     blocks=blocks)
    launches = read_launches()
    print(f"K1s path (ab_skew, 8 x 32 bench frames, K1 vs K1s): labels "
          f"equal on {res['labels_compared']} ungated rows "
          f"({res['labels_gated']} gated, {res['labels_differ_in_gate']} "
          f"differ there); {100 * res['assigned']:.2f}% assigned; max conf "
          f"difference {res['max_conf_diff']:.3g}; bit-equal "
          f"{res['bitwise_equal']}; frames/s K1 {res['plain_fps']:.1f}, "
          f"K1s {res['skew_fps']:.1f} (ratio {res['ratio']:.4f}); launches "
          f"{launches}", flush=True)
    for k in ("K1", "K1s"):
        check(launches[k] == 7 * len(blocks), f"{k} launched {launches[k]} "
              f"times on the K1s path, not {7 * len(blocks)}")
    return launches


def run_tool(label, module, argv=()):
    """``module.main(argv)`` in this process with its standard output
    captured, then printed: the JSON of its last line (after ``RESULT``
    where the tool prints that) and its seconds.  A non-zero exit fails the
    phase."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(list(argv))
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"{label}: exit code {rc}")
    last = out.strip().splitlines()[-1]
    return json.loads(last.removeprefix("RESULT ")), seconds


def profile_rep(fn):
    """One run of ``fn()`` under ``torch.profiler``: ``(host-to-device
    copies by name with their counts, [(kernel or copy, device ms), ...]
    the largest first, wall ms)``; the profiler's overhead is in the
    wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    h2d = {e.key: e.count for e in events if "HtoD" in e.key}
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.self_device_time_total > 0), key=lambda x: -x[1])
    return h2d, ops, wall


def phase_bench(device):
    """The chip-measurement tools (``sitator_tpu_torch/tools``) through
    their entry points, counters reset first and read after: ``bench.main``
    (K1 over 8 x 32 bench frames, the prefix-form jump statistics, the
    checksum; a warm-up rep and 5 timed reps; the NumPy baseline), then
    ``gpu_fps`` in ``fused`` (K3) and ``xla`` (the dense route) mode on the
    same frames, with equal checksums; each mode's host synchronisations
    and host-to-device copies in one timed rep; the same step on the
    site-centre system, where the three modes' labels must agree outside
    the margin gate and their ``n_ij`` equal the int64 oracle of their
    labels (and each other where the labels agree); then ``ab_s_tile``
    and ``ab_skew`` at their defaults and
    ``validate_preshift_streaming``.  Returns the launch counts and the
    bench's frames/s by mode."""
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
    from sitator_tpu_torch.tools import ab_s_tile, ab_skew, bench, bench_config
    from sitator_tpu_torch.tools import validate_preshift_streaming as vps

    import torch
    n_rep = (1 + bench.N_REPS) * bench.N_BLOCKS
    reset_launches()
    before = read_launches()
    rec, seconds = run_tool("bench", bench)
    got = launches_since(before)
    print(f"bench.main: {seconds:.1f} s; launches {got}", flush=True)
    check(rec["metric"] == bench.METRIC and rec["mode"] == "mxu"
          and rec["backend"] == "cuda", f"bench record {rec}")
    check(rec["mfu"] is not None and 0.0 < rec["mfu"] < 1.0,
          f"bench mfu {rec['mfu']}")
    check("W" in rec["card"] and rec["device"] in rec["card"],
          f"bench card line {rec['card']!r}")
    n_frames = bench.N_BLOCKS * bench.BLOCK
    check(rec["checksum"] == -n_frames * bench_config.N_IONS,
          f"bench checksum {rec['checksum']}: under random centres every "
          "label is -1 and no jump is tallied")
    check(got["K1"] == n_rep, f"bench: K1 launched {got['K1']} times, not "
          f"once a block ({n_rep})")

    system = bench_config.build_system()
    blocks = bench.bench_blocks(system, device)
    fps = {"mxu": rec["value"]}
    for mode, key in (("fused", "K3"), ("xla", None)):
        before = read_launches()
        reps, _, checksum = bench.gpu_fps(system, mode, device,
                                          blocks=blocks)
        got = launches_since(before)
        fps[mode] = float(np.median(reps))
        print(json.dumps({"metric": bench.METRIC, "mode": mode,
                          "value": fps[mode],
                          "spread": [min(reps), max(reps)],
                          "n_reps": len(reps), "checksum": checksum,
                          "launches": got}), flush=True)
        check(checksum == rec["checksum"], f"bench {mode}: checksum "
              f"{checksum}, mxu {rec['checksum']}")
        if key:
            check(got[key] == n_rep, f"bench {mode}: {key} launched "
                  f"{got[key]} times, not once a block ({n_rep})")
    for mode in bench.MODES:
        rep, _, _ = bench.bench_rep(system, mode, device, blocks=blocks)
        rep().item()
        n_sync = syncs_in(lambda: rep().item())
        names, ops, wall = profile_rep(lambda: rep().item())
        n_h2d = sum(names.values())
        dev = sum(t for _, t in ops)
        print(f"bench {mode}, one timed rep of {bench.N_BLOCKS} blocks: "
              f"{n_sync} host synchronisations; {n_h2d} host-to-device "
              f"copies {names}; under torch.profiler wall {wall:.2f} ms, "
              f"device kernels and copies {dev:.2f} ms; by name (ms a "
              "rep): " + "; ".join(f"{k[:60]} {t:.3f}" for k, t in ops[:8]),
              flush=True)
        check(n_h2d < bench.N_BLOCKS, f"bench {mode}: {n_h2d} host-to-"
              "device copies in one rep, at least one a block")

    # the same step on centres at real sites, the ions hopping among them
    sy = add_site_centres(bench_system(n_frames, seed=19), device)
    site_system = as_bench_system(sy)
    site_blocks = bench.device_blocks(sy["static"], sy["mobile"], device)
    K = len(sy["centers"])
    n_ions = sy["mobile"].shape[1]
    margin, top1 = bench.top2_margin(site_system, site_blocks, sy["centers"])
    gate = bench.gated(margin, top1)
    res = {}
    for mode in bench.MODES:
        assign, _ = bench.ASSIGNERS[mode](site_system, device)
        out, total = bench.run_blocks(assign, site_blocks, K)
        labels = torch.cat([o[0] for o in out]).cpu().numpy()
        n_ij = [o[2]["n_ij"].cpu().numpy() for o in out]
        for (lab, _, _), got_n in zip(out, n_ij):
            want, _, _ = _jump_stats_block_int64(
                lab.cpu().numpy(), K, np.full(n_ions, -1, np.int64),
                np.zeros(n_ions, np.int64), "persist")
            check(np.array_equal(got_n, want["n_ij"]), f"bench {mode} on "
                  "site centres: n_ij differs from the int64 oracle")
        res[mode] = (labels, n_ij, total.item())
    want_l, want_n, want_sum = res["xla"]
    for mode in ("mxu", "fused"):
        labels, n_ij, total = res[mode]
        bad = np.argwhere((labels != want_l) & ~gate)
        check(not len(bad), f"bench {mode} on site centres: {len(bad)} "
              f"labels differ from xla outside the margin gate")
        same = np.array_equal(labels, want_l)
        check(not same or (all(np.array_equal(a, b)
                               for a, b in zip(n_ij, want_n))
                           and total == want_sum),
              f"bench {mode} on site centres: equal labels, other n_ij")
        print(f"bench step on site centres, {mode} vs xla: labels equal on "
              f"{int((~gate).sum())} ungated rows ({int(gate.sum())} gated, "
              f"{int((labels != want_l).sum())} differ there); "
              f"{100 * np.mean(labels >= 0):.2f}% assigned; n_ij "
              f"{'equal' if same else 'each equal to its own oracle'} "
              f"({int(sum(n.sum() for n in n_ij))} jumps); checksum {total}",
              flush=True)
    check(sum(n.sum() for n in want_n) > 0, "site centres: no jump")

    ab = {}
    for name, module in (("ab_s_tile", ab_s_tile), ("ab_skew", ab_skew)):
        before = read_launches()
        ab[name], seconds = run_tool(name, module)
        print(f"{name}: {seconds:.1f} s; launches {launches_since(before)}",
              flush=True)
    before = read_launches()
    val, seconds = run_tool("validate_preshift_streaming", vps)
    got = launches_since(before)
    print(f"validate_preshift_streaming: {seconds:.1f} s; launches {got}",
          flush=True)
    check(val["route_fused"] == "mxu" and got["K2"] >= 1
          and got["K1"] == -(-vps.N_FRAMES // vps.BLOCK_FRAMES),
          f"validate_preshift_streaming: route {val['route_fused']}, "
          f"launches {got}")
    launches = read_launches()
    print(f"bench path: frames/s by mode {json.dumps(fps)}; A/B ratios: "
          f"s_tile 256/128 {ab['ab_s_tile']['ratio_256_over_128']:.4f}, "
          f"K1s/K1 {ab['ab_skew']['ratio']:.4f}; launches {launches}",
          flush=True)
    return launches, fps


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
        check(launches["fold"] == sla.run_trace_["fold"]["launches"] > 0,
              f"streaming run: jump fold launches {launches['fold']}, run "
              f"record {sla.run_trace_['fold']}")
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
    check(sla.run_trace_["fold"]["jumps"] == int(want["n_ij"].sum()),
          f"streaming run record: {sla.run_trace_['fold']} jumps, the "
          f"oracle {int(want['n_ij'].sum())}")
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
    return launches, fps, dict(sy=sy, sn=sn, frames=frames, centers=centers,
                               kw=kw)


NS_POOL, NS_BLOCKS = 4, 6     # the north-star phase: pool and pass, blocks


def phase_northstar(device):
    """The north-star tool's path (``tools/northstar_run.py``) at the
    bench width: a pool of ``NS_POOL`` 512-frame blocks generated on the
    card, ``fit_centers`` (K2) on one, then pass 2 (K1, ``pipeline_depth``
    2, labels spilled) over ``NS_BLOCKS`` blocks through ``CycleReader``,
    so that the pool wraps, from the card's pool and from the same pool as
    host arrays.  Returns the launch counts and both runs' frames/s."""
    import tempfile
    from sitator_tpu_torch.tools import northstar_run as ns

    sn, sy = ns.bench_network()
    B = ns.BLOCK_FRAMES
    n_frames = NS_BLOCKS * B
    t0 = time.perf_counter()
    pool = ns.make_pool(sy, NS_POOL, B, device)
    host_pool = [b.cpu().numpy() for b in pool]
    t_pool = time.perf_counter() - t0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        centers = ns.fit_centers(sn, pool, sy.centers, tmp, device,
                                 cache=False)
        sync()
        t_fit = time.perf_counter() - t0
        fit_launches = read_launches()
        for name, blocks in (("card", pool), ("host", host_pool)):
            eng = ns.make_engine(tmp, name, block_frames=B, device=device)
            sync()
            t0 = time.perf_counter()
            out = eng.run(sn, ns.CycleReader(blocks, n_frames),
                          centers=centers)
            sync()
            dt = time.perf_counter() - t0
            labels = np.array(np.load(eng.store_labels))
            runs[name] = dict(eng=eng, out=out, labels=labels,
                              fps=n_frames / dt)
        launches = read_launches()
    card, host = runs["card"], runs["host"]
    for name, r in runs.items():
        print(f"north-star path, {name} pool ({NS_POOL} x {B} frames, "
              f"{NS_BLOCKS} blocks through CycleReader, depth "
              f"{r['eng'].pipeline_depth}, labels spilled): "
              f"{r['fps']:.1f} frames/s; phase_times_ (s): " + json.dumps(
                  {k: round(v, 4) for k, v in r["eng"].phase_times_.items()}),
              flush=True)
    # (1) the pool wraps: blocks 4 and 5 are blocks 0 and 1 again
    lab = card["labels"]
    check(lab.shape == (n_frames, len(sy.occ)), f"labels {lab.shape}")
    check(np.array_equal(lab[NS_POOL * B:], lab[:(NS_BLOCKS - NS_POOL) * B]),
          "north-star: the labels of the wrapped blocks differ from the "
          "first blocks'")
    ns.check_periodic(lab, NS_POOL * B)
    # (2) the card's pool against the host pool
    check(np.array_equal(lab, host["labels"]), "north-star: card and host "
          f"pools' labels differ on {int((lab != host['labels']).sum())} "
          "rows")
    for k in INT_ATTRS:
        check(np.array_equal(getattr(card["out"], k),
                             getattr(host["out"], k)),
              f"north-star: {k} differs between the card and host pools")
    fc, fh = card["eng"].final_state_, host["eng"].final_state_
    worst = 0.0
    for k in fc:
        if k in ("conf", "cos", "sin"):
            err = float(np.abs(fc[k] - fh[k]).max())
            scale = float(np.abs(fh[k]).max())
            check(err <= 1e-12 * scale, f"north-star: {k} sums differ by "
                  f"{err:.3g} (> 1e-12 of {scale:.3g})")
            worst = max(worst, err / scale if scale else 0.0)
        else:
            check(np.array_equal(fc[k], fh[k]),
                  f"north-star: {k} differs between the card and host pools")
    # (3) the host int64 recount
    counts = ns.check_recount(lab, card["eng"], card["out"])
    # (4) the kernels ran, on the card
    check(card["eng"].route_ == host["eng"].route_ == "mxu",
          f"north-star routes {card['eng'].route_}, {host['eng'].route_}")
    check(fit_launches["K2"] >= 1, f"north-star fit launches {fit_launches}")
    want = dict(K1=2 * NS_BLOCKS, K2=fit_launches["K2"], K3=0, K1s=0,
                fold=2 * NS_BLOCKS)
    check(launches == want, f"north-star launches {launches}, want {want}")
    # (5) no host round trip for the card's pool
    check(card["eng"].staged_blocks_ == 0,
          f"north-star: {card['eng'].staged_blocks_} blocks of the card's "
          "pool went through the pinned staging slots")
    check(host["eng"].staged_blocks_ == NS_BLOCKS,
          f"north-star: the host pool staged {host['eng'].staged_blocks_} "
          f"blocks, not {NS_BLOCKS}")
    print(f"north-star path: pool made on the card in {t_pool:.2f} s, fit "
          f"(K2) {len(centers)} centres in {t_fit:.2f} s; labels of blocks "
          f"{NS_POOL}..{NS_BLOCKS - 1} == blocks 0..{NS_BLOCKS - NS_POOL - 1}"
          "; card pool == host pool (labels, every integer tally and the "
          f"carry equal, conf/cos/sin within {worst:.3g} relative); host "
          f"int64 recount == engine ({counts['jumps']} jumps, "
          f"{counts['assigned']} assigned); staged blocks card 0, host "
          f"{NS_BLOCKS}; launches {launches}", flush=True)
    del pool, host_pool
    return launches, {k: r["fps"] for k, r in runs.items()}


def run_streaming(ctx, tmp, name, frames=None, **kw):
    """One timed pass 2 on the context's network and centres with the labels
    spilled: (engine, result, labels, seconds)."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    path = Path(tmp) / f"{name}.npy"
    sla = StreamingLandmarkAnalysis(store_labels=str(path),
                                    **{**ctx["kw"], **kw})
    sync()
    t0 = time.perf_counter()
    out = sla.run(ctx["sn"], ctx["frames"] if frames is None else frames,
                  centers=ctx["centers"])
    sync()
    seconds = time.perf_counter() - t0
    return sla, out, np.array(np.load(path)), seconds


INT_ATTRS = ("n_ij", "total_corrected_residences", "occupancies")
FLOAT_ATTRS = ("p_ij", "jump_lag", "residence_times", "centers")


def check_same_streaming(name, got, want, lab_got, lab_want):
    """Labels and integer statistics equal, float attributes within 1e-9
    (on the card the float64 sums add atomically in arrival order)."""
    check(np.array_equal(lab_got, lab_want), f"{name}: label memmaps differ "
          f"on {int((lab_got != lab_want).sum())} rows")
    for k in INT_ATTRS:
        check(np.array_equal(getattr(got, k), getattr(want, k)),
              f"{name}: {k} differs")
    worst = 0.0
    for k in FLOAT_ATTRS:
        a, b = getattr(got, k), getattr(want, k)
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: {k} NaNs")
        err = float(np.nanmax(np.abs(a - b), initial=0.0))
        check(err <= 1e-9, f"{name}: {k} differs by {err:.3g} > 1e-9")
        worst = max(worst, err)
    return worst


def count_host_syncs(ctx, tmp, n_frames, depth, **kw):
    """Host synchronisations PyTorch reports (``set_sync_debug_mode``) while
    one pass 2 over ``n_frames`` runs: blocking copies, ``.item()``,
    ``torch.cuda.synchronize``.  Waits on an event are not among them."""
    # the two around the timed run are run_streaming's own
    return syncs_in(lambda: run_streaming(
        ctx, tmp, f"sync{depth}_{n_frames}", frames=ctx["frames"][:n_frames],
        pipeline_depth=depth, **kw)) - 2


def syncs_in(fn):
    """The host synchronisations PyTorch reports while ``fn()`` runs."""
    import warnings
    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_streaming(ctx, tmp, depth):
    """One pass 2 under ``torch.profiler``: the wall time, the device's
    kernels and copies summed and by name (the 6 largest).  The sum can
    exceed the wall where copies on their own streams overlap kernels; the
    profiler's overhead (about 15,000 small launches a pass) is in the
    wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run_streaming(ctx, tmp, f"prof{depth}",
                             pipeline_depth=depth)[3] * 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    dev = sum(t for _, t, _ in ops)
    print(f"profile of pass 2 at pipeline_depth={depth} (torch.profiler on): "
          f"wall {wall:.0f} ms, device kernels and copies {dev:.0f} ms "
          f"({100 * dev / wall:.1f}% of the wall) in "
          f"{sum(n for _, _, n in ops)} launches; by name (ms): "
          + "; ".join(f"{k[:48]} {t:.1f}" for k, t, _ in ops[:6]), flush=True)


def phase_network(device, ctx):
    """The seed → stream → merge → network path.  Returns the launch counts,
    the frames/s of pass 2 at depth 2 and depth 0, and what the descriptor
    phase goes on with (the streamed network and labels, the merged network
    and its pathways, the over-split trajectory)."""
    import tempfile
    import torch
    from sitator_tpu_torch import (JumpAnalysis, LandmarkAnalysis,
                                   StreamingLandmarkAnalysis)
    from sitator_tpu_torch.dynamics import (MergeSitesByDynamics,
                                            RemoveUnoccupiedSites)
    from sitator_tpu_torch.io import ArrayTrajectory
    from sitator_tpu_torch.network import DiffusionPathwayAnalysis
    from sitator_tpu_torch.ops import mcl
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    from scipy.optimize import linear_sum_assignment  # noqa: F401 (warm)

    sy, sn, frames = ctx["sy"], ctx["sn"], ctx["frames"]
    n_frames, n_ions = len(frames), sy["mobile"].shape[1]
    last = [time.perf_counter()]

    def lap():
        """Seconds since the last call, as a tag for a progress line."""
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        return f"[+{dt:.1f} s]"

    reset_launches()

    # 1. shipped defaults (run-ahead) against the synchronous loop
    check(StreamingLandmarkAnalysis(device=device).pipeline_depth == 2,
          "the shipped pipeline_depth is not 2")
    fit = StreamingLandmarkAnalysis(**ctx["kw"])
    centers = fit.fit_centers(sn, ArrayTrajectory(frames))
    check(read_launches()["K2"] > 0, "fit_centers did not launch K2")
    check(centers.shape == ctx["centers"].shape
          and np.allclose(centers, ctx["centers"], atol=1e-5),
          "fit_centers is not reproducible")
    ctx = dict(ctx, centers=centers)
    K = len(centers)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for i, depth in enumerate((2, 0, 0, 2)):
            kw = {} if depth == 2 else {"pipeline_depth": 0}
            runs[i] = (depth,) + run_streaming(ctx, tmp, f"d{depth}_{i}", **kw)
            check(runs[i][1].pipeline_depth == depth
                  and runs[i][1].route_ == "mxu",
                  f"run {i}: depth {runs[i][1].pipeline_depth}, route "
                  f"{runs[i][1].route_}")
        check(read_launches()["K1"] >= 16, "pass 2 did not launch K1")
        _, sla2, out2, lab2, _ = runs[0]
        for i in (1, 2, 3):
            err = check_same_streaming(
                f"depth {runs[i][0]} (run {i}) vs depth 2", runs[i][2], out2,
                runs[i][3], lab2)
        want, _, _ = _jump_stats_block_int64(
            lab2, K, np.full(n_ions, -1, np.int64),
            np.zeros(n_ions, np.int64), "persist")
        check(np.array_equal(out2.n_ij, want["n_ij"])
              and np.array_equal(out2.total_corrected_residences,
                                 want["occ_counts"]) and out2.n_ij.sum() > 0,
              "depth 2: tallies differ from the int64 oracle on its labels")
        check(sla2.rollbacks_ == 0, "a rollback without an offender")
        fps = {d: max(n_frames / r[4] for r in runs.values() if r[0] == d)
               for d in (2, 0)}
        for i, (depth, sla, _, _, sec) in runs.items():
            print(f"streaming pass 2, pipeline_depth={depth} (run {i}, "
                  f"{n_frames} bench frames in 256-frame blocks, labels "
                  f"spilled): {n_frames / sec:.1f} frames/s ({sec:.3f} s)",
                  flush=True)
            print(f"phase_times_ depth {depth} run {i} (s): " + json.dumps(
                {k: round(v, 4) for k, v in sla.phase_times_.items()}),
                flush=True)
        print(f"depth 2 == depth 0: labels on all {lab2.size} rows, every "
              f"integer statistic, float attributes within 1e-9 (worst of "
              f"the last pair {err:.3g}), tallies == int64 oracle; best "
              f"frames/s depth 2 {fps[2]:.1f}, depth 0 {fps[0]:.1f} {lap()}",
              flush=True)

        syncs = {(d, n): count_host_syncs(ctx, tmp, n, d)
                 for d in (2, 0) for n in (512, 1024)}
        print(f"host synchronisations reported by PyTorch in one pass 2 "
              f"(depth, frames): {syncs} {lap()}", flush=True)
        check(syncs[2, 1024] == syncs[2, 512],
              "the run-ahead loop synchronises the host once or more a block")
        check(syncs[0, 1024] > syncs[0, 512],
              "the synchronous loop shows no per-block synchronisation: the "
              "counter does not see them")

        for depth in (2, 0):
            profile_streaming(ctx, tmp, depth)
        lap()

        # 2. two static atoms exchange inside the second of four blocks
        T, (a, b) = 64 + 17, (100, 101)
        swapped = frames[:256].copy()
        swapped[T:, [a, b]] = swapped[T:, [b, a]]
        dl = dict(frames=swapped, block_frames=64,
                  dynamic_lattice_mapping=True)
        plain = run_streaming(ctx, tmp, "noswap", frames=frames[:256],
                              block_frames=64)
        s0, o0, l0, t0 = run_streaming(ctx, tmp, "swap0", pipeline_depth=0,
                                       **dl)
        s2, o2, l2, t2 = run_streaming(ctx, tmp, "swap2", **dl)
        check_same_streaming("lattice exchange, depth 2 vs 0", o2, o0, l2, l0)
        check(np.array_equal(s2.lattice_mapping_, s0.lattice_mapping_)
              and s2.lattice_mapping_[a] == b and s2.lattice_mapping_[b] == a,
              "lattice exchange: the permutations differ")
        check(s2.rollbacks_ == 1 and s0.rollbacks_ == 0,
              f"lattice exchange: rollbacks {s2.rollbacks_}, {s0.rollbacks_}")
        check_same_streaming("lattice exchange vs the unswapped run", o2,
                             plain[1], l2, plain[2])
        print(f"lattice exchange at frame {T} of 256 (4 blocks of 64): depth "
              f"2 == depth 0 == the unswapped run (labels, integers, floats "
              f"within 1e-9, permutation); rollbacks at depth 2: "
              f"{s2.rollbacks_}; {t2:.3f} s against {t0:.3f} s at depth 0 "
              f"and {plain[3]:.3f} s unswapped {lap()}", flush=True)

    # the accumulator copy taken before each optimistic fold: the engine's
    # own accumulators and its own copy, at this run's site count
    from sitator_tpu_torch.landmark.streaming import (_snapshot,
                                                      _zero_accumulators)
    acc = {k: v.to(device) for k, v in _zero_accumulators(
        K, sla2.max_mobile_per_site).items()}
    nbytes = sum(v.numel() * v.element_size() for v in acc.values())
    snap_ms = timed(lambda: _snapshot(acc), 20)
    print(f"accumulator snapshot at {K} sites: {nbytes / 1e6:.1f} MB, "
          f"{snap_ms:.3f} ms of device time a block; host time in "
          f"phase_times_['snapshot'] above {lap()}", flush=True)
    del acc

    # 3. merge the streamed network, read off the pathways; MCL card vs CPU
    def check_merged(name, merged, remap):
        """A merged network against a NumPy reduction of the streamed one by
        ``remap``: a partition numbered by smallest member, hop counts
        summed by group with the hops inside a group dropped, occupancy
        summed by group."""
        n = merged.n_sites
        first = np.full(n, K)
        np.minimum.at(first, remap, np.arange(K))
        check(remap.shape == (K,) and remap.min() == 0
              and remap.max() == n - 1 and (np.diff(first) > 0).all()
              and first[0] == 0, f"{name}: remap is not a partition numbered "
              "by smallest member")
        onehot = np.zeros((K, n))         # float64: exact on these counts
        onehot[np.arange(K), remap] = 1.0
        want = (onehot.T @ np.asarray(out2.n_ij, np.float64)
                @ onehot).astype(np.int64)
        inside = int(np.trace(want))
        np.fill_diagonal(want, 0)
        check(np.array_equal(merged.n_ij, want),
              f"{name}: n_ij is not the sum over the groups")
        check(np.allclose(merged.occupancies, onehot.T @ out2.occupancies,
                          rtol=1e-12, atol=0),
              f"{name}: occupancies are not the sum over the groups")
        check(merged.centers.shape == (n, 3)
              and np.isfinite(merged.centers).all(), f"{name}: bad centres")
        return inside

    t0 = time.perf_counter()
    merged, remap = StreamingLandmarkAnalysis.merge_network(
        out2, verbose=False, device=device)
    t_merge = time.perf_counter() - t0
    check_merged("merge_network", merged, remap)
    dpa_m = DiffusionPathwayAnalysis(verbose=False, device=device)
    dpa_m.run(merged)
    check(dpa_m.n_pathways >= 1 and len(merged.diffusion_pathway)
          == merged.n_sites, "no diffusion pathway on the merged network")
    print(f"merge_network: {K} -> {merged.n_sites} sites, "
          f"{int(out2.n_ij.sum())} -> {int(merged.n_ij.sum())} jumps in "
          f"{t_merge:.3f} s; pathways {dpa_m.n_pathways}, dims "
          f"{np.bincount(dpa_m.pathway_dims, minlength=4).tolist()} (count by "
          f"dimension 0-3) {lap()}", flush=True)

    check_bottlenecks(merged, device)

    n_ij = np.asarray(out2.n_ij, np.float64)
    T = n_ij + n_ij.T
    T[np.diag_indices_from(T)] += np.maximum(T.max(axis=1), 1.0)
    mats, iters, ms = {}, {}, {}
    for d in (device, "cpu"):
        t = torch.as_tensor(T, dtype=torch.float32, device=d)
        mcl.mcl_iterate(t, 2.0)                       # warm-up
        sync()
        t0 = time.perf_counter()
        mats[d], iters[d] = mcl._mcl_loop(t, 2.0)
        sync()
        ms[d] = (time.perf_counter() - t0) * 1e3
    err = float((mats[device].cpu() - mats["cpu"]).abs().max())
    check(err <= 1e-5, f"MCL: card and CPU matrices differ by {err:.3g}")
    g_card = mcl.markov_cluster(T, device=device)
    g_cpu = mcl.markov_cluster(T, device="cpu")
    check(len(g_card) == len(g_cpu) and all(
        np.array_equal(x, y) for x, y in zip(g_card, g_cpu)),
        "MCL: card and CPU partitions differ")
    check(iters[device] == iters["cpu"], f"MCL iterations {iters}")
    loose, loose_map = StreamingLandmarkAnalysis.merge_network(
        out2, distance_threshold=None, verbose=False, device=device)
    check(loose.n_sites == len(g_card) <= merged.n_sites,
          f"merge_network without the distance guard: {loose.n_sites} sites "
          f"for {len(g_card)} MCL groups")
    check(loose.n_sites < K, "merge_network without the distance guard "
          "merged nothing: the group sums below would check an identity")
    for k, g in enumerate(sorted(g_card, key=lambda g: int(g.min()))):
        check((loose_map[g] == k).all(), "merge_network without the distance "
              f"guard: group {k} is not MCL's")
    flickers = check_merged("merge_network without the distance guard",
                            loose, loose_map)
    check(int(loose.n_ij.sum()) == int(out2.n_ij.sum()) - flickers,
          "merge_network without the distance guard: jumps lost")
    dpa_loose = DiffusionPathwayAnalysis(verbose=False, device=device)
    dpa_loose.run(loose)
    check(dpa_loose.n_pathways >= 1 and len(loose.diffusion_pathway)
          == loose.n_sites, "no diffusion pathway on the loosely merged "
          "network")
    print(f"MCL on the {K}-site jump graph: {iters[device]} iterations, "
          f"{ms[device]:.2f} ms on the card, {ms['cpu']:.2f} ms on the CPU; "
          f"{len(g_card)} groups (merge_network without its distance "
          f"guard: {K} -> {loose.n_sites} sites, {flickers} hops inside "
          f"the groups dropped, n_ij and occupancies == the NumPy sums over "
          f"the groups), partitions equal, matrices within {err:.3g} "
          f"{lap()}", flush=True)
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    check(not tf32_before, "TF32 products were on during the MCL comparison")
    torch.backends.cuda.matmul.allow_tf32 = True
    refused = False
    try:
        mcl.mcl_iterate(torch.as_tensor(T, dtype=torch.float32,
                                        device=device), 2.0)
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_before
    check(refused, "MCL ran with TF32 products enabled")

    # 4. the classic chain on a shorter run
    t0 = time.perf_counter()
    st = LandmarkAnalysis(cutoff_midpoint=MID, cutoff_steepness=STEEP,
                          cutoff_shape=CUTOFF, verbose=False,
                          clustering_params={"k_max": 1024},
                          device=device).run(sn, frames[:32])
    JumpAnalysis(verbose=False, device=device).run(st)
    n0 = st.site_network.n_sites
    st = MergeSitesByDynamics(verbose=False, device=device).run(st)
    n1 = st.site_network.n_sites
    st = RemoveUnoccupiedSites(verbose=False).run(st)
    dpa = DiffusionPathwayAnalysis(verbose=False, device=device)
    dpa.run(st)
    check(0 < st.site_network.n_sites <= n1 <= n0, "classic chain: site "
          f"counts {n0} -> {n1} -> {st.site_network.n_sites}")
    check(st.traj.shape == (32, n_ions) and (st.traj >= 0).any()
          and st.traj.max() < st.site_network.n_sites,
          "classic chain: bad trajectory")
    print(f"LandmarkAnalysis -> JumpAnalysis -> MergeSitesByDynamics -> "
          f"RemoveUnoccupiedSites (32 bench frames): {n0} -> {n1} -> "
          f"{st.site_network.n_sites} sites; pathways {dpa.n_pathways}; "
          f"{time.perf_counter() - t0:.2f} s {lap()}", flush=True)

    # ... and on an input that both engines change: the streamed labels on
    # the K fitted sites, without the distance guard (the MCL groups above),
    # then the first frames alone, which leave sites unvisited
    from sitator_tpu_torch import SiteTrajectory
    lab = np.asarray(lab2)
    stm = MergeSitesByDynamics(distance_threshold=None, verbose=False,
                               device=device).run(SiteTrajectory(out2, lab))
    want = np.where(lab >= 0, loose_map[np.maximum(lab, 0)], -1)
    check(stm.site_network.n_sites == loose.n_sites < K
          and np.array_equal(stm.traj, want),
          "MergeSitesByDynamics on the streamed labels: the trajectory is "
          "not the labels renumbered by the MCL groups")
    d = (stm.site_network.centers - loose.centers) @ np.linalg.inv(
        sn.structure.cell)
    d = np.abs((d - np.round(d)) @ sn.structure.cell).max()
    check(d <= 1e-6, "MergeSitesByDynamics on the streamed labels: centres "
          f"{d:.3g} A from merge_network's")
    JumpAnalysis(verbose=False, device=device).run(stm)
    check(np.array_equal(stm.site_network.n_ij, loose.n_ij),
          "JumpAnalysis on the merged labels differs from merge_network's "
          "group sums")
    few = SiteTrajectory(out2, lab[:32])
    kept = np.unique(lab[:32][lab[:32] >= 0])
    stf = RemoveUnoccupiedSites(verbose=False).run(few)
    want = np.where(lab[:32] >= 0,
                    np.searchsorted(kept, np.maximum(lab[:32], 0)), -1)
    check(0 < len(kept) < K and stf.site_network.n_sites == len(kept)
          and np.array_equal(stf.traj, want)
          and np.array_equal(stf.site_network.n_ij,
                             out2.n_ij[np.ix_(kept, kept)])
          and np.array_equal(stf.site_network.centers, out2.centers[kept]),
          "RemoveUnoccupiedSites on 32 frames of the streamed labels: not "
          "the visited sites, renumbered in order")
    print(f"on the streamed labels: MergeSitesByDynamics without the "
          f"distance guard {K} -> {stm.site_network.n_sites} sites "
          f"(trajectory == labels renumbered by MCL's groups, centres within "
          f"{d:.3g} A of merge_network's, JumpAnalysis n_ij == its group "
          f"sums); RemoveUnoccupiedSites on the first 32 frames {K} -> "
          f"{len(kept)} sites (== the visited sites, attributes subset) "
          f"{lap()}", flush=True)

    # ... and the mergers with their distance guard on, on an input that
    # they must change
    split_st, split = check_guarded_merges(device, out2, lab)
    lap()

    # 5. Voronoi seeds of the bench's static lattice (frame 0), then K2
    from sitator_tpu_torch import SiteNetwork, Structure
    t0 = time.perf_counter()
    bare = SiteNetwork(Structure(frames[0].astype(np.float64),
                                 sn.structure.species, sn.structure.cell),
                       sn.static_mask, sn.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.3, verbose=False).run(bare)
    t_vor = time.perf_counter() - t0
    sizes = np.bincount([len(v) for v in seeds.vertices])
    check(seeds.n_sites >= len(sy["site_pos"]) and sizes[0] == 0,
          f"Voronoi: {seeds.n_sites} nodes, {sizes[0]} without vertices")
    before = read_launches()["K2"]
    la = LandmarkAnalysis(cutoff_midpoint=MID, cutoff_steepness=STEEP,
                          cutoff_shape=CUTOFF, verbose=False,
                          clustering_params={"k_max": 1024}, device=device)
    st = la.run(seeds, frames[:8])
    check(read_launches()["K2"] > before,
          "the Voronoi-seeded network did not reach K2")
    check(la.landmark_vectors.shape[-1] == seeds.n_sites
          and np.isfinite(la.landmark_vectors).all()
          and st.site_network.n_sites > 0, "Voronoi-seeded run: bad result")
    print(f"VoronoiSiteGenerator on {sn.n_static} static atoms: "
          f"{seeds.n_sites} nodes in {t_vor:.2f} s on the host, vertices a "
          f"node by count {dict(enumerate(sizes.tolist()))}; through "
          f"prepare_engine_basis and K2: {st.site_network.n_sites} sites "
          f"from 8 frames {lap()}", flush=True)

    launches = read_launches()
    print(f"launches on the seed -> stream -> merge -> network path: "
          f"{launches}", flush=True)
    for k in ("K1", "K2"):
        check(launches[k] > 0, f"{k} was not launched on the network path")
    return launches, fps, dict(out=out2, labels=lab, merged=merged, dpa=dpa_m,
                               remap=remap, split_st=split_st, split=split)


def brandes_oracle(n, adj):
    """Normalised weighted betweenness by Brandes' algorithm as networkx 3
    runs it, in plain Python float64: a heap Dijkstra from every node over
    ``adj[v] = [(w, length), ...]`` (predecessors where ``dist[v] + len ==
    dist[w]``), dependencies accumulated back in the order the nodes were
    settled, ``1 / ((n - 1)(n - 2))``."""
    import heapq
    import itertools
    bc = [0.0] * n
    for s in range(n):
        order, pred, sigma, dist, seen = [], {s: []}, {s: 1.0}, {}, {s: 0.0}
        count = itertools.count()
        heap = [(0.0, next(count), s, s)]
        while heap:
            d, _, p, v = heapq.heappop(heap)
            if v in dist:
                continue
            if p != v:
                sigma[v] += sigma[p]
            order.append(v)
            dist[v] = d
            for w, length in adj[v]:
                vw = d + length
                if w not in dist and (w not in seen or vw < seen[w]):
                    seen[w] = vw
                    heapq.heappush(heap, (vw, next(count), v, w))
                    sigma[w], pred[w] = 0.0, [v]
                elif w not in dist and vw == seen[w]:
                    sigma[w] += sigma[v]
                    pred[w].append(v)
        delta = dict.fromkeys(order, 0.0)
        while order:
            w = order.pop()
            coeff = (1.0 + delta[w]) / sigma[w]
            for v in pred[w]:
                delta[v] += sigma[v] * coeff
            if w != s:
                bc[w] += delta[w]
    scale = 1.0 / ((n - 1) * (n - 2)) if n > 2 else 1.0
    return np.array(bc) * scale


def check_bottlenecks(net, device):
    """``ConductionBottleneckAnalysis`` on a copy of ``net`` (its Brandes in
    NumPy/SciPy on the host, no networkx; the jump tallies are given),
    held to :func:`brandes_oracle` — betweenness within 1e-9 — and to the
    same percolation readout computed from the oracle's betweenness:
    ``base_dim_``, ``candidates_``, ``removal_dims_`` and
    ``critical_sites_`` equal."""
    from sitator_tpu_torch.network import (ConductionBottleneckAnalysis,
                                           DiffusionPathwayAnalysis)
    net = net.copy()
    t0 = time.perf_counter()
    cba = ConductionBottleneckAnalysis(verbose=False, device=device).run(net)
    t_cba = time.perf_counter() - t0
    n_ij = np.asarray(net.n_ij, np.float64)
    sym = n_ij + n_ij.T
    np.fill_diagonal(sym, 0.0)
    conn = sym >= 1
    S = net.n_sites
    adj = [[] for _ in range(S)]
    for i, j in zip(*np.nonzero(np.triu(conn, k=1))):
        adj[i].append((int(j), 1.0 / sym[i, j]))
        adj[j].append((int(i), 1.0 / sym[i, j]))
    for a in adj:
        a.sort()
    t0 = time.perf_counter()
    bc = brandes_oracle(S, adj)
    t_oracle = time.perf_counter() - t0
    err = float(np.abs(cba.betweenness_ - bc).max())
    check(err <= 1e-9, f"ConductionBottleneckAnalysis: betweenness differs "
          f"from the float64 oracle by {err:.3g} > 1e-9")
    frac = np.asarray(net.centers) @ np.linalg.inv(
        np.asarray(net.structure.cell, np.float64))
    perc = DiffusionPathwayAnalysis.percolation_dimension
    base = perc(conn, frac)
    cands = [int(i) for i in np.argsort(bc)[::-1][:cba.n_candidates]
             if bc[i] > 0]
    dims = []
    for i in cands:
        sub = conn.copy()
        sub[i, :] = sub[:, i] = False
        dims.append(perc(sub, frac))
    critical = [i for i, d in zip(cands, dims) if d < base]
    check(cba.base_dim_ == base and cba.candidates_.tolist() == cands
          and cba.removal_dims_.tolist() == dims
          and cba.critical_sites_.tolist() == critical,
          f"ConductionBottleneckAnalysis: readout {cba.base_dim_}, "
          f"{cba.candidates_.tolist()}, {cba.removal_dims_.tolist()}, "
          f"{cba.critical_sites_.tolist()} != the oracle's {base}, {cands}, "
          f"{dims}, {critical}")
    print(f"ConductionBottleneckAnalysis on the merged network ({S} sites, "
          f"{int(np.triu(conn, 1).sum())} edges): {t_cba:.2f} s "
          f"(networkx-free Brandes); betweenness within {err:.3g} of the "
          f"float64 oracle ({t_oracle:.2f} s, plain Python) (<= 1e-9); "
          f"max {bc.max():.4g}; base {base}D, candidates {cands}, removal "
          f"dims {dims}, critical {critical} == the oracle's", flush=True)


SPLIT_OFFSET = 0.2      # Å between the halves of an engineered split site


def oversplit(net, labels, n_split, offset=SPLIT_OFFSET):
    """An engineered over-split copy of a streamed result: the ``n_split``
    most visited sites of ``net`` each get a near-duplicate centre ``offset``
    Å away along x (far inside the mergers' 3 Å distance guard, and near
    enough that the halves' SOAP vectors stay 0.99 similar), appended
    after the ``K`` sites, and an ion assigned to such a site flickers
    between the two halves, one frame each.  Returns (SiteTrajectory on the
    ``K + n_split`` sites, the split sites, the expected remap: every
    duplicate back onto its site, which keeps the numbering by smallest
    member)."""
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory
    K = net.n_sites
    visits = np.bincount(labels[labels >= 0], minlength=K)
    split = np.sort(np.argsort(-visits, kind="stable")[:n_split])
    sn = SiteNetwork(net.structure, net.static_mask, net.mobile_mask)
    sn.centers = np.concatenate([net.centers,
                                 net.centers[split] + [offset, 0.0, 0.0]])
    twin = np.full(K + 1, -1)
    twin[split] = K + np.arange(n_split)
    odd = (np.arange(len(labels)) % 2 == 1)[:, None]
    lab = np.where(odd & (twin[labels] >= 0), twin[labels], labels)
    remap = np.concatenate([np.arange(K), split])
    return SiteTrajectory(sn, lab.astype(np.int32)), split, remap


def check_guarded_merges(device, net, labels, n_split=64):
    """The *guarded* mergers on an input they must change: on the
    over-split copy of the streamed result, ``MergeSitesByDynamics`` and
    ``merge_network`` with their default 3 Å distance guard must merge each
    duplicate back into its site and nothing else, so that the streamed
    labels, hop counts and occupancies come back, held to NumPy reductions
    over the expected groups.  Returns the over-split trajectory and the
    sites that were split."""
    from sitator_tpu_torch import (JumpAnalysis, SiteTrajectory,
                                   StreamingLandmarkAnalysis)
    from sitator_tpu_torch.dynamics import MergeSitesByDynamics
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64

    K, n_ions = net.n_sites, labels.shape[1]
    st, split, remap = oversplit(net, labels, n_split)
    S = st.site_network.n_sites
    check(S == K + n_split and (st.traj >= K).any(), "over-split input: no "
          "duplicate site is visited")
    # host oracle of the over-split statistics and of their group sums
    stats, _, _ = _jump_stats_block_int64(
        st.traj, S, np.full(n_ions, -1, np.int64), np.zeros(n_ions, np.int64),
        "persist")
    onehot = np.zeros((S, K))                 # float64: exact on these counts
    onehot[np.arange(S), remap] = 1.0
    want_nij = (onehot.T @ stats["n_ij"].astype(np.float64)
                @ onehot).astype(np.int64)
    flickers = int(np.trace(want_nij))
    np.fill_diagonal(want_nij, 0)
    check(flickers > 0 and np.array_equal(want_nij, net.n_ij),
          "over-split input: its group sums are not the streamed hop counts")
    occ = stats["occ_counts"] / len(labels)
    w = stats["occ_counts"][K:] / (stats["occ_counts"][split]
                                   + stats["occ_counts"][K:])
    want_centres = net.centers.copy()
    want_centres[split] += (st.site_network.centers[K:]
                            - net.centers[split]) * w[:, None]

    def centre_err(got):
        d = (got - want_centres) @ np.linalg.inv(net.structure.cell)
        return float(np.abs((d - np.round(d)) @ net.structure.cell).max())

    t0 = time.perf_counter()
    merged = MergeSitesByDynamics(verbose=False, device=device).run(
        SiteTrajectory(st.site_network, st.traj.copy()))
    t_dyn = time.perf_counter() - t0
    check(merged.site_network.n_sites == K,
          f"guarded MergeSitesByDynamics: {S} -> "
          f"{merged.site_network.n_sites} sites, expected {K}")
    check(np.array_equal(merged.traj, labels), "guarded MergeSitesByDynamics: "
          "the merged trajectory is not the streamed labels")
    e_dyn = centre_err(merged.site_network.centers)
    check(e_dyn <= 1e-6, f"guarded MergeSitesByDynamics: centres {e_dyn:.3g} "
          "A from the occupancy-weighted means")
    JumpAnalysis(verbose=False, device=device).run(merged)
    check(np.array_equal(merged.site_network.n_ij, want_nij),
          "guarded MergeSitesByDynamics: n_ij differs from the group sums")

    # merge_network works on statistics: the engine's own tallies of the
    # over-split labels, held to the host oracle first
    JumpAnalysis(verbose=False, device=device).run(st)
    st.compute_site_occupancies()
    check(np.array_equal(st.site_network.n_ij, stats["n_ij"])
          and np.allclose(st.site_network.occupancies, occ, rtol=1e-12,
                          atol=0), "over-split input: JumpAnalysis differs "
          "from the int64 oracle")
    t0 = time.perf_counter()
    net2, got_map = StreamingLandmarkAnalysis.merge_network(
        st.site_network, verbose=False, device=device)
    t_net = time.perf_counter() - t0
    check(net2.n_sites == K and np.array_equal(got_map, remap),
          f"guarded merge_network: {S} -> {net2.n_sites} sites, or another "
          "remap than duplicate -> site")
    check(np.array_equal(net2.n_ij, want_nij)
          and np.allclose(net2.occupancies, onehot.T @ occ, rtol=1e-12,
                          atol=0), "guarded merge_network: n_ij or "
          "occupancies differ from the group sums")
    e_net = centre_err(net2.centers)
    check(e_net <= 1e-6, f"guarded merge_network: centres {e_net:.3g} A from "
          "the occupancy-weighted means")
    print(f"guarded merges on the over-split input ({n_split} visited sites "
          f"given a duplicate centre {SPLIT_OFFSET} A away, ions flickering "
          f"between the "
          f"halves): MergeSitesByDynamics {S} -> "
          f"{merged.site_network.n_sites} sites in {t_dyn:.2f} s (trajectory == the streamed labels, n_ij "
          f"== the group sums), merge_network {S} -> {net2.n_sites} in "
          f"{t_net:.2f} s (remap == duplicate -> site, n_ij and occupancies "
          f"== the NumPy sums over the groups, {flickers} flickers dropped); "
          f"centres within {max(e_dyn, e_net):.3g} A of the weighted means",
          flush=True)
    return st, split


def seam_check(grid, pos, cell, n_bins, ulps=16):
    """Hold a float32-binned count grid to float64 arithmetic on the same
    positions.  An atom whose float64 bin coordinate lies within ``ulps``
    float32 ulp (of the coordinate's range, ``n_bins``) of a bin seam may
    land on either side; every other atom must be counted exactly where
    float64 puts it.  Returns (atoms near a seam, counts that differ
    from the straight float64 histogram)."""
    x = pos.astype(np.float64) @ np.linalg.inv(np.asarray(cell, np.float64))
    x = (x - np.floor(x)) * n_bins
    tol = ulps * n_bins * 2.0 ** -24
    near = (np.abs(x - np.round(x)) < tol).any(axis=1)

    def hist(points):
        h = np.zeros((n_bins,) * 3, np.int64)
        idx = np.floor(points).astype(np.int64) % n_bins
        np.add.at(h, tuple(idx.T), 1)
        return h

    rest = grid - hist(x[~near])
    # the bins a near-seam atom may fall in: each axis one ulp-window down
    # and up
    room = np.zeros_like(grid)
    corners = np.stack(np.meshgrid(*[(-tol, tol)] * 3, indexing="ij"),
                       -1).reshape(-1, 1, 3)
    cand = np.floor(x[near][None] + corners).astype(np.int64) % n_bins
    who = np.broadcast_to(np.arange(cand.shape[1])[None, :, None],
                          cand.shape[:2] + (1,))
    pairs = np.unique(np.concatenate([who, cand], axis=-1).reshape(-1, 4),
                      axis=0)                     # each (atom, bin) once
    np.add.at(room, tuple(pairs[:, 1:].T), 1)
    check((rest >= 0).all() and rest.sum() == near.sum()
          and (rest <= room).all(), "density_grid: a count differs from the "
          "float64 histogram away from every bin seam")
    return int(near.sum()), int(np.abs(grid - hist(x)).sum() // 2)


def first_cpu_math_calls_on_one_thread():
    """Call each vectorised math function the CPU oracles below reach once,
    on a tensor under torch's parallel grain.  The first call of such a
    function on a CPU build of torch, when it is a multi-threaded one, has
    been seen to return 12-bit approximations on some threads' chunks
    (relative error up to 3e-4); later calls are exact."""
    import torch
    x = torch.linspace(0.5, 2.0, 1024)
    for fn in (torch.sqrt, torch.rsqrt, torch.exp, torch.log, torch.cos,
               torch.sin, torch.round, torch.floor, torch.abs):
        fn(x)
    torch.atan2(x, x)
    torch.pow(x, torch.arange(1024) % 7)
    x[:64].reshape(8, 8) @ x[:64].reshape(8, 8)


def phase_descriptors(device, ctx):
    """Site descriptors and the other two ways to seed sites, after the
    passes, at the bench width (9261 static atoms, 739 ions, the streamed
    1024-site network and its labels over 1024 frames): SOAP per site
    (centres, and averages over sampled ion positions) on the card against
    the CPU, rotation invariance, the TF32 refusal, the descriptor merge on
    the over-split input, the density grid and its site generator, the
    bond-valence mismatch grid, and string refinement of the pathways'
    edges.  No hand-written kernel runs here; every check is against a host
    oracle."""
    import torch
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory, Structure
    from sitator_tpu_torch.network import (DensitySiteGenerator, match_sites,
                                           min_image_distance_matrix)
    from sitator_tpu_torch.ops import bondvalence, density, mep
    from sitator_tpu_torch.site_descriptors import (MergeSitesByDescriptors,
                                                    SiteCentersDescriptor,
                                                    SOAPDescriptorAverages,
                                                    soap_descriptors)

    sy, sn, frames = ctx["sy"], ctx["sn"], ctx["frames"]
    net, labels = ctx["out"], ctx["labels"]
    cell = np.asarray(sn.structure.cell, np.float64)
    K, (n_frames, n_ions) = net.n_sites, labels.shape
    n_static = sn.n_static
    first_cpu_math_calls_on_one_thread()
    last = [time.perf_counter()]

    def lap():
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        return f"[{dt:.2f} s]"

    def network(centers=None, structure=sn.structure):
        out = SiteNetwork(structure, sn.static_mask, sn.mobile_mask)
        if centers is not None:
            out.centers = centers
        return out

    # 1. SOAP at the site centres: card against CPU on 64 sites, rotation
    rng = np.random.default_rng(23)
    sub = np.sort(rng.choice(K, 64, replace=False))
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    d_card, ones = SiteCentersDescriptor(device=device).get_descriptors(net)
    sync()
    t_centres = time.perf_counter() - t0
    peak_centres = torch.cuda.max_memory_allocated() / 1e9
    D = d_card.shape[1]
    check(d_card.shape == (K, 8 * 8 * 7) and np.isfinite(d_card).all()
          and np.allclose(np.linalg.norm(d_card, axis=1), 1.0, atol=1e-5)
          and (ones == 1).all(), "SiteCentersDescriptor: bad descriptors")
    d_cpu, _ = SiteCentersDescriptor(device="cpu").get_descriptors(
        network(net.centers[sub]))
    e_centres = float(np.abs(d_card[sub] - d_cpu).max())
    check(e_centres <= 2e-5, f"SiteCentersDescriptor: card and CPU differ by "
          f"{e_centres:.3g} > 2e-5")
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))                   # a proper rotation
    turned = Structure(sn.structure.positions @ q.T, sn.structure.species,
                       cell @ q.T)
    d_rot, _ = SiteCentersDescriptor(device=device).get_descriptors(
        network(net.centers @ q.T, turned))
    e_rot = float(np.abs(d_rot - d_card).max())
    check(e_rot <= 1e-4, f"SiteCentersDescriptor: a rotation of the system "
          f"moves the descriptors by {e_rot:.3g} > 1e-4")
    print(f"SiteCentersDescriptor ({K} probes x {n_static} atoms, n_max=8, "
          f"l_max=6, D={D}): {t_centres:.2f} s on the card, peak memory "
          f"{peak_centres:.2f} GB; card == CPU on 64 sites within "
          f"{e_centres:.3g} (<= 2e-5); rotated system within {e_rot:.3g} "
          f"(<= 1e-4) {lap()}", flush=True)

    # TF32 on must raise (the check stands outside the handler)
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    check(not tf32_before, "TF32 products were on during the SOAP comparison")
    torch.backends.cuda.matmul.allow_tf32 = True
    refused = False
    try:
        soap_descriptors(net.centers[:4], sn.static_structure.positions,
                         sn.static_structure.species, cell, device=device)
    except RuntimeError as e:
        refused = "allow_tf32" in str(e)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_before
    check(refused, "soap_descriptors ran with TF32 products enabled")
    print("soap_descriptors with TF32 products enabled raises RuntimeError",
          flush=True)

    # 2. SOAP averaged over sampled ion positions, each in its own frame
    st = SiteTrajectory(net, labels)
    st.set_real_traj(frames)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    avg, counts = SOAPDescriptorAverages(
        averages_n=16, verbose=False, device=device).get_descriptors(st)
    sync()
    t_avg = time.perf_counter() - t0
    peak_avg = torch.cuda.max_memory_allocated() / 1e9
    visits = np.bincount(labels[labels >= 0], minlength=K)
    check(np.array_equal(counts, np.minimum(visits, 16)),
          "SOAPDescriptorAverages: counts are not the capped visits")
    norms = np.linalg.norm(avg, axis=1)
    check(avg.shape == (K, D) and np.isfinite(avg).all()
          and np.allclose(norms[visits > 0], 1.0, atol=1e-5)
          and (norms[visits == 0] == 0).all(),
          "SOAPDescriptorAverages: bad descriptors")
    # the same call on 64 sites alone (other rows unassigned), card and CPU:
    # both draw the same samples from the same seed
    keep = np.full(K + 1, -1)
    keep[sub] = sub
    st_sub = SiteTrajectory(net, keep[labels].astype(np.int32))
    st_sub.set_real_traj(frames)
    a_card, c_card = SOAPDescriptorAverages(
        averages_n=16, verbose=False, device=device).get_descriptors(st_sub)
    sync()
    t0 = time.perf_counter()
    a_cpu, c_cpu = SOAPDescriptorAverages(
        averages_n=16, verbose=False, device="cpu").get_descriptors(st_sub)
    t_avg_cpu = time.perf_counter() - t0
    e_avg = float(np.abs(a_card - a_cpu).max())
    check(np.array_equal(c_card, c_cpu) and c_card.sum() > 0
          and e_avg <= 2e-5, f"SOAPDescriptorAverages: card and CPU differ "
          f"by {e_avg:.3g} > 2e-5 on 64 sites, or in their counts")
    print(f"SOAPDescriptorAverages (averages_n=16: {int(counts.sum())} "
          f"probes, each in its own frame's {n_static}-atom environment): "
          f"{t_avg:.2f} s on the card, peak memory {peak_avg:.2f} GB; counts "
          f"== the capped visits; card == CPU on 64 sites "
          f"({int(c_card.sum())} probes, {t_avg_cpu:.2f} s on the CPU) "
          f"within {e_avg:.3g} (<= 2e-5) {lap()}", flush=True)
    check_site_typing({"averages": avg, "centers": d_card}, device)
    print(f"site typing {lap()}", flush=True)

    # 3. the descriptor merge on the over-split input
    from scipy.sparse.csgraph import connected_components
    split_st = ctx["split_st"]
    S = split_st.site_network.n_sites
    desc = SiteCentersDescriptor(device=device)
    merger = MergeSitesByDescriptors(desc, similarity_threshold=0.98,
                                     verbose=False)
    groups = sorted(tuple(g) for g in merger._get_merges(split_st))
    d = desc.get_descriptors(split_st)[0].astype(np.float64)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    sims = d @ d.T
    adj = sims >= 0.98
    np.fill_diagonal(adj, False)
    _, comp = connected_components(adj, directed=False)
    want = sorted(tuple(np.flatnonzero(comp == c)) for c in np.unique(comp))
    check(groups == want, "MergeSitesByDescriptors: its groups are not the "
          "components of the thresholded similarity matrix")
    twin_sim = sims[np.arange(K, S), ctx["split"]]
    merged = merger.run(SiteTrajectory(split_st.site_network,
                                       split_st.traj.copy()))
    # the 3 A guard: single linkage inside each group, by NumPy
    dist = min_image_distance_matrix(split_st.site_network.centers,
                                     split_st.site_network.centers, cell)
    link = (dist <= 3.0) & (comp[:, None] == comp[None, :])
    n_guarded = connected_components(link, directed=False)[0]
    check(merged.site_network.n_sites == n_guarded,
          f"MergeSitesByDescriptors: {S} -> {merged.site_network.n_sites} "
          f"sites, the NumPy oracle gives {n_guarded}")
    check(n_guarded < S, "MergeSitesByDescriptors merged nothing on the "
          "over-split input")
    print(f"MergeSitesByDescriptors (SiteCentersDescriptor, similarity >= "
          f"0.98, 3 A guard) on the over-split input: {len(groups)} "
          f"similarity group(s) == the NumPy components; {S} -> "
          f"{merged.site_network.n_sites} sites == the guarded NumPy oracle; "
          f"duplicate-to-site similarity {twin_sim.min():.4f} to "
          f"{twin_sim.max():.4f} {lap()}", flush=True)

    # 4. density grid of the ions, its seams, and the density site generator
    mobile = np.flatnonzero(sn.mobile_mask)
    sync()
    t0 = time.perf_counter()
    grid = density.density_grid(frames, cell, mask=sn.mobile_mask, n_bins=48,
                                device=device)
    sync()
    t_grid = time.perf_counter() - t0
    check(grid.dtype == np.int64 and grid.sum() == n_frames * n_ions,
          f"density_grid: total {grid.sum()} != {n_frames} x {n_ions}")
    n_near, n_moved = seam_check(grid, frames[:, mobile].reshape(-1, 3),
                                 cell, 48)
    t0 = time.perf_counter()
    seeds = DensitySiteGenerator(n_bins=48, verbose=False,
                                 device=device).run(
        network(), frames)
    t_gen = time.perf_counter() - t0
    true_sites = sy["site_pos"][sy["centred"]]
    mapping, dists = match_sites(seeds, network(true_sites), cutoff=1.0)
    n_match = int((mapping >= 0).sum())
    check(seeds.n_sites > 0 and n_match >= 0.9 * seeds.n_sites
          and all(len(v) == 8 for v in seeds.vertices),
          f"DensitySiteGenerator: {seeds.n_sites} sites, {n_match} within "
          "1 A of a lattice site the ions hop between")
    print(f"density_grid ({n_frames} frames x {n_ions} ions, 48^3 bins): "
          f"{t_grid:.2f} s, total == frames x ions, max count "
          f"{int(grid.max())}; against the float64 histogram {n_moved} "
          f"count(s) differ, every one an atom within 16 f32 ulp of a seam "
          f"({n_near} such seam atoms); DensitySiteGenerator: "
          f"{seeds.n_sites} sites in {t_gen:.2f} s, {n_match} within 1 A of "
          f"one of the {len(true_sites)} lattice sites the ions hop between "
          f"(worst {np.nanmax(dists):.2f} A) {lap()}", flush=True)

    # 5. bond-valence mismatch of the static lattice taken as the anions
    anions = sn.static_structure.positions
    r0, cutoff = 2.4, 6.0
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    mism = bondvalence.bv_mismatch_grid(anions, r0, cell, 1.0, n_bins=48,
                                        cutoff=cutoff, device=device)
    sync()
    t_bv = time.perf_counter() - t0
    peak_bv = torch.cuda.max_memory_allocated() / 1e9
    pick = np.sort(rng.choice(48 ** 3, 4096, replace=False))
    ii = (np.arange(48) + 0.5) / 48
    pts = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"),
                   -1).reshape(-1, 3)[pick] @ cell
    inv = np.linalg.inv(cell)
    # float64 arithmetic on the coordinates as the device holds them
    pts32 = pts.astype(np.float32).astype(np.float64)
    an32 = anions.astype(np.float32).astype(np.float64)
    v64 = np.empty(len(pts))
    for lo in range(0, len(pts), 256):
        df = (pts32[lo:lo + 256, None, :] - an32[None]) @ inv
        dist = np.linalg.norm((df - np.round(df)) @ cell, axis=-1)
        v64[lo:lo + 256] = np.where(dist < cutoff,
                                    np.exp((r0 - dist) / bondvalence.BV_B),
                                    0.0).sum(axis=1)
    e_bv = float((np.abs(mism.reshape(-1)[pick] - np.abs(v64 - 1.0))
                  / v64).max())
    # the float32 minimum image rounds a fractional separation of up to 1
    # before the nearest integer is taken off it: 4 ulp of that, times the
    # cell's edge, over b, is what a term's exponent can be off by
    edge = float(np.linalg.norm(cell, axis=1).max())
    tol_bv = 4 * 2.0 ** -24 * edge / bondvalence.BV_B
    check(mism.shape == (48,) * 3 and np.isfinite(mism).all()
          and e_bv <= tol_bv, f"bv_mismatch_grid: {e_bv:.3g} relative from "
          f"the float64 oracle > {tol_bv:.3g}")
    print(f"bv_mismatch_grid (48^3 = {48 ** 3} points x {len(anions)} anions, "
          f"chunk 65536): {t_bv:.2f} s, peak memory {peak_bv:.2f} GB; within "
          f"{e_bv:.3g} relative (<= {tol_bv:.3g}: 4 f32 ulp of the fractional "
          f"separation over a {edge:.0f} A edge, over b) of float64 NumPy on "
          f"4096 points; mismatch {mism.min():.3f} to {mism.max():.3f} "
          f"{lap()}",
          flush=True)

    # 6. string refinement along the pathways' edges on the smoothed density
    merged_net, dpa = ctx["merged"], ctx["dpa"]
    nij = np.asarray(merged_net.n_ij)
    edges = np.argwhere(np.triu(nij + nij.T >= dpa.connectivity_threshold, 1))
    edges = edges[:256]
    check(len(edges) > 0, "no edge on the merged network")
    a = merged_net.centers[edges[:, 0]]
    step = (merged_net.centers[edges[:, 1]] - a) @ inv
    step = (step - np.round(step)) @ cell              # minimum image
    paths = a[:, None, :] + np.linspace(0, 1, 21)[None, :, None] \
        * step[:, None, :]
    rho = density.smooth_density(grid, cell, 1.0)

    def refine(nodes, its, dev):
        sync()
        t0 = time.perf_counter()
        got = mep.refine_string_paths(rho, cell, nodes, iterations=its,
                                      device=dev)
        sync()
        return got, time.perf_counter() - t0

    def moved(a, b):
        """Largest node distance of each edge between two sets of paths."""
        return np.abs(a - b).max(axis=(1, 2))

    # The ions of this system hop to any free site, so these edges cross
    # voids where the density sits on its floor.  There the landscape is a
    # plateau with a kink at its rim, and the gradient of the trilinear
    # interpolation also jumps at the borders of its cells: a node within
    # rounding of such a place gets another force on the card than on the
    # CPU, and that string then relaxes along another route.  So whole runs
    # are held to the CPU while rounding is all that separates them (20
    # iterations, every edge), and the full 300 by their last step: the
    # card's and the CPU's step 300 from the card's nodes after 299.
    early, t20 = refine(paths, 20, device)
    e20 = moved(early, refine(paths, 20, "cpu")[0])
    check(np.isfinite(early).all() and e20.max() <= 1e-3,
          f"refine_string_paths, 20 iterations: card and CPU differ by "
          f"{e20.max():.3g} A > 1e-3")
    full, t300 = refine(paths, 300, device)
    full_cpu, t300_cpu = refine(paths, 300, "cpu")
    before, _ = refine(paths, 299, device)
    chained = moved(refine(before, 1, device)[0], full)
    e_step = moved(refine(before, 1, "cpu")[0], full)
    e300 = moved(full, full_cpu)
    pinned = float(np.abs(full[:, [0, -1]] - paths[:, [0, -1]]).max())
    check(np.isfinite(full).all() and pinned <= 1e-4 and chained.max() == 0,
          f"refine_string_paths, 300 iterations: an end point moved by "
          f"{pinned:.3g} A, or 299 + 1 iterations differ from 300 by "
          f"{chained.max():.3g} A")
    check((e_step > 1e-4).sum() <= 3, f"refine_string_paths: step 300 on "
          f"the card and on the CPU from the same nodes differ by more than "
          f"1e-4 A on {(e_step > 1e-4).sum()} edges (worst "
          f"{e_step.max():.3g} A)")
    print(f"refine_string_paths ({len(edges)} edges x 21 nodes, 48^3 density "
          f"smoothed by 1 A): 20 iterations {t20:.2f} s, card == CPU on "
          f"every edge within {e20.max():.3g} A (<= 1e-3); 300 iterations "
          f"{t300:.2f} s on the card ({t300_cpu:.2f} s on the CPU), nodes "
          f"moved up to {moved(full, paths).max():.2f} A, end points pinned; "
          f"step 300 from the card's nodes after 299: card == CPU within "
          f"1e-4 A on {(e_step <= 1e-4).sum()} edges (median "
          f"{np.median(e_step):.3g} A, worst {e_step.max():.3g} A), 299 + 1 "
          f"== 300 on the card exactly; the whole runs agree within 1e-3 A "
          f"on {(e300 <= 1e-3).sum()} edges, the other {(e300 > 1e-3).sum()} "
          f"strings took another route (worst {e300.max():.3g} A) {lap()}",
          flush=True)


# the number of wavevectors the scattering step asks for at the bench width
NQ_RANGE = (5000, 10000)


class FixedDescriptors:
    """A descriptor that hands back one matrix: the typing step alone."""

    def __init__(self, matrix):
        self.matrix = matrix

    def get_descriptors(self, st):
        return self.matrix, np.ones(len(self.matrix), np.int64)


def check_site_typing(matrices, device):
    """``SiteTypeAnalysis`` (the PCA in float64 on the device, the Ward tree
    and the cut on the host; no sklearn) on each descriptor matrix, on the
    card against the same call on the CPU with the same matrix, through
    the elbow (``max_types=8``) and at 4 types: type labels equal,
    ``reduced`` within 1e-9 of its largest magnitude, ``distances_``
    within 1e-9 relative."""
    from types import SimpleNamespace
    from sitator_tpu_torch.site_descriptors import SiteTypeAnalysis
    for name, matrix in matrices.items():
        for mode in (dict(max_types=8), dict(n_types=4)):
            runs = {}
            for dev in (device, "cpu"):
                sta = SiteTypeAnalysis(FixedDescriptors(matrix),
                                       verbose=False, device=dev, **mode)
                net = SimpleNamespace()
                sync()
                t0 = time.perf_counter()
                sta.run(net)
                sync()
                runs[dev] = sta, net.site_types, time.perf_counter() - t0
            card, card_labels, t_card = runs[device]
            cpu, cpu_labels, t_cpu = runs["cpu"]
            e_red = float(np.abs(card.reduced - cpu.reduced).max())
            scale = float(np.abs(cpu.reduced).max())
            e_dist = float((np.abs(card.distances_ - cpu.distances_)
                            / np.maximum(np.abs(cpu.distances_),
                                         1e-300)).max())
            check(np.array_equal(card_labels, cpu_labels),
                  f"SiteTypeAnalysis ({name}, {mode}): card and CPU type "
                  "labels differ")
            check(e_red <= 1e-9 * scale, f"SiteTypeAnalysis ({name}, "
                  f"{mode}): reduced differs by {e_red:.3g} (scale "
                  f"{scale:.3g})")
            check(e_dist <= 1e-9, f"SiteTypeAnalysis ({name}, {mode}): "
                  f"distances_ differ by {e_dist:.3g} relative")
            print(f"SiteTypeAnalysis on the {name} descriptors "
                  f"({matrix.shape[0]} x {matrix.shape[1]}, {mode}): "
                  f"{int(card_labels.max()) + 1} types "
                  f"{np.bincount(card_labels).tolist()}; card {t_card:.3f} s, "
                  f"CPU {t_cpu:.3f} s; labels equal, reduced within "
                  f"{e_red / scale:.3g} of its scale, distances_ within "
                  f"{e_dist:.3g} relative (<= 1e-9)", flush=True)


def pair_hist64(fa, fb, exclude, cell, r_max, n_bins, exact, ulps=4,
                max_pairs=2 ** 22, device="cuda"):
    """The float64 oracle of a pair histogram, on the card, independent of
    ``ops/correlation.py``: ``pbc.min_image_disp`` in float64 (matrix
    products; TF32 does not touch float64) on the float32-rounded inputs.
    Returns (int64 counts, pairs within ``ulps`` float32 ulps of a bin edge,
    the ulps taken at the coordinates' scale, the cell's longest row)."""
    import torch
    from sitator_tpu_torch.ops import pbc
    dev = torch.device(device)
    c = torch.as_tensor(np.asarray(cell, np.float64), device=dev)
    inv = torch.linalg.inv(c)
    keep = ~torch.as_tensor(np.asarray(exclude, bool), device=dev)
    tol = ulps * float(np.spacing(np.float32(
        np.linalg.norm(cell, axis=1).max())))
    width = r_max / n_bins
    na, nb = fa.shape[1], fb.shape[1]
    step = max(1, (max_pairs // (27 if exact else 1)) // (na * nb))
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=dev)
    near = torch.zeros((), dtype=torch.int64, device=dev)

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float64)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).double()

    for s in range(0, len(fa), step):
        a, b = on(fa[s:s + step]), on(fb[s:s + step])
        d = pbc.min_image_disp(a[:, :, None] - b[:, None], c, inv,
                               exact=exact)
        x = torch.sqrt((d * d).sum(-1)) / width
        del d
        idx = torch.floor(x).long()
        ok = keep & (idx < n_bins)
        counts += torch.bincount(torch.where(ok, idx, n_bins).reshape(-1),
                                 minlength=n_bins + 1)
        near += (keep & (x <= n_bins + 0.5)
                 & ((x - torch.round(x)).abs() * width <= tol)).sum()
    return counts[:n_bins].cpu().numpy(), int(near)


def phase_transport(device, ctx):
    """The transport and kinetics layer on what the passes handed on (9261
    static atoms, 739 ions, 1024 frames; the streamed network, its labels
    and the merged network): RDF ion–ion and ion–lattice (and the 27-image
    route) against float64 histograms on the card, van Hove on the card
    against the CPU, ρ_q(t) on the card against the CPU, the host transport
    engines, kinetic Monte Carlo on the merged network (its noise replayed
    on the CPU, its transition frequencies, no forbidden step), and density
    barriers along relaxed strings.  No hand-written kernel runs here;
    seconds and peak device memory a step."""
    import torch
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory
    from sitator_tpu_torch.dynamics import (
        ConductivitySpectrumAnalysis, DiffusionAnalysis, JumpAnalysis,
        KineticMonteCarlo, OnsagerAnalysis, PathwayBarrierAnalysis,
        RDFAnalysis, ScatteringAnalysis, VanHoveAnalysis)
    from sitator_tpu_torch.dynamics import kmc as kmc_ops
    from sitator_tpu_torch.network import min_image_distance_matrix
    from sitator_tpu_torch.ops import correlation, scattering
    from scipy.stats import binom

    sn, frames = ctx["sn"], ctx["frames"]
    net, labels = ctx["out"], ctx["labels"]
    cell = np.asarray(sn.structure.cell, np.float64)
    F, W = labels.shape
    mob, sta = sn.mobile_mask, sn.static_mask
    first_cpu_math_calls_on_one_thread()
    st = SiteTrajectory(net, labels)
    st.set_real_traj(frames)
    t_phase = time.perf_counter()

    def step(fn):
        """(result, seconds, peak GB) of ``fn()`` on the card."""
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9)

    def counts_of(g, r_max, n_bins, n_frames, n_pairs):
        """The integer counts behind a g(r), from its normalisation."""
        shells = correlation._shell_volumes(r_max, n_bins)[0]
        norm = n_frames * n_pairs * shells / abs(np.linalg.det(cell))
        return np.rint(g * norm).astype(np.int64)

    def held(name, got, want, near):
        diff = int(np.abs(got - want).sum())
        check(diff <= 2 * near, f"{name}: {diff} counts differ from the "
              f"float64 histogram, more than twice the {near} pairs within "
              "4 f32 ulp of a bin edge")
        return diff

    # 1. RDF: ion-ion over every frame, ion-lattice over 64, 27 images on 8
    r_max = correlation._resolve_r_max(None, cell, False)
    n_ion = int(mob.sum())
    cases = [("ion-ion", dict(), F, mob, mob),
             ("ion-lattice", dict(select_b="static"), min(64, F), mob, sta),
             ("ion-ion exact=True", dict(exact=True), min(8, F), mob, mob)]
    for name, kw, nf, ma, mb in cases:
        sub = SiteTrajectory(net, labels[:nf])
        sub.set_real_traj(frames[:nf])
        ra, t, peak = step(lambda: RDFAnalysis(verbose=False, device=device,
                                               **kw).run(sub))
        ex = correlation._exclude_matrix(ma, mb)
        n_pairs = int(ma.sum()) * int(mb.sum()) - int(ex.sum())
        got = counts_of(ra.g_, r_max, 200, nf, n_pairs)
        want, near = pair_hist64(frames[:nf, ma], frames[:nf, mb], ex, cell,
                                 r_max, 200, kw.get("exact", False),
                                 device=device)
        diff = held(f"RDF {name}", got, want, near)
        check(got.sum() > 0 and np.isfinite(ra.g_).all(),
              f"RDF {name}: empty")
        print(f"RDFAnalysis {name}: {nf} frames x {n_pairs} pairs "
              f"({nf * n_pairs / 1e6:.1f} M pairs) in {t:.3f} s, peak "
              f"{peak:.2f} GB; {int(got.sum())} counts in range, {diff} "
              f"differ from float64 (pairs within 4 f32 ulp of an edge: "
              f"{near}); first peak at {ra.r_[np.argmax(ra.g_)]:.2f} A",
              flush=True)
    # card against CPU on 2 frames: the same IEEE steps, so the same counts
    ex = correlation._exclude_matrix(mob, sta)
    two = [correlation._pair_hist(frames[:2, mob], frames[:2, sta], ex,
                                  cell, r_max, 200, False, device=d)
           for d in (device, "cpu")]
    check(np.array_equal(two[0], two[1]), "RDF ion-lattice on 2 frames: "
          f"card and CPU differ by {np.abs(two[0] - two[1]).sum()} counts")
    print("RDF ion-lattice on 2 frames: card == CPU, every count",
          flush=True)

    # 2. van Hove, ions, every origin; card against CPU on 6 origins
    lags = [lag for lag in (1, 4, 16, 64, 256) if lag < F]
    vh, t, peak = step(lambda: VanHoveAnalysis(
        lags=lags, origin_stride=1, verbose=False, device=device).run(st))
    n_orig = F - max(lags)
    check(vh.G_self_.shape == vh.G_distinct_.shape == (len(lags), 200)
          and np.isfinite(vh.G_distinct_).all(), "VanHoveAnalysis: shapes "
          f"{vh.G_self_.shape}, {vh.G_distinct_.shape}")
    # the self part's normalisation: a density of the (F - lag) * ions
    # displacements, so density * dr * their number is a count of them
    # (the ions hop to any free site: long lags leave some beyond r_max)
    dr = vh.r_[1] - vh.r_[0]
    n_disp = (F - np.asarray(lags)) * n_ion
    c = vh.G_self_ * dr * n_disp[:, None]
    mass = c.sum(axis=1) / n_disp
    check(np.abs(c - np.rint(c)).max() <= 1e-6 * n_disp.max()
          and (mass <= 1 + 1e-9).all() and mass[0] >= 0.9,
          f"VanHoveAnalysis: G_self is not a density of the displacements "
          f"(mass within r_max {mass})")
    stride = max(1, n_orig // 6)
    sub_card, sub_cpu = (correlation.van_hove_distinct(
        frames, cell, mob, lags, origin_stride=stride, device=d)[1]
        for d in (device, "cpu"))
    origins = np.arange(0, n_orig, stride)
    check(np.array_equal(sub_card, sub_cpu), "van Hove on "
          f"{len(origins)} origins: card and CPU differ")
    print(f"VanHoveAnalysis lags {lags}, {n_orig} origins "
          f"({n_orig * n_ion * (n_ion - 1) * len(lags) / 1e9:.2f} G pairs): "
          f"{t:.3f} s, peak {peak:.2f} GB; card == CPU on {len(origins)} "
          f"origins, every bin; G_self mass within "
          f"r_max {np.round(mass, 4).tolist()}", flush=True)

    # 3. scattering on a shell around the lattice's first reciprocal shell
    a_lat = cell[0, 0] / round(cell[0, 0] / 4.0)
    q0 = 2 * np.pi / a_lat
    q_min, q_max = 0.92 * q0, 1.05 * q0
    n_modes = scattering.allowed_wavevectors(cell, q_max, q_min=q_min)[0]
    check(NQ_RANGE[0] <= len(n_modes) <= NQ_RANGE[1],
          f"scattering: Nq = {len(n_modes)}")
    sa, t, peak = step(lambda: ScatteringAnalysis(
        q_max=q_max, q_min=q_min, n_shells=24, verbose=False,
        device=device).run(st))
    check(np.isfinite(sa.F_[sa.n_q_ > 0]).all(), "ScatteringAnalysis: NaN")
    _, t_rho_all, _ = step(lambda: scattering.collective_density_modes(
        frames, cell, mob, n_modes, device=device))
    rho, t_rho, _ = step(lambda: scattering.collective_density_modes(
        frames[:64], cell, mob, n_modes, device=device))
    t0 = time.perf_counter()
    rho_cpu = scattering.collective_density_modes(frames[:64], cell, mob,
                                                  n_modes, device="cpu")
    t_cpu = time.perf_counter() - t0
    e_rho = float(np.abs(rho - rho_cpu).max() / np.abs(rho_cpu).max())
    check(e_rho <= 1e-4, f"rho_q card vs CPU {e_rho:.3g} > 1e-4 relative")
    shell = int(np.nanargmin(np.abs(sa.q_ - q0)))
    print(f"ScatteringAnalysis Nq = {len(n_modes)} ({q_min:.4f} < |q| <= "
          f"{q_max:.4f}), {F} frames: {t:.3f} s, peak {peak:.2f} GB (rho_q "
          f"alone {t_rho_all:.3f} s, the rest host float64); rho_q on "
          f"64 frames {t_rho:.3f} s on the card, {t_cpu:.2f} s on the CPU, "
          f"within {e_rho:.3g} of the largest |rho| (<= 1e-4); S(q) at the "
          f"lattice's first shell (q = {sa.q_[shell]:.4f}, {sa.n_q_[shell]} "
          f"modes) = {sa.S_q_[shell]:.3f}, shell peak "
          f"{np.nanmax(sa.S_q_):.3f}", flush=True)

    # 4. host transport engines on the streamed trajectory
    half = mob & (np.cumsum(mob) <= n_ion // 2)
    groups = [half, mob & ~half]
    t0 = time.perf_counter()
    da = DiffusionAnalysis(temperature=600.0, verbose=False).run(st)
    t_da = time.perf_counter() - t0
    t0 = time.perf_counter()
    oa = OnsagerAnalysis(groups, temperature=600.0, charges=[1.0, 1.0],
                         verbose=False).run(st)
    t_oa = time.perf_counter() - t0
    t0 = time.perf_counter()
    ca = ConductivitySpectrumAnalysis(groups, [1.0, 1.0], temperature=600.0,
                                      verbose=False).run(st)
    t_ca = time.perf_counter() - t0
    check(np.isfinite([da.D_tracer_, da.D_collective_]).all()
          and np.isfinite(oa.L_).all()
          and np.isfinite(ca.sigma_).all(), "host transport: not finite")
    print(f"DiffusionAnalysis {t_da:.3f} s (D_tracer {da.D_tracer_:.4g}, "
          f"Haven {da.haven_ratio_:.3g}); OnsagerAnalysis 2 groups "
          f"{t_oa:.3f} s; ConductivitySpectrumAnalysis {t_ca:.3f} s: finite",
          flush=True)

    # 5. kinetic Monte Carlo on the merged network
    merged, remap = ctx["merged"], ctx["remap"]
    lab_m = np.where(labels >= 0, remap[np.maximum(labels, 0)], -1)
    bare = SiteNetwork(merged.structure, merged.static_mask,
                       merged.mobile_mask)
    bare.centers = merged.centers
    st_m = SiteTrajectory(bare, lab_m.astype(np.int32))
    JumpAnalysis(verbose=False, device=device).run(st_m)
    S = bare.n_sites
    seed, n_kmc = 29, 10000
    kmc = KineticMonteCarlo(n_walkers=W, n_frames=n_kmc, seed=seed,
                            verbose=False, device=device)
    out, t_kmc, peak = step(lambda: kmc.run(bare))
    P = kmc.transition_matrix_
    lab = out.traj
    check(lab.shape == (n_kmc, W), f"KMC labels {lab.shape}")
    # (a) 64 frames on the card; its noise, drawn again from the same
    # seeded generator, replayed on the CPU through the noise-driven walk
    check(kmc_ops._noise_block(W, S) >= 63, "KMC: 63 steps are not one "
          "noise block")
    s0 = lab[0]
    _, t_walk, _ = step(lambda: KineticMonteCarlo._walk(P, s0, n_kmc, seed,
                                                        device=device))
    short = KineticMonteCarlo._walk(P, s0, 64, seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = kmc_ops._gumbel(gen, (63, W, S), torch.device(device))
    logP = kmc_ops._log_transition(P, torch.device(device))
    replay = kmc_ops._walk_with_noise(logP.cpu(), torch.as_tensor(s0),
                                      noise.cpu()).numpy()
    check(np.array_equal(replay, short), "KMC: the CPU replay of the card's "
          f"noise differs on {(replay != short).sum()} labels")
    lp_cpu = kmc_ops._log_transition(P, torch.device("cpu")).numpy()
    lp = logP.cpu().numpy()
    fin = np.isfinite(lp_cpu)
    check(np.array_equal(fin, np.isfinite(lp)), "KMC: log P's support "
          "differs between card and CPU")
    ulp = int(np.abs(lp[fin].view(np.int32) - lp_cpu[fin].view(np.int32))
              .max())
    # (b) transition frequencies, (c) no forbidden step
    pairs = lab[:-1].astype(np.int64) * S + lab[1:]
    counts = np.bincount(pairs.ravel(), minlength=S * S).reshape(S, S)
    check(counts[P == 0].sum() == 0, f"KMC: {counts[P == 0].sum()} steps "
          "where P = 0")
    visits = counts.sum(axis=1)
    rows = visits >= 1000
    n_r = np.broadcast_to(visits[:, None], P.shape)[rows]
    k, p = counts[rows], P[rows]
    live = p > 0
    tail = np.minimum(binom.cdf(k[live], n_r[live], p[live]),
                      binom.sf(k[live] - 1, n_r[live], p[live]))
    z = np.abs(k - n_r * p) / np.sqrt(np.maximum(n_r * p * (1 - p), 1e-300))
    check((2 * tail >= 5.733e-7).all(), "KMC: a transition frequency lies "
          f"beyond 5 binomial sigma of P (smallest two-sided tail "
          f"{2 * tail.min():.3g})")
    print(f"KineticMonteCarlo {W} walkers x {n_kmc} frames on the merged "
          f"network's {S} sites: {t_kmc:.3f} s (the walk alone {t_walk:.3f} "
          f"s, the rest the host's chain set-up), peak {peak:.2f} GB, "
          f"{int((lab[1:] != lab[:-1]).sum())} hops; 64-frame run replayed "
          f"on the CPU from the card's noise: equal; log P card vs CPU within "
          f"{ulp} ulp; {int(rows.sum())} rows with >= 1000 visits, "
          f"{int(live.sum())} entries, every one within 5 binomial sigma "
          f"(largest normal |z| {z[live].max():.2f}); 0 steps where P = 0",
          flush=True)

    # 6. density barriers along relaxed strings, at most 256 edges
    n_ij = np.asarray(net.n_ij)
    D = min_image_distance_matrix(net.centers, net.centers, cell)
    jumped = np.triu(n_ij + n_ij.T >= 1, 1)
    for max_d in (16.0, 14.0, 12.0, 10.0, 8.0, 6.0):
        n_edges = int((jumped & (D <= max_d)).sum())
        if n_edges <= 256:
            break
    check(0 < n_edges <= 256, f"barriers: {n_edges} edges")
    pb, t_pb, peak = step(lambda: PathwayBarrierAnalysis(
        600.0, path="string", min_jumps=1, max_distance=max_d, verbose=False,
        device=device).run(st))
    E = net.density_barrier_ij
    done = np.zeros_like(jumped)
    for (i, j) in pb.profiles_:
        done[i, j] = done[j, i] = True
    check(len(pb.paths_) == len(pb.profiles_) <= n_edges
          and np.isfinite(E[done]).all()
          and np.isnan(E[~done]).all(), "PathwayBarrierAnalysis: barriers "
          "are not finite exactly where the profile is positive")
    print(f"PathwayBarrierAnalysis(path='string', max_distance={max_d}): "
          f"{n_edges} edges, {len(pb.profiles_)} with a positive profile, "
          f"{t_pb:.3f} s, peak {peak:.2f} GB; median barrier "
          f"{np.median(E[done]):.3g} eV", flush=True)
    print(f"transport phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def cli(*argv):
    """``sitator_tpu_torch.cli.main`` in this process: (rc, stdout)."""
    import contextlib
    import io
    from sitator_tpu_torch import cli as port_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(list(argv))
    text = out.getvalue()
    print("  $ sitator_tpu_torch " + " ".join(
        Path(a).name if "/" in a else a for a in argv), flush=True)
    for line in text.splitlines():
        print("    " + line, flush=True)
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    return text


def phase_cli(device, ctx):
    """The command line end to end on the bench system's frames (9261
    static atoms, 739 ions).  256 frames are written as extended XYZ (about
    100 MB of text) and the file is repeated to 2048 frames (the text
    already formatted, copied 8 times).  The native decoder is timed alone
    (index, then the whole file decoded twice), then driven through
    ``sitator_tpu_torch.cli.main`` in this process with the launch counters
    reset first and read after: ``info``, ``convert`` to ``.npy`` with its
    structure sidecar, ``analyze --streaming --out`` at the CLI's defaults
    (two whole 1024-frame blocks) on the ``.npy`` (a memmap reader) and on
    the XYZ itself (the native decoder on the feeder thread) — Voronoi
    seeding, then K2 in the fit and K1 in pass 2 —, eager ``analyze`` on a
    64-frame file (``LandmarkAnalysis``, K2), ``sites`` on the lattice
    structure and ``doctor``; meanwhile one ``python3 -m sitator_tpu_torch
    analyze --streaming`` on that file in a subprocess.  The seeds come
    from the reference lattice (``--structure``), so the basis is the
    bench's 9261 sites.  The networks and labels the two CLI runs save
    (``--out``) must equal an engine built directly with the CLI's
    parameters on the decoded frames in memory, and its tallies the int64
    oracle.  Then pass 2 alone
    on that engine's centres from memory, memmap and XYZ, in 1024-frame
    blocks and in 256-frame blocks (the feeder decodes the next block while
    the card works), each reader twice in the order memory, npy, xyz, xyz,
    npy, memory, with ``phase_times_``; and 256 frames in one block of 1024
    (the CLI's default on a short file: the block runs on its own frames)
    against the same frames in one block of 256."""
    import os
    import tempfile
    import torch
    from sitator_tpu_torch import SiteNetwork, StreamingLandmarkAnalysis
    from sitator_tpu_torch.io import (ArrayTrajectory, NpyTrajectory,
                                      convert_to_npy, open_trajectory,
                                      read_structure, write_xyz)
    from sitator_tpu_torch.io import native
    from sitator_tpu_torch.ops.jumps import _jump_stats_block_int64
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    t_phase = time.perf_counter()
    n_written, copies = 256, 8
    n_frames = n_written * copies
    sn, frames = ctx["sn"], ctx["frames"][:n_written]
    frames = np.concatenate([frames] * copies)
    n_ions = int(sn.mobile_mask.sum())
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    check(gxx.returncode == 0, "g++ is not usable: " + gxx.stderr[-300:])
    print(f"g++: {gxx.stdout.splitlines()[0]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        part, xyz = tmp / "md256.xyz", str(tmp / "md.xyz")
        npy = str(tmp / "md.npy")
        t0 = time.perf_counter()
        write_xyz(str(part), sn.structure, frames[:n_written])
        t_write = time.perf_counter() - t0
        text = part.read_bytes()
        with open(xyz, "wb") as f:
            for _ in range(copies):
                f.write(text)
        del text
        mb = os.path.getsize(xyz) / 1e6
        print(f"write_xyz: {n_written} frames, {mb / copies:.1f} MB in "
              f"{t_write:.2f} s; repeated to {n_frames} frames, {mb:.1f} MB",
              flush=True)

        # the native decoder alone: build, index scan, whole-file decodes
        t0 = time.perf_counter()
        check(native.get_lib() is not None, "the fast-IO library does not "
              "build (g++): the readers would fall back to Python")
        t_lib = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = native.FastXYZTrajectory(xyz, cache_index=False)
        t_index = time.perf_counter() - t0
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            decoded = r[0:n_frames]
            rates.append(n_frames / (time.perf_counter() - t0))
        check(np.abs(decoded - frames).max() < 1e-5,
              "native decode differs from the frames written")
        print(f"native XYZ decode ({r.n_threads} threads): library "
              f"{t_lib:.2f} s, index {t_index:.3f} s "
              f"({n_frames / t_index:.0f} frames/s, {mb / t_index:.0f} MB/s), "
              "decode of the whole file twice: " + ", ".join(
                  f"{x:.1f} frames/s ({x * mb / n_frames:.0f} MB/s of text)"
                  for x in rates), flush=True)

        reset_launches()
        out = cli("info", xyz)
        check(f"frames:  {n_frames}" in out, "info: frame count")
        out = cli("convert", xyz, npy)
        check("structure sidecar" in out
              and os.path.exists(npy + ".structure.xyz"), "no sidecar")
        check(np.array_equal(np.load(npy, mmap_mode="r"), decoded),
              "the converted .npy differs from the native decode")
        readers = {"npy": NpyTrajectory, "xyz": native.FastXYZTrajectory}
        for k, src in (("npy", npy), ("xyz", xyz)):
            check(type(open_trajectory(src)) is readers[k],
                  f"open_trajectory({k}) gave {type(open_trajectory(src))}")
        # the seeds come from the reference lattice (the ideal host and the
        # ions of frame 0), as the bench's sites do: Voronoi on a thermally
        # jittered frame splits each cube centre into 4-5 nodes (42,043 of
        # them here)
        lattice = str(tmp / "lattice.xyz")
        write_xyz(lattice, sn.structure)
        args = ["--mobile", "Li", "--structure", lattice,
                "--cutoff-midpoint", str(MID), "--cutoff-steepness",
                str(STEEP), "--streaming"]
        peaks, walls = [], []
        for src in (npy, xyz):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = cli("analyze", src, *args, "--out", src + ".r.npz")
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            check(f"streamed {n_frames} frames" in out,
                  "analyze --streaming: no summary line")
        # pass 2 writes the lv of a whole block to device memory before
        # the similarity (K1's lv_tile → assign_tail): 1024 x 768 x 9344 f32
        print("analyze --streaming at the defaults (1024-frame blocks), "
              "seeding, fit, pass 2 and save, from the .npy and the XYZ: "
              + ", ".join(f"{w:.2f} s" for w in walls) + "; peak device "
              "memory " + ", ".join(f"{p:.2f} GB" for p in peaks), flush=True)
        small = str(tmp / "md64.npy")
        convert_to_npy(ArrayTrajectory(frames[:64], sn.structure), small)
        # the subprocess shares the card: hand back this process's cached
        # blocks, and stream in 64-frame blocks (1.8 GB of lv)
        torch.cuda.empty_cache()
        proc = subprocess.Popen(
            [sys.executable, "-m", "sitator_tpu_torch", "analyze", small,
             *args, "--block-frames", "64"], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out = cli("analyze", small, *args[:-1])
            check("final:" in out and "assigned:" in out,
                  "eager analyze: no summary")
            out = cli("sites", lattice, "--mobile", "Li")
            check("Voronoi sites" in out, "sites: no summary")
            out = cli("doctor")
            check("healthy" in out and "backend: cuda" in out,
                  "doctor on the card")
        finally:
            sub_out, sub_err = proc.communicate(timeout=300)
        launches = read_launches()
        check(launches["K1"] > 0 and launches["K2"] > 0,
              f"the CLI launched {launches}")
        check(proc.returncode == 0,
              f"python3 -m sitator_tpu_torch exited {proc.returncode}: "
              + sub_err[-2000:])
        check("streamed 64 frames" in sub_out,
              "python3 -m sitator_tpu_torch: no summary line")
        print(f"python3 -m sitator_tpu_torch analyze --streaming (a "
              f"subprocess on the card): exit 0, '"
              + [ln for ln in sub_out.splitlines() if "streamed" in ln][0]
              + "'", flush=True)
        print(f"cli launches (info, convert, two streamed analyses, eager "
              f"analyze, sites, doctor): {launches}", flush=True)

        # what the CLI saved against an engine built directly with its
        # parameters (cli.py defaults) on the frames in memory
        structure = read_structure(lattice)
        mobile = structure.species == 3   # Li, as ``--mobile Li``
        seeded = VoronoiSiteGenerator(merge_tol=0.05).run(
            SiteNetwork(structure, ~mobile, mobile))
        kw = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
                  minimum_site_occupancy=0.01, verbose=False, device=device)
        direct = StreamingLandmarkAnalysis(
            block_frames=1024, store_labels=str(tmp / "direct.npy"), **kw)
        memory = ArrayTrajectory(decoded)
        centers = direct.fit_centers(seeded, memory)
        want = direct.run(seeded, memory, centers=centers)
        lab_direct = np.array(np.load(direct.store_labels))
        oracle, _, _ = _jump_stats_block_int64(
            lab_direct, len(centers), np.full(n_ions, -1, np.int64),
            np.zeros(n_ions, np.int64), "persist")
        check(np.array_equal(want.n_ij, oracle["n_ij"]),
              "direct engine n_ij differs from the int64 oracle")
        for src in (npy, xyz):
            check_same_streaming(
                f"cli {Path(src).name} vs the engine",
                SiteNetwork.load(src + ".r.npz"), want,
                np.load(src + ".r.npz.labels.npy"), lab_direct)
        print(f"cli streamed runs (.npy and XYZ): {len(centers)} sites, "
              f"{int(want.n_ij.sum())} jumps; the saved networks and labels "
              "== the engine called directly on the frames, n_ij == int64 "
              "oracle", flush=True)

        # pass 2 alone: does the feeder keep up?
        sources = {"memory": lambda: memory, "npy": lambda: NpyTrajectory(npy),
                   "xyz": lambda: native.FastXYZTrajectory(xyz)}
        for block in (1024, 256):
            for name in ("memory", "npy", "xyz", "xyz", "npy", "memory"):
                reader = sources[name]()
                eng = StreamingLandmarkAnalysis(block_frames=block, **kw)
                sync()
                t0 = time.perf_counter()
                got = eng.run(seeded, reader, centers=centers)
                sync()
                dt = time.perf_counter() - t0
                check(np.array_equal(got.n_ij, want.n_ij),
                      f"pass 2 from {name} in {block}-frame blocks: n_ij "
                      "differs")
                print(f"pass 2 from {name} ({type(reader).__name__}, "
                      f"{n_frames // block} blocks of {block} frames, depth "
                      f"{eng.pipeline_depth}): {n_frames / dt:.1f} frames/s "
                      f"({dt:.3f} s); phase_times_ (s): " + json.dumps(
                          {a: round(b, 4)
                           for a, b in eng.phase_times_.items()}), flush=True)
        # a short input at the CLI's default block: 256 frames run as a
        # block of their own
        short = ArrayTrajectory(decoded[:n_written])
        for block in (1024, n_written, 1024, n_written):
            eng = StreamingLandmarkAnalysis(block_frames=block, **kw)
            sync()
            t0 = time.perf_counter()
            eng.run(seeded, short, centers=centers)
            sync()
            dt = time.perf_counter() - t0
            print(f"pass 2 on {n_written} frames from memory in one block of "
                  f"{block}: {n_written / dt:.1f} frames/s ({dt:.3f} s)",
                  flush=True)
        zarr_launches = zarr_passes(tmp, decoded, structure, seeded, kw)
        h5_launches = h5_passes(tmp, decoded, structure, seeded, kw)
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: launches[k] + zarr_launches[k] + h5_launches[k]
            for k in launches}


# -- test-side zarr writers: the card's machine has no tensorstore, so the
# stores of ``zarr_passes`` are written here, independently of the port
# (zstd through libzstd.so.1 by ctypes, bitshuffle and crc32c in NumPy and
# Python); ``tests/test_torch_zarr_layouts.py`` holds them to tensorstore

def _libzstd():
    import ctypes
    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_int]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    return lib


def zstd_compress_all(buffers, level):
    """One zstd frame (``bytes``) of each C-contiguous buffer, 8 at a
    time on threads (ctypes lets go of the interpreter)."""
    from concurrent.futures import ThreadPoolExecutor
    lib = _libzstd()

    def one(buf):
        src = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
        dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
        n = lib.ZSTD_compress(dst.ctypes.data, dst.size, src.ctypes.data,
                              src.size, level)
        check(not lib.ZSTD_isError(n), "ZSTD_compress failed")
        return dst[:n].tobytes()
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, buffers))


def crc32c_py(data):
    """CRC-32C (Castagnoli, reflected 0x82F63B78), bit by bit."""
    c = 0xFFFFFFFF
    for b in bytes(data):
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


def bitshuffle_blocks(blocks, ts):
    """Bitshuffle each row of ``blocks`` (uint8, (n, bytes)) over elements
    of ``ts`` bytes, as c-blosc 1.x: row (j, k) of ne / 8 bytes holds bit k
    of byte j of every element (element i at bit i % 8 of byte i / 8).
    The element count must be a multiple of 8.  Byte j of 8 elements is
    one uint64, whose 8 x 8 bit matrix is transposed (Hacker's Delight)."""
    n, nbytes = blocks.shape
    ne = nbytes // ts
    x = np.ascontiguousarray(blocks.reshape(n, ne // 8, 8, ts).transpose(
        0, 3, 1, 2)).view("<u8")[..., 0]
    for shift, mask in ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                        (28, 0x00000000F0F0F0F0)):
        t = (x ^ (x >> np.uint64(shift))) & np.uint64(mask)
        x = x ^ t ^ (t << np.uint64(shift))
    return np.ascontiguousarray(x).view(np.uint8).reshape(
        n, ts, ne // 8, 8).transpose(0, 1, 3, 2).reshape(n, nbytes)


def blosc_zstd_bitshuffle_frames(chunks, level=1, blocksize=1 << 18):
    """Blosc1 frames of float32 chunks: zstd at ``level``, bitshuffle,
    typesize 4, no split, blocks of ``blocksize`` bytes (the leftover block
    of a chunk whose element count is a multiple of 8 bitshuffled too; one
    whose count is not, stored as is, as c-blosc does)."""
    import struct
    frames = []
    for chunk in chunks:
        raw = np.ascontiguousarray(chunk, np.float32).reshape(-1).view(
            np.uint8)
        nbytes = raw.size
        bs = min(blocksize, nbytes)
        full = nbytes // bs
        blocks = [bitshuffle_blocks(raw[:full * bs].reshape(full, bs), 4)]
        rest = raw[full * bs:]
        if rest.size:
            blocks.append(bitshuffle_blocks(rest[None], 4)
                          if rest.size % 32 == 0 else rest[None])
        blocks = [r for b in blocks for r in b]
        packed = zstd_compress_all(blocks, level)
        streams = [struct.pack("<i", len(p)) + p if len(p) < b.size
                   else struct.pack("<i", b.size) + b.tobytes()
                   for b, p in zip(blocks, packed)]
        start = 16 + 4 * len(streams)
        starts, pos = [], start
        for s in streams:
            starts.append(pos)
            pos += len(s)
        head = struct.pack("<BBBBiii", 2, 1, (4 << 5) | 0x10 | 0x04, 4,
                           nbytes, bs, pos)
        frames.append(head + struct.pack(f"<{len(starts)}i", *starts)
                      + b"".join(streams))
    return frames


def write_blosc_zstd_bitshuffle_store(path, frames, chunk, level=1):
    """A zarr v2 store of ``frames`` (float32) in chunks of ``chunk``
    frames: the compressor Blosc, cname zstd, bitshuffle."""
    import os
    import shutil
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    shape = [int(s) for s in frames.shape]
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump({"zarr_format": 2, "shape": shape,
                   "chunks": [chunk, *shape[1:]], "dtype": "<f4",
                   "compressor": {"id": "blosc", "cname": "zstd",
                                  "clevel": level, "shuffle": 2,
                                  "blocksize": 0},
                   "fill_value": 0.0, "filters": None, "order": "C",
                   "dimension_separator": "."}, f)
    for lo in range(0, len(frames), 8 * chunk):
        parts = []
        for a in range(lo, min(lo + 8 * chunk, len(frames)), chunk):
            part = np.zeros((chunk, *shape[1:]), np.float32)
            part[:min(chunk, len(frames) - a)] = frames[a:a + chunk]
            parts.append(part)
        for k, blob in enumerate(blosc_zstd_bitshuffle_frames(parts, level)):
            name = ".".join([str(lo // chunk + k)] + ["0"] * (len(shape) - 1))
            with open(os.path.join(path, name), "wb") as f:
                f.write(blob)


def write_sharded_zstd_store(path, frames, shard, inner, level=1):
    """A zarr v3 store of ``frames`` (float32): shards of ``shard`` frames
    holding inner chunks of ``inner`` (codecs ``bytes`` + ``zstd``), the
    index (``bytes`` + ``crc32c``) at the end of each shard file."""
    import os
    import shutil
    import struct
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    shape = [int(s) for s in frames.shape]
    little = {"name": "bytes", "configuration": {"endian": "little"}}
    with open(os.path.join(path, "zarr.json"), "w") as f:
        json.dump({"zarr_format": 3, "node_type": "array", "shape": shape,
                   "data_type": "float32",
                   "chunk_grid": {"name": "regular", "configuration": {
                       "chunk_shape": [shard, *shape[1:]]}},
                   "chunk_key_encoding": {"name": "default"},
                   "fill_value": 0.0,
                   "codecs": [{"name": "sharding_indexed", "configuration": {
                       "chunk_shape": [inner, *shape[1:]],
                       "codecs": [little, {"name": "zstd", "configuration": {
                           "level": level, "checksum": False}}],
                       "index_codecs": [little, {"name": "crc32c"}],
                       "index_location": "end"}}]}, f)
    absent = 2 ** 64 - 1
    for s, lo in enumerate(range(0, len(frames), shard)):
        parts = []
        for a in range(lo, lo + shard, inner):
            if a >= len(frames):
                parts.append(None)
                continue
            part = np.zeros((inner, *shape[1:]), np.float32)
            part[:min(inner, len(frames) - a)] = frames[a:a + inner]
            parts.append(part)
        blobs = zstd_compress_all([p for p in parts if p is not None],
                                  level)
        index, body, pos = [], [], 0
        for p in parts:
            if p is None:
                index += [absent, absent]
                continue
            blob = blobs.pop(0)
            index += [pos, len(blob)]
            body.append(blob)
            pos += len(blob)
        index = struct.pack(f"<{len(index)}Q", *index)
        index += struct.pack("<I", crc32c_py(index))
        shard_dir = os.path.join(path, "c", str(s),
                                 *["0"] * (len(shape) - 2))
        os.makedirs(shard_dir, exist_ok=True)
        with open(os.path.join(shard_dir, "0"), "wb") as f:
            f.write(b"".join(body) + index)


# -- test-side HDF5 writer: the card's machine has no h5py, so the files of
# ``h5_passes`` are written here, independently of the port, in the format
# h5py writes under libver "earliest" (superblock v1, v1 object headers, an
# old-style root group, data layout v3); ``tests/test_torch_h5_layouts.py``
# holds them to h5py

_H5_UNDEF = 2 ** 64 - 1


def _h5_header(messages):
    """A v1 object header of (type, body) messages, each padded to 8
    bytes; the datatype, fill value and filter pipeline flagged constant,
    as h5py writes them."""
    import struct
    body = b""
    for mtype, data in messages:
        data = data + b"\0" * (-len(data) % 8)
        constant = 1 if mtype in (3, 5, 11) else 0
        body += struct.pack("<HHB3x", mtype, len(data), constant) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def write_h5_trajectory(path, frames, chunk_frames=None):
    """An HDF5 file holding ``frames`` (float32, ``(F, A, 3)``) as the
    dataset ``positions`` of its root group: contiguous, or
    (``chunk_frames``) chunked in whole frames, each chunk byte-shuffled
    and deflated at level 4 (h5py's ``gzip`` default) on 8 threads, the
    chunks indexed by one v1 B-tree leaf."""
    import struct
    import zlib
    from concurrent.futures import ThreadPoolExecutor
    frames = np.ascontiguousarray(frames, np.float32)
    shape = frames.shape
    name = b"positions\0"
    heap_data = b"\0" * 8 + name + b"\0" * (-len(name) % 8)
    chunks = []
    if chunk_frames:
        c0 = int(chunk_frames)

        def encode(i):
            part = np.zeros((c0, *shape[1:]), np.float32)
            part[:min(c0, shape[0] - i * c0)] = frames[i * c0:(i + 1) * c0]
            shuffled = part.reshape(-1).view(np.uint8).reshape(-1, 4).T
            return zlib.compress(shuffled.tobytes(), 4)
        with ThreadPoolExecutor(8) as pool:
            chunks = list(pool.map(encode, range(-(-shape[0] // c0))))
    istore_k = max(32, (len(chunks) + 1) // 2)
    # addresses: superblock, root header, root B-tree, local heap, its
    # data, SNOD, the dataset's header, its chunk B-tree, then the data
    root_oh = 104
    group_bt = root_oh + 40
    heap = group_bt + 24 + 32 * 16 + 8
    heap_at = heap + 32
    snod = heap_at + len(heap_data)
    dset_oh = snod + 8 + 8 * 40
    space = struct.pack("<BBBx4x", 1, len(shape), 1) + struct.pack(
        f"<{2 * len(shape)}Q", *shape, *shape)
    dtype = bytes.fromhex("11201f0004000000") + struct.pack(
        "<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
    fill = struct.pack("<BBBBI", 2, 3 if chunks else 2, 2, 1, 0)
    messages = [(1, space), (3, dtype), (5, fill)]
    if chunks:
        # shuffle (client data: the element size), then deflate (level 4)
        pipeline = struct.pack("<BB6x", 1, 2)
        for fid, fname, cd in ((2, b"shuffle\0", 4), (1, b"deflate\0", 4)):
            pipeline += struct.pack("<HHHH", fid, len(fname), 1, 1) + fname
            pipeline += struct.pack("<Ixxxx", cd)
        messages.append((11, pipeline))
    layout_size = 32 if chunks else 24
    head_size = len(_h5_header(messages + [(8, b"\0" * layout_size)]))
    chunk_bt = dset_oh + head_size
    key_size = 8 + 8 * (len(shape) + 1)
    data_at = chunk_bt + (24 + 2 * istore_k * (key_size + 8) + key_size
                          if chunks else 0)
    if chunks:
        layout = struct.pack("<BBBQ", 3, 2, len(shape) + 1, chunk_bt) + \
            struct.pack(f"<{len(shape) + 1}I", c0, *shape[1:], 4)
    else:
        layout = struct.pack("<BBQQ", 3, 1, data_at, frames.nbytes)
    dset = _h5_header(messages + [(8, layout)])
    assert len(dset) == head_size
    eof = data_at + (sum(map(len, chunks)) if chunks else frames.nbytes)
    sb = (b"\x89HDF\r\n\x1a\n" + struct.pack(
        "<BBBBBBBBHHIHH", 1, 0, 0, 0, 0, 8, 8, 0, 4, 16, 0, istore_k, 0)
        + struct.pack("<QQQQ", 0, _H5_UNDEF, eof, _H5_UNDEF)
        + struct.pack("<QQII", 0, root_oh, 1, 0)
        + struct.pack("<QQ", group_bt, heap))
    sb += b"\0" * (root_oh - len(sb))
    root = _h5_header([(17, struct.pack("<QQ", group_bt, heap))])
    tree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _H5_UNDEF, _H5_UNDEF)
            + struct.pack("<QQQ", 0, snod, 8))
    tree += b"\0" * (heap - group_bt - len(tree))
    # free list offset 1: the heap has no free block
    local = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_at)
    entries = struct.pack("<QQII16x", 8, dset_oh, 0, 0)
    symbols = b"SNOD" + struct.pack("<BxH", 1, 1) + entries
    symbols += b"\0" * (dset_oh - snod - len(symbols))
    with open(path, "wb") as f:
        f.write(sb + root + tree + local + heap_data + symbols + dset)
        if chunks:
            node = b"TREE" + struct.pack("<BBHQQ", 1, 0, len(chunks),
                                         _H5_UNDEF, _H5_UNDEF)
            at = data_at
            for i, blob in enumerate(chunks):
                node += struct.pack(f"<II{len(shape) + 1}Q", len(blob), 0,
                                    i * c0, *[0] * len(shape)) + \
                    struct.pack("<Q", at)
                at += len(blob)
            node += struct.pack(f"<II{len(shape) + 1}Q", 0, 0,
                                len(chunks) * c0, *[0] * len(shape))
            f.write(node + b"\0" * (data_at - chunk_bt - len(node)))
            for blob in chunks:
                f.write(blob)
        else:
            f.write(memoryview(frames.reshape(-1).view(np.uint8)))


def write_h5_segments(d, frames, turn):
    """The data the headers of ``tests/data/torch_h5_bench/`` (made by
    ``tests/_torch_h5_layouts.py::bench_headers``) name, written into the
    directory ``d``: the ring segments ``seg{k}.h5`` of ``vds.h5`` (segment
    k holds ``segment_frames(len(frames), k, turn)``; the second chunked in
    8 frames with shuffle + deflate 4, the others contiguous) and the raw
    segments ``seg{k}.bin`` of ``external.h5`` (a quarter of the frames
    each, in order, by ``ndarray.tofile``)."""
    import os
    from tests._torch_h5_layouts import segment_frames
    q = len(frames) // 4
    for k in range(4):
        write_h5_trajectory(os.path.join(d, f"seg{k}.h5"),
                            frames[segment_frames(len(frames), k, turn)],
                            chunk_frames=8 if k == 1 else None)
        np.ascontiguousarray(frames[k * q:(k + 1) * q], np.float32).tofile(
            os.path.join(d, f"seg{k}.bin"))


def store_turns(tmp, sources, order, n_frames, block, seeded, kw, what):
    """The streaming fit (K2) and pass 2 (K1) in blocks of ``block`` frames
    from each source in ``order``, then back, with the launch counters
    reset before and read after.  Every run's fitted centres, labels and
    ``n_ij`` must equal the first run's bit for bit.  Returns (pass 2
    frames/s by source, feeder wait by source, launches)."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    first, fps, feeder = None, {}, {}
    reset_launches()
    for name in order + order[::-1]:
        reader = sources[name]()
        labels_path = str(tmp / "zlabels.npy")
        eng = StreamingLandmarkAnalysis(block_frames=block,
                                        store_labels=labels_path, **kw)
        t0 = time.perf_counter()
        centers = eng.fit_centers(seeded, reader)
        sync()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = eng.run(seeded, reader, centers=centers)
        sync()
        dt = time.perf_counter() - t0
        labels = np.load(labels_path)
        if first is None:
            first = centers, labels, got.n_ij
        check(np.array_equal(centers, first[0]), f"the fit from {name} "
              "differs from the fit from memory")
        check(np.array_equal(labels, first[1])
              and np.array_equal(got.n_ij, first[2]),
              f"pass 2 from {name}: labels or n_ij differ from memory's")
        fps.setdefault(name, []).append(n_frames / dt)
        feeder.setdefault(name, []).append(
            eng.phase_times_.get("feeder", float("nan")))
        print(f"fit + pass 2 from {name} ({type(reader).__name__}, "
              f"{n_frames // block} blocks of {block} frames): fit "
              f"{t_fit:.2f} s; pass 2 {n_frames / dt:.1f} frames/s "
              f"({dt:.3f} s), feeder wait {feeder[name][-1]:.3f} s; "
              "phase_times_ (s): " + json.dumps(
                  {a: round(b, 4) for a, b in eng.phase_times_.items()}),
              flush=True)
    launches = read_launches()
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"the {what}-fed runs launched {launches}")
    print("pass 2 frames/s by source (two runs each): " + json.dumps(
        {k: [round(x, 1) for x in v] for k, v in fps.items()})
        + f"; centres, labels and n_ij of every run == memory's; launches "
        f"{launches}", flush=True)
    return fps, feeder, launches


def zarr_passes(tmp, decoded, structure, seeded, kw):
    """Zarr stores at the bench width: the phase's frames twice over (4096
    frames, 491 MB of float32) converted by the port's ``convert_to_zarr``
    to a zarr v2 store (blosc/LZ4, shuffle) and a zarr v3 store (raw
    bytes), in chunks of 256 frames, and written by this script's own
    writers to a zarr v3 sharded store (shards of 1024 frames, inner chunks
    of 256: ``bytes`` + ``zstd`` level 1, index ``bytes`` + ``crc32c``) and
    a zarr v2 store of Blosc/zstd level 1 with bitshuffle (chunks of 256);
    each codec's decode alone over every chunk of its store; then the
    streaming fit (K2) and pass 2 (K1) in 16 blocks of 256 frames from
    memory, the ``.npy`` memmap and the four stores, in the order memory,
    npy, v2, v3, sharded, Blosc/zstd, then back, with the launch counters
    reset before and read after.  Every run's fitted centres, labels and
    ``n_ij`` equal the first memory run's bit for bit.  Returns the
    launches."""
    import os
    import shutil
    from sitator_tpu_torch.io import (ArrayTrajectory, NpyTrajectory,
                                      TensorstoreTrajectory, convert_to_zarr,
                                      open_trajectory)
    from sitator_tpu_torch.io import zarr_store

    n_z, block = 2 * len(decoded), 256
    frames = np.concatenate([decoded, decoded])
    raw_mb = frames.nbytes / 1e6
    npy = str(tmp / "zmd.npy")
    np.save(npy, frames)
    sharded, bzstd = "zarr v3 sharded zstd", "zarr v2 blosc/zstd bitshuffle"
    writers = {
        "zarr v2": ("blosc/LZ4, shuffle, chunks of 256 frames: the port's "
                    "convert_to_zarr", lambda path: convert_to_zarr(
                        ArrayTrajectory(frames, structure), path,
                        chunk_frames=block, zarr_format=2)),
        "zarr v3": ("raw bytes, chunks of 256 frames: the port's "
                    "convert_to_zarr", lambda path: convert_to_zarr(
                        ArrayTrajectory(frames, structure), path,
                        chunk_frames=block, zarr_format=3)),
        sharded: ("shards of 1024 frames, inner chunks of 256 (bytes + "
                  "zstd level 1), index bytes + crc32c: this script's "
                  "writer", lambda path: write_sharded_zstd_store(
                      path, frames, shard=4 * block, inner=block)),
        bzstd: ("Blosc zstd level 1, bitshuffle, chunks of 256 frames: this "
                "script's writer", lambda path: write_blosc_zstd_bitshuffle_store(
                    path, frames, chunk=block))}
    stores, share = {}, {}
    for i, (name, (what, write)) in enumerate(writers.items()):
        path = str(tmp / f"md_{i}.zarr")
        t0 = time.perf_counter()
        write(path)
        t_conv = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(path) for f in fs)
        stores[name], share[name] = path, size / frames.nbytes
        reader = open_trajectory(path)
        check(type(reader) is TensorstoreTrajectory and reader._ts is None,
              f"open_trajectory({name}) gave {type(reader)}")
        print(f"{name} ({what}): {n_z} frames x {frames.shape[1]} atoms "
              f"written in {t_conv:.2f} s ({raw_mb / t_conv:.0f} MB/s of "
              f"frames); {size / 1e6:.1f} MB on disk, {share[name]:.3f} of "
              f"the {raw_mb:.1f} MB of float32 frames", flush=True)

    # each codec alone: every chunk of its store decoded in one call
    def chunk_files(name):
        store = zarr_store.ZarrArray(stores[name])
        blobs = []
        for i in range(store.grid[0]):
            with open(store.chunk_path((i, 0, 0)), "rb") as f:
                blobs.append(np.frombuffer(f.read(), np.uint8))
        return store, blobs

    def inner_chunks(name):
        store, shards = chunk_files(name)
        m = store._shard.index_nbytes
        blobs = []
        for blob in shards:
            entries = store._shard.entries([blob[-m:]], [name])[0]
            blobs += [blob[int(o):int(o) + int(n)] for o, n in entries]
        return store, blobs

    decode_rate = {}
    for name, fn, blobs_of in (
            ("zarr v2", zarr_store.blosc_decode, chunk_files),
            (bzstd, zarr_store.blosc_decode, chunk_files),
            (sharded, zarr_store.zstd_decode, inner_chunks)):
        store, blobs = blobs_of(name)
        outs = [np.empty((block, *frames.shape[1:]), np.float32)
                for _ in blobs]
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn(blobs, outs)
            rates.append(sum(o.nbytes for o in outs) / 1e6
                         / (time.perf_counter() - t0))
        check(np.array_equal(np.concatenate(outs)[:n_z], frames),
              f"the {name} codec's decode differs from the frames written")
        decode_rate[name] = rates
        print(f"{name}: {fn.__name__} alone ({zarr_store.N_THREADS} threads, "
              f"{len(blobs)} chunks of {block} frames, "
              f"{sum(b.size for b in blobs) / 1e6:.1f} MB in): "
              + ", ".join(f"{r:.0f} MB/s" for r in rates)
              + " of decoded frames", flush=True)

    sources = {"memory": lambda: ArrayTrajectory(frames),
               "npy": lambda: NpyTrajectory(npy),
               **{name: (lambda p=path: open_trajectory(p))
                  for name, path in stores.items()}}
    fps, feeder, launches = store_turns(
        tmp, sources, ["memory", "npy", "zarr v2", "zarr v3", sharded, bzstd],
        n_z, block, seeded, kw, "zarr")
    memmap = np.mean(fps["npy"])
    for name in stores:
        rate = (", ".join(f"{r:.0f}" for r in decode_rate[name]) + " MB/s"
                if name in decode_rate else "no codec")
        print(f"{name}: decode alone {rate}; pass 2 "
              f"{np.mean(fps[name]):.1f} frames/s = "
              f"{np.mean(fps[name]) / memmap:.3f} of the memmap's "
              f"{memmap:.1f} in this call; feeder "
              + ", ".join(f"{f:.3f}" for f in feeder[name])
              + f" s; on disk {share[name]:.3f} of the raw bytes",
              flush=True)
    for path in stores.values():
        shutil.rmtree(path)
    os.remove(npy)
    return launches


def h5_passes(tmp, decoded, structure, seeded, kw):
    """HDF5 files at the bench width: the phase's frames twice over (4096
    frames, 491 MB of float32) written by this script's own writer
    (``write_h5_trajectory``: the card's machine has no h5py) contiguous,
    and chunked in 8 frames (960 KB, about h5py's own chunk size) with
    byte shuffle and deflate level 4 (h5py's ``gzip`` default); and read
    through the three headers h5py made, committed in
    ``tests/data/torch_h5_bench/`` and copied beside their data: a virtual
    dataset over four ring segments of 1024 frames (``write_h5_segments``;
    the second chunked as above; turned by 128 frames, so blocks cross a
    segment border and a codec), external storage in four raw segments
    (``ndarray.tofile``; the run's working directory is theirs, as HDF5
    resolves them against it) and an external link to the chunked file.
    Each input read whole by the port's reader (``H5Dataset.read``: the
    decode alone, MB/s); then the streaming fit (K2) and pass 2 (K1) in 16
    blocks of 256 frames from memory, the ``.npy`` memmap and the five
    inputs, in the order memory, npy, contiguous, chunked, virtual,
    external, link, then back, through ``open_trajectory`` on the port's
    own reader (``_h5py is None``).  Every run's fitted centres, labels and
    ``n_ij`` equal the first memory run's bit for bit.  Returns the
    launches."""
    import os
    import shutil
    from tests import _torch_h5_layouts as layouts

    n_h, block = 2 * len(decoded), 256
    frames = np.concatenate([decoded, decoded])
    raw_mb = frames.nbytes / 1e6
    npy = str(tmp / "hmd.npy")
    np.save(npy, frames)
    chunked = "h5 chunked shuffle+deflate"
    writers = {
        "h5 contiguous": ("one contiguous dataset", lambda path:
                          write_h5_trajectory(path, frames)),
        chunked: ("chunks of 8 frames, byte shuffle + deflate level 4",
                  lambda path: write_h5_trajectory(path, frames,
                                                   chunk_frames=8)),
    }
    files, share = {}, {}
    for i, (name, (what, write)) in enumerate(writers.items()):
        path = str(tmp / f"md_{i}.h5")
        t0 = time.perf_counter()
        write(path)
        t_write = time.perf_counter() - t0
        files[name], share[name] = path, os.path.getsize(path) / frames.nbytes
        print(f"{name} ({what}; this script's writer): {n_h} frames x "
              f"{frames.shape[1]} atoms written in {t_write:.2f} s; "
              f"{os.path.getsize(path) / 1e6:.1f} MB on disk, "
              f"{share[name]:.3f} of the {raw_mb:.1f} MB of float32 frames",
              flush=True)
    check(frames.shape == layouts.BENCH_SHAPE, f"{frames.shape} frames for "
          f"headers of {layouts.BENCH_SHAPE}")
    t0 = time.perf_counter()
    write_h5_segments(str(tmp), frames, layouts.BENCH_TURN)
    t_write = time.perf_counter() - t0
    segments = [str(tmp / f"seg{k}.{x}") for k in range(4)
                for x in ("h5", "bin")]
    headers = {"h5 virtual (4 ring segments)": "vds.h5",
               "h5 external storage (4 raw segments)": "external.h5",
               "h5 external link (to the chunked file)": "link.h5"}
    for name, header in headers.items():
        shutil.copy(os.path.join(layouts.BENCH, header), tmp / header)
        files[name] = str(tmp / header)
        share[name] = sum(os.path.getsize(p) for p in segments if p.endswith(
            ".h5" if header == "vds.h5" else ".bin")) / frames.nbytes
    share["h5 external link (to the chunked file)"] = share[chunked]
    print(f"h5 segments (this script's writer): 4 ring segments of "
          f"{n_h // 4} frames (the second chunked in 8, shuffle + deflate "
          f"4) and 4 raw segments written in {t_write:.2f} s; the committed "
          "headers vds.h5, external.h5, link.h5 copied beside them",
          flush=True)
    layout = {"h5 contiguous": "contiguous", chunked: "chunked",
              "h5 virtual (4 ring segments)": "virtual",
              "h5 external storage (4 raw segments)": "external",
              "h5 external link (to the chunked file)": "chunked"}
    home = os.getcwd()
    os.chdir(tmp)          # external storage resolves against it
    try:
        return _h5_reads_and_turns(tmp, frames, npy, files, share, layout,
                                   seeded, kw, n_h, block, raw_mb)
    finally:
        os.chdir(home)
        for path in [*files.values(), *segments, npy]:
            os.remove(path)


def _h5_reads_and_turns(tmp, frames, npy, files, share, layout, seeded, kw,
                        n_h, block, raw_mb):
    from sitator_tpu_torch.io import (ArrayTrajectory, H5Trajectory,
                                      NpyTrajectory, open_trajectory)
    from sitator_tpu_torch.io import h5_store
    from sitator_tpu_torch.io._shared import N_THREADS
    for name, path in files.items():
        reader = open_trajectory(path)
        check(type(reader) is H5Trajectory and reader._h5py is None
              and reader._ds.layout == layout[name],
              f"open_trajectory({name}) gave {type(reader)} (h5py route: "
              f"{getattr(reader, '_h5py', None) is not None}; layout "
              f"{getattr(getattr(reader, '_ds', None), 'layout', None)})")
        reader.close()

    # each input read whole by the port's reader: for the chunked file,
    # the decode alone (deflate on the I/O pool, then the native unshuffle)
    decode_rate = {}
    for name, path in files.items():
        ds = h5_store.H5Dataset(path)
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = ds.read(0, n_h)
            rates.append(raw_mb / (time.perf_counter() - t0))
        check(got.tobytes() == frames.tobytes(),
              f"{name}: the port's read differs from the frames written")
        decode_rate[name] = rates
        del got
        print(f"{name}: H5Dataset.read of all {n_h} frames "
              f"({ds.layout}, {N_THREADS} threads): "
              + ", ".join(f"{r:.0f} MB/s" for r in rates)
              + " of decoded frames", flush=True)

    sources = {"memory": lambda: ArrayTrajectory(frames),
               "npy": lambda: NpyTrajectory(npy),
               **{name: (lambda p=path: open_trajectory(p))
                  for name, path in files.items()}}
    fps, feeder, launches = store_turns(
        tmp, sources, ["memory", "npy", *files], n_h, block, seeded, kw,
        "HDF5")
    memmap = np.mean(fps["npy"])
    for name in files:
        print(f"{name}: read alone "
              + ", ".join(f"{r:.0f}" for r in decode_rate[name])
              + f" MB/s; pass 2 {np.mean(fps[name]):.1f} frames/s = "
              f"{np.mean(fps[name]) / memmap:.3f} of the memmap's "
              f"{memmap:.1f} in this call; feeder "
              + ", ".join(f"{f:.3f}" for f in feeder[name])
              + f" s; on disk {share[name]:.3f} of the raw bytes",
              flush=True)
    return launches


def phase_h5_layouts():
    """The HDF5 codec census, then every layout of
    ``tests/data/torch_h5_layouts/`` (written by h5py: every libver, layout,
    chunk index and filter it writes, virtual datasets, external links and
    storage, n-bit, szip and shared messages; a layout of several files in
    a directory of its own) read through ``H5Trajectory`` on the port's own
    reader (``_h5py is None``) and held bit for bit to its ``.npy``, from
    the layout's directory where HDF5 resolves names against the working
    directory: the card's machine reads them without h5py.  The plugin
    filters and the compound type must be refused by name (the reference
    reads none of them); a layout refused otherwise fails the phase."""
    import contextlib
    import ctypes.util
    import os
    from sitator_tpu_torch.io import h5_store
    from sitator_tpu_torch.io.formats import H5Trajectory
    from tests import _torch_h5_layouts as layouts
    names = sorted([*layouts.LAYOUTS, *layouts.MULTI])
    check(len(names) > 100, f"only {len(names)} HDF5 layouts")

    @contextlib.contextmanager
    def where(name):
        home = os.getcwd()
        os.chdir(layouts.cwd_of(name) or home)
        try:
            yield layouts.path_of(name), layouts.key_of(name)
        finally:
            os.chdir(home)
    refused = {}
    for name in names:
        with where(name) as (path, key):
            try:
                h5_store.H5Dataset(path, key).close()
            except h5_store.UnsupportedLayout as e:
                refused[name] = str(e)
    unexpected = {n: e for n, e in refused.items()
                  if n not in layouts.REFUSED}
    have = h5_store.codec_libraries()
    print("HDF5 codec libraries here: " + ", ".join(
        f"{lib} {'loads' if ok else 'does not load'}"
        if lib.endswith(".so.1") else f"{lib} {'built' if ok else 'not built'}"
        for lib, ok in have.items())
        + " (its codecs: shuffle, LZF, Fletcher-32, scale-offset, n-bit, "
        "szip); szip's libraries, which the port does not load: " + ", ".join(
            f"lib{x} {'present' if ctypes.util.find_library(x) else 'absent'}"
            for x in ("sz", "aec"))
        + "; HDF5 layouts this machine cannot open: "
        + (json.dumps(unexpected) if unexpected else "none")
        + "; refused by name as meant: " + ", ".join(
            f"{x} ({layouts.REFUSED[x]})" for x in sorted(refused)
            if x in layouts.REFUSED), flush=True)
    check(not unexpected, f"HDF5 layouts refused here: {sorted(unexpected)}")
    for name, what in layouts.REFUSED.items():
        check(what in refused.get(name, ""),
              f"{name} was not refused naming {what}")
    n = 0
    for name in names:
        if name in layouts.REFUSED:
            continue
        want = np.load(os.path.join(layouts.FIXTURES, f"{name}.npy"))
        with where(name) as (path, key):
            traj = H5Trajectory(path, key)
            check(traj._h5py is None,
                  f"HDF5 layout {name} took the h5py route")
            check(traj[:].tobytes() == want.tobytes()
                  and traj[1:len(want) - 1].tobytes() == want[1:-1].tobytes()
                  and traj[-1].tobytes() == want[-1].tobytes()
                  and traj[::3].tobytes() == want[::3].tobytes(),
                  f"HDF5 layout {name}: the port's read differs from the "
                  "frames h5py wrote")
            traj.close()
        n += 1
    print(f"HDF5 layouts read equal to the frames h5py wrote: {n} "
          f"({', '.join(x for x in names if x not in layouts.REFUSED)})",
          flush=True)


def phase_zarr_layouts():
    """The codec census, then every store of
    ``tests/data/torch_zarr_layouts/`` (written by tensorstore: zarr v2,
    zarr v3 and n5 with every codec it writes) read by the port and held
    bit for bit to its ``.npy``: the card's machine opens them without
    tensorstore.  A layout this machine cannot open fails the phase."""
    import ctypes.util
    from sitator_tpu_torch.io import zarr_store
    from sitator_tpu_torch.io.tensorstore_io import TensorstoreTrajectory
    fixtures = ROOT / "tests" / "data" / "torch_zarr_layouts"
    names = sorted(p.name for p in fixtures.iterdir() if p.is_dir())
    check(len(names) > 30, f"only {len(names)} zarr layout fixtures")
    refused = {}
    for name in names:
        try:
            zarr_store.ZarrArray(str(fixtures / name))
        except zarr_store.UnsupportedLayout as e:
            refused[name] = str(e)
    have = zarr_store.codec_libraries()
    print("codec libraries here: " + ", ".join(
        f"{lib} {'loads' if ok else 'does not load'}"
        if lib.endswith(".so.1") else
        f"{lib} {'imports' if ok else 'does not import'}"
        if lib in ("bz2", "lzma") else
        f"{lib} {'built' if ok else 'not built'}"
        for lib, ok in have.items())
        + " (Blosc cnames decoded: " + ", ".join(zarr_store.BLOSC_CNAMES)
        + "; Snappy by the port's own decoder, libsnappy "
        + ("present" if ctypes.util.find_library("snappy") else "absent")
        + ", not loaded)"
        + "; zarr layouts this machine cannot open: "
        + (json.dumps(refused) if refused else "none"), flush=True)
    check(not refused, f"zarr layouts refused here: {sorted(refused)}")
    for name in names:
        want = np.load(fixtures / f"{name}.npy")
        got = zarr_store.ZarrArray(str(fixtures / name)).read(
            0, len(want), want.dtype)
        check(got.tobytes() == want.tobytes(),
              f"zarr layout {name}: the port's read differs from the "
              "frames tensorstore wrote")
        traj = TensorstoreTrajectory(str(fixtures / name))
        check(traj._ts is None and np.array_equal(
            traj[1:len(want) - 1], want[1:-1].astype(np.float32)),
              f"zarr layout {name}: TensorstoreTrajectory differs")
    print(f"zarr layouts read equal to the frames tensorstore wrote: "
          f"{len(names)} ({', '.join(names)})", flush=True)


# the port's walkthroughs in the order they run on the card
EXAMPLE_NAMES = ("landmark_walkthrough", "streaming_and_typing",
                 "formats_and_lattice_mapping", "npt_variable_cell",
                 "multichip_mesh", "fcc_tet_oct", "zarr_and_smeared_soap",
                 "density_sites", "structure_screening",
                 "diffusion_kinetics", "temperature_series",
                 "msm_validation")
# examples whose spilled labels let the phase trace a difference in their
# integers to rows inside the precision gate: each exposes ``system()``,
# its streaming engine's settings ``ENGINE``, the prefix of its temporary
# directory ``TMP_PREFIX`` and its label files ``LABELS``
LABEL_GATE = ("multichip_mesh",)


def example_key_lines():
    """``tests/test_examples.py``'s ``EXAMPLES`` (the reference's key lines
    of each walkthrough), read from the file without importing it."""
    import ast
    tree = ast.parse((ROOT / "tests" / "test_examples.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "EXAMPLES" for t in node.targets):
            return {k.removesuffix(".py"): v
                    for k, v in ast.literal_eval(node.value).items()}
    raise SmokeError("EXAMPLES not found in tests/test_examples.py")


def label_gate(mod, tmp, device):
    """The (frame, ion) rows whose labels differ between the card's
    single-device run of example ``mod`` (K1: bf16 similarities) and the
    CPU's (the dense route: f32), with their f32 top-2 margins
    (``examples/_parity.py::gate_margins``) against centres fitted by the
    dense route on the card; ``(rows, margins, every row inside
    tools/bench.py's gate)``."""
    import glob
    from sitator_tpu_torch.examples._parity import gate_margins
    from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
    from sitator_tpu_torch.tools.bench import gated
    card, cpu = (glob.glob(str(tmp / side / f"{mod.TMP_PREFIX}*"
                                / mod.LABELS.format("1dev")))
                 for side in ("card", "cpu"))
    check(len(card) == len(cpu) == 1, f"label files: card {card}, CPU {cpu}")
    rows = np.argwhere(np.load(card[0]) != np.load(cpu[0]))
    if not len(rows):
        return rows, np.zeros(0), False
    md, seeds = mod.system()
    centers = StreamingLandmarkAnalysis(
        **mod.ENGINE, use_fused=False, verbose=False,
        device=device).fit_centers(seeds, md.traj)
    margin, top1 = gate_margins(md, seeds, centers, rows, device,
                                **mod.ENGINE)
    return rows, margin, bool(gated(margin, top1).all())


@contextlib.contextmanager
def first_launches():
    """While entered, the first launch of K2 (``_mxu_lv_cuda``) and of K1
    (``_mxu_assign_cuda``) keeps a copy of its inputs and of its output in
    the dict it yields, ``{kernel: (inputs, output)}``; every launch runs
    and is counted as before."""
    import threading
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    saved = {"K2": ("_mxu_lv_cuda", mx._mxu_lv_cuda),
             "K1": ("_mxu_assign_cuda", mx._mxu_assign_cuda)}
    kept, lock = {}, threading.Lock()

    def copy(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(copy(v) for v in x)
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return x

    def keeping(key, fn):
        def launch(**kw):
            out = fn(**kw)
            with lock:
                if key not in kept:
                    kept[key] = (copy(kw), copy(out))
            return out
        return launch

    for key, (attr, fn) in saved.items():
        setattr(mx, attr, keeping(key, fn))
    try:
        yield kept
    finally:
        for attr, fn in saved.values():
            setattr(mx, attr, fn)


def hold_first_launches(name, kept):
    """The first launches kept by :func:`first_launches` against their
    plain versions on the same inputs on the card: K2's landmark vectors to
    the f32 tolerance (:func:`compare_lv`); K1's labels outside the margin
    gate and its confidences to ``CONF_TOL`` (:func:`compare_assign`), the
    margins from the plain landmark vectors of the same inputs in kd order
    against the same padded centres.  Returns ``{kernel: max abs err}``."""
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    sync()
    errs = {}
    for key, (kw, out) in sorted(kept.items(), reverse=True):
        n_st, UP, s_tile = kw["A"].shape
        real = kw["kill"] <= 0
        verts = kw["A"].sum(1).reshape(-1)[real].long().unique().tolist()
        label = (f"{name} {key} first launch (B={kw['mob'].shape[0]}, "
                 f"ions padded to {kw['mob'].shape[2]}, {int(real.sum())} of "
                 f"{n_st * s_tile} site rows real in {n_st} tile(s), "
                 f"UP={UP}, vertices a site {verts}, "
                 f"preshift={kw['preshift']})")
        if key == "K2":
            errs[key] = compare_lv(label, out, mx._mxu_lv_plain(**kw))
            continue
        lv = mx._mxu_lv_plain(
            **{k: kw[k] for k in ("mob", "vpu", "A", "kill", "params",
                                  "anchors", "triclinic", "r2_cutoff",
                                  "preshift")},
            M=kw["mob"].shape[2], inv_order=torch.arange(
                n_st * s_tile, device=kw["mob"].device))
        margin, top1 = top2_margin(
            lv, kw["cpad"].T, "clip" if kw["peak_clip"] else "none")
        errs[key] = compare_assign(label, out, mx._mxu_assign_plain(**kw),
                                   margin, top1, kw["mxu_bf16"])
    return errs


@contextlib.contextmanager
def engine_routes():
    """While entered, each ``StreamingLandmarkAnalysis.run`` records its
    ``route_`` and each ``LandmarkAnalysis.run`` 'K2' when it launched K2,
    else 'dense', in the list it yields."""
    from sitator_tpu_torch.landmark import analysis, streaming
    from sitator_tpu_torch.ops import landmark_mxu as mx
    s_cls, la_cls = streaming.StreamingLandmarkAnalysis, \
        analysis.LandmarkAnalysis
    s_run, la_run = s_cls.run, la_cls.run
    routes = []

    def s_recorded(eng, *a, **k):
        out = s_run(eng, *a, **k)
        routes.append(f"streaming {eng.route_}")
        return out

    def la_recorded(eng, *a, **k):
        k2 = mx.mxu_landmark_blocks.launches
        out = la_run(eng, *a, **k)
        sync()
        routes.append("landmark " + (
            "K2" if mx.mxu_landmark_blocks.launches > k2 else "dense"))
        return out

    s_cls.run, la_cls.run = s_recorded, la_recorded
    try:
        yield routes
    finally:
        s_cls.run, la_cls.run = s_run, la_run


def phase_examples(device, names=EXAMPLE_NAMES):
    """The port's walkthroughs (``sitator_tpu_torch/examples``) on the card
    and on the CPU in the same call.  At the phase's start every example
    is started as a ``--device cpu`` subprocess (one thread each, four at
    a time, no card visible); meanwhile each runs here, in this process,
    as ``main(["--device", "cuda", ...])`` with its output captured and the
    launch counters reset before and read after.  Every step of every
    example runs (the typing, the zarr store: the port needs no
    ``sklearn``, ``tensorstore`` or ``networkx``).  For each example: the
    seconds on the card and on the CPU, the engines' routes, K1/K2/K3/K1s
    launches, peak device memory, the first launch of K2 and of K1 held to
    its plain version on the same inputs (:func:`first_launches`), the
    reference's key lines present (``tests/test_examples.py``), and the
    card's printed lines against the CPU's
    (``sitator_tpu_torch/examples/_parity.py``).  Every example runs; a
    fault is printed when it is found and the phase fails after the last
    one if any was.  K1 and K2 must each have been launched.  Returns the
    launch counts summed over the examples and the largest error of each
    kernel against its plain version."""
    import importlib
    import io
    import os
    import shutil
    import tempfile
    import threading
    import traceback
    import torch
    from sitator_tpu_torch.examples import _parity
    from sitator_tpu_torch.tools.bench import MARGIN as bench_gate

    t_phase = time.perf_counter()
    keys = example_key_lines()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    (tmp / "cpu").mkdir()
    (tmp / "card").mkdir()

    def argv_of(name, side):
        if name == "landmark_walkthrough":
            return ["--out", str(tmp / side / "walkthrough_result.npz")]
        return []

    # the CPU runs: four at a time, in the card's order
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", TMPDIR=str(tmp / "cpu"))
    procs, cpu = {}, {n: {} for n in names}
    lock, slots = threading.Lock(), threading.Semaphore(4)
    stop = threading.Event()

    def cpu_run(name):
        with slots:
            if stop.is_set():
                return
            t0 = time.perf_counter()
            with lock:
                procs[name] = p = subprocess.Popen(
                    [sys.executable, "-m",
                     f"sitator_tpu_torch.examples.{name}", "--device", "cpu",
                     *argv_of(name, "cpu")],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            try:
                out, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            cpu[name].update(rc=p.returncode, out=out, err=err,
                             s=time.perf_counter() - t0)

    threads = [threading.Thread(target=cpu_run, args=(n,), daemon=True)
               for n in names]
    for t in threads:
        t.start()
        time.sleep(0.05)        # start in order: the card waits in order

    faults, launches, errs = [], {k: 0 for k in KERNELS}, {}
    saved_tmp = tempfile.tempdir
    try:
        for name, t in zip(names, threads):
            mod = importlib.import_module(f"sitator_tpu_torch.examples.{name}")
            argv = argv_of(name, "card")
            buf = io.StringIO()
            tempfile.tempdir = str(tmp / "card")
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc, kept = None, {}
            try:
                with engine_routes() as routes, first_launches() as kept, \
                        contextlib.redirect_stdout(buf):
                    rc = mod.main(["--device", device, *argv])
                sync()
            except Exception:         # noqa: BLE001 -- every fault is kept
                routes = []
                print(traceback.format_exc(), flush=True)
            card_s = time.perf_counter() - t0
            tempfile.tempdir = saved_tmp
            got = read_launches()
            for k in launches:
                launches[k] += got[k]
            peak = torch.cuda.max_memory_allocated() / 2**20
            card_out = buf.getvalue()
            t.join()
            c = cpu[name]
            print(f"example {name}: card {card_s:.1f} s, CPU "
                  f"{c.get('s', float('nan')):.1f} s (one thread); routes "
                  f"{routes or 'none'}; launches K1 {got['K1']} K2 "
                  f"{got['K2']} K3 {got['K3']} K1s {got['K1s']}; peak "
                  f"device memory {peak:.1f} MiB", flush=True)
            for line in card_out.splitlines():
                print("    " + line, flush=True)
            problems = []
            try:
                for k, e in hold_first_launches(name, kept).items():
                    errs[k] = max(errs.get(k, 0.0), e)
            except SmokeError as e:
                problems.append(f"first launch against its plain version: "
                                f"{e}")
            if rc != 0:
                problems.append(f"card run exited {rc}")
            if c.get("rc") != 0:
                problems.append(f"CPU run exited {c.get('rc')}: "
                                f"{c.get('err', '')[-2000:]}")
            want = [k.replace("/tmp/walkthrough_result.npz",
                              argv[-1] if name == "landmark_walkthrough"
                              else "") for k in keys[name]]
            missing = [k for k in want if k not in card_out]
            if missing:
                problems.append(f"key lines missing on the card: {missing}")
            if not problems:
                roots = ["/tmp", str(tmp)]
                diff = _parity.differences(
                    name, card_out, c["out"], roots, against=_parity.CARD,
                    float_units=_parity.CARD_FLOAT_UNITS)
                if diff and name in LABEL_GATE and all(
                        "numbers differ" in d for d in diff):
                    rows, margin, inside = label_gate(mod, tmp, device)
                    print(f"example {name}: {len(diff)} line(s) differ in "
                          f"numbers; {len(rows)} label(s) differ between "
                          "the card (K1, bf16 similarities) and the CPU "
                          "(dense route, f32), top-2 margins "
                          f"{[f'{m:.2e}' for m in margin]} (gate "
                          f"{bench_gate[True]}): "
                          + ("every one inside the precision gate" if inside
                             else "NOT all inside the precision gate"),
                          flush=True)
                    for d in diff:
                        print(f"    {d}", flush=True)
                    if inside:
                        diff = []
                problems += [f"card != CPU: {d}" for d in diff]
            print(f"example {name}: {len(want)} of the reference's key "
                  f"lines present"
                  + ("; card == CPU on every line that is not exempt"
                     if not problems else ""), flush=True)
            for p in problems:
                faults.append(f"{name}: {p}")
                print(f"FAULT {faults[-1]}", flush=True)
    finally:
        tempfile.tempdir = saved_tmp
        stop.set()
        with lock:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        for t in threads:
            t.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"examples phase: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    check(not faults, f"{len(faults)} fault(s) in the examples: "
          + " | ".join(faults))
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"the examples launched K1 {launches['K1']} and K2 "
          f"{launches['K2']} times; each must be launched")
    check(set(errs) == {"K1", "K2"}, f"first launches held: {sorted(errs)}")
    return launches, errs


STAT_KEYS = ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts",
             "last_sites", "last_res")


def same_passes(name, got, want):
    """Two passes of a pipeline (:func:`one_pass` outputs): labels and every
    jump statistic equal.  Returns the largest confidence difference (0.0
    when they are bit-equal)."""
    worst = 0.0
    for (lg, cg, sg), (lw, cw, sw) in zip(got, want, strict=True):
        check(lg.shape == lw.shape and np.array_equal(lg, lw),
              f"{name}: labels differ on {int((lg != lw).sum())} rows")
        for k in STAT_KEYS:
            check(np.array_equal(sg[k], sw[k]), f"{name}: {k} differs")
        worst = max(worst, float(np.abs(cg - cw).max()))
    from sitator_tpu_torch.tools.bench import CONF_TOL
    check(worst <= CONF_TOL[True], f"{name}: confidences differ by "
          f"{worst:.3g}")
    return worst


def conf_words(err):
    return ("confidences bit-equal" if err == 0.0 else
            f"confidences NOT bit-equal (up to {err:.3g} apart)")


def spread(xs):
    """Median [min, max] of ``xs``."""
    return f"{np.median(xs):.1f} [{min(xs):.1f}, {max(xs):.1f}]"


def launches_since(before):
    """Launches by kernel since ``before`` (a :func:`read_launches`)."""
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def phase_mesh(device, ctx):
    """Frame sharding (``mesh=``) at the bench width on one card: virtual
    meshes of 2 and 4 shards over it (each shard on its own stream) and the
    one-card ``frame_mesh()``, each held to the unmeshed run: the pipeline
    through K1 (8 x 32 frames with the carry, and a 30-frame block on 4
    shards) and through K3 (no vertex sharing, 2 shards), pass 2 through
    K1 (1024 frames in 256-frame blocks at depths 2 and 0, a lattice
    exchange on 4 shards), host synchronisations a pass, frames/s at each
    mesh size (median of 5 in turns); ``dryrun_multichip(4)`` on the card;
    a short input at a large ``block_frames`` against its own block size
    (time and peak memory).  Real cards: :func:`phase_cards`.  Returns the
    launch counts and the frames/s by mesh size."""
    import tempfile
    import torch
    from sitator_tpu_torch import SpmdLandmarkPipeline
    from sitator_tpu_torch.graft_entry import dryrun_multichip
    from sitator_tpu_torch.parallel import frame_mesh

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"mesh phase on {smi}", flush=True)
    sy, sn, frames = ctx["sy"], ctx["sn"], ctx["frames"]
    n_frames, n_ions = len(frames), sy["mobile"].shape[1]
    centers = sy["centers"]
    K = len(centers)
    meshes = {1: frame_mesh(n_devices=1),
              2: frame_mesh(devices=[device] * 2),
              4: frame_mesh(devices=[device] * 4)}
    pk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, assignment_threshold=THR, device=device)
    reset_launches()
    start = read_launches()

    # 1. the pipeline through K1, meshed against unmeshed
    blocks = [frames[i:i + 32] for i in range(0, 256, 32)]
    ref = SpmdLandmarkPipeline(sn, centers, np.ones(K, bool), **pk)
    check(ref.route == "mxu" and ref.n_devices == 1,
          f"default pipeline: route {ref.route}, {ref.n_devices} devices")
    want = one_pass(ref, blocks)
    pipes = {n: SpmdLandmarkPipeline(sn, centers, np.ones(K, bool), mesh=m,
                                     **pk) for n, m in meshes.items()}
    for n, pipe in pipes.items():
        before = read_launches()
        err = same_passes(f"pipeline on {n} shard(s)", one_pass(pipe, blocks),
                          want)
        k1 = launches_since(before)["K1"]
        check(k1 == len(blocks) * n, f"pipeline on {n} shard(s): {k1} K1 "
              f"launches for {len(blocks)} blocks")
        print(f"pipeline (K1) on {n} shard(s) of one card: labels and every "
              f"jump statistic == the unmeshed pipeline over {len(blocks)} x "
              f"32 frames with the carry; {conf_words(err)}; K1 launches "
              f"{k1} == blocks x shards", flush=True)
    odd_ref = ref.run_block(frames[:30])
    before = read_launches()
    odd = pipes[4].run_block(frames[:30])
    err = same_passes("a 30-frame block on 4 shards", [odd], [odd_ref])
    k1 = launches_since(before)["K1"]
    check(odd[0].shape == (30, n_ions) and k1 == 4,
          f"30-frame block: labels {odd[0].shape}, {k1} K1 launches")
    print(f"pipeline: a 30-frame block on 4 shards (padded to 32, the "
          f"padding masked) == unmeshed; {conf_words(err)}", flush=True)
    runners = {"unmeshed": ref, **pipes}
    fps = {key: [] for key in runners}
    for _ in range(5):
        for key, pipe in runners.items():
            t0 = time.perf_counter()
            one_pass(pipe, blocks)
            fps[key].append(256 / (time.perf_counter() - t0))
    syncs = {key: syncs_in(lambda: one_pass(pipe, blocks))
             for key, pipe in runners.items()}
    check(syncs[1] <= syncs["unmeshed"], f"the one-card mesh synchronises "
          f"more: {syncs}")
    print("pipeline (K1, 8 x 32 bench frames, carry) frames/s, median of 5 "
          "in turns [min, max]: " + "; ".join(
              f"{k if k == 'unmeshed' else f'{k} shard(s)'} {spread(v)}"
              for k, v in fps.items())
          + f"; host synchronisations a pass {syncs} ({smi})", flush=True)

    # 2. the pipeline through K3 on a basis without vertex sharing
    ns = add_site_centres(no_sharing_bench_system(64, seed=23), device)
    sn_ns, fr = site_network(ns), frames_of(ns)
    Kn = len(ns["centers"])
    ref_g = SpmdLandmarkPipeline(sn_ns, ns["centers"], np.ones(Kn, bool),
                                 **pk)
    mesh_g = SpmdLandmarkPipeline(sn_ns, ns["centers"], np.ones(Kn, bool),
                                  mesh=meshes[2], **pk)
    check(ref_g.route == mesh_g.route == "gather",
          f"no-sharing routes {ref_g.route}, {mesh_g.route}")
    gb = [fr[:32], fr[32:]]
    want_g = one_pass(ref_g, gb)
    before = read_launches()
    err = same_passes("K3 pipeline on 2 shards", one_pass(mesh_g, gb),
                      want_g)
    k3 = launches_since(before)["K3"]
    check(k3 == 4, f"K3 pipeline on 2 shards: {k3} launches for 2 blocks")
    print(f"pipeline (K3, 2 x 32 bench frames without vertex sharing) on 2 "
          f"shards == unmeshed: labels, every jump statistic; "
          f"{conf_words(err)}; K3 launches {k3} == blocks x shards",
          flush=True)
    del ns, sn_ns, fr, ref_g, mesh_g, want_g

    # 3. pass 2 through K1, meshed against unmeshed
    with tempfile.TemporaryDirectory() as tmp:
        base = {d: run_streaming(ctx, tmp, f"m0_d{d}", pipeline_depth=d)
                for d in (2, 0)}
        before = read_launches()
        for n in (2, 4):
            for d in (2, 0):
                sla, out, lab, _ = run_streaming(
                    ctx, tmp, f"m{n}_d{d}", mesh=meshes[n], pipeline_depth=d)
                check(sla.route_ == "mxu", f"meshed pass 2 route {sla.route_}")
                err = check_same_streaming(
                    f"pass 2 on {n} shards at depth {d}", out, base[d][1],
                    lab, base[d][2])
                print(f"pass 2 (K1) on {n} shards at pipeline_depth={d} == "
                      f"unmeshed: labels on all {lab.size} rows, every "
                      f"integer statistic, float attributes within 1e-9 "
                      f"(worst {err:.3g})", flush=True)
        k1 = launches_since(before)["K1"]
        n_blocks = n_frames // 256
        check(k1 == n_blocks * (2 + 4) * 2, f"meshed pass 2: {k1} K1 "
              f"launches for {n_blocks} blocks")
        stream_fps = {n: [] for n in meshes}
        for _ in range(5):
            for n, m in meshes.items():
                sec = run_streaming(ctx, tmp, f"t{n}", mesh=m)[3]
                stream_fps[n].append(n_frames / sec)
        ssyncs = {(n, f): count_host_syncs(ctx, tmp, f, 2, mesh=meshes[n])
                  for n, f in ((1, 1024), (2, 1024), (4, 512), (4, 1024))}
        check(ssyncs[4, 1024] == ssyncs[4, 512], "the meshed run-ahead loop "
              f"synchronises the host once or more a block: {ssyncs}")
        print(f"pass 2 (K1, {n_frames} bench frames in 256-frame blocks, "
              "depth 2, labels spilled) frames/s, median of 5 in turns "
              "[min, max]: " + "; ".join(
                  f"{n} shard(s) {spread(v)}" for n, v in stream_fps.items())
              + f"; K1 launches {k1} == blocks x shards; host "
              f"synchronisations a pass (shards, frames): {ssyncs} ({smi})",
              flush=True)

        # a lattice exchange inside the second of four blocks, 4 shards
        T, (a, b) = 64 + 17, (100, 101)
        swapped = frames[:256].copy()
        swapped[T:, [a, b]] = swapped[T:, [b, a]]
        plain = run_streaming(ctx, tmp, "m_noswap", frames=frames[:256],
                              block_frames=64)
        s4, o4, l4, _ = run_streaming(ctx, tmp, "m_swap", frames=swapped,
                                      block_frames=64, mesh=meshes[4],
                                      dynamic_lattice_mapping=True)
        check_same_streaming("lattice exchange on 4 shards vs the unswapped "
                             "run", o4, plain[1], l4, plain[2])
        check(s4.rollbacks_ == 1 and s4.lattice_mapping_[a] == b
              and s4.lattice_mapping_[b] == a, f"lattice exchange on 4 "
              f"shards: rollbacks {s4.rollbacks_} or another permutation")
        print(f"lattice exchange at frame {T} of 256 on 4 shards (depth 2): "
              f"one rollback, == the unswapped run", flush=True)

        # 4. a short input at a large block_frames: only its own frames
        short = frames[:256]
        f4 = {}
        for block in (1024, 256, 1024, 256):
            torch.cuda.reset_peak_memory_stats()
            _, out, lab, sec = run_streaming(ctx, tmp, f"f4_{block}",
                                             frames=short,
                                             block_frames=block)
            f4.setdefault(block, []).append(
                (sec, torch.cuda.max_memory_allocated() / 1e9, out, lab))
        for sec, peak, out, lab in f4[1024]:
            check_same_streaming("256 frames at block_frames=1024 vs 256",
                                 out, f4[256][0][2], lab, f4[256][0][3])
        print("256 bench frames at block_frames=1024 vs 256 (depth 2, equal "
              "labels and tallies): " + "; ".join(
                  f"{b}: " + ", ".join(f"{sec:.3f} s peak {peak:.2f} GB"
                                       for sec, peak, _, _ in v)
                  for b, v in f4.items()) + f" ({smi})", flush=True)
        del base, f4

    # 5. the reference's mesh driver, on the card
    t0 = time.perf_counter()
    dryrun_multichip(4, device=device)
    print(f"dryrun_multichip(4) on {device}: {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    launches = launches_since(start)
    print(f"mesh phase: launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, {"pipeline": {k: float(np.median(v))
                                   for k, v in fps.items()},
                      "pass2": {k: float(np.median(v))
                                for k, v in stream_fps.items()}}


def card_names():
    """``nvidia-smi``'s name and power limit of every card, one a line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


def sync_cards():
    """Wait for every card."""
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def per_card(mesh, n):
    """``n`` for each of ``mesh``'s shards, summed by card index."""
    out = {}
    for d in mesh.devices:
        out[d.index] = out.get(d.index, 0) + n
    return out


def card_launches_since(before, key):
    """``key``'s launches by card since ``before`` (a
    :func:`read_launches_by_card`), cards without one left out."""
    now = read_launches_by_card()[key]
    got = {d: now.get(d, 0) - before[key].get(d, 0) for d in now}
    return {d: n for d, n in sorted(got.items()) if n}


def kernel_name(name):
    """A device event's name cut to its kernel (``lv_tile_kernel``, ...) or
    copy."""
    import re
    m = re.search(r"(\w+_kernel)", name)
    return m.group(1) if m else name[:40]


def device_time_by_card(fn):
    """``fn()`` under ``torch.profiler``: returns ``(fn's result, {card:
    {kernel or copy: [ms, count]}})`` from the device's own events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync_cards()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync_cards()
    cards = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            slot = cards.setdefault(e.device_index, {}).setdefault(
                kernel_name(e.name), [0.0, 0])
            slot[0] += e.device_time_total / 1e3
            slot[1] += 1
    return out, cards


def print_cards(label, cards, n_top=6):
    for d, by in sorted(cards.items()):
        total = sum(ms for ms, _ in by.values())
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n_top]
        print(f"{label}, card {d}: device {total:.3f} ms; " + "; ".join(
            f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in top), flush=True)


def kernel_counts(cards, kernel):
    """How many ``kernel`` events each card ran (cards with none left
    out)."""
    return {d: by[kernel][1] for d, by in sorted(cards.items())
            if kernel in by}


def phase_cards(ctx):
    """The engines' ``mesh=`` on 2 and 4 real cards (``frame_mesh(
    n_devices=n)``), where the machine has them, each held to the
    unmeshed run of this process (card 0): the pipeline through K1 (8 x 32
    bench frames, carry) and K3 (2 x 32 frames without vertex sharing),
    pass 2 through K1 at depths 2 and 0, one lattice exchange with its
    rollback, ``LandmarkAnalysis`` on 16 frames (the dense route on a mesh,
    held to the unmeshed dense route); labels and every tally equal,
    confidences bit-equal, pass 2's floats within 1e-9; launches per card
    == blocks x the card's shards, by the wrappers' counters and by the
    kernels the profiler saw on each card.  A replicated argument written
    in place between two sharded calls must reach every card.  Then
    frames/s on 1, 2 and 4 cards against the unmeshed run (median of 5 in
    turns), device time by kernel per card for one pass of the pipeline and
    of pass 2 on the largest mesh, and ``LandmarkAnalysis`` (K2), the
    pipeline and pass 2 (K1) on the last card alone, held to card 0.  Every
    step runs; a fault is printed when it is found, and the phase fails
    after the last step if any was.  Returns the launch counts and the frames/s
    (empty with one card)."""
    import tempfile
    import torch
    from sitator_tpu_torch import LandmarkAnalysis, SpmdLandmarkPipeline
    from sitator_tpu_torch.parallel import frame_mesh
    from sitator_tpu_torch.parallel.mesh import (gather_frames,
                                                 shard_map_frames)

    n_cards = torch.cuda.device_count()
    start = read_launches()
    if n_cards < 2:
        print(f"real multi-card mesh: not run ({n_cards} card)", flush=True)
        return launches_since(start), {}
    t_phase = time.perf_counter()
    for d, line in enumerate(card_names()):
        print(f"card {d}: {line}", flush=True)
    print("peer access from card 0: " + ", ".join(
        f"card {i} {torch.cuda.can_device_access_peer(0, i)}"
        for i in range(1, n_cards)), flush=True)
    sizes = [n for n in (2, 4) if n <= n_cards]
    meshes = {n: frame_mesh(n_devices=n) for n in sizes}
    sy, sn, frames = ctx["sy"], ctx["sn"], ctx["frames"]
    n_frames = len(frames)
    centers = sy["centers"]
    K = len(centers)
    pk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, assignment_threshold=THR)
    blocks = [frames[i:i + 32] for i in range(0, 256, 32)]
    faults = []

    def step(name, fn):
        """``fn()``; a failure is recorded and printed and the phase goes
        on, so that one call shows every fault."""
        try:
            return fn()
        except Exception as e:       # noqa: BLE001 -- every fault is kept
            faults.append(f"{name}: {type(e).__name__}: {e}")
            print(f"FAULT {faults[-1]}", flush=True)
            return None

    def held_per_card(name, key, before, mesh, n, cards=None, kernel=None):
        """``key``'s launches since ``before`` on each card == ``n`` a
        shard, and the profiler's ``kernel`` events likewise where
        ``cards`` is given."""
        got, want = card_launches_since(before, key), per_card(mesh, n)
        check(got == want, f"{name}: {key} launches by card {got}, "
              f"expected {want}")
        if cards is not None:
            seen = kernel_counts(cards, kernel)
            check(seen == want, f"{name}: {kernel} ran on the cards "
                  f"{seen}, expected {want}")
        return got

    ref = SpmdLandmarkPipeline(sn, centers, np.ones(K, bool), device="cuda",
                               **pk)
    want = one_pass(ref, blocks)
    ns = add_site_centres(no_sharing_bench_system(64, seed=23), "cuda")
    sn_ns, fr_ns = site_network(ns), frames_of(ns)
    Kn = len(ns["centers"])
    gb = [fr_ns[:32], fr_ns[32:]]
    ref_g = SpmdLandmarkPipeline(sn_ns, ns["centers"], np.ones(Kn, bool),
                                 device="cuda", **pk)
    want_g = one_pass(ref_g, gb)
    lk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, verbose=False,
              clustering_params={"k_max": 1024})
    la_ref = LandmarkAnalysis(use_fused=False, device="cuda", **lk)
    st_ref = la_ref.run(sn, frames[:16])

    for n, mesh in meshes.items():
        where = f"{n} cards"

        def pipeline_k1():
            pipe = SpmdLandmarkPipeline(sn, centers, np.ones(K, bool),
                                        mesh=mesh, device="cuda", **pk)
            before = read_launches_by_card()
            got, cards = device_time_by_card(lambda: one_pass(pipe, blocks))
            err = same_passes(f"pipeline (K1) on {where}", got, want)
            check(err == 0.0, f"pipeline (K1) on {where}: "
                  f"{conf_words(err)}")
            by = held_per_card(f"pipeline (K1) on {where}", "K1", before,
                               mesh, len(blocks), cards, "lv_tile_kernel")
            print(f"pipeline (K1) on {where}: labels and every jump "
                  f"statistic == the unmeshed pipeline over {len(blocks)} x "
                  f"32 frames with the carry; {conf_words(err)}; K1 "
                  f"launches by card {by} == blocks x shards (lv_tile_kernel "
                  f"on each card by the profiler the same)", flush=True)
            print_cards(f"device time of one pipeline pass on {where} (8 x "
                        "32 frames, ms a pass)", cards)

        def pipeline_k3():
            pipe = SpmdLandmarkPipeline(sn_ns, ns["centers"],
                                        np.ones(Kn, bool), mesh=mesh,
                                        device="cuda", **pk)
            check(pipe.route == "gather", f"no-sharing route {pipe.route}")
            before = read_launches_by_card()
            got, cards = device_time_by_card(lambda: one_pass(pipe, gb))
            err = same_passes(f"pipeline (K3) on {where}", got, want_g)
            check(err == 0.0, f"pipeline (K3) on {where}: "
                  f"{conf_words(err)}")
            by = held_per_card(f"pipeline (K3) on {where}", "K3", before,
                               mesh, len(gb), cards, "lv_gather_kernel")
            print(f"pipeline (K3, 2 x 32 frames without vertex sharing, "
                  f"carry) on {where} == unmeshed: labels, every jump "
                  f"statistic; {conf_words(err)}; K3 launches by card {by} "
                  "== blocks x shards (lv_gather_kernel by the profiler the "
                  "same)", flush=True)

        def pass2(tmp, base, depth):
            before = read_launches_by_card()
            sla, out, lab, _ = run_streaming(
                ctx, tmp, f"c{n}_d{depth}", mesh=mesh, pipeline_depth=depth)
            check(sla.route_ == "mxu", f"pass 2 route {sla.route_}")
            err = check_same_streaming(
                f"pass 2 on {where} at depth {depth}", out, base[depth][1],
                lab, base[depth][2])
            by = held_per_card(f"pass 2 on {where} at depth {depth}", "K1",
                               before, mesh, n_frames // 256)
            print(f"pass 2 (K1, {n_frames} frames in 256-frame blocks) on "
                  f"{where} at pipeline_depth={depth} == unmeshed: labels on "
                  f"all {lab.size} rows, every integer statistic, floats "
                  f"within 1e-9 (worst {err:.3g}); K1 launches by card {by} "
                  "== blocks x shards", flush=True)

        def exchange(tmp, plain):
            T, (a, b) = 64 + 17, (100, 101)
            swapped = frames[:256].copy()
            swapped[T:, [a, b]] = swapped[T:, [b, a]]
            sla, out, lab, _ = run_streaming(
                ctx, tmp, f"x{n}", frames=swapped, block_frames=64,
                mesh=mesh, dynamic_lattice_mapping=True)
            check_same_streaming(f"lattice exchange on {where} vs the "
                                 "unswapped run", out, plain[1], lab,
                                 plain[2])
            check(sla.rollbacks_ == 1 and sla.lattice_mapping_[a] == b
                  and sla.lattice_mapping_[b] == a, f"lattice exchange on "
                  f"{where}: rollbacks {sla.rollbacks_} or another "
                  "permutation")
            print(f"lattice exchange at frame {T} of 256 on {where} (depth "
                  "2, 64-frame blocks): one rollback, == the unswapped run",
                  flush=True)

        def landmark_analysis():
            la = LandmarkAnalysis(mesh=mesh, device="cuda", **lk)
            st = la.run(sn, frames[:16])
            lv_err = float(np.abs(la.landmark_vectors
                                  - la_ref.landmark_vectors).max())
            conf_err = float(np.abs(st.confidences
                                    - st_ref.confidences).max())
            check(np.array_equal(st.traj, st_ref.traj),
                  f"LandmarkAnalysis on {where}: labels differ on "
                  f"{int((st.traj != st_ref.traj).sum())} rows")
            check(lv_err == 0.0 and conf_err == 0.0, f"LandmarkAnalysis "
                  f"on {where}: landmark vectors {lv_err:.3g} and "
                  f"confidences {conf_err:.3g} from the unmeshed run")
            print(f"LandmarkAnalysis (16 bench frames, the dense route) on "
                  f"{where} == unmeshed: {st.site_network.n_sites} sites, "
                  "labels, landmark vectors and confidences bit-equal",
                  flush=True)

        def replica_written_in_place():
            x = torch.arange(n * 8 * 3, dtype=torch.float32,
                             device="cuda").reshape(n * 8, 3)
            w = torch.ones(3, device="cuda")

            def scaled():
                return gather_frames(shard_map_frames(
                    lambda v, w: (v * w,), mesh, 1, x, w, n_outputs=1)[0])

            check(torch.equal(scaled(), x), "x * 1 differs from x")
            w.mul_(3.0)
            got = scaled()
            stale = [d for d in range(n)
                     if not torch.equal(got[d * 8:(d + 1) * 8],
                                        x[d * 8:(d + 1) * 8] * 3.0)]
            check(not stale, f"a replicated tensor written in place: the "
                  f"shards on cards {stale} used the old copy")
            print(f"replicated argument written in place between two "
                  f"sharded calls on {where}: every card used the new "
                  "values", flush=True)

        step(f"pipeline K1, {where}", pipeline_k1)
        step(f"pipeline K3, {where}", pipeline_k3)
        with tempfile.TemporaryDirectory() as tmp:
            base = {d: run_streaming(ctx, tmp, f"c1_d{d}", pipeline_depth=d)
                    for d in (2, 0)}
            for depth in (2, 0):
                step(f"pass 2 depth {depth}, {where}",
                     lambda: pass2(tmp, base, depth))
            plain = run_streaming(ctx, tmp, "c_noswap", frames=frames[:256],
                                  block_frames=64)
            step(f"lattice exchange, {where}", lambda: exchange(tmp, plain))
        step(f"LandmarkAnalysis, {where}", landmark_analysis)
        step(f"replica written in place, {where}", replica_written_in_place)

    # frames/s on 1, 2 and 4 cards against the unmeshed run, in turns
    fps = {}

    def speeds():
        runners = {"unmeshed": None, 1: frame_mesh(n_devices=1), **meshes}
        pipe_of = {k: ref if m is None else SpmdLandmarkPipeline(
            sn, centers, np.ones(K, bool), mesh=m, device="cuda", **pk)
            for k, m in runners.items()}
        for key in runners:
            fps[("pipeline", key)], fps[("pass2", key)] = [], []
        with tempfile.TemporaryDirectory() as tmp:
            for _ in range(5):
                for key, m in runners.items():
                    t0 = time.perf_counter()
                    one_pass(pipe_of[key], blocks)
                    fps[("pipeline", key)].append(
                        256 / (time.perf_counter() - t0))
                    sec = run_streaming(ctx, tmp, "speed", mesh=m)[3]
                    fps[("pass2", key)].append(n_frames / sec)
        for path, what in (
                ("pipeline", "pipeline (K1, 8 x 32 frames, carry)"),
                ("pass2", f"pass 2 (K1, {n_frames} frames in 256-frame "
                 "blocks, depth 2, labels spilled)")):
            print(f"{what} frames/s, median of 5 in turns [min, max]: "
                  + "; ".join(f"{k if k == 'unmeshed' else f'{k} card(s)'} "
                              f"{spread(v)}" for (p, k), v in fps.items()
                              if p == path), flush=True)
        for line in card_names():
            print(f"  on {line}", flush=True)

    def profile_pass2():
        n = max(meshes)
        with tempfile.TemporaryDirectory() as tmp:
            _, cards = device_time_by_card(lambda: run_streaming(
                ctx, tmp, "prof", mesh=meshes[n]))
        print_cards(f"device time of one pass 2 on {n} cards ({n_frames} "
                    "frames in 256-frame blocks, depth 2, ms a pass)", cards)
        seen = kernel_counts(cards, "lv_tile_kernel")
        check(seen == per_card(meshes[n], n_frames // 256),
              f"pass 2 on {n} cards: lv_tile_kernel ran on the cards {seen}")

    step("frames/s", speeds)
    step("profile of pass 2", profile_pass2)

    # the last card alone: a user's device="cuda:N", no mesh
    last = torch.device("cuda", n_cards - 1)

    def landmark_analysis_last():
        la0 = LandmarkAnalysis(device="cuda:0", **lk)
        st0 = la0.run(sn, frames[:16])
        before = read_launches_by_card()
        la = LandmarkAnalysis(device=last, **lk)
        st, cards = device_time_by_card(lambda: la.run(sn, frames[:16]))
        by = card_launches_since(before, "K2")
        seen = kernel_counts(cards, "lv_tile_kernel")
        check(by == seen == {last.index: 1}, f"LandmarkAnalysis on {last}: "
              f"K2 launches by card {by}, lv_tile_kernel on the cards "
              f"{seen}")
        check(np.array_equal(la.landmark_vectors, la0.landmark_vectors)
              and np.array_equal(st.traj, st0.traj)
              and np.array_equal(st.confidences, st0.confidences),
              f"LandmarkAnalysis on {last} differs from card 0")
        print(f"LandmarkAnalysis (K2, 16 bench frames) on {last} alone: "
              "one K2 launch, on that card (wrapper and profiler); landmark "
              "vectors, labels and confidences bit-equal to card 0's",
              flush=True)

    def pipeline_last():
        pipe = SpmdLandmarkPipeline(sn, centers, np.ones(K, bool),
                                    device=last, **pk)
        before = read_launches_by_card()
        got, cards = device_time_by_card(lambda: one_pass(pipe, blocks[:2]))
        err = same_passes(f"pipeline on {last}", got, want[:2])
        check(err == 0.0, f"pipeline on {last}: {conf_words(err)}")
        by = card_launches_since(before, "K1")
        seen = kernel_counts(cards, "lv_tile_kernel")
        check(by == seen == {last.index: 2}, f"pipeline on {last}: K1 "
              f"launches by card {by}, lv_tile_kernel on the cards {seen}")
        print(f"pipeline (K1, 2 x 32 frames) on {last} alone == card 0; "
              "K1 on that card only (wrapper and profiler)", flush=True)

    def pass2_last():
        with tempfile.TemporaryDirectory() as tmp:
            base = run_streaming(ctx, tmp, "on0")
            before = read_launches_by_card()
            (sla, out, lab, _), cards = device_time_by_card(
                lambda: run_streaming(ctx, tmp, "onN", device=last))
        check_same_streaming(f"pass 2 on {last}", out, base[1], lab, base[2])
        by = card_launches_since(before, "K1")
        seen = kernel_counts(cards, "lv_tile_kernel")
        want_n = {last.index: n_frames // 256}
        check(sla.route_ == "mxu" and by == seen == want_n, f"pass 2 on "
              f"{last}: route {sla.route_}, K1 launches by card {by}, "
              f"lv_tile_kernel on the cards {seen}")
        print(f"pass 2 (K1, {n_frames} frames, depth 2) on {last} alone == "
              "card 0's; K1 on that card only (wrapper and profiler)",
              flush=True)

    step(f"LandmarkAnalysis on {last}", landmark_analysis_last)
    step(f"pipeline on {last}", pipeline_last)
    step(f"pass 2 on {last}", pass2_last)
    launches = launches_since(start)
    print(f"real-card mesh phase: launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(not faults, f"{len(faults)} fault(s) on real cards: "
          + " | ".join(faults))
    return launches, {f"{p} {k}": float(np.median(v))
                      for (p, k), v in fps.items()}


MP_DEADLINE = 300      # seconds a group of ranks may run before it is killed


def mp_system(sy, frames):
    """The arrays a rank rebuilds a system from (:func:`mp_load`)."""
    return dict(static_ref=sy["static_ref"], site_pos=sy["site_pos"],
                cell=sy["cell"], verts=sy["verts"],
                mobile=sy["mobile"][:1], centers=sy["centers"],
                frames=frames)


def mp_load(path, device):
    """A rank's system: its network, the K1 and K3 arguments the unmeshed
    ``SpmdLandmarkPipeline`` gives its route on ``device``, and the
    frames."""
    import torch
    from sitator_tpu_torch.ops import landmark_mxu as mx
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    with np.load(path) as d:
        sy = {k: d[k] for k in d.files}
    sn = site_network(sy)
    verts, vmask = sn.padded_vertices()
    static_idx = np.flatnonzero(sn.static_mask)
    K = len(sy["centers"])
    basis = mx.prepare_engine_basis(
        verts, vmask, sn.centers, sn.structure.cell, midpoint=MID,
        steepness=STEEP, cutoff_shape=CUTOFF,
        static_ref=sn.structure.positions[static_idx], drift_budget=3.0)
    a = dict(kcell=kernel_cell(sn.structure.cell), n_sites=K,
             active_idx=torch.arange(K, dtype=torch.int32, device=device),
             centers=torch.as_tensor(sy["centers"], device=device),
             verts=torch.as_tensor(verts, device=device),
             vmask=torch.as_tensor(vmask, device=device),
             full_mask=bool(vmask.all()))
    if basis is not None:
        a["basis"] = mx.basis_from_jax(basis, device)
        a["perm"] = torch.as_tensor(mx.permute_centers(sy["centers"], basis),
                                    device=device)
    return (sy["frames"], np.flatnonzero(sn.mobile_mask), static_idx), a


def mp_pass(rank, world, mesh, system, route):
    """One pass of the system's 32-frame blocks through ``route``'s step
    across the ranks, the carry chained: each rank places its 32 / world
    frames of a block with ``shard_frames_local``.  Returns [(labels,
    confs, stats)] per block, on every rank the whole block's."""
    from sitator_tpu_torch.parallel import shard_frames_local
    from sitator_tpu_torch.parallel.pipeline import (fused_analysis_step,
                                                     mxu_analysis_step)
    (frames, mobile_idx, static_idx), a = system
    kw = dict(midpoint=MID, steepness=STEEP, threshold=THR,
              cutoff_shape=CUTOFF, active_idx=a["active_idx"],
              n_sites=a["n_sites"])
    slab = 32 // world
    carry, out = None, []
    for lo in range(0, len(frames), 32):
        mine = frames[lo + rank * slab:lo + (rank + 1) * slab]
        mob = shard_frames_local(
            np.ascontiguousarray(mine[:, mobile_idx], np.float32), mesh)
        sta = shard_frames_local(
            np.ascontiguousarray(mine[:, static_idx], np.float32), mesh)
        if route == "mxu":
            labels, confs, stats = mxu_analysis_step(
                mesh, mob, sta, a["basis"], a["kcell"], a["perm"],
                carry=carry, **kw)
        else:
            labels, confs, stats = fused_analysis_step(
                mesh, mob, sta, a["verts"], a["vmask"], a["kcell"],
                a["centers"], full_mask=a["full_mask"], carry=carry, **kw)
        carry = (stats["last_sites"], stats["last_res"])
        out.append((labels.cpu().numpy(), confs.cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in stats.items()}))
    return out


def mp_worker(rank, world, backend, tmp):
    """One rank of :func:`phase_multiprocess`: joins the group (``backend``
    through the file ``tmp/rendezvous``; under gloo every rank on cuda:0,
    under NCCL rank r on cuda:r), builds the frame mesh of one shard a rank,
    runs K1's system (``tmp/k1.npz``) and K3's (``tmp/k3.npz``) through
    their steps, timed five times, and writes its results, launches and
    seconds to ``tmp/rank{rank}.npz``.  Fails if jax or sitator_tpu was
    imported."""
    import datetime
    import torch
    import torch.distributed as dist
    from sitator_tpu_torch.parallel import frame_mesh
    tmp = Path(tmp)
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False     # as in phase_device
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        mesh = frame_mesh(devices=[device])
        check(mesh.devices.size == world and mesh.local == [rank],
              f"rank {rank}: mesh {mesh}, local {mesh.local}")
        for route, name in (("mxu", "k1"), ("gather", "k3")):
            system = mp_load(tmp / f"{name}.npz", device)
            reset_launches()
            runs = mp_pass(rank, world, mesh, system, route)
            out[f"{name}_launches"] = read_launches()["K1" if route == "mxu"
                                                      else "K3"]
            for b, (labels, confs, stats) in enumerate(runs):
                out[f"{name}_{b}_labels"], out[f"{name}_{b}_confs"] = (
                    labels, confs)
                for k in STAT_KEYS:
                    out[f"{name}_{b}_{k}"] = stats[k]
            seconds = []
            for _ in range(5):
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                mp_pass(rank, world, mesh, system, route)
                sync()
                seconds.append(time.perf_counter() - t0)
            out[f"{name}_seconds"] = np.array(seconds)
            del system
    finally:
        dist.destroy_process_group()
    check(not any(m.split(".")[0] in ("jax", "sitator_tpu")
                  for m in sys.modules), "a rank imported jax or sitator_tpu")
    np.savez(tmp / f"rank{rank}.npz", **out)


def run_group(tmp, world, backend):
    """Start ``world`` ranks of :func:`mp_worker`, each a fresh interpreter;
    wait until all end, one fails or :data:`MP_DEADLINE` passes, then kill
    what still runs.  Fails unless every rank exits 0.  Returns each rank's
    results."""
    import os
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.mp_worker(int(sys.argv[2]), int(sys.argv[3]), "
            "*sys.argv[4:6])")
    logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(ROOT), str(r),
                     str(world), backend, str(tmp)],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > MP_DEADLINE:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    rcs = [p.returncode for p in procs]
    check(rcs == [0] * world, f"{backend} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s:\n" + "\n".join(
              f"--- rank {r}\n{log.read_text()[-3000:]}"
              for r, log in enumerate(logs)))
    ranks = []
    for r in range(world):
        with np.load(Path(tmp) / f"rank{r}.npz") as d:
            ranks.append({k: d[k] for k in d.files})
    return ranks, time.perf_counter() - t0


def check_group(label, ranks, name, want, n_shards):
    """Every rank's blocks bit-equal to the unmeshed pipeline's ``want``
    (labels, confidences, every tally), and the kernel's launches ==
    blocks x global shards.  Returns the launches and the pass's frames/s
    over the five timed runs (the slowest rank's time each)."""
    for r, got in enumerate(ranks):
        for b, (lw, cw, sw) in enumerate(want):
            check(np.array_equal(got[f"{name}_{b}_labels"], lw),
                  f"{label}: rank {r}, block {b}: labels differ on "
                  f"{int((got[f'{name}_{b}_labels'] != lw).sum())} rows")
            check(np.array_equal(got[f"{name}_{b}_confs"], cw),
                  f"{label}: rank {r}, block {b}: confidences differ by "
                  f"{float(np.abs(got[f'{name}_{b}_confs'] - cw).max()):.3g}")
            for k in STAT_KEYS:
                check(np.array_equal(got[f"{name}_{b}_{k}"], sw[k]),
                      f"{label}: rank {r}, block {b}: {k} differs")
    launches = sum(int(got[f"{name}_launches"]) for got in ranks)
    check(launches == len(want) * n_shards, f"{label}: {launches} launches "
          f"for {len(want)} blocks x {n_shards} shards")
    n_frames = 32 * len(want)
    secs = np.max([got[f"{name}_seconds"] for got in ranks], axis=0)
    return launches, [n_frames / s for s in secs]


def phase_multiprocess(device, ctx):
    """The multi-process frame mesh on the card: 2 ranks under gloo, each a
    fresh process on cuda:0 with a one-shard mesh (2 global shards), run
    the step through K1 over the bench pipeline's 8 x 32 frames with the
    carry (each block split 16/16 by ``shard_frames_local``) and through
    K3 on the no-sharing bench system's 2 x 32 frames; with two or three
    cards the same under NCCL, 2 ranks, rank r on cuda:r, with four or more
    4 ranks.  Each rank's labels, confidences and
    tallies must be bit-equal to the unmeshed ``SpmdLandmarkPipeline`` run
    here on the same frames, and K1/K3 launches == blocks x global shards.
    Returns the launch counts and the frames/s of both against the
    unmeshed pipeline's."""
    import tempfile
    import torch
    from sitator_tpu_torch import SpmdLandmarkPipeline

    t_phase = time.perf_counter()
    smi = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines())
    print(f"multi-process phase on {smi}", flush=True)
    pk = dict(cutoff_midpoint=MID, cutoff_steepness=STEEP,
              cutoff_shape=CUTOFF, assignment_threshold=THR, device=device)
    sy, frames = ctx["sy"], ctx["frames"][:256]
    K = len(sy["centers"])
    ref = SpmdLandmarkPipeline(ctx["sn"], sy["centers"], np.ones(K, bool),
                               **pk)
    check(ref.route == "mxu", f"bench pipeline route {ref.route}")
    blocks = [frames[i:i + 32] for i in range(0, 256, 32)]
    want = one_pass(ref, blocks)
    unmeshed = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_pass(ref, blocks)
        unmeshed.append(256 / (time.perf_counter() - t0))
    ns = add_site_centres(no_sharing_bench_system(64, seed=23), device)
    ns_frames = frames_of(ns)
    ref_g = SpmdLandmarkPipeline(site_network(ns), ns["centers"],
                                 np.ones(len(ns["centers"]), bool), **pk)
    check(ref_g.route == "gather", f"no-sharing route {ref_g.route}")
    gb = [ns_frames[:32], ns_frames[32:]]
    want_g = one_pass(ref_g, gb)
    unmeshed_g = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_pass(ref_g, gb)
        unmeshed_g.append(64 / (time.perf_counter() - t0))
    del ref, ref_g
    torch.cuda.empty_cache()
    launches = dict.fromkeys(KERNELS, 0)
    fps = {"K1": {"unmeshed": float(np.median(unmeshed))},
           "K3": {"unmeshed": float(np.median(unmeshed_g))}}
    n_cards = torch.cuda.device_count()
    groups = [("gloo", 2, "2 ranks on one card (gloo)")]
    if n_cards >= 2:
        world = 4 if n_cards >= 4 else 2
        groups.append(("nccl", world, f"{world} ranks on {world} cards "
                       "(NCCL)"))
    for backend, world, label in groups:
        with tempfile.TemporaryDirectory() as tmp:
            np.savez(Path(tmp) / "k1.npz", **mp_system(sy, frames))
            np.savez(Path(tmp) / "k3.npz", **mp_system(ns, ns_frames))
            ranks, sec = run_group(tmp, world, backend)
        k1, k1_fps = check_group(f"K1 step, {label}", ranks, "k1", want,
                                 world)
        k3, k3_fps = check_group(f"K3 step, {label}", ranks, "k3", want_g,
                                 world)
        launches["K1"] += k1
        launches["K3"] += k3
        fps["K1"][backend] = float(np.median(k1_fps))
        fps["K3"][backend] = float(np.median(k3_fps))
        print(f"{label}: the step through K1 (8 x 32 bench frames, carry, "
              f"{32 // world} frames a rank a block by shard_frames_local) "
              "and through "
              f"K3 (2 x 32 frames without vertex sharing) == the unmeshed "
              f"pipeline on every rank: labels, confidences and every jump "
              f"statistic bit-equal; launches K1 {k1}, K3 {k3} == blocks x "
              f"shards; frames/s, median of 5 [min, max]: K1 "
              f"{spread(k1_fps)}, K3 {spread(k3_fps)}; the unmeshed "
              f"pipeline (this process, before the ranks): K1 "
              f"{spread(unmeshed)}, K3 {spread(unmeshed_g)}; the group "
              f"{sec:.1f} s ({smi})", flush=True)
    if len(groups) == 1:
        print(f"NCCL group: not run ({n_cards} card)", flush=True)
    print(f"multi-process phase: launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
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
    from sitator_tpu_torch.tools import bench_config as bc
    rng = np.random.default_rng(seed)
    n_c, a = bc.N_CELLS, bc.A_LAT
    g = np.stack(np.meshgrid(*(np.arange(n_c),) * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    cell = np.eye(3) * a * n_c
    sites = (g + 0.5) * a
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) * 1.0
    host = (sites[:, None, :] + tet[None]).reshape(-1, 3)
    verts = np.arange(len(host), dtype=np.int32).reshape(len(sites), 4)
    return hopping(rng, cell, host, verts, sites, bc.N_IONS, n_frames,
                   bc.K_CENTERS, 0.01, sigma=0.25)


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
    if not (ROOT / "sitator_tpu_torch" / "csrc").is_dir():
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
    if sys.argv[1:] == ["cards"]:
        _, _, ctx = phase_streaming("cuda")
        phase_cards(ctx)
        print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["examples"]:
        _, errs = phase_examples("cuda")
        print(f"examples' first launches against their plain versions, "
              f"max abs err: {json.dumps(errs)}", flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["jumps"]:
        fold = phase_jumps("cuda")
        launches, _, _ = phase_streaming("cuda")
        print(json.dumps({"kernels": [dict(fold, route="cuda",
                                           launches=launches["fold"])]}),
              flush=True)
        print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; the "
              "arguments are 'cards', 'examples' and 'jumps'",
              file=sys.stderr)
        return 2
    phase_zarr_layouts()
    phase_h5_layouts()
    res = phase_kernels("cuda")
    fold = phase_jumps("cuda")
    paths = {}
    paths["slice"], fps = phase_slice("cuda")
    paths["K1s"] = phase_skew("cuda")
    paths["bench"], bench_fps = phase_bench("cuda")
    paths["streaming"], stream_fps, ctx = phase_streaming("cuda")
    paths["northstar"], ns_fps = phase_northstar("cuda")
    paths["network"], depth_fps, net_ctx = phase_network("cuda", ctx)
    phase_descriptors("cuda", dict(ctx, **net_ctx))
    phase_transport("cuda", dict(ctx, **net_ctx))
    paths["cli"] = phase_cli("cuda", ctx)
    paths["examples"], ex_errs = phase_examples("cuda")
    for key, err in ex_errs.items():
        res[key]["err"] = max(res[key]["err"], err)
    paths["mesh"], mesh_fps = phase_mesh("cuda", ctx)
    paths["cards"], cards_fps = phase_cards(ctx)
    paths["multiprocess"], mp_fps = phase_multiprocess("cuda", ctx)
    del ctx, net_ctx
    paths["gather"], gather_fps, gather_stream_fps = phase_gather("cuda")
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    check(not any(m == "sitator_tpu" or m.startswith("sitator_tpu.")
                  for m in sys.modules), "sitator_tpu was imported")
    check("bench" not in sys.modules, "bench was imported")
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
    n = sum(p.get("fold", 0) for p in paths.values())
    check(n > 0, "the jump fold was launched on no path")
    kernels.append(dict(fold, route="cuda", launches=n))
    print(f"bench step frames/s (median of 5): {json.dumps(bench_fps)}; "
          f"pipeline frames/s: K1 {fps:.1f}, K3 {gather_fps:.1f}; streaming "
          f"pass 2 frames/s: K1 {stream_fps:.1f} (depth 2 {depth_fps[2]:.1f}, "
          f"depth 0 {depth_fps[0]:.1f}), K3 {gather_stream_fps:.1f}; "
          f"north-star path (K1, 6 x 512 frames): card pool "
          f"{ns_fps['card']:.1f}, host pool {ns_fps['host']:.1f}; "
          f"by mesh size (median frames/s): {json.dumps(mesh_fps)}; "
          "on real cards: "
          f"{json.dumps(cards_fps) if cards_fps else 'not run'}; "
          f"across processes (median frames/s): "
          f"{json.dumps(mp_fps)}; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
