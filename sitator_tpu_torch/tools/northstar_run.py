"""The north-star measurement on one card: sustained frames/s of the literal
``StreamingLandmarkAnalysis`` pass-2 loop (feeder thread, run-ahead window,
device accumulators, checkpoint cadence, label memmap) at the 10k-atom bench
configuration (:mod:`~sitator_tpu_torch.tools.bench_config`).

Frames are not read from a file: 10^6 frames of 10^4 atoms are 120 GB.  A
pool of 16 blocks of 512 frames is generated on the device once
(a seeded ``torch.Generator``, the bench's statistics: the lattice at 0.05 Å
of thermal jitter, the ions at 0.25 Å about their sites), and
:class:`CycleReader` hands the resident blocks to the engine's feeder, over
and over; the engine takes frames that are already on the card without a
host round trip.  Everything else is the production engine.

Run from the root of a checkout::

    python3 -m sitator_tpu_torch.tools.northstar_run [--blocks 256]
        [--no-labels] [--split] [--ab-...] [--workdir DIR]
        [--device {cuda,cpu}]

``--blocks 2048`` is the literal 1,048,576-frame pass.  ``--small`` is a
tiny configuration for wiring checks (``--small --device cpu`` runs on a
machine without a card).  One JSON line goes to stdout and to
``<workdir>/northstar_result.json``.  After the main run, with labels
stored, the run is checked, and a failed check exits non-zero: (a) the
label memmap is periodic with the pool's period, (b) a host int64 recount
of the memmap equals the engine's statistics and final carry, (c) peak device
memory and the host's anonymous memory do not grow by more than 5% after
block 64 (runs of at least 128 blocks), (d) before the run,
``--workdir`` has room for the memmap and 1 GB more.

Exit codes: 1 without a card (unless ``--device cpu``) or without room in
``--workdir``; 2 for an option the port does not have (``--ab-pack``); 3
when the health matmul is slower than ``--require-probe-s``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sitator_tpu_torch.tools import bench_config

ROOT = Path(__file__).resolve().parents[2]

BLOCK_FRAMES = 512   # engine block_frames
POOL_BLOCKS = 16     # resident blocks (61.4 MB each at the bench width)
SMALL = dict(block_frames=64, pool_blocks=2, n_cells=5, n_ions=20,
             k_centers=32)
PROBE_BLOCK = 64  # check (c) compares the end with this block
KW = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
          cutoff_shape="logistic_r2")


class CheckFailed(RuntimeError):
    """A check of the north-star run failed."""


class CycleReader:
    """A trajectory reader over ``blocks``, a list of equal-shaped frame
    blocks (NumPy arrays or tensors), cycled: frame ``f`` of the
    ``n_frames`` is frame ``f % B`` of block ``(f // B) % len(blocks)``, B
    the blocks' length.  A slice returns one array of the blocks' kind, on
    their device; a slice within one block is a view of it."""

    def __init__(self, blocks, n_frames, structure=None):
        shapes = {tuple(b.shape) for b in blocks}
        if len(shapes) != 1:
            raise ValueError(f"blocks of different shapes: {shapes}")
        self.blocks = list(blocks)
        self.block_frames = int(self.blocks[0].shape[0])
        self._n = int(n_frames)
        self.structure = structure

    def __len__(self):
        return self._n

    @property
    def n_atoms(self):
        return int(self.blocks[0].shape[1])

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("CycleReader takes a slice of frames")
        lo, hi, step = key.indices(self._n)
        if step != 1:
            raise ValueError("CycleReader takes slices with step 1")
        Bk, n_pool = self.block_frames, len(self.blocks)
        parts = []
        while lo < hi:
            off = lo % Bk
            take = min(Bk - off, hi - lo)
            parts.append(self.blocks[(lo // Bk) % n_pool][off:off + take])
            lo += take
        if not parts:
            return self.blocks[0][:0]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if torch.is_tensor(parts[0]) \
            else np.concatenate(parts)


def bench_network(small=False):
    """The bench system and its ``SiteNetwork`` (static atoms first, the
    ions on their sites, the cube-centre sites with their 8 corner atoms):
    ``(sn, system)``."""
    from sitator_tpu_torch import SiteNetwork, Structure
    sizes = {k: SMALL[k] for k in ("n_cells", "n_ions", "k_centers")} \
        if small else {}
    sy = bench_config.build_system(**sizes)
    n_ions = len(sy.occ)
    positions = np.concatenate([sy.host, sy.sites[sy.occ]])
    species = np.array([16] * sy.n_static + [3] * n_ions)
    s = Structure(positions, species, np.asarray(sy.cell, np.float64))
    sn = SiteNetwork(s, species == 16, species == 3)
    sn.centers = sy.sites
    sn.vertices = [sy.verts[i] for i in range(sy.n_static)]
    return sn, sy


def make_pool(sy, n_blocks, block_frames, device, seed=7):
    """``n_blocks`` blocks of ``block_frames`` frames (static atoms, then
    ions) generated on ``device`` from ``torch.Generator(device)`` seeded
    with ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    host = torch.as_tensor(sy.host, dtype=torch.float32, device=dev)
    ions = torch.as_tensor(sy.sites[sy.occ], dtype=torch.float32, device=dev)
    pool = []
    for _ in range(n_blocks):
        st = host + 0.05 * torch.randn((block_frames,) + host.shape,
                                       generator=gen, device=dev)
        mo = ions + 0.25 * torch.randn((block_frames,) + ions.shape,
                                       generator=gen, device=dev)
        pool.append(torch.cat([st, mo], dim=1))
    return pool


def make_engine(workdir, tag, *, block_frames=BLOCK_FRAMES, labels=True,
                device="cuda", **kw):
    """A pass-2 engine at the bench settings whose checkpoint and label
    memmap live in ``workdir`` under ``tag``.  A stale checkpoint of a
    killed earlier run would be resumed and inflate frames/s, so both files
    are deleted first."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    ckpt = os.path.join(workdir, f"ns_ckpt_{tag}.npz")
    lab = os.path.join(workdir, f"ns_labels_{tag}.npy")
    for p in (ckpt, lab):
        if os.path.exists(p):
            os.remove(p)
    return StreamingLandmarkAnalysis(
        block_frames=block_frames, checkpoint_path=ckpt,
        store_labels=lab if labels else None, verbose=False, device=device,
        **KW, **kw)


def fit_centers(sn, pool, k_pad, workdir, device, cache=True):
    """``fit_centers`` (K2 on a card) on one cycled block of the ``pool``
    (at its block length) with ``k_max`` 1024, padded to ``len(k_pad)``
    with the first rows of ``k_pad``.  The fit is cached in ``<workdir>/ns_centers_fit.npy`` when ``cache``; a
    cache of another configuration is refit."""
    from sitator_tpu_torch import StreamingLandmarkAnalysis
    path = os.path.join(workdir, "ns_centers_fit.npy") if cache else None
    fit = None
    if path and os.path.exists(path):
        try:
            fit = np.load(path)
        except (OSError, ValueError):   # a truncated file of a killed run
            fit = None
        if fit is not None and (fit.ndim != 2
                                or fit.shape[1] != int(sn.static_mask.sum())
                                or not 0 < fit.shape[0] <= len(k_pad)):
            fit = None
        if fit is not None:
            print(f"# fit pass: {len(fit)} centers (cached)", flush=True)
    if fit is None:
        n = len(pool[0])
        eng = StreamingLandmarkAnalysis(
            block_frames=n, clustering_params={"k_max": 1024},
            verbose=False, device=device, **KW)
        t0 = time.perf_counter()
        fit = np.asarray(eng.fit_centers(sn, CycleReader(pool, n)))
        print(f"# fit pass: {len(fit)} centers in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if path:
            np.save(path, fit)
    if len(fit) < len(k_pad):
        fit = np.concatenate([fit, np.asarray(k_pad[:len(k_pad) - len(fit)],
                                              np.float32)])
    return fit


# -- checks ---------------------------------------------------------------

def recount(labels, n_sites, chunk=4096):
    """Jump statistics of a ``(F, M)`` label array (a memmap is read chunk
    by chunk), recounted on the host in int64 with the carry chained from
    chunk to chunk, under the engine's unknown-frame policy ('persist': an
    unknown frame neither jumps nor advances a residence).  Returns the
    engine's ``final_state_`` keys: ``n_ij``, ``lag_sum``, ``res_sum``,
    ``res_cnt`` (K) and ``occ`` (K + 1, the last the unknown count),
    ``carry_last``, ``carry_res``."""
    F, M = labels.shape
    K = n_sites
    n_ij = np.zeros(K * K, np.int64)
    lag = np.zeros(K * K, np.int64)
    res_sum = np.zeros(K, np.int64)
    res_cnt = np.zeros(K, np.int64)
    occ = np.zeros(K + 1, np.int64)
    last = np.full(M, -1, np.int64)
    res = np.zeros(M, np.int64)
    for lo in range(0, F, chunk):
        t = np.asarray(labels[lo:lo + chunk], np.int64)
        C = len(t)
        occ += np.bincount(np.where(t >= 0, t, K).ravel(), minlength=K + 1)
        # row 0 is the carry: the site before the chunk, weighted by the
        # residence it brings
        x = np.concatenate([last[None], t])
        known = x >= 0
        w = known.astype(np.int64)
        w[0] = np.where(known[0], res, 0)
        W = np.cumsum(w, axis=0)
        # the last known site at or before each row
        at = np.where(known, np.arange(C + 1)[:, None], 0)
        np.maximum.accumulate(at, axis=0, out=at)
        seen = np.take_along_axis(x, at, axis=0)
        prev, cur = seen[:-1], x[1:]
        new = known[1:] & (cur != prev)          # a jump or a first site
        jump = new & (prev >= 0)
        start = np.concatenate([known[:1], new])
        # weight before the start of each row's residence
        base = np.where(start, W - w, -1)
        np.maximum.accumulate(base, axis=0, out=base)
        r = (W[:-1] - base[:-1])[jump]
        i, j = prev[jump], cur[jump]
        n_ij += np.bincount(i * K + j, minlength=K * K)
        np.add.at(lag, i * K + j, r)
        np.add.at(res_sum, i, r)
        res_cnt += np.bincount(i, minlength=K)
        last = seen[-1]
        res = np.where(last >= 0, W[-1] - base[-1], res)
    return dict(n_ij=n_ij.reshape(K, K), lag_sum=lag.reshape(K, K),
                res_sum=res_sum, res_cnt=res_cnt, occ=occ, carry_last=last,
                carry_res=res)


def check_periodic(labels, period):
    """(a) Every frame's labels equal those of frame ``f % period``: the
    pool repeats, and labels depend only on the frame and the centres.
    Read a period at a time; returns the number of frames compared with an
    earlier one."""
    first = np.array(labels[:period])
    F = len(labels)
    for lo in range(period, F, period):
        got = np.asarray(labels[lo:lo + period])
        bad = np.flatnonzero((got != first[:len(got)]).any(axis=1))
        if len(bad):
            raise CheckFailed(
                f"(a) labels are not periodic: frame {lo + int(bad[0])} "
                f"differs from frame {int(bad[0])} ({len(bad)} frames of "
                f"[{lo}, {lo + len(got)}))")
    return max(0, F - period)


def check_recount(labels, engine, out):
    """(b) The host int64 recount of the memmap equals the engine's
    integer totals and final carry, and its result network."""
    K = engine.n_sites_
    want = recount(labels, K)
    got = engine.final_state_
    for k in ("n_ij", "lag_sum", "res_sum", "res_cnt", "carry_last",
              "carry_res"):
        if not np.array_equal(np.asarray(got[k]), want[k]):
            raise CheckFailed(f"(b) {k}: the engine differs from the host "
                              f"recount of its labels")
    if not np.array_equal(np.asarray(got["occ"]), want["occ"]):
        raise CheckFailed("(b) occupancy counts: the engine differs from "
                          "the host recount of its labels")
    if not (np.array_equal(out.n_ij, want["n_ij"])
            and np.array_equal(out.total_corrected_residences,
                               want["occ"][:K])
            and np.array_equal(out.occupancies,
                               want["occ"][:K] / len(labels))):
        raise CheckFailed("(b) the result network differs from the host "
                          "recount")
    return dict(jumps=int(want["n_ij"].sum()),
                assigned=int(want["occ"][:K].sum()))


HOST_KEYS = ("RssAnon", "VmData", "VmRSS")


def host_memory():
    """This process's host memory in bytes, from ``/proc/self/status``:
    ``RssAnon`` (resident anonymous memory: the label memmap's file pages
    are not in it), ``VmData`` (private writable mappings, counted when
    mapped rather than when touched; the memmap is a shared mapping, not in
    it) and ``VmRSS`` (all resident pages, the memmap's included), as far
    as the kernel reports them (some kernels give no ``RssAnon``)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in HOST_KEYS:
                out[key] = int(value.split()[0]) * 1024
    return out


def memory_now(device):
    """(peak device bytes since the last reset, or None on the CPU;
    :func:`host_memory`)."""
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return peak, host_memory()


class ProbedReader(CycleReader):
    """A :class:`CycleReader` that samples :func:`memory_now` when the
    feeder reads the block that starts at frame ``probe_lo``."""

    def __init__(self, blocks, n_frames, probe_lo, device):
        super().__init__(blocks, n_frames)
        self.probe_lo = probe_lo
        self.device = device
        self.sample = None

    def __getitem__(self, key):
        if isinstance(key, slice) and key.start == self.probe_lo:
            self.sample = memory_now(self.device)
        return super().__getitem__(key)


def check_memory(at_probe, at_end):
    """(c) Neither peak device memory nor the host's anonymous memory at the
    end exceeds the sample at the probe block by more than 5%: ``RssAnon``
    where the kernel reports it, else ``VmData`` (not ``VmRSS``, which
    grows with the memmap's pages by design).  Returns the host key
    checked."""
    key = next(k for k in ("RssAnon", "VmData")
               if k in at_probe[1] and k in at_end[1])
    for name, a, b in (("peak device memory", at_probe[0], at_end[0]),
                       (key, at_probe[1][key], at_end[1][key])):
        if a is not None and b > 1.05 * a:
            raise CheckFailed(f"(c) {name} grew from {a / 1e6:.1f} MB at "
                              f"block {PROBE_BLOCK} to {b / 1e6:.1f} MB at "
                              "the end (> 5%)")
    return key


# -- the device and the host link ------------------------------------------

def card_line():
    """``name, power.limit`` of the card from ``nvidia-smi``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi not available"


def link_probe(device, n_bytes=8 << 20, reps=5):
    """Host↔device copy rates in MB/s, median of ``reps``: device to
    pageable and to pinned host memory, pageable and pinned host memory to
    the device."""
    dev = torch.device(device)
    n = n_bytes // 4
    d = torch.zeros(n, device=dev)
    rates = {}
    for pinned in (False, True):
        h = torch.ones(n, pin_memory=pinned)
        for name, dst, src in (("dl", h, d), ("ul", d, h)):
            ts = []
            for _ in range(reps + 1):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                dst.copy_(src, non_blocking=pinned)
                torch.cuda.synchronize(dev)
                ts.append(time.perf_counter() - t0)
            key = f"host_link_{name}{'_pinned' if pinned else ''}_MBps"
            rates[key] = n_bytes / 1e6 / float(np.median(ts[1:]))
    return rates


# -- --split: the engine's per-block math alone ----------------------------

def split_math(engine, sn, centers, blocks):
    """A function running the engine's exact per-block math
    (``_assign_block`` + ``_accum_block`` with its plan) over ``blocks``
    resident on the device, with no host synchronisation inside; it
    returns a scalar tensor that consumes the drift and the egress labels,
    as the engine's retirement does."""
    from sitator_tpu_torch.landmark.streaming import (_accum_block,
                                                      _assign_block,
                                                      _zero_accumulators)
    from sitator_tpu_torch.parallel.mesh import take_columns
    dev = engine.device
    K = len(centers)
    route, kw = engine._assign_setup(sn, centers)
    cols = {}
    mobile_idx = np.flatnonzero(sn.mobile_mask)
    static_idx = np.flatnonzero(sn.static_mask)
    mo = [take_columns(b, mobile_idx, cols) for b in blocks]
    st = [take_columns(b, static_idx, cols) for b in blocks]
    acc = {k: v.to(dev) for k, v in _zero_accumulators(
        K, engine.max_mobile_per_site).items()}
    valid = torch.ones(len(blocks[0]), dtype=torch.bool, device=dev)
    n_mobile = len(mobile_idx)

    def one_pass():
        for v in acc.values():
            v.zero_()
        carry = (torch.full((n_mobile,), -1, dtype=torch.int64, device=dev),
                 torch.zeros(n_mobile, dtype=torch.int64, device=dev))
        sink = torch.zeros((), device=dev)
        for m, s in zip(mo, st):
            labels, confs, drift, eg = _assign_block(m, s, route, **kw)
            carry = _accum_block(labels, confs, m, kw["cell_inv"], valid,
                                 carry, acc, n_sites=K,
                                 max_mobile=engine.max_mobile_per_site)
            sink = sink + drift.max() + eg.float().sum()
        return sink + acc["occ"].sum()

    return one_pass


def math_rate(one_pass, n_frames_a_pass, device, n_disp=3):
    """frames/s of ``n_disp`` passes of :func:`split_math`'s function, timed
    by CUDA events on a card (the host clock on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sinks = [one_pass() for _ in range(n_disp)]
        b.record()
        b.synchronize()
        seconds = a.elapsed_time(b) / 1e3
    else:
        t0 = time.perf_counter()
        sinks = [one_pass() for _ in range(n_disp)]
        seconds = time.perf_counter() - t0
    if not all(bool(torch.isfinite(s)) for s in sinks):
        raise CheckFailed("--split: the math pass gave a non-finite sink")
    return n_disp * n_frames_a_pass / seconds


# -- main --------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m sitator_tpu_torch.tools.northstar_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=256,
                    help="number of blocks in the timed run (512 frames "
                         "each; 2048 is the 1,048,576-frame pass)")
    ap.add_argument("--no-labels", action="store_true",
                    help="disable the label memmap (isolates label egress; "
                         "checks (a) and (b) need it)")
    ap.add_argument("--small", action="store_true",
                    help="tiny configuration (2 x 64-frame blocks, 5 cells, "
                         "20 ions, K 32) for wiring checks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default cuda; cpu only "
                         "for wiring checks)")
    ap.add_argument("--ab", action="store_true",
                    help="same-process labels/no-labels comparison")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="engine pipeline_depth for the main timed run "
                         "(default: the engine's)")
    ap.add_argument("--ab-pipeline", action="store_true",
                    help="same-process alternating depth 0 / depth 2")
    ap.add_argument("--ab-depth", action="store_true",
                    help="same-process alternating depth 2 / depth 4")
    ap.add_argument("--ab-pack", action="store_true",
                    help="packed vs separate drift retirement: not in the "
                         "port (exits 2)")
    ap.add_argument("--split", action="store_true",
                    help="the host's share of the engine: interleave engine "
                         "segments with the engine's exact per-block math "
                         "over resident blocks (no host synchronisation "
                         "inside, CUDA events), and report the engine's "
                         "phase_times_ table")
    ap.add_argument("--workdir", default=str(ROOT / "build" / "northstar"),
                    help="directory for checkpoints, label memmaps, the fit "
                         "cache and the result JSON")
    ap.add_argument("--require-probe-s", type=float, default=None,
                    help="exit 3 if the health matmul takes longer than "
                         "this many seconds")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.ab_pack:
        print("--ab-pack: packed_retire is not in the port (a drift fetch "
              "is a copy on its own stream there, with no round trip to "
              "save)", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("northstar_run: no CUDA device (torch.cuda.is_available() is "
              "false); pass --device cpu for a wiring check", file=sys.stderr)
        return 1
    B, POOL = (SMALL["block_frames"], SMALL["pool_blocks"]) if args.small \
        else (BLOCK_FRAMES, POOL_BLOCKS)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    res = {"metric": "streaming_engine_sustained_fps_10k_atoms_1chip"}
    if cuda:
        card = card_line()
        res["device"] = torch.cuda.get_device_name(dev)
        res["card"] = card
    else:
        card = "cpu"
        res["device"] = "cpu"
    res["torch"] = torch.__version__
    res["cuda"] = torch.version.cuda
    print(f"# device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- health check + host link probes ---------------------------------
    t0 = time.perf_counter()
    x = torch.ones((256, 256), device=dev)
    (x @ x).cpu()
    probe_s = time.perf_counter() - t0
    print(f"# health matmul: {probe_s:.2f}s", flush=True)
    if args.require_probe_s is not None and probe_s > args.require_probe_s:
        print(f"# ABORT: probe {probe_s:.1f}s > --require-probe-s "
              f"{args.require_probe_s:.0f}s", flush=True)
        return 3
    res["health_matmul_s"] = probe_s
    link = (link_probe(dev) if cuda else dict.fromkeys(
        ("host_link_dl_MBps", "host_link_ul_MBps",
         "host_link_dl_pinned_MBps", "host_link_ul_pinned_MBps")))
    res.update(link)
    if cuda:
        print("# host link MB/s: " + ", ".join(
            f"{k[10:-5]} {v:.1f}" for k, v in link.items()), flush=True)

    # ---- bench system, SiteNetwork, the resident pool ---------------------
    sn, sy = bench_network(args.small)
    pool = make_pool(sy, POOL, B, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"# staged {POOL} device blocks x {B} frames "
          f"({sum(p.numel() * 4 for p in pool) / 1e9:.2f} GB)", flush=True)

    centers = fit_centers(sn, pool, sy.centers, wd, dev,
                          cache=not args.small)
    print(f"# K = {len(centers)} (fit + random pad to bench size)",
          flush=True)

    def engine(tag, **kw):
        return make_engine(wd, tag, block_frames=B, device=dev, **kw)

    # ---- warm run ----------------------------------------------------------
    t0 = time.perf_counter()
    warm = engine("warm")
    out = warm.run(sn, CycleReader(pool, 2 * B), centers=centers)
    print(f"# warm run (2 blocks): {time.perf_counter() - t0:.1f}s; "
          f"K={warm.n_sites_} occ_sum={float(np.sum(out.occupancies)):.2f}",
          flush=True)

    def timed(tag, n_blocks, labels=True, depth=None, reader=None):
        n_frames = n_blocks * B
        eng = engine(tag, labels=labels)
        if depth is not None:
            eng.pipeline_depth = depth
        t0 = time.perf_counter()
        out = eng.run(sn, reader or CycleReader(pool, n_frames),
                      centers=centers)
        if cuda:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if not float(np.sum(out.occupancies)) > 0:
            raise CheckFailed(f"{tag}: no frame was assigned")
        return n_frames / dt, dt, n_frames, eng, out

    # ---- the main timed run, then its checks ------------------------------
    n_frames = args.blocks * B
    labels_bytes = n_frames * len(sy.occ) * 4
    if not args.no_labels:
        free = shutil.disk_usage(wd).free
        res["workdir_free_GB"] = free / 1e9
        if free < labels_bytes + (1 << 30):
            print(f"(d) {wd} has {free / 1e9:.2f} GB free; the label memmap "
                  f"needs {labels_bytes / 1e9:.2f} GB + 1 GB", file=sys.stderr)
            return 1
    probe_block = min(PROBE_BLOCK, args.blocks // 2)
    reader = ProbedReader(pool, n_frames, probe_block * B, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    fps, dt, n_frames, eng, out = timed(
        "main", args.blocks, labels=not args.no_labels,
        depth=args.pipeline_depth, reader=reader)
    at_end = memory_now(dev)
    res.update(value=fps, unit="frames/sec", n_frames=n_frames, wall_s=dt,
               labels_memmap=not args.no_labels, block_frames=B,
               pool_blocks=POOL, pipeline_depth=eng.pipeline_depth,
               route=eng.route_, phase_times=dict(eng.phase_times_),
               staged_blocks=eng.staged_blocks_)
    print(f"# main run: {n_frames} frames in {dt:.1f}s = {fps:.1f} frames/s "
          f"(route {eng.route_}, depth {eng.pipeline_depth}); phase_times_ "
          "(s): " + json.dumps({k: round(v, 3)
                                for k, v in eng.phase_times_.items()}),
          flush=True)
    if reader.sample is not None:
        def gb(b):
            return None if b is None else b / 1e9
        res.update(probe_block=probe_block,
                   peak_device_GB_probe=gb(reader.sample[0]),
                   peak_device_GB_end=gb(at_end[0]),
                   host_GB_probe={k: gb(v) for k, v in
                                  reader.sample[1].items()},
                   host_GB_end={k: gb(v) for k, v in at_end[1].items()})
        print(f"# memory at block {probe_block} / at the end: peak device "
              f"{res['peak_device_GB_probe']} / {res['peak_device_GB_end']} "
              f"GB; host {res['host_GB_probe']} / {res['host_GB_end']} GB",
              flush=True)
        if args.blocks >= 2 * PROBE_BLOCK:
            res["check_memory"] = check_memory(reader.sample, at_end)
    if not args.no_labels:
        labels = np.load(eng.store_labels, mmap_mode="r")
        t0 = time.perf_counter()
        n_cmp = check_periodic(labels, POOL * B)
        res["check_periodic_frames"] = n_cmp
        counts = check_recount(labels, eng, out)
        res.update(check_recount="held", jumps=counts["jumps"],
                   assigned=counts["assigned"])
        print(f"# checks: (a) {n_cmp} frames equal to frame f mod "
              f"{POOL * B}; (b) host int64 recount == engine "
              f"({counts['jumps']} jumps, {counts['assigned']} assigned "
              f"(frame, ion) pairs, final carry equal); "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        del labels

    if args.split:
        nsc = min(4, POOL)
        one_pass = split_math(eng, sn, centers, pool[:nsc])
        t0 = time.perf_counter()
        math_rate(one_pass, nsc * B, dev, n_disp=1)
        print(f"# split: math pass warm {time.perf_counter() - t0:.1f}s",
              flush=True)
        nb = max(24, args.blocks // 2)
        tables = []

        def timed_split(tag, n_blocks, record=True):
            """frames/s of the pass-2 loop alone: set-up and finalize are
            fixed costs a long run amortises."""
            _, dt, n_fr, e, _ = timed(tag, n_blocks)
            pt = dict(e.phase_times_)
            loop = dt - pt.get("setup", 0.0) - pt.get("finalize", 0.0)
            if record:
                tables.append((pt, loop))
            return n_fr / loop

        timed_split("spw", 2, record=False)
        seq = []
        for i in range(3):
            seq.append(("math", math_rate(one_pass, nsc * B, dev)))
            seq.append(("engine", timed_split(f"sp{i}", nb)))
        f_math = float(np.median([v for t, v in seq if t == "math"]))
        f_eng = float(np.median([v for t, v in seq if t == "engine"]))
        tot, loop = {}, 0.0
        for pt, lp in tables:
            loop += lp
            for k, v in pt.items():
                if k not in ("setup", "finalize"):
                    tot[k] = tot.get(k, 0.0) + v
        res.update(
            split_blocks=nsc, split_engine_blocks=nb,
            split_segments=seq, split_math_fps=f_math,
            split_engine_loop_fps=f_eng,
            split_host_overhead_share=1.0 - f_eng / f_math,
            split_phase_share_of_loop={
                k: v / loop for k, v in sorted(tot.items(),
                                               key=lambda kv: -kv[1])},
            split_phase_covered=sum(tot.values()) / loop)
        print(f"# split: math {f_math:.1f} frames/s, engine loop "
              f"{f_eng:.1f} frames/s, host share "
              f"{res['split_host_overhead_share']:.4f}", flush=True)

    if args.ab:
        nb = max(32, args.blocks // 2)
        res["ab_sync_labels_fps"] = timed("b", nb)[0]
        res["ab_no_labels_fps"] = timed("c", nb, labels=False)[0]

    def ab_segments(name, variants, rounds=2):
        """Alternating A/B in one process: each variant warmed on one
        block, then ``rounds`` turns of every variant; per-variant
        medians."""
        nb = max(16, args.blocks // 8)
        for tag, kw in variants:
            timed(f"{name[:2]}w{tag}", 1, **kw)
        seq = [(tag, timed(f"{name[:2]}{tag}{i}", nb, **kw)[0])
               for i in range(rounds) for tag, kw in variants]
        res[f"{name}_segments"] = seq
        for tag, _ in variants:
            res[f"{name}_{tag}_fps"] = float(np.median(
                [v for t, v in seq if t == tag]))

    if args.ab_pipeline:
        ab_segments("ab_pipeline", [("sync", dict(depth=0)),
                                    ("piped", dict(depth=2))])
        res["ab_pipeline_ratio"] = (res["ab_pipeline_piped_fps"]
                                    / res["ab_pipeline_sync_fps"])
    if args.ab_depth:
        ab_segments("ab_depth", [("d2", dict(depth=2)),
                                 ("d4", dict(depth=4))])

    print(json.dumps(res), flush=True)
    with open(os.path.join(wd, "northstar_result.json"), "w") as f:
        json.dump(res, f)
    del pool[:]
    if cuda:
        torch.cuda.synchronize(dev)
    print("# teardown: pool freed, device synchronised", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
