"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
lands in ``build/sitator_tpu_torch-<hash>/`` beside the package, keyed by a
hash of the sources, so a fresh checkout builds everything from its own
sources and an edited source rebuilds.  Nothing here is imported or built
until a CUDA tensor reaches a kernel wrapper.

Every launcher checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, and raises when the C entry returns a CUDA error
(a refused launch never runs, and a later synchronise would not report it).
While a profiler records, each launch runs inside a ``record_function``
range named after its C entry, so a trace holds a host record of the
``ctypes`` launches (the profiler sees no runtime call for them).
A launch goes to the current device (the C entries take its stream, and
their runtime calls act on it), so every tensor a launcher is given must
lie on that device: the public wrappers make the inputs' card current, and
a launcher handed a tensor of another card raises (:func:`launch_device_error`)
instead of running on the wrong card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from sitator_tpu_torch.ops.kernel_common import skew_cluster_size
from sitator_tpu_torch.util.timing import (profiler_recording,
                                           record_function, stage_mark)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # mob, vpu, midx, mmul, kill, anchors, col_map, out, B, MP, M_out,
    # n_st, UP, s_tile, vmax, out_cols, params, triclinic, r2, preshift,
    # stream
    "sit_lv_tile": [_P] * 8 + [_I] * 8 + [_P, _I, _I, _I, _P],
    # mob, vp, mask, out (or NULL), lvb (or NULL), inv_norm (or NULL), B,
    # MP, V, SP, params, triclinic, r2, full_mask, stream
    "sit_lv_gather": [_P] * 6 + [_I] * 4 + [_P, _I, _I, _I, _P],
    # lv, lvb (or NULL), inv_norm, rows, cols, clip, stream
    "sit_row_prep": [_P] * 3 + [_I] * 3 + [_P],
    # lv, inv_norm, centers, part_val, part_idx, rows, cols, KP, stream
    "sit_sims_fma": [_P] * 5 + [_I] * 3 + [_P],
    # lvb, centers_bf16, inv_norm, part_val, part_idx, rows, SP, KP, stream
    "sit_sims_wgmma": [_P] * 5 + [_I] * 3 + [_P],
    # part_val, part_idx, labels, confs, rows, n_kb, threshold, stream
    "sit_argmax_merge": [_P] * 4 + [_I] * 2 + [_F, _P],
    # mob, vpu, A, kill, anchors, centers, labels, confs, B, MP, n_st, UP,
    # s_tile, KP, ldc, nj, params, triclinic, r2, preshift, stream
    "sit_assign_skew": [_P] * 8 + [_I] * 8 + [_P, _I, _I, _I, _P],
    # mob, vpu, midx, mmul, kill, anchors, tile_nu, centers_bf16, labels,
    # confs, run_val, run_idx, B, MP, n_st, UP, s_tile, vmax, KP, nc,
    # params, triclinic, r2, preshift, stream
    "sit_assign_skew_wgmma": [_P] * 12 + [_I] * 8 + [_P, _I, _I, _I, _P],
    # nc, UP, s_tile, vmax, &stages, &smem, &clusters
    "sit_assign_skew_wgmma_occupancy": [_I] * 4 + [_P] * 3,
    # labels, F, M, ld, last_in, res_in, last_out, res_out, n_ij, lag_sum,
    # res_sum, res_cnt, S, brk, stream
    "sit_jump_fold": [_P] + [_I] * 3 + [_P] * 8 + [_I] * 2 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build():
    """Compile ``csrc/*.cu`` unless a library for these exact sources is
    already built.  Returns ``(path, seconds, compiler_log)``; seconds is 0
    and the log empty when nothing was compiled."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    out_dir = BUILD_ROOT / f"sitator_tpu_torch-{h.hexdigest()[:16]}"
    lib = out_dir / "libsitator_kernels.so"
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = out_dir / f"libsitator_kernels.{tag}.so"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    proc = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in jobs]],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    return lib, seconds, "".join(logs)


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sit_error_string.argtypes = [ctypes.c_int]
    lib.sit_error_string.restype = ctypes.c_char_p
    return lib


def _call(name, *args):
    lib = library()
    if profiler_recording():
        with record_function(name):
            err = getattr(lib, name)(*args)
    else:
        err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.sit_error_string(err).decode()})")


def launch_device_error(device, current):
    """Why a kernel cannot take a tensor on ``device`` while CUDA device
    ``current`` (an index) is current, or None when it can.  A launch runs
    on the current device's stream; a tensor of another card would be read
    from there (over NVLink where peer access is on, unordered against the
    stream that wrote it) or fault."""
    if device.type != "cuda":
        return f"a CUDA tensor is needed, got one on {device}"
    if device.index != current:
        return (f"the tensor is on {device} but cuda:{current} is the "
                f"current device; launch under torch.cuda.device({device})")
    return None


def _check(t, name, dtype, shape=None):
    err = launch_device_error(
        t.device, torch.cuda.current_device() if t.is_cuda else None)
    if err is not None:
        raise ValueError(f"{name}: {err}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.data_ptr()


def _host_params(params):
    p = params.detach().to("cpu", torch.float32).contiguous()
    if p.numel() not in (6, 21):
        raise ValueError("params must hold 6 (orthorhombic) or 21 "
                         "(triclinic) floats")
    return p


def _stream():
    return torch.cuda.current_stream().cuda_stream


def lv_tile(mob, vpu, midx, mmul, kill, anchors, col_map, out, params, *,
            triclinic, r2_cutoff, preshift):
    """Landmark vectors of every (ion, kd site tile) into ``out (B, M_out,
    out_cols)``: column ``c`` of the kd-ordered site axis lands in
    ``out[..., col_map[c]]`` (skipped where ``col_map[c] < 0``), ion rows
    beyond ``M_out`` are skipped.  ``midx`` / ``mmul (n_st, s_tile, vmax)``
    are the membership lists of ``landmark_mxu.membership_lists``."""
    B, _, MP = mob.shape
    n_st, s_tile, vmax = midx.shape
    UP = vpu.shape[-1]
    SP = n_st * s_tile
    _, M_out, out_cols = out.shape
    if MP % 32 or M_out > MP:
        raise ValueError("lv_tile needs MP % 32 == 0, M_out <= MP")
    p = _host_params(params)
    _call("sit_lv_tile",
          _check(mob, "mob", torch.float32, (B, 3, MP)),
          _check(vpu, "vpu", torch.float32, (B, n_st, 3, UP)),
          _check(midx, "midx", torch.int32),
          _check(mmul, "mmul", torch.float32, (n_st, s_tile, vmax)),
          _check(kill, "kill", torch.float32, (SP,)),
          _check(anchors, "anchors", torch.float32, (n_st, 3)),
          _check(col_map, "col_map", torch.int32, (SP,)),
          _check(out, "out", torch.float32, (B, M_out, out_cols)),
          B, MP, M_out, n_st, UP, s_tile, vmax, out_cols, p.data_ptr(),
          int(triclinic), int(r2_cutoff), int(preshift), _stream())


def lv_gather(mob, vp, mask, params, *, triclinic, r2_cutoff, full_mask,
              bf16):
    """Per-vertex-slot landmark vectors of every (ion, site) pair, rows
    ``B * MP`` x ``SP`` columns; mask row ``V`` kills padding sites.  With
    ``bf16`` the kernel forms each row's norm itself and returns ``(lvb,
    inv_norm)``: the bf16 copy and ``rsqrt(max(norm², 1e-24))``, bit-equal
    to :func:`row_prep` on the f32 rows; else the f32 rows ``lv``."""
    B, _, MP = mob.shape
    _, _, V, SP = vp.shape
    if MP % 32:
        raise ValueError("lv_gather needs MP % 32 == 0")
    p = _host_params(params)
    dev = mob.device
    lv = lvb = inv_norm = None
    if bf16:
        lvb = torch.empty((B * MP, SP), device=dev, dtype=torch.bfloat16)
        inv_norm = torch.empty(B * MP, device=dev, dtype=torch.float32)
    else:
        lv = torch.empty((B * MP, SP), device=dev, dtype=torch.float32)
    _call("sit_lv_gather",
          _check(mob, "mob", torch.float32, (B, 3, MP)),
          _check(vp, "vp", torch.float32, (B, 3, V, SP)),
          _check(mask, "mask", torch.float32, (V + 1, SP)),
          None if lv is None else lv.data_ptr(),
          None if lvb is None else lvb.data_ptr(),
          None if inv_norm is None else inv_norm.data_ptr(),
          B, MP, V, SP, p.data_ptr(), int(triclinic), int(r2_cutoff),
          int(full_mask), _stream())
    return (lvb, inv_norm) if bf16 else lv


def row_prep(lv, *, peak_clip, bf16_copy):
    """Tail stage 1 on ``lv (rows, SP)``: clip every row in place at its
    second-largest value when ``peak_clip``; returns ``inv_norm (rows,)``
    and, when ``bf16_copy``, the bf16 copy of the (clipped) rows, else
    None."""
    rows, SP = lv.shape
    inv_norm = torch.empty(rows, device=lv.device, dtype=torch.float32)
    lvb = (torch.empty((rows, SP), device=lv.device, dtype=torch.bfloat16)
           if bf16_copy else None)
    _call("sit_row_prep", _check(lv, "lv", torch.float32),
          None if lvb is None else lvb.data_ptr(), inv_norm.data_ptr(),
          rows, SP, int(peak_clip), _stream())
    return inv_norm, lvb


def centers_bf16(centers):
    """The tensor-core operand of the centres ``(SP, KP)``: rounded to bf16
    once, K-major ``(KP, SP)``."""
    return centers.t().to(torch.bfloat16).contiguous()


def sims_argmax(lv, inv_norm, centers):
    """Tail stage 2: per row, the max and first arg-max of ``sims ·
    inv_norm`` over each block of the f32 ``centers (SP, KP)``'s columns.
    The dtype of ``lv (rows, SP)`` picks the kernel: bf16 rows run on the
    tensor cores over 256-column blocks against the centres' bf16 operand
    (:func:`centers_bf16`, made here); f32 rows on the FMA pipes over
    128-column blocks.  Returns ``(part_val, part_idx)``, ``(rows,
    n_kb)``."""
    rows, SP = lv.shape
    bf16 = lv.dtype == torch.bfloat16
    KP = centers.shape[1]
    if KP % 128:
        raise ValueError("centers must be padded to a multiple of 128")
    _check(centers, "centers", torch.float32, (SP, KP))
    dev = lv.device
    n_kb = -(-KP // 256) if bf16 else KP // 128
    part_val = torch.empty((rows, n_kb), device=dev, dtype=torch.float32)
    part_idx = torch.empty((rows, n_kb), device=dev, dtype=torch.int32)
    if not bf16:
        _call("sit_sims_fma", _check(lv, "lv", torch.float32, (rows, SP)),
              _check(inv_norm, "inv_norm", torch.float32, (rows,)),
              centers.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
              rows, SP, KP, _stream())
        return part_val, part_idx
    if rows % 128 or SP % 64:
        raise ValueError("the tensor-core tail needs rows % 128 == 0 and "
                         f"SP % 64 == 0 (rows={rows}, SP={SP})")
    centers_b = centers_bf16(centers)
    _call("sit_sims_wgmma", _check(lv, "lvb", torch.bfloat16, (rows, SP)),
          _check(centers_b, "centers_b", torch.bfloat16, (KP, SP)),
          _check(inv_norm, "inv_norm", torch.float32, (rows,)),
          part_val.data_ptr(), part_idx.data_ptr(), rows, SP, KP, _stream())
    return part_val, part_idx


def argmax_merge(part_val, part_idx, threshold):
    """Tail stage 3: merge the per-block partials of every row in column
    order; returns (labels int32 with -1 below ``threshold``, confs)."""
    rows, n_kb = part_val.shape
    _check(part_val, "part_val", torch.float32)
    _check(part_idx, "part_idx", torch.int32, (rows, n_kb))
    labels = torch.empty(rows, device=part_val.device, dtype=torch.int32)
    confs = torch.empty(rows, device=part_val.device, dtype=torch.float32)
    _call("sit_argmax_merge", part_val.data_ptr(), part_idx.data_ptr(),
          labels.data_ptr(), confs.data_ptr(), rows, n_kb, float(threshold),
          _stream())
    return labels, confs


def assign_tail(lv, centers, threshold, *, peak_clip, mxu_bf16):
    """Cosine assignment of every row of ``lv (rows, SP)`` (clipped in
    place at its second-largest value when ``peak_clip``) to the padded
    centres ``centers (SP, KP)``: :func:`row_prep`, :func:`sims_argmax`
    (on the tensor cores when ``mxu_bf16``), :func:`argmax_merge`.
    Returns (labels int32, confs float32), both ``(rows,)``.  The landmark
    stage ends with :func:`row_prep` (``util.timing.stage_mark``)."""
    inv_norm, lvb = row_prep(lv, peak_clip=peak_clip, bf16_copy=mxu_bf16)
    stage_mark()
    part_val, part_idx = sims_argmax(lvb if mxu_bf16 else lv, inv_norm,
                                     centers)
    return argmax_merge(part_val, part_idx, threshold)


def assign_skew(mob, vpu, A, kill, anchors, centers, params, *, n_valid,
                nj, triclinic, r2_cutoff, preshift):
    """K1s with f32 similarity operands (the FMA kernel): landmark vectors,
    norm and cosine assignment of every (frame, ion) row in one launch, the
    lv kept on chip.  ``centers (SP, ldc)`` are the zero-padded f32 centre
    columns, taken in chunks of ``128 * nj`` columns; only the first
    ``n_valid`` columns compete in the arg-max.  Returns (labels int32,
    confs float32), both ``(B * MP,)``."""
    B, _, MP = mob.shape
    n_st, UP, s_tile = A.shape
    SP = n_st * s_tile
    ldc = centers.shape[1]
    if nj not in (1, 2, 4, 8) or ldc % (128 * nj) or not 0 < n_valid <= ldc:
        raise ValueError("assign_skew needs nj in (1, 2, 4, 8), centre "
                         "columns a multiple of 128 * nj, 0 < n_valid <= "
                         "columns")
    if s_tile % 128 or UP % 32 or MP % 16:
        raise ValueError("assign_skew needs s_tile % 128 == 0, UP % 32 == 0, "
                         "MP % 16 == 0")
    p = _host_params(params)
    labels = torch.empty(B * MP, device=mob.device, dtype=torch.int32)
    confs = torch.empty(B * MP, device=mob.device, dtype=torch.float32)
    _call("sit_assign_skew",
          _check(mob, "mob", torch.float32, (B, 3, MP)),
          _check(vpu, "vpu", torch.float32, (B, n_st, 3, UP)),
          _check(A, "A", torch.float32),
          _check(kill, "kill", torch.float32, (SP,)),
          _check(anchors, "anchors", torch.float32, (n_st, 3)),
          _check(centers, "centers", torch.float32, (SP, ldc)),
          labels.data_ptr(), confs.data_ptr(), B, MP, n_st, UP, s_tile,
          n_valid, ldc, nj, p.data_ptr(), int(triclinic), int(r2_cutoff),
          int(preshift), _stream())
    return labels, confs


def skew_occupancy(nc, UP, s_tile, vmax):
    """The launch shape of the tensor-core K1s with ``nc`` CTAs a cluster:
    ``{"stages", "smem", "clusters"}``: the ring depth, a CTA's dynamic
    shared memory and ``cudaOccupancyMaxActiveClusters``."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _call("sit_assign_skew_wgmma_occupancy", nc, UP, s_tile, vmax,
          *[ctypes.addressof(x) for x in out])
    return dict(zip(("stages", "smem", "clusters"), (x.value for x in out)))


def assign_skew_wgmma(mob, vpu, midx, mmul, kill, anchors, centers_b,
                      params, *, triclinic, r2_cutoff, preshift):
    """K1s with bf16 similarity operands: landmark vectors (summed over the
    membership lists ``midx`` / ``mmul`` of ``landmark_mxu.
    membership_lists``), norm, the similarity on the tensor cores and the
    cosine assignment of every (frame, ion) row, the lv kept on chip, in
    clusters of :func:`skew_cluster_size` CTAs that split the centre
    columns.  ``centers_b (KP, SP)`` is the centres' K-major bf16 copy
    (:func:`centers_bf16`); every one of the ``KP`` columns competes in the
    arg-max.  Returns (labels int32, confs float32), both ``(B * MP,)``."""
    B, _, MP = mob.shape
    n_st, s_tile, vmax = midx.shape
    UP = vpu.shape[-1]
    SP = n_st * s_tile
    KP = centers_b.shape[0]
    if KP % 128 or MP % 64 or s_tile % 64:
        raise ValueError("assign_skew_wgmma needs KP % 128 == 0, "
                         "MP % 64 == 0, s_tile % 64 == 0")
    nc = skew_cluster_size(KP)
    p = _host_params(params)
    dev = mob.device
    labels = torch.empty(B * MP, device=dev, dtype=torch.int32)
    confs = torch.empty(B * MP, device=dev, dtype=torch.float32)
    # one more than the largest atom index each tile's lists use
    tile_nu = (midx.amax(dim=(1, 2)) + 1).to(torch.int32)
    multi = KP > 256 * nc
    run_val = torch.empty(B * MP if multi else 1, device=dev)
    run_idx = torch.empty(B * MP if multi else 1, device=dev,
                          dtype=torch.int32)
    _call("sit_assign_skew_wgmma",
          _check(mob, "mob", torch.float32, (B, 3, MP)),
          _check(vpu, "vpu", torch.float32, (B, n_st, 3, UP)),
          _check(midx, "midx", torch.int32),
          _check(mmul, "mmul", torch.float32, (n_st, s_tile, vmax)),
          _check(kill, "kill", torch.float32, (SP,)),
          _check(anchors, "anchors", torch.float32, (n_st, 3)),
          tile_nu.data_ptr(),
          _check(centers_b, "centers_b", torch.bfloat16, (KP, SP)),
          labels.data_ptr(), confs.data_ptr(), run_val.data_ptr(),
          run_idx.data_ptr(), B, MP, n_st, UP, s_tile, vmax, KP, nc,
          p.data_ptr(), int(triclinic), int(r2_cutoff), int(preshift),
          _stream())
    return labels, confs


def jump_fold(labels, last, res, n_ij, lag_sum, res_sum, res_cnt, *,
              unknown_policy):
    """The carried jump scan of ``labels (F, M)`` (int32, the assignment's
    dtype; rows may be strided) from the carry ``last``, ``res (M,)`` int64:
    every jump adds to ``n_ij``, ``lag_sum (S, S)`` and ``res_sum``,
    ``res_cnt (S,)`` (int64) in place.  Returns the new carry ``(last,
    res)`` in fresh tensors; the given carry is not written."""
    F, M = labels.shape
    S = n_ij.shape[0]
    err = launch_device_error(
        labels.device,
        torch.cuda.current_device() if labels.is_cuda else None)
    if err is not None:
        raise ValueError(f"labels: {err}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be torch.int32, got {labels.dtype}")
    if M > 1 and labels.stride(1) != 1:
        raise ValueError("labels' rows must be contiguous")
    last_out = torch.empty(M, device=labels.device, dtype=torch.int64)
    res_out = torch.empty_like(last_out)
    _call("sit_jump_fold", labels.data_ptr(), F, M, labels.stride(0),
          _check(last, "last", torch.int64, (M,)),
          _check(res, "res", torch.int64, (M,)),
          last_out.data_ptr(), res_out.data_ptr(),
          _check(n_ij, "n_ij", torch.int64, (S, S)),
          _check(lag_sum, "lag_sum", torch.int64, (S, S)),
          _check(res_sum, "res_sum", torch.int64, (S,)),
          _check(res_cnt, "res_cnt", torch.int64, (S,)), S,
          int(unknown_policy == "break"), _stream())
    return last_out, res_out
