"""Shared helpers for the landmark kernels and their plain versions.

Counterpart of ``sitator_tpu.ops.kernel_common``.  The cell/params layout
is the one the CUDA kernels read (``csrc/landmark_common.cuh``); the
``min_image_xyz`` / ``merge_top2`` math here is what the plain PyTorch
versions of the kernels run, element for element.  Kernel dispatch goes by
``tensor.is_cuda``, so there is no backend probe.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["round_up", "pack_cell_params", "load_cell_params",
           "min_image_xyz", "merge_top2", "supports_cell", "kernel_cell",
           "softplus", "tiled_assign_plain", "blocked_assign_plain",
           "row_prep_plain", "skew_cluster_size", "clustered_assign_plain"]


def round_up(x, m):
    """Round ``x`` up to the next multiple of ``m``."""
    return (x + m - 1) // m * m


def as_f32(x, device):
    """``x`` (tensor, NumPy or JAX array) as a float32 tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def cell_array(cell):
    """A kernel cell argument ((3,) or (3, 3); tensor or array) as float32
    NumPy."""
    if torch.is_tensor(cell):
        cell = cell.detach().cpu().numpy()
    return np.asarray(cell, np.float32)


def softplus(x):
    """``log(1 + e^x)`` as ``logaddexp(x, 0)`` — the formula of the
    reference's softplus, with no switch to the identity at large ``x``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def supports_cell(cell, tol=1e-8) -> bool:
    """True when ``cell`` is orthorhombic (diagonal) — the kernels' cheap
    per-axis minimum-image variant.  Triclinic cells are supported too (via
    :func:`kernel_cell`); this predicate only selects the cheap path."""
    cell = np.asarray(cell)
    return bool(np.all(np.abs(cell - np.diag(np.diag(cell))) < tol))


def kernel_cell(cell):
    """Reduce a (3, 3) cell to the kernels' preferred argument: the ``(3,)``
    diagonal when orthorhombic, else the full ``(3, 3)`` matrix — a float32
    CPU tensor either way."""
    cell = np.asarray(cell, np.float32)
    if supports_cell(cell):
        return torch.from_numpy(np.diag(cell).copy())
    return torch.from_numpy(cell.copy())


def pack_cell_params(cell, consts):
    """Pack the cell and trailing scalar constants (midpoint, steepness,
    threshold) into one float32 CPU vector: ``[cell(9), cell_inv(9),
    consts]`` for a (3, 3) triclinic cell, ``[lx, ly, lz, consts]`` for the
    (3,) orthorhombic diagonal.  Returns ``(params, triclinic)``."""
    cell = torch.as_tensor(np.asarray(cell, np.float32))
    consts = torch.as_tensor(np.asarray(consts, np.float32))
    if cell.ndim == 2:
        cell_inv = torch.linalg.inv(cell)
        return torch.cat([cell.reshape(-1), cell_inv.reshape(-1), consts]), True
    return torch.cat([cell, consts]), False


def load_cell_params(params, triclinic):
    """Unpack :func:`pack_cell_params` → ``(cell, midpoint, steepness,
    threshold)`` as 0-d float32 tensors on ``params``' device; ``cell`` is
    the (rows, inverse) pair for triclinic cells, else ``(lx, ly, lz)``."""
    p = list(params.unbind(0))
    if triclinic:
        return (tuple(p[:9]), tuple(p[9:18])), p[18], p[19], p[20]
    return tuple(p[:3]), p[3], p[4], p[5]


def min_image_xyz(dx, dy, dz, cell, triclinic):
    """Minimum-image displacement components (same math as
    ``ops.pbc.min_image_disp``): per-axis rounding for orthorhombic cells,
    the fractional round-trip for triclinic ones."""
    if triclinic:
        c, ci = cell
        fx = dx * ci[0] + dy * ci[3] + dz * ci[6]
        fy = dx * ci[1] + dy * ci[4] + dz * ci[7]
        fz = dx * ci[2] + dy * ci[5] + dz * ci[8]
        fx = fx - torch.round(fx)
        fy = fy - torch.round(fy)
        fz = fz - torch.round(fz)
        dx = fx * c[0] + fy * c[3] + fz * c[6]
        dy = fx * c[1] + fy * c[4] + fz * c[7]
        dz = fx * c[2] + fy * c[5] + fz * c[8]
        return dx, dy, dz
    lx, ly, lz = cell
    dx = dx - torch.round(dx * (1.0 / lx)) * lx
    dy = dy - torch.round(dy * (1.0 / ly)) * ly
    dz = dz - torch.round(dz * (1.0 / lz)) * lz
    return dx, dy, dz


def merge_top2(top2_acc, lv):
    """Merge a tile's per-row top-2 of ``lv (..., S_t)`` into the running
    top-2 ``top2_acc (..., 2)``; returns the merged summary.

    Ties: if the max occurs more than once, the 2nd-largest IS the max
    (the ``top_k`` semantics of ``ops.landmark.peak_even``).
    """
    m1 = lv.amax(dim=-1)
    is_max = lv >= m1[..., None]
    n_max = is_max.sum(dim=-1)
    m2 = torch.where(n_max > 1, m1,
                     torch.where(is_max, -1.0, lv).amax(dim=-1))
    r1, r2 = top2_acc[..., 0], top2_acc[..., 1]
    return torch.stack([torch.maximum(r1, m1),
                        torch.maximum(torch.minimum(r1, m1),
                                      torch.maximum(r2, m2))], dim=-1)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def tiled_assign_plain(tile_lv, B, MP, n_tiles, s_tile, cpad, threshold, *,
                       frame_chunk, peak_clip, mxu_bf16):
    """Plain version of the assignment tail shared by K1 and K3.

    ``tile_lv(lo, hi, t)`` gives frames ``lo:hi``'s landmark vectors on site
    tile ``t`` as ``(hi - lo, MP, s_tile)``; ``cpad (n_tiles·s_tile, KP)``
    holds the zero-padded centres as columns.  With ``peak_clip`` a first
    sweep reduces every row's top-2 and the second clips at it.  Then the
    running norm² (f32) and ``sims += lv @ centres`` (operands rounded to
    bf16 when ``mxu_bf16``, f32 accumulation), ``sims · rsqrt(max(norm²,
    1e-24))``, the first-index arg-max over all ``KP`` columns, and the
    threshold (label −1 below it).  Returns labels int32 / confs, ``(B,
    MP)``."""
    dev = cpad.device
    c = _round_bf16(cpad) if mxu_bf16 else cpad
    labels = torch.empty((B, MP), dtype=torch.int32, device=dev)
    confs = torch.empty((B, MP), device=dev)
    for lo in range(0, B, frame_chunk):
        hi = min(lo + frame_chunk, B)
        if peak_clip:
            top2 = torch.zeros((hi - lo, MP, 2), device=dev)
            for t in range(n_tiles):
                top2 = merge_top2(top2, tile_lv(lo, hi, t))
            cap = top2[..., 1:2]
        sims = torch.zeros((hi - lo, MP, c.shape[1]), device=dev)
        norm2 = torch.zeros((hi - lo, MP), device=dev)
        for t in range(n_tiles):
            lv = tile_lv(lo, hi, t)
            if peak_clip:
                lv = torch.minimum(lv, cap)
            norm2 += (lv * lv).sum(-1)
            sims += ((_round_bf16(lv) if mxu_bf16 else lv)
                     @ c[t * s_tile:(t + 1) * s_tile])
        sims = sims * torch.rsqrt(torch.clamp_min(norm2, 1e-24))[..., None]
        conf = sims.amax(-1)
        lab = sims.argmax(-1).to(torch.int32)
        labels[lo:hi] = torch.where(conf >= threshold, lab, -1)
        confs[lo:hi] = conf
    return labels, confs


def blocked_assign_plain(lv, inv_norm, centers, threshold, *, mxu_bf16):
    """Plain twin of the CUDA tail's partition (``csrc/assign_tail.cu``,
    ``csrc/sims_wgmma.cu``) on ``lv (rows, SP)`` and ``centers (SP, KP)``:
    per block of rows x centre columns (128 x 256 with bf16 operands, the
    last block holding only the ``KP mod 256`` real columns; 64 x 128 in
    f32) the max of ``sims · inv_norm`` and its first arg-max, then the
    merge of each row's blocks in column order (strict ``>``: the lowest
    index wins a tie) and the threshold.  Returns (labels int32, confs)."""
    rows, _ = lv.shape
    KP = centers.shape[1]
    bm, bn = (128, 256) if mxu_bf16 else (64, 128)
    a = _round_bf16(lv) if mxu_bf16 else lv
    c = _round_bf16(centers) if mxu_bf16 else centers
    n_kb = -(-KP // bn)
    part_val = torch.empty((rows, n_kb), device=lv.device)
    part_idx = torch.empty((rows, n_kb), dtype=torch.int64, device=lv.device)
    for r0 in range(0, rows, bm):
        r1 = min(rows, r0 + bm)
        for kb in range(n_kb):
            c0, c1 = kb * bn, min(KP, (kb + 1) * bn)
            s = (a[r0:r1] @ c[:, c0:c1]) * inv_norm[r0:r1, None]
            part_val[r0:r1, kb], part_idx[r0:r1, kb] = s.max(1)
            part_idx[r0:r1, kb] += c0
    best = part_val[:, 0].clone()
    idx = part_idx[:, 0].clone()
    for kb in range(1, n_kb):
        take = part_val[:, kb] > best
        best = torch.where(take, part_val[:, kb], best)
        idx = torch.where(take, part_idx[:, kb], idx)
    labels = torch.where(best >= threshold, idx, -1).to(torch.int32)
    return labels, best


def row_prep_plain(lv, *, peak_clip):
    """Plain twin of ``row_prep_kernel`` (``csrc/assign_tail.cu``) and of the
    norm the bf16 gather route forms itself (``csrc/lv_gather.cu``) on
    ``lv (rows, SP)``, SP a multiple of 32: with ``peak_clip`` every row
    capped at its second-largest value (a repeated maximum is its own
    second value); then norm² in the kernels' order — lane ``l`` sums
    ``fmaf(x, x, n2)`` over columns ``l, l + 32, ...`` in ascending order,
    then the 32 lane sums are combined by the xor-shuffle tree (offsets 16,
    8, 4, 2, 1) — and ``inv_norm = rsqrt(max(norm², 1e-24))``.  The fused
    multiply-add is taken in float64 and rounded once to float32 (equal to
    ``fmaf`` but on the rare double-rounding tie).  Returns ``(inv_norm,
    rows)``: the (clipped) f32 rows, whose bf16 rounding is the kernels'
    bf16 copy."""
    rows, SP = lv.shape
    if peak_clip:
        cap = lv.topk(2, dim=-1).values[:, 1:2]
        lv = torch.minimum(lv, cap)
    x = lv.view(rows, SP // 32, 32).double()
    n2 = torch.zeros((rows, 32), dtype=torch.float64, device=lv.device)
    for j in range(SP // 32):
        n2 = (x[:, j] * x[:, j] + n2).float().double()
    off = 16
    while off:
        lanes = torch.arange(32, device=lv.device) ^ off
        n2 = (n2 + n2[:, lanes]).float().double()
        off //= 2
    n2 = n2[:, 0].float()
    return torch.rsqrt(torch.clamp_min(n2, 1e-24)), lv


def skew_cluster_size(KP):
    """CTAs in a cluster of the tensor-core K1s kernel for ``KP`` centre
    columns (``csrc/assign_skew_wgmma.cu``): 256 columns each, the power of
    two at or above ``KP / 256``, at most 8 — more columns run in passes of
    8 CTAs."""
    n = -(-KP // 256)
    return min(8, 1 << (n - 1).bit_length())


def clustered_assign_plain(lv, inv_norm, centers, threshold):
    """Plain twin of the tensor-core K1s kernel's partition
    (``csrc/assign_skew_wgmma.cu``) on ``lv (rows, SP)``, ``centers (SP,
    KP)``, bf16 operands: per tile of 64 rows, clusters of
    :func:`skew_cluster_size` CTAs of 256 columns each (a CTA past ``KP``
    sees zero centres, masked), each CTA's max of ``sims · inv_norm`` and
    its first arg-max, the CTAs merged in rank (column) order with a strict
    ``>``, passes of at most 8 CTAs with the running (value, index) carried
    (a later pass wins only with a strictly larger value), then the
    threshold.  Returns (labels int32, confs)."""
    rows, _ = lv.shape
    KP = centers.shape[1]
    nc = skew_cluster_size(KP)
    a = _round_bf16(lv)
    c = _round_bf16(centers)
    dev = lv.device
    labels = torch.empty(rows, dtype=torch.int32, device=dev)
    confs = torch.empty(rows, device=dev)
    for r0 in range(0, rows, 64):
        r1 = min(rows, r0 + 64)
        run_v = run_i = None
        for base in range(0, KP, 256 * nc):
            best = idx = None
            for rank in range(nc):
                c0 = base + 256 * rank
                c1 = min(KP, c0 + 256)
                if c0 >= KP:          # zero centres, every column masked
                    v = torch.full((r1 - r0,), -float("inf"), device=dev)
                    i = torch.full((r1 - r0,), c0, dtype=torch.int64,
                                   device=dev)
                else:
                    s = (a[r0:r1] @ c[:, c0:c1]) * inv_norm[r0:r1, None]
                    v, i = s.max(1)
                    i = i + c0
                if best is None:
                    best, idx = v, i
                else:
                    take = v > best
                    best = torch.where(take, v, best)
                    idx = torch.where(take, i, idx)
            if run_v is not None:
                keep = ~(best > run_v)
                best = torch.where(keep, run_v, best)
                idx = torch.where(keep, run_i, idx)
            run_v, run_i = best, idx
        confs[r0:r1] = run_v
        labels[r0:r1] = torch.where(run_v >= threshold, run_i, -1).to(
            torch.int32)
    return labels, confs
