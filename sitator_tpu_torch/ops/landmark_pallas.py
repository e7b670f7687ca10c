"""Per-vertex gather landmark kernel (counterpart of
``sitator_tpu.ops.landmark_pallas``).

For every (ion, site) pair and each vertex slot ``v`` of the site: the
minimum-image displacement to that vertex, ``x = k (d − d0)`` (or the d²
form), then ``q *= 1 + e^{max(x, −80)}`` — the product of logistics in
linear space, ``lv = 1 / q`` — so a far site overflows ``q`` to +inf and
gets the same exact 0 the log-space route reaches by underflow.  Row ``V``
of the mask kills padding sites.  Then the cosine assignment tail shared
with K1.

:func:`fused_assign_blocks` (K3, replaces
``sitator_tpu/ops/landmark_pallas.py::_kernel``) launches the CUDA kernels
on CUDA tensors (``csrc/lv_gather.cu``, then the tensor-core tail) and runs
the plain PyTorch version on CPU tensors.  It serves bases without vertex
sharing, and it is the exactness arbiter the unique-atom kernel is held
against.  :func:`_gather_route_plain` is the plain twin of the card's
partition (lane-strided norm, blocked arg-max).
"""
from __future__ import annotations

from collections import Counter

import torch

from sitator_tpu_torch.ops.kernel_common import (as_f32,
                                                 blocked_assign_plain,
                                                 cell_array, kernel_cell,
                                                 load_cell_params,
                                                 min_image_xyz,
                                                 pack_cell_params,
                                                 round_up as _round_up,
                                                 row_prep_plain,
                                                 supports_cell,
                                                 tiled_assign_plain)
from sitator_tpu_torch.util.timing import stage_mark

__all__ = ["fused_assign_blocks", "prepare_vertex_planes", "supports_cell",
           "kernel_cell"]


def prepare_vertex_planes(static, verts, vmask):
    """Per-site vertex coordinate planes: ``static (B, N, 3)``, ``verts (S,
    V)`` indices into it, ``vmask (S, V)`` → ``vp (B, 3, V, S)`` float32 and
    ``mask (V, S)`` float32."""
    vp = static[:, torch.as_tensor(verts, device=static.device).long()]
    vp = vp.permute(0, 3, 2, 1)                             # (B, 3, V, S)
    mask = torch.as_tensor(vmask, device=static.device).float().T
    return vp, mask


def _gather_tile_plain(mob, vp_t, mask_t, cell, midpoint, steepness, *,
                       r2_cutoff, triclinic, full_mask):
    """One tile's landmark vectors ``(Bc, MP, S_t)`` — the plain version of
    the gather kernel's per-vertex product.  ``vp_t (Bc, 3, V, S_t)``,
    ``mask_t (V + 1, S_t)``."""
    V = vp_t.shape[2]
    mx, my, mz = (mob[:, i, :, None] for i in range(3))       # (Bc, MP, 1)
    q = torch.ones((mob.shape[0], mob.shape[2], vp_t.shape[3]),
                   device=mob.device)
    for v in range(V):
        dx, dy, dz = min_image_xyz(mx - vp_t[:, 0, None, v],
                                   my - vp_t[:, 1, None, v],
                                   mz - vp_t[:, 2, None, v], cell, triclinic)
        d2 = dx * dx + dy * dy + dz * dz
        if r2_cutoff:
            k2 = steepness / (2.0 * midpoint)
            x = k2 * d2 - k2 * (midpoint * midpoint)
        else:
            x = steepness * (torch.sqrt(d2) - midpoint)
        e = torch.exp(torch.clamp_min(x, -80.0))
        if full_mask:
            q = q + q * e
        else:
            q = q * torch.where(mask_t[v] > 0.0, 1.0 + e, 1.0)
    lv = 1.0 / q
    return torch.where(mask_t[V] > 0.0, 0.0, lv)


def _gather_assign_plain(mob, vp, mask, cpad, params, *, s_tile, triclinic,
                         r2_cutoff, peak_clip, full_mask, mxu_bf16):
    """Plain version of K3: labels/confs ``(B, MP)``, site tile by tile."""
    B, _, MP = mob.shape
    SP = vp.shape[3]
    cell, mid, steep, thr = load_cell_params(params.to(mob.device),
                                             triclinic)

    def tile_lv(lo, hi, t):
        sl = slice(t * s_tile, (t + 1) * s_tile)
        return _gather_tile_plain(mob[lo:hi], vp[lo:hi, :, :, sl],
                                  mask[:, sl], cell, mid, steep,
                                  r2_cutoff=r2_cutoff, triclinic=triclinic,
                                  full_mask=full_mask)

    return tiled_assign_plain(tile_lv, B, MP, SP // s_tile, s_tile, cpad,
                              thr, frame_chunk=max(1, (1 << 24) // (
                                  MP * s_tile)),
                              peak_clip=peak_clip, mxu_bf16=mxu_bf16)


def _gather_assign_cuda(mob, vp, mask, cpad, params, *, s_tile, triclinic,
                        r2_cutoff, peak_clip, full_mask, mxu_bf16):
    """K3 on the card.  ``lv_gather`` (one warp a group of 8 ion rows,
    sweeping every site: each vertex loaded once per column for the 8 ions)
    computes the block's landmark vectors.  With bf16 similarity operands
    and no clip (the default) it forms each row's norm itself in
    ``row_prep``'s order and writes only the bf16 copy and ``inv_norm``, and
    the tensor-core product (``sims_wgmma``) and the merge follow: the f32
    lv never reaches device memory and ``row_prep`` is not launched.  With
    the clip or f32 operands it writes the f32 lv and K1's whole tail runs
    (``assign_tail``: the clip needs each row's second-largest value before
    the norm).  ``s_tile`` only sets the site padding here: one launch
    covers every site.  The landmark stage ends with ``lv_gather`` on the
    bf16 route, with ``row_prep`` on the other (``util.timing.
    stage_mark``)."""
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = mob.shape
    kw = dict(triclinic=triclinic, r2_cutoff=r2_cutoff, full_mask=full_mask)
    thr = float(params[-1])
    if mxu_bf16 and not peak_clip:
        lvb, inv_norm = _cuda.lv_gather(mob, vp, mask, params, bf16=True,
                                        **kw)
        stage_mark()
        labels, confs = _cuda.argmax_merge(
            *_cuda.sims_argmax(lvb, inv_norm, cpad), thr)
    else:
        lv = _cuda.lv_gather(mob, vp, mask, params, bf16=False, **kw)
        labels, confs = _cuda.assign_tail(lv, cpad, thr, peak_clip=peak_clip,
                                          mxu_bf16=mxu_bf16)
    return labels.view(B, MP), confs.view(B, MP)


def _gather_lv_rows_plain(mob, vp, mask, params, *, triclinic, r2_cutoff,
                          full_mask):
    """The f32 landmark vectors ``(B * MP, SP)`` of every (ion, site) pair:
    the plain version of ``lv_gather``'s f32 output."""
    B, _, MP = mob.shape
    cell, mid, steep, _ = load_cell_params(params.to(mob.device), triclinic)
    return _gather_tile_plain(mob, vp, mask, cell, mid, steep,
                              r2_cutoff=r2_cutoff, triclinic=triclinic,
                              full_mask=full_mask).reshape(B * MP, -1)


def _gather_route_plain(mob, vp, mask, cpad, params, *, s_tile, triclinic,
                        r2_cutoff, peak_clip, full_mask, mxu_bf16):
    """Plain twin of K3's partition on the card: the f32 lv rows, the
    norm in the kernels' lane-strided order (``row_prep_plain``: what
    ``row_prep`` computes on the f32 route and what ``lv_gather`` forms
    itself on the bf16 route), then the tail's blocks and merge
    (``blocked_assign_plain``).  Returns ``(labels, confs, inv_norm,
    rows)``; ``rows`` are the (clipped) f32 rows the product reads, rounded
    to bf16 by it when ``mxu_bf16``."""
    B, _, MP = mob.shape
    lv = _gather_lv_rows_plain(mob, vp, mask, params, triclinic=triclinic,
                               r2_cutoff=r2_cutoff, full_mask=full_mask)
    inv_norm, rows = row_prep_plain(lv, peak_clip=peak_clip)
    labels, confs = blocked_assign_plain(rows, inv_norm, cpad,
                                         float(params[-1]),
                                         mxu_bf16=mxu_bf16)
    return labels.view(B, MP), confs.view(B, MP), inv_norm, rows


def _gather_inputs(mobile, static, verts, vmask, cell, centers, *,
                   midpoint, steepness, threshold, s_tile=512,
                   mxu_bf16=True, cutoff_shape="logistic",
                   peak_evening="none", full_mask=False):
    """Keyword arguments of :func:`_gather_assign_cuda` /
    :func:`_gather_assign_plain`: ion planes padded to ``MP``, vertex
    planes and mask padded to ``SP`` (mask row ``V`` marks padding sites),
    the centres as ``(SP, KP)`` zero-padded columns, the packed params."""
    if peak_evening not in ("none", "clip"):
        raise ValueError(f"unknown peak_evening mode {peak_evening!r}")
    if mobile.ndim != 3 or static.ndim != 3 \
            or mobile.shape[0] != static.shape[0]:
        raise ValueError("mobile (B, M, 3) and static (B, N, 3) expected")
    if mobile.dtype != torch.float32 or static.dtype != torch.float32:
        raise TypeError("mobile and static must be float32")
    dev = mobile.device
    B, M, _ = mobile.shape
    S, V = verts.shape
    centers = as_f32(centers, dev)
    K = centers.shape[0]
    MP = _round_up(M, 128)
    SP = _round_up(S, s_tile)
    KP = _round_up(K, 128)

    mob = mobile.transpose(1, 2)
    mob = torch.cat([mob, mob[:, :, -1:].expand(B, 3, MP - M)],
                    dim=2).contiguous()
    vp, mask = prepare_vertex_planes(static, verts, vmask)
    vp = torch.nn.functional.pad(vp, (0, SP - S)).contiguous()
    pad_kill = torch.zeros((1, SP), device=dev)
    pad_kill[0, S:] = 1.0
    mask = torch.cat([torch.nn.functional.pad(mask, (0, SP - S)),
                      pad_kill]).contiguous()
    cpad = torch.zeros((SP, KP), device=dev)
    cpad[:S, :K] = centers.T
    params, triclinic = pack_cell_params(
        cell_array(cell), [midpoint, steepness, threshold])
    return dict(mob=mob, vp=vp, mask=mask, cpad=cpad, params=params,
                s_tile=s_tile, triclinic=triclinic,
                r2_cutoff=cutoff_shape == "logistic_r2",
                peak_clip=peak_evening == "clip", full_mask=full_mask,
                mxu_bf16=mxu_bf16)


def fused_assign_blocks(mobile, static, verts, vmask, cell, centers,
                        *, midpoint, steepness, threshold, s_tile=512,
                        mxu_bf16=True, cutoff_shape="logistic",
                        peak_evening="none", full_mask=False):
    """Fused landmark + normalise + assign for a block of frames (K3).

    ``mobile (B, M, 3)`` / ``static (B, N, 3)`` float32, ``verts (S, V)``,
    ``vmask (S, V)``, ``cell`` (3,) orthorhombic lengths or (3, 3)
    triclinic (:func:`kernel_cell`), ``centers (K, S)`` unit rows.
    ``peak_evening='clip'`` caps every row at its second-largest value
    first; ``full_mask=True`` (every vertex slot valid) drops the per-vertex
    mask select.  Returns (labels (B, M) int32 with −1 below threshold,
    confs (B, M)).  On CUDA tensors this launches the kernel on their card
    (counted in ``.launches`` and, by the card's index, in
    ``.launches_by_card``); on CPU tensors it runs the plain version.
    """
    args = _gather_inputs(mobile, static, verts, vmask, cell, centers,
                          midpoint=midpoint, steepness=steepness,
                          threshold=threshold, s_tile=s_tile,
                          mxu_bf16=mxu_bf16, cutoff_shape=cutoff_shape,
                          peak_evening=peak_evening, full_mask=full_mask)
    M = mobile.shape[1]
    if mobile.is_cuda:
        with torch.cuda.device(mobile.device):
            labels, confs = _gather_assign_cuda(**args)
        fused_assign_blocks.launches += 1
        fused_assign_blocks.launches_by_card[mobile.device.index] += 1
    else:
        labels, confs = _gather_assign_plain(**args)
    return labels[:, :M], confs[:, :M]


fused_assign_blocks.launches = 0
fused_assign_blocks.launches_by_card = Counter()
