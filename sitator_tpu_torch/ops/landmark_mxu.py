"""Unique-atom landmark kernels (counterpart of
``sitator_tpu.ops.landmark_mxu``).

Neighbouring landmark polyhedra share static atoms, so a spatially compact
tile of sites touches far fewer unique atoms than it has vertex slots.  Per
(frame, kd site tile):

1. distance core on the tile's unique atoms only:
   ``logc[m, u] = −softplus(k (d(m, u) − d0))`` (or the d² form);
2. the product over each site's vertices as a matmul in log space against
   the tile-local membership matrix ``loglv = logc @ A_t`` (f32);
3. ``lv = exp(loglv)``, padded site columns killed.

The host part (kd ordering, per-tile unique atoms, the preshift bound, the
tile-size cost model) is a NumPy copy of the reference's, array for array;
its ``{128, 256}`` tile candidates and ×128 padding are kept so both
packages build the same basis.

Two device entry points, each a hand-written CUDA kernel on CUDA tensors
and its plain PyTorch version on CPU tensors:

- :func:`mxu_assign_blocks` (K1, replaces
  ``sitator_tpu/ops/landmark_mxu.py::_kernel``) — lv tiles, then cosine
  assignment to the centres; with ``skew=True`` K1s (replaces
  ``::_kernel_skew``), the same function in one kernel that keeps the lv
  on chip: with bf16 operands a thread-block cluster whose CTAs split the
  centre columns and share the lv tile (``csrc/assign_skew_wgmma.cu``, the
  product on the tensor cores in K1's k-step order), with f32 operands
  the FMA kernel (``csrc/assign_skew.cu``);
- :func:`mxu_landmark_blocks` (K2, replaces ``::_lv_kernel``) — the lv
  matrix itself, in the caller's site order.
"""
from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import torch

from sitator_tpu_torch.ops.kernel_common import (as_f32, cell_array,
                                                 load_cell_params,
                                                 min_image_xyz,
                                                 pack_cell_params,
                                                 round_up as _round_up,
                                                 softplus,
                                                 tiled_assign_plain)

logger = logging.getLogger(__name__)

# the largest cost ratio (unique-atom work over gather work) that takes K1
MAX_COST_RATIO = 0.75

__all__ = ["prepare_mxu_basis", "prepare_engine_basis", "choose_s_tile",
           "mxu_assign_blocks", "mxu_supported", "permute_centers",
           "mxu_landmark_blocks", "basis_from_jax", "membership_lists"]


def _kd_order(frac, s_tile):
    """Balanced kd-split site ordering: recursively split the site set along
    its widest fractional axis at exact ``s_tile`` multiples, so every
    consecutive ``s_tile`` slice of the permutation is a compact box."""
    S = len(frac)
    n_tiles = -(-S // s_tile)
    out = []

    def rec(ids, k):
        if k == 1:
            out.append(ids)
            return
        f = frac[ids]
        ax = int(np.argmax(f.max(axis=0) - f.min(axis=0)))
        k1 = k // 2
        n_left = min(k1 * s_tile, len(ids))
        o = ids[np.argsort(f[:, ax], kind="stable")]
        rec(o[:n_left], k1)
        rec(o[n_left:], k - k1)

    rec(np.arange(S), n_tiles)
    return np.concatenate(out)


def _tile_geometry(verts, vmask, site_pos, cell, s_tile, static_ref=None):
    """kd-tiling analysis shared by :func:`choose_s_tile` and
    :func:`prepare_mxu_basis`: the site ordering, per-tile unique-atom lists
    and padded sizes; given ``static_ref``, also the anchor-unwrapped
    per-tile reference geometry the preshift bound needs."""
    verts = np.asarray(verts)
    vmask = np.asarray(vmask).astype(bool)
    site_pos = np.asarray(site_pos, np.float64)
    cell = np.asarray(cell, np.float64)
    S, V = verts.shape
    inv = np.linalg.inv(cell)
    frac = (site_pos @ inv) % 1.0
    order = _kd_order(frac, s_tile)
    verts_s = verts[order]
    vmask_s = vmask[order]
    SP = _round_up(S, s_tile)
    n_st = SP // s_tile
    uniq = []
    for t in range(n_st):
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        if lo >= S:
            uniq.append(np.zeros(0, np.int64))
            continue
        uniq.append(np.unique(verts_s[lo:hi][vmask_s[lo:hi]]))
    UP = _round_up(max(max((len(u) for u in uniq), default=1), 1), 128)
    g = dict(order=order, verts_s=verts_s, vmask_s=vmask_s, uniq=uniq,
             S=S, V=V, SP=SP, n_st=n_st, UP=UP)
    if static_ref is None:
        return g
    static_ref = np.asarray(static_ref, np.float64)
    site_frac = site_pos @ inv                   # NOT wrapped
    ref_frac = static_ref @ inv
    ref_u = np.zeros((n_st, UP, 3), np.float64)
    anchors = np.zeros((n_st, 3), np.float64)
    rfrac = np.zeros(3)
    for t in range(n_st):
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        u = uniq[t]
        if lo >= S or len(u) == 0:
            continue
        # anchor: fractional centroid of the tile's sites, each unwrapped
        # to the first site's image
        sf = site_frac[order[lo:hi]]
        sf = sf - np.round(sf - sf[0])
        anchor_f = sf.mean(axis=0)
        af = ref_frac[u]
        af = af - np.round(af - anchor_f)        # unwrap atoms to anchor
        rfrac = np.maximum(rfrac, np.abs(af - anchor_f).max(axis=0))
        ref_u[t, :len(u)] = af @ cell
        # padded slots replay atom 0's coords; A never references them
        ref_u[t, len(u):] = ref_u[t, 0]
        anchors[t] = anchor_f @ cell
    g.update(ref_u=ref_u, anchors=anchors, rfrac=rfrac)
    return g


def _preshift_log_bound(rfrac, cell, midpoint, steepness, cutoff_shape,
                        vibration_margin):
    """log-cutoff value at the nearest distance any wrong-image pair can
    have under this tiling; the preshift route is exact when it is ≤ −75."""
    cell = np.asarray(cell, np.float64)
    w = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
    half_gap = 0.5 - rfrac - vibration_margin / w
    if not (half_gap > 0.0).all():
        return 0.0
    d_far = float(np.min(half_gap * w))
    if cutoff_shape == "logistic_r2":
        k2 = steepness / (2.0 * midpoint)
        return -(k2 * (d_far * d_far - midpoint * midpoint))
    return -(steepness * (d_far - midpoint))


def choose_s_tile(verts, vmask, site_pos, cell,
                  candidates=(128, 256), vpu_weight=25.0,
                  static_ref=None, midpoint=None, steepness=None,
                  cutoff_shape="logistic", vibration_margin=3.0):
    """Per-basis tile size by the reference's host-side cost model:

        cost = vpu_weight · 12 · (UP · n_st) + 2 · UP · SP + 2 · SP · S

    Candidates that keep the preshift bound (when its inputs are given)
    beat every candidate that loses it.  The candidates and weights are the
    reference's, so both packages pick the same tile; retuning them for
    this card is later work."""
    check_ps = (static_ref is not None and midpoint is not None
                and steepness is not None)
    best = None
    for st in candidates:
        g = _tile_geometry(verts, vmask, site_pos, cell, st,
                           static_ref if check_ps else None)
        cost = (vpu_weight * 12.0 * g["UP"] * g["n_st"]
                + 2.0 * g["UP"] * g["SP"] + 2.0 * g["SP"] * g["S"])
        loses_preshift = check_ps and _preshift_log_bound(
            g["rfrac"], cell, midpoint, steepness, cutoff_shape,
            vibration_margin) > -75.0
        key = (loses_preshift, cost)
        if best is None or key < best[0]:
            best = (key, st)
    return best[1]


def prepare_mxu_basis(verts, vmask, site_pos, cell, *, s_tile=256,
                      static_ref=None, midpoint=None,
                      steepness=None, cutoff_shape="logistic",
                      vibration_margin=3.0):
    """Host-side, once per landmark basis.  Returns a dict of CPU tensors
    (move it with :func:`basis_from_jax`):

    - ``uidx (n_st, UP)`` int32: per-tile unique static-atom indices;
    - ``A (n_st, UP, s_tile)``: tile-local vertex multiplicities;
    - ``kill (1, SP)``: 1.0 on padded site columns;
    - ``site_order (S,)`` (NumPy) and ``inv_order (S,)`` int32;
    - ``ref_u (n_st, UP, 3)`` / ``anchors (n_st, 3)`` when the tile-preshift
      route is exact (one minimum image per (ion, tile) instead of per
      pair: a pair the single shift gets wrong is so far that its factor
      underflows to ≤ 2.7e−33 either way);

    plus ``s_tile``, ``n_st``, ``UP``, ``cost_ratio`` and ``preshift``.
    """
    have_ref = (static_ref is not None and midpoint is not None
                and steepness is not None)
    g = _tile_geometry(verts, vmask, site_pos, cell, s_tile,
                       static_ref if have_ref else None)
    S, V = g["S"], g["V"]
    SP, n_st, UP = g["SP"], g["n_st"], g["UP"]
    order, uniq = g["order"], g["uniq"]
    verts_s, vmask_s = g["verts_s"], g["vmask_s"]

    uidx = np.zeros((n_st, UP), np.int32)
    A = np.zeros((n_st, UP, s_tile), np.float32)
    for t in range(n_st):
        u = uniq[t]
        if len(u) == 0:
            continue
        uidx[t, :len(u)] = u
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        vs = verts_s[lo:hi]
        vm = vmask_s[lo:hi]
        row = np.searchsorted(u, vs)            # (st_real, V)
        cols = np.broadcast_to(np.arange(hi - lo)[:, None], vs.shape)
        np.add.at(A, (t, row[vm], cols[vm]), 1.0)
    kill = np.zeros((1, SP), np.float32)
    kill[0, S:] = 1.0

    basis = dict(
        uidx=torch.from_numpy(uidx),
        A=torch.from_numpy(A),
        kill=torch.from_numpy(kill),
        site_order=order,
        inv_order=torch.from_numpy(np.argsort(order).astype(np.int32)),
        s_tile=int(s_tile),
        n_st=int(n_st),
        UP=int(UP),
        cost_ratio=float(n_st * UP) / float(max(S * V, 1)),
        preshift=False,
    )
    if not have_ref:
        return basis
    if _preshift_log_bound(g["rfrac"], cell, midpoint, steepness,
                           cutoff_shape, vibration_margin) <= -75.0:
        basis["preshift"] = True
        basis["ref_u"] = torch.from_numpy(g["ref_u"].astype(np.float32))
        basis["anchors"] = torch.from_numpy(g["anchors"].astype(np.float32))
    return basis


def prepare_engine_basis(verts, vmask, site_pos, cell, *, midpoint,
                         steepness, cutoff_shape, static_ref=None,
                         drift_budget=None, s_tile="auto"):
    """The fused-route gate shared by the engines: the kd basis with the
    preshift drift budget tied to the caller's drift guard
    (``vibration_margin = max(3, 2·budget)``; ``drift_budget=None``
    disables preshift), or None when the basis shares too few vertices
    for the unique-atom route (:func:`mxu_supported`)."""
    return _engine_gate(verts, vmask, site_pos, cell, midpoint=midpoint,
                        steepness=steepness, cutoff_shape=cutoff_shape,
                        static_ref=static_ref, drift_budget=drift_budget,
                        s_tile=s_tile)[0]


def _engine_gate(verts, vmask, site_pos, cell, *, midpoint, steepness,
                 cutoff_shape, static_ref=None, drift_budget=None,
                 s_tile="auto"):
    """:func:`prepare_engine_basis`'s basis (or None) and the gate's
    decision, taken or refused: ``route`` ('mxu' for K1, 'gather' for
    K3), ``cost_ratio`` and the most K1 takes (``max_cost_ratio``),
    ``s_tile``, ``UP``, ``n_sites`` and ``vertex_slots``."""
    vib = (max(3.0, 2.0 * float(drift_budget))
           if drift_budget is not None else 3.0)
    if s_tile == "auto":
        s_tile = choose_s_tile(
            verts, vmask, site_pos, cell,
            static_ref=static_ref if drift_budget is not None else None,
            midpoint=midpoint, steepness=steepness,
            cutoff_shape=cutoff_shape, vibration_margin=vib)
    basis = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=s_tile,
        static_ref=static_ref if drift_budget is not None else None,
        midpoint=midpoint, steepness=steepness, cutoff_shape=cutoff_shape,
        vibration_margin=vib)
    ok = mxu_supported(basis)
    S, V = np.shape(verts)
    gate = dict(route="mxu" if ok else "gather",
                cost_ratio=basis["cost_ratio"],
                max_cost_ratio=MAX_COST_RATIO, s_tile=basis["s_tile"],
                UP=basis["UP"], n_sites=int(S), vertex_slots=int(V))
    logger.debug(
        "fused-route gate: mxu=%s (cost_ratio %.3f), preshift=%s "
        "(drift budget %s)", ok, basis["cost_ratio"],
        basis["preshift"] if ok else "-", drift_budget)
    return (basis if ok else None), gate


def mxu_supported(basis, max_cost_ratio=MAX_COST_RATIO) -> bool:
    """True when the unique-atom formulation does less elementwise work than
    the gather kernel (vertex sharing is high enough)."""
    return basis["cost_ratio"] <= max_cost_ratio


def permute_centers(centers, basis):
    """Permute cluster-centre COLUMNS into the basis's kd-tile site order
    (labels index centre ROWS and need no remapping)."""
    return np.asarray(centers)[:, basis["site_order"]]


_BASIS_ARRAYS = ("uidx", "A", "kill", "inv_order", "ref_u", "anchors")


def basis_from_jax(basis, device):
    """A basis dict with its arrays as tensors on ``device``: takes the
    reference's (JAX arrays) or this module's own (CPU tensors).  Each
    array goes through ``np.asarray``; the static fields are copied."""
    out = {}
    for k, v in basis.items():
        if k in _BASIS_ARRAYS and v is not None:
            out[k] = torch.tensor(np.asarray(v), device=device)
        elif k == "site_order" and v is not None:
            out[k] = np.asarray(v)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# device part
# --------------------------------------------------------------------------

def membership_lists(A):
    """The sparse form of the membership matrices ``A (n_st, UP, s_tile)``
    that the ``lv_tile`` kernel sums over: for every site column, the
    tile-local unique-atom rows with a nonzero multiplicity in ascending
    order, padded with -1, and those multiplicities (0 on padding).  Returns
    ``(idx int32, mult float32)``, both ``(n_st, s_tile, vmax)`` on ``A``'s
    device; ``vmax`` is the largest nonzero count of any column (at least
    1).  Derived from ``A`` alone, so a basis from either package works."""
    n_st, UP, s_tile = A.shape
    nz = A != 0
    vmax = max(1, int(nz.sum(1).max())) if A.numel() else 1
    k = torch.arange(UP, device=A.device, dtype=torch.int32)[None, :, None]
    key = torch.where(nz, k, UP).sort(dim=1).values[:, :vmax]
    valid = key < UP
    idx = torch.where(valid, key, -1)
    mult = torch.where(valid, A.gather(1, key.clamp_max(UP - 1).long()), 0.0)
    return (idx.transpose(1, 2).contiguous(),
            mult.float().transpose(1, 2).contiguous())


def _members(basis, A):
    """:func:`membership_lists` of the basis on ``A``'s device, made once
    per basis and device and kept in the basis dict (key ``members``, a
    dict by device: the shards of a frame mesh on several cards each read
    their own)."""
    by_dev = basis.setdefault("members", {})
    cached = by_dev.get(A.device)
    if cached is None:
        lists = membership_lists(A)
        made = (torch.cuda.current_stream(A.device).record_event()
                if A.is_cuda else None)
        cached = by_dev[A.device] = (lists, made)
    lists, made = cached
    if made is not None:
        # the shards of a frame mesh read the lists from streams of their
        # own: each waits for the stream that wrote them (no host wait)
        torch.cuda.current_stream(A.device).wait_event(made)
    return lists


def _cell_on(basis, cell, device):
    """The float32 NumPy ``cell`` as the (3, 3) matrix and its inverse on
    ``device``, made once per basis, cell and device and kept in the basis
    dict (key ``cell_dev``).  The per-block path must not make them: a
    host→device copy from pageable memory waits for the stream, and
    ``torch.linalg.inv`` reads its error flag back on the host."""
    by_dev = basis.setdefault("cell_dev", {})
    key = (str(device), cell.tobytes())
    cached = by_dev.get(key)
    if cached is None:
        cm = torch.from_numpy(cell).to(device)
        if cm.ndim == 1:
            cm = torch.diag(cm)
        cached = by_dev[key] = (cm, torch.linalg.inv(cm))
    return cached


def _basis_tensors(basis, device):
    """(uidx, A, kill, ref_u, anchors) on ``device``; zeros stand in for the
    preshift geometry on the per-pair route."""
    n_st, UP = basis["n_st"], basis["UP"]
    preshift = bool(basis.get("preshift", False))
    uidx = torch.as_tensor(basis["uidx"], device=device)
    A = torch.as_tensor(basis["A"], device=device, dtype=torch.float32)
    kill = torch.as_tensor(basis["kill"], device=device,
                           dtype=torch.float32).reshape(-1)
    if preshift:
        ref_u = torch.as_tensor(basis["ref_u"], device=device,
                                dtype=torch.float32)
        anchors = torch.as_tensor(basis["anchors"], device=device,
                                  dtype=torch.float32)
    else:
        ref_u = torch.zeros((n_st, UP, 3), device=device)
        anchors = torch.zeros((n_st, 3), device=device)
    return uidx, A.contiguous(), kill.contiguous(), ref_u, \
        anchors.contiguous()


def _prep_mob_vpu(mobile, static, uidx, ref_u, cell, n_st, UP, MP,
                  preshift):
    """Input prep shared by both entry points: ion coordinate planes padded
    to ``MP`` (repeating the last ion), and each tile's unique-atom
    coordinate planes — re-unwrapped to the reference image when
    preshifting (``cell`` is the (matrix, inverse) pair of
    :func:`_cell_on`).  Returns ``mob (B, 3, MP)``, ``vpu (B, n_st, 3,
    UP)``."""
    B, M, _ = mobile.shape
    mob = mobile.transpose(1, 2)
    mob = torch.cat([mob, mob[:, :, -1:].expand(B, 3, MP - M)], dim=2)
    vpu = static[:, uidx.reshape(-1).long()].reshape(B, n_st, UP, 3)
    if preshift:
        cm, cm_inv = cell
        f = (vpu - ref_u[None]) @ cm_inv
        vpu = ref_u[None] + (f - torch.round(f)) @ cm
    return mob.contiguous(), vpu.transpose(2, 3).contiguous()


def _tile_lv_plain(mob, vpu_t, A_t, kill_t, anchor_t, cell, midpoint,
                   steepness, *, r2_cutoff, triclinic, preshift):
    """One tile's landmark vectors ``(Bc, MP, S_t)``: the plain version of
    the kernels' distance core, log-cutoff, membership matmul and pad-kill.
    ``mob (Bc, 3, MP)``, ``vpu_t (Bc, 3, UP)``, ``A_t (UP, S_t)``."""
    mx, my, mz = (mob[:, i, :, None] for i in range(3))       # (Bc, MP, 1)
    ux, uy, uz = (vpu_t[:, i, None, :] for i in range(3))     # (Bc, 1, UP)
    if preshift:
        ax, ay, az = anchor_t.unbind(0)
        sx, sy, sz = min_image_xyz(mx - ax, my - ay, mz - az, cell,
                                   triclinic)
        dx, dy, dz = (ax + sx) - ux, (ay + sy) - uy, (az + sz) - uz
    else:
        dx, dy, dz = min_image_xyz(mx - ux, my - uy, mz - uz, cell,
                                   triclinic)
    d2 = dx * dx + dy * dy + dz * dz
    if r2_cutoff:
        k2 = steepness / (2.0 * midpoint)
        logc = -softplus(k2 * d2 - k2 * (midpoint * midpoint))
    else:
        logc = -softplus(steepness * (torch.sqrt(d2) - midpoint))
    lv = torch.exp(logc @ A_t)
    return torch.where(kill_t > 0.0, 0.0, lv)


def _frame_chunk(B, per_frame_elems, budget=1 << 24):
    """Frames per chunk so one intermediate stays near ``budget`` elements
    (lets the plain versions run at the bench width on the card)."""
    return max(1, min(B, budget // max(per_frame_elems, 1)))


def _mxu_lv_plain(mob, vpu, A, kill, params, anchors, *, M, inv_order,
                  triclinic, r2_cutoff, preshift, members=None):
    """Plain version of K2: ``(B, M, S)`` landmark vectors in the caller's
    site order, tile by tile (the membership product over the dense ``A``;
    ``members`` is the kernel's input and unused here)."""
    B, _, MP = mob.shape
    n_st, UP, s_tile = A.shape
    S = inv_order.numel()
    cell, mid, steep, _ = load_cell_params(params.to(mob.device), triclinic)
    out = torch.empty((B, MP, n_st * s_tile), device=mob.device)
    bc = _frame_chunk(B, MP * UP)
    for lo in range(0, B, bc):
        for t in range(n_st):
            out[lo:lo + bc, :, t * s_tile:(t + 1) * s_tile] = _tile_lv_plain(
                mob[lo:lo + bc], vpu[lo:lo + bc, t], A[t],
                kill[t * s_tile:(t + 1) * s_tile], anchors[t], cell, mid,
                steep, r2_cutoff=r2_cutoff, triclinic=triclinic,
                preshift=preshift)
    return out[:, :M, :S][:, :, inv_order.long()]


def _mxu_lv_cuda(mob, vpu, A, kill, params, anchors, *, M, inv_order,
                 triclinic, r2_cutoff, preshift, members):
    """K2 on the card: one ``lv_tile`` launch writes every tile straight
    into the caller's site order (no kd-ordered copy), summing over the
    membership lists ``members`` (:func:`membership_lists`)."""
    from sitator_tpu_torch.ops import _cuda
    B = mob.shape[0]
    n_st, _, s_tile = A.shape
    S = inv_order.numel()
    col_map = torch.full((n_st * s_tile,), -1, dtype=torch.int32,
                         device=mob.device)
    col_map[inv_order.long()] = torch.arange(S, dtype=torch.int32,
                                             device=mob.device)
    out = torch.empty((B, M, S), device=mob.device)
    _cuda.lv_tile(mob, vpu, *members, kill, anchors, col_map, out, params,
                  triclinic=triclinic, r2_cutoff=r2_cutoff,
                  preshift=preshift)
    return out


def _mxu_assign_plain(mob, vpu, A, kill, cpad, params, anchors, *,
                      triclinic, r2_cutoff, peak_clip, preshift, mxu_bf16,
                      members=None):
    """Plain version of K1, and of K1s (which computes the same function,
    only with its tiles overlapped): labels/confs ``(B, MP)``, tile by
    tile (``members`` is unused, as in :func:`_mxu_lv_plain`)."""
    B, _, MP = mob.shape
    n_st, UP, s_tile = A.shape
    cell, mid, steep, thr = load_cell_params(params.to(mob.device),
                                             triclinic)

    def tile_lv(lo, hi, t):
        return _tile_lv_plain(
            mob[lo:hi], vpu[lo:hi, t], A[t],
            kill[t * s_tile:(t + 1) * s_tile], anchors[t], cell, mid, steep,
            r2_cutoff=r2_cutoff, triclinic=triclinic, preshift=preshift)

    return tiled_assign_plain(tile_lv, B, MP, n_st, s_tile, cpad, thr,
                              frame_chunk=_frame_chunk(B, MP * UP),
                              peak_clip=peak_clip, mxu_bf16=mxu_bf16)


def _mxu_assign_cuda(mob, vpu, A, kill, cpad, params, anchors, *,
                     triclinic, r2_cutoff, peak_clip, preshift, mxu_bf16,
                     members):
    """K1 on the card: ``lv_tile`` writes the block's lv tiles in kd order to
    scratch (summing over the membership lists), then ``assign_tail`` clips
    (optionally), normalises, multiplies by the centres (on the tensor cores
    with bf16 operands) and takes the arg-max.  Keeping lv on chip, as the
    TPU kernel does in VMEM, is later work."""
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = mob.shape
    n_st, _, s_tile = A.shape
    SP = n_st * s_tile
    lv = torch.empty((B, MP, SP), device=mob.device)
    col_map = torch.arange(SP, dtype=torch.int32, device=mob.device)
    _cuda.lv_tile(mob, vpu, *members, kill, anchors, col_map, lv, params,
                  triclinic=triclinic, r2_cutoff=r2_cutoff,
                  preshift=preshift)
    labels, confs = _cuda.assign_tail(
        lv.view(B * MP, SP), cpad, float(params[-1]), peak_clip=peak_clip,
        mxu_bf16=mxu_bf16)
    return labels.view(B, MP), confs.view(B, MP)


def _mxu_assign_skew_cuda(mob, vpu, A, kill, cpad, params, anchors, *,
                          triclinic, r2_cutoff, peak_clip, preshift,
                          mxu_bf16, members):
    """K1s on the card, the lv kept on chip.  With bf16 similarity operands
    (the default) one ``assign_skew_wgmma`` call (a cluster launch per 2048
    centre columns): a thread-block cluster per 64-row tile whose CTAs each own
    256 centre columns, share the tile's lv through distributed shared
    memory (each CTA computes 64 / cluster-size of its rows, summing over
    the membership lists ``members``) and run the product on the tensor
    cores against the centres' K-major bf16 copy.  With f32 operands the
    FMA kernel ``assign_skew``: the centres in chunks of up to 1024 columns
    (a power of two times 128), so they are padded to whole chunks here."""
    if peak_clip:
        raise ValueError(_SKEW_CLIP)
    from sitator_tpu_torch.ops import _cuda
    B, _, MP = mob.shape
    if mxu_bf16:
        labels, confs = _cuda.assign_skew_wgmma(
            mob, vpu, *members, kill, anchors, _cuda.centers_bf16(cpad),
            params, triclinic=triclinic, r2_cutoff=r2_cutoff,
            preshift=preshift)
        return labels.view(B, MP), confs.view(B, MP)
    KP = cpad.shape[1]
    nj = min(8, 1 << (KP // 128 - 1).bit_length())
    ldc = _round_up(KP, 128 * nj)
    centers = torch.nn.functional.pad(cpad, (0, ldc - KP))
    labels, confs = _cuda.assign_skew(
        mob, vpu, A, kill, anchors, centers.contiguous(), params,
        n_valid=KP, nj=nj, triclinic=triclinic, r2_cutoff=r2_cutoff,
        preshift=preshift)
    return labels.view(B, MP), confs.view(B, MP)


_SKEW_CLIP = "skew=True is not implemented for peak_evening='clip'"


def _kernel_inputs(mobile, static, basis, cell, consts):
    """Inputs shared by K1 and K2 and their plain versions: ion and
    unique-atom coordinate planes, the basis tensors, the packed params."""
    if mobile.ndim != 3 or static.ndim != 3 or mobile.shape[-1] != 3 \
            or static.shape[-1] != 3 or mobile.shape[0] != static.shape[0]:
        raise ValueError("mobile (B, M, 3) and static (B, N, 3) expected")
    if mobile.dtype != torch.float32 or static.dtype != torch.float32:
        raise TypeError("mobile and static must be float32")
    if static.device != mobile.device:
        raise ValueError("mobile and static must share a device")
    dev = mobile.device
    n_st, UP = basis["n_st"], basis["UP"]
    preshift = bool(basis.get("preshift", False))
    uidx, A, kill, ref_u, anchors = _basis_tensors(basis, dev)
    cell = cell_array(cell)
    MP = _round_up(mobile.shape[1], 128)
    mob, vpu = _prep_mob_vpu(mobile, static, uidx, ref_u,
                             _cell_on(basis, cell, dev), n_st, UP, MP,
                             preshift)
    params, triclinic = pack_cell_params(cell, consts)
    members = _members(basis, A) if dev.type == "cuda" else None
    return dict(mob=mob, vpu=vpu, A=A, kill=kill, params=params,
                anchors=anchors, triclinic=triclinic, preshift=preshift,
                members=members)


def _lv_inputs(mobile, static, basis, cell, *, midpoint, steepness,
               cutoff_shape="logistic"):
    """Keyword arguments of :func:`_mxu_lv_cuda` / :func:`_mxu_lv_plain`."""
    args = _kernel_inputs(mobile, static, basis, cell,
                          [midpoint, steepness, 0.0])
    inv_order = basis.get("inv_order")
    if inv_order is None:   # hand-built basis dicts
        inv_order = np.argsort(np.asarray(basis["site_order"]))
    if not torch.is_tensor(inv_order):
        inv_order = torch.from_numpy(np.asarray(inv_order))
    return dict(args, M=mobile.shape[1], inv_order=inv_order.to(
        mobile.device), r2_cutoff=cutoff_shape == "logistic_r2")


def _assign_inputs(mobile, static, basis, cell, centers_perm, *, midpoint,
                   steepness, threshold, mxu_bf16=True,
                   cutoff_shape="logistic", peak_evening="none",
                   skew=False):
    """Keyword arguments of :func:`_mxu_assign_cuda`,
    :func:`_mxu_assign_skew_cuda` and :func:`_mxu_assign_plain`, with the
    centres transposed and zero-padded to ``(SP, KP)`` in f32 (``cpad``).
    ``skew=True`` with ``peak_evening='clip'`` raises: K1s has no two-pass
    (clip) form, and quietly running K1 instead would corrupt a K1-vs-K1s
    comparison."""
    if peak_evening not in ("none", "clip"):
        raise ValueError(f"unknown peak_evening mode {peak_evening!r}")
    if skew and peak_evening == "clip":
        raise ValueError(_SKEW_CLIP)
    args = _kernel_inputs(mobile, static, basis, cell,
                          [midpoint, steepness, threshold])
    dev = mobile.device
    common = dict(r2_cutoff=cutoff_shape == "logistic_r2",
                  peak_clip=peak_evening == "clip", mxu_bf16=mxu_bf16)
    centers_perm = as_f32(centers_perm, dev)
    K, S = centers_perm.shape
    cpad = torch.zeros((basis["n_st"] * basis["s_tile"], _round_up(K, 128)),
                       device=dev)
    cpad[:S, :K] = centers_perm.T
    return dict(args, cpad=cpad, **common)


def mxu_landmark_blocks(mobile, static, basis, cell, *, midpoint,
                        steepness, cutoff_shape="logistic"):
    """Landmark vectors ``(B, M, S)`` in the CALLER's site order through the
    unique-atom kernel (K2).  ``mobile (B, M, 3)`` / ``static (B, N, 3)``
    float32; ``cell`` (3,) orthorhombic lengths or (3, 3) triclinic.  On
    CUDA tensors this launches the kernel; on CPU tensors it runs the plain
    version.  ``.launches`` counts the launches, ``.launches_by_card`` the
    same by the index of the card they ran on."""
    args = _lv_inputs(mobile, static, basis, cell, midpoint=midpoint,
                      steepness=steepness, cutoff_shape=cutoff_shape)
    if mobile.is_cuda:
        with torch.cuda.device(mobile.device):
            lv = _mxu_lv_cuda(**args)
        mxu_landmark_blocks.launches += 1
        mxu_landmark_blocks.launches_by_card[mobile.device.index] += 1
        return lv
    return _mxu_lv_plain(**args)


mxu_landmark_blocks.launches = 0
mxu_landmark_blocks.launches_by_card = Counter()


def mxu_assign_blocks(mobile, static, basis, cell, centers_perm, *,
                      midpoint, steepness, threshold, mxu_bf16=True,
                      cutoff_shape="logistic", peak_evening="none",
                      skew=False):
    """Fused landmark + normalise + assign through the unique-atom kernel
    (K1, or K1s with ``skew=True``: the same function with
    ``peak_evening='none'`` only, the lv kept on chip).  ``basis`` from
    :func:`prepare_mxu_basis`; ``centers_perm (K, S)`` unit centres with
    columns in kd order (:func:`permute_centers`).  Returns (labels (B, M)
    int32 with −1 below threshold, confs (B, M)).  On CUDA tensors this
    launches the kernel (counted in ``.launches`` for K1 and
    ``.skew_launches`` for K1s; K1's also in ``.launches_by_card``, by the
    index of the card it ran on); on CPU tensors it runs the plain
    version.  A launch runs on the inputs' card, whichever is current.

    The reference's ``a_bf16``, ``centers_store_f32`` and ``interpret``
    are not here: the port sums the membership lists in f32 (no membership
    matmul to round, and the preshift bound assumes f32); it pads the
    centres in f32 and casts them to the product's bf16 operand once a
    call, which gives the labels of either setting of the reference's
    centre store (the product reads the same bf16 values); and interpret
    mode is the TPU's."""
    args = _assign_inputs(mobile, static, basis, cell, centers_perm,
                          midpoint=midpoint, steepness=steepness,
                          threshold=threshold, mxu_bf16=mxu_bf16,
                          cutoff_shape=cutoff_shape,
                          peak_evening=peak_evening, skew=skew)
    M = mobile.shape[1]
    if not mobile.is_cuda:
        labels, confs = _mxu_assign_plain(**args)
    elif skew:
        with torch.cuda.device(mobile.device):
            labels, confs = _mxu_assign_skew_cuda(**args)
        mxu_assign_blocks.skew_launches += 1
    else:
        with torch.cuda.device(mobile.device):
            labels, confs = _mxu_assign_cuda(**args)
        mxu_assign_blocks.launches += 1
        mxu_assign_blocks.launches_by_card[mobile.device.index] += 1
    return labels[:, :M], confs[:, :M]


mxu_assign_blocks.launches = 0
mxu_assign_blocks.launches_by_card = Counter()
mxu_assign_blocks.skew_launches = 0
