"""Dense landmark-vector math (counterpart of ``sitator_tpu.ops.landmark``).

The per-pair log-cutoff over (frame, mobile, static), the product over each
site's vertex atoms as a matmul with the 0/1 membership matrix in log space,
then ``exp``.  This is the ``use_fused=False`` route of every engine and the
oracle the kernels' plain versions are checked against on small cells: its
``(B, M, N, 3)`` intermediate makes it a small-cell tool only.  On a card
the log-space product runs in products of a fixed row count
(:func:`contract_rows`), so a (frame, ion) row's landmark vector does not
depend on how many frames a call, or a frame shard of a mesh, holds.
"""
from __future__ import annotations

import numpy as np
import torch

from sitator_tpu_torch.ops.kernel_common import softplus
from sitator_tpu_torch.ops.pbc import min_image_disp

__all__ = [
    "vertex_membership_matrix",
    "log_cutoff",
    "log_cutoff_r2",
    "landmark_vectors",
    "normalize_landmark_vectors",
    "peak_even",
    "assign_to_centers",
    "max_static_drift",
    "static_drift_per_frame",
]


def vertex_membership_matrix(verts, vmask, n_static, dtype=torch.float32):
    """Membership matrix ``A (n_static, n_sites)`` from padded vertex indices
    ``verts (S, V)`` + validity ``vmask (S, V)``: ``A[n, s]`` counts how often
    static atom ``n`` is a vertex of site ``s`` (>1 reproduces repeated
    factors).  Host-side; returns a CPU tensor."""
    verts = np.asarray(verts)
    vmask = np.asarray(vmask)
    S, V = verts.shape
    A = np.zeros((n_static, S), dtype=np.float32)
    sites = np.broadcast_to(np.arange(S)[:, None], (S, V))
    np.add.at(A, (verts[vmask], sites[vmask]), 1.0)
    return torch.from_numpy(A).to(dtype)


def log_cutoff(d, midpoint, steepness):
    """log of ``c(d) = 1 / (1 + exp(steepness (d - midpoint)))``, evaluated
    stably as ``-softplus(steepness (d - midpoint))``."""
    return -softplus(steepness * (d - midpoint))


def log_cutoff_r2(d2, midpoint, steepness):
    """Logistic in d²: ``k' = steepness / (2 d0)`` matches the value and
    slope of :func:`log_cutoff` at the midpoint, with no sqrt."""
    k2 = steepness / (2.0 * midpoint)
    return -softplus(k2 * (d2 - midpoint * midpoint))


def landmark_vectors(mobile, static, A, cell, cell_inv, midpoint, steepness,
                     matmul_dtype=None, cutoff_shape="logistic"):
    """Landmark vectors ``(B, M, S)`` float32 for ``mobile (B, M, 3)``,
    ``static (B, N, 3)`` and membership ``A (N, S)``.  ``matmul_dtype``
    (e.g. ``torch.bfloat16``) rounds the log-space contraction operands;
    the product accumulates in float32."""
    diff = mobile[:, :, None, :] - static[:, None, :, :]      # (B, M, N, 3)
    diff = min_image_disp(diff, cell, cell_inv)
    d2 = (diff * diff).sum(-1)                                # (B, M, N)
    if cutoff_shape == "logistic":
        logc = log_cutoff(torch.sqrt(d2), midpoint, steepness)
    elif cutoff_shape == "logistic_r2":
        logc = log_cutoff_r2(d2, midpoint, steepness)
    else:
        raise ValueError(f"unknown cutoff_shape {cutoff_shape!r}")
    if matmul_dtype is not None:
        logc = logc.to(matmul_dtype).float()
        A = A.to(matmul_dtype).float()
    return torch.exp(contract_rows(logc, A, CONTRACT_ROWS if logc.is_cuda
                                   else None))


# rows of each log-space product on a card (a multiple of 4, so that every
# product's first row keeps the operand's 16-byte alignment)
CONTRACT_ROWS = 1024


def contract_rows(logc, A, rows):
    """``logc (..., N) @ A (N, S)``, in products of exactly ``rows`` rows
    (the last zero-padded) when ``rows`` is given, else in one.  cuBLAS
    picks its kernel by the row count, and its kernels sum in different
    orders: on H100s a frame mesh of 4 cards (4 bench frames, 2956 rows, a
    shard) moved ``LandmarkAnalysis``'s landmark vectors by up to 1.65e-17
    from the unmeshed run (16 frames in one product).  Products of one
    fixed row count give each row the same bits whatever the frame
    count."""
    if rows is None:
        return logc @ A
    flat = logc.reshape(-1, logc.shape[-1])
    n = flat.shape[0]
    out = torch.empty((n, A.shape[1]), dtype=torch.result_type(logc, A),
                      device=logc.device)
    for lo in range(0, n, rows):
        part = flat[lo:lo + rows]
        if part.shape[0] < rows:
            part = torch.nn.functional.pad(part, (0, 0, 0, rows - len(part)))
        out[lo:lo + rows] = (part @ A)[:n - lo]
    return out.reshape(logc.shape[:-1] + (A.shape[1],))


def normalize_landmark_vectors(lv, eps=1e-12):
    """Row-normalize to unit L2 norm; all-zero rows stay zero.
    Returns (normalized, norms)."""
    norms = torch.sqrt((lv * lv).sum(-1, keepdim=True))
    return lv / torch.clamp_min(norms, eps), norms[..., 0]


def peak_even(lv, mode: str):
    """'none' — identity.  'clip' — cap every component at the vector's
    second-largest value (a repeated maximum is its own second value)."""
    if mode == "none":
        return lv
    if mode == "clip":
        cap = torch.topk(lv, 2, dim=-1).values[..., 1:2]
        return torch.minimum(lv, cap)
    raise ValueError(f"unknown peak_evening mode {mode!r}")


def assign_to_centers(lv_norm, centers, active, assignment_threshold,
                      matmul_dtype=None):
    """Best active centre by dot product: ``lv_norm (..., S)`` unit rows,
    ``centers (K, S)``, ``active (K,)`` bool.  Returns (labels int32 with
    -1 below threshold, confidences); ties go to the lowest index."""
    if matmul_dtype is not None:
        lv_norm = lv_norm.to(matmul_dtype).float()
        centers = centers.to(matmul_dtype).float()
    sims = lv_norm @ centers.T                                # (..., K)
    sims = torch.where(active, sims, -torch.inf)
    confs = sims.amax(dim=-1)
    labels = sims.argmax(dim=-1).to(torch.int32)     # first index on ties
    labels = torch.where(confs >= assignment_threshold, labels, -1)
    return labels, confs


def max_static_drift(static_block, static_ref, cell, cell_inv):
    """Max minimum-image displacement of any static atom in the block from
    its reference position."""
    diff = min_image_disp(static_block - static_ref[None], cell, cell_inv)
    return torch.sqrt((diff * diff).sum(-1).max())


def static_drift_per_frame(static_block, static_ref, cell, cell_inv):
    """Per-frame max minimum-image drift of the static lattice: (B,)."""
    diff = min_image_disp(static_block - static_ref[None], cell, cell_inv)
    return torch.sqrt((diff * diff).sum(-1).amax(-1))
