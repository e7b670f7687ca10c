"""Landmark vectors, cosine assignment and their tallies, written plainly.

For an ion at ``x`` and a site with vertex atoms ``v``, the landmark value
is the product over the vertices of the cutoff ``c(d)`` of the minimum-image
distance ``d = |x - r_v|``: ``c = 1 / (1 + exp(k (d² - d0²)))`` with ``k =
steepness / (2 d0)`` for ``logistic_r2`` (``1 / (1 + exp(steepness (d -
d0)))`` for ``logistic``).  The similarity of an ion to centre ``k`` is
``(round(lv) . round(C_k)) / |lv|``: the un-normalised landmark vector and
the centres rounded to the configuration's similarity operand type, the
products summed in float32.  The label is the first centre of largest
similarity, −1 where that similarity is below the threshold; the
confidence is that similarity; the margin is how far it lies from the
decision that sets the label (the threshold, and above it a second
centre).  Everything else is float32 (TF32 off).
"""
import contextlib

import numpy as np
import torch

from portbench.reference.tally import centres_from_sums, sums, tally

__all__ = ["site_centres", "label_pool", "tally", "sums",
           "centres_from_sums"]

# (frame, ion, vertex-atom) elements of one chunk of frames
_CHUNK_ELEMS = 1 << 26


@contextlib.contextmanager
def _exact_f32():
    """float32 products in float32, not TF32, while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _log_cutoff(d2, shape, midpoint, steepness):
    """log c, with softplus written out: log(1 + e^x) = max(x, 0) +
    log1p(e^-|x|)."""
    if shape == "logistic_r2":
        x = (steepness / (2.0 * midpoint)) * (d2 - midpoint * midpoint)
    elif shape == "logistic":
        x = steepness * (torch.sqrt(d2) - midpoint)
    else:
        raise ValueError(f"unknown cutoff shape {shape!r}")
    return -(torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs())))


def landmark_vectors(mobile, static, cell, verts, cfg):
    """Un-normalised landmark vectors ``(B, M, S)``: ``mobile (B, M, 3)``,
    ``static (B, N, 3)``, ``cell (3, 3)`` rows the lattice vectors,
    ``verts (S, V)`` long indices into the static atoms."""
    cell_inv = torch.linalg.inv(cell.double()).to(cell.dtype)
    fm, fs = mobile @ cell_inv, static @ cell_inv
    used = torch.unique(verts)                   # atoms that are vertices
    fs = fs[:, used]
    d = fm[:, :, None, :] - fs[:, None, :, :]    # (B, M, U, 3) fractional
    d = d - torch.round(d)
    d = d @ cell
    logc_u = _log_cutoff((d * d).sum(-1), cfg["cutoff_shape"],
                         float(cfg["cutoff_midpoint"]),
                         float(cfg["cutoff_steepness"]))
    del d
    slot = torch.full((static.shape[1],), -1, dtype=torch.long,
                      device=static.device)
    slot[used] = torch.arange(len(used), device=static.device)
    vs = slot[verts]
    log_lv = logc_u.index_select(-1, vs[:, 0])
    for j in range(1, vs.shape[1]):
        log_lv = log_lv + logc_u.index_select(-1, vs[:, j])
    return torch.exp(log_lv)


def _round(x, operand):
    if operand == "float32":
        return x
    return x.to(getattr(torch, operand)).float()


def assign(lv, centres, threshold, operand):
    """``lv (R, S)``, ``centres (K, S)`` unit rows: labels ``(R,)`` int32,
    confidences, and the margin, float32: how far the top similarity lies
    from the decision that sets the label: below the threshold, its
    distance from it; above, the lesser of that and its lead over the
    second."""
    norm = torch.sqrt((lv * lv).sum(-1))
    sims = (_round(lv, operand) @ _round(centres, operand).T) \
        / torch.clamp_min(norm, 1e-30)[:, None]
    top = torch.topk(sims, 2, dim=-1).values
    conf = top[:, 0]
    labels = torch.argmax(sims, dim=-1).to(torch.int32)
    labels = torch.where(conf >= threshold, labels, -1)
    lead = torch.minimum(top[:, 0] - top[:, 1], conf - threshold)
    return labels, conf, torch.where(conf >= threshold, lead,
                                     threshold - conf)


def label_pool(pool, n_static, geo, centres, cfg, device, operand=None):
    """Labels, confidences and margins ``(P, M)`` of every frame of the
    pool ``(P, n_static + M, 3)`` (static atoms first), computed on
    ``device`` in chunks of frames; ``operand`` defaults to the
    configuration's similarity operand type."""
    operand = operand or cfg["precision"]["similarity_operands"]
    dev = torch.device(device)
    P, A, _ = pool.shape
    M = A - n_static
    verts = torch.as_tensor(np.asarray(geo["verts"]), dtype=torch.long,
                            device=dev)
    U = int(torch.unique(verts).numel())
    cell = torch.as_tensor(np.asarray(geo["cell"]), dtype=torch.float32,
                           device=dev)
    C = torch.as_tensor(np.asarray(centres), dtype=torch.float32, device=dev)
    thr = float(cfg["assignment_threshold"])
    b = max(1, _CHUNK_ELEMS // (M * U))
    labels = np.empty((P, M), np.int32)
    conf = np.empty((P, M), np.float32)
    margin = np.empty((P, M), np.float32)
    with _exact_f32(), torch.no_grad():
        for lo in range(0, P, b):
            fr = torch.as_tensor(np.asarray(pool[lo:lo + b]), device=dev)
            lv = landmark_vectors(fr[:, n_static:], fr[:, :n_static], cell,
                                  verts, cfg)
            lab, cf, mg = assign(lv.reshape(-1, lv.shape[-1]), C, thr,
                                 operand)
            n = fr.shape[0]
            labels[lo:lo + n] = lab.view(n, M).cpu().numpy()
            conf[lo:lo + n] = cf.view(n, M).cpu().numpy()
            margin[lo:lo + n] = mg.view(n, M).cpu().numpy()
    return labels, conf, margin


def site_centres(points, static_ref, geo, cfg):
    """Unit landmark vectors ``(K, S)`` float32 of probes at ``points (K,
    3)`` against the static atoms at their reference positions, in float64
    NumPy: the centres both sides are given."""
    cell = np.asarray(geo["cell"], np.float64)
    inv = np.linalg.inv(cell)
    verts = np.asarray(geo["verts"])
    fs = np.asarray(static_ref, np.float64) @ inv
    out = np.empty((len(points), len(verts)), np.float32)
    mid, steep = float(cfg["cutoff_midpoint"]), float(cfg["cutoff_steepness"])
    for k, p in enumerate(np.asarray(points, np.float64)):
        d = (p @ inv) - fs
        d = (d - np.round(d)) @ cell
        d2 = (d * d).sum(-1)
        if cfg["cutoff_shape"] == "logistic_r2":
            x = (steep / (2 * mid)) * (d2 - mid * mid)
        else:
            x = steep * (np.sqrt(d2) - mid)
        logc = -(np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x))))
        lv = np.exp(logc[verts].sum(-1))
        out[k] = lv / np.linalg.norm(lv)
    return out
