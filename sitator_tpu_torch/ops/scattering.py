"""Lattice-commensurate scattering functions: S(q) and coherent F(q, t)
(counterpart of ``sitator_tpu.ops.scattering``).

- :func:`allowed_wavevectors`: the q-grid commensurate with the
  periodic cell, ``q = 2π · cell⁻¹ · n`` for integer ``n`` — the ONLY
  wavevectors for which ``ρ_q = Σ_j exp(iq·r_j)`` is exactly periodic,
  so no minimum-image truncation or windowing artifacts exist (unlike
  the r-space histogram route of :mod:`sitator_tpu_torch.ops.correlation`).
- :func:`collective_density_modes`: ρ_q(t) for every frame and
  wavevector, computed on ``device``.
- :func:`static_structure_factor` / :func:`coherent_scattering`:
  shell-averaged S(q) and the coherent intermediate scattering function
  F(q, t) = ⟨ρ_q(t₀+t) ρ_q*(t₀)⟩/N over ALL time origins (FFT).

Device mapping: with wrapped fractional coordinates ``f ∈ [0, 1)`` the
phase is ``q·r = 2π n·f``.  For a chunk of frames the phase table
``u = f · n`` ``(C, M, Nq)`` is three explicit float32 multiply-adds, not
a ``K = 3`` matrix product: a TF32 product (which
``torch.backends.cuda.matmul.allow_tf32`` may turn on for the whole
process) would keep 10 mantissa bits of each phase, and no precision
setting reaches elementwise code.  Then ``θ = 2π(u − ⌊u⌋)`` and the
cos/sin sums over the atoms.  The mod-1 step keeps every angle in
``[0, 2π)`` BEFORE the trig call: float32 phase error stays ~1e-5 rad
even for high-order modes (|n| ~ 20), where naive float32
``q·r_unwrapped`` would be wrong by whole radians.  The time
autocorrelation per mode is a host float64 FFT (the S1/S2 reasoning of
:mod:`sitator_tpu_torch.ops.msd` — it runs once per trajectory).

Only one of each ``±q`` pair is enumerated (``ρ_{-q} = ρ_q*`` for real
densities, so both carry the same real correlation).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["allowed_wavevectors", "collective_density_modes",
           "static_structure_factor", "coherent_scattering"]

# cap C*M*Nq phase-table elements per chunk (~256 MB of float32 a table;
# about 1 GB of temporaries with the angle, cosine and sine)
_MAX_CHUNK_PHASES = 2 ** 26


def allowed_wavevectors(cell, q_max, q_min=0.0):
    """Integer modes ``n`` and wavevectors ``q = 2π·cell⁻¹·n`` with
    ``q_min < |q| <= q_max``, one per ±pair (first nonzero component of
    ``n`` positive).  Returns ``(n, q, |q|)`` sorted by ``|q|`` —
    ``n`` int32 ``(Nq, 3)``, ``q``/``|q|`` float64.
    """
    cell = np.asarray(cell, dtype=np.float64)
    q_max = float(q_max)
    if q_max <= 0:
        raise ValueError("q_max must be positive")
    inv = np.linalg.inv(cell)
    # |n_i| = |q·a_i| / 2π <= q_max |a_i| / 2π
    n_max = np.floor(q_max * np.linalg.norm(cell, axis=1)
                     / (2 * np.pi)).astype(int)
    axes = [np.arange(-m, m + 1) for m in n_max]
    n = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    # half space: first nonzero component positive (drops n = 0 too)
    key = np.where(n[:, 0] != 0, np.sign(n[:, 0]),
                   np.where(n[:, 1] != 0, np.sign(n[:, 1]),
                            np.sign(n[:, 2])))
    n = n[key > 0]
    q = 2 * np.pi * n @ inv.T
    mag = np.linalg.norm(q, axis=1)
    keep = (mag <= q_max * (1 + 1e-12)) & (mag > float(q_min))
    n, q, mag = n[keep], q[keep], mag[keep]
    order = np.argsort(mag, kind="stable")
    return n[order].astype(np.int32), q[order], mag[order]


def _rho_chunk(frac, n_t):
    """(C, M, 3) wrapped fractional frames × (3, Nq) integer modes →
    (C, Nq, 2) atom-summed (cos, sin), float32 on ``frac``'s device."""
    u = frac[..., 0:1] * n_t[0]
    u += frac[..., 1:2] * n_t[1]
    u += frac[..., 2:3] * n_t[2]                       # (C, M, Nq)
    theta = u.sub_(torch.floor(u)).mul_(2 * math.pi)
    return torch.stack([torch.cos(theta).sum(dim=1),
                        torch.sin(theta).sum(dim=1)], dim=-1)


def collective_density_modes(traj, cell, mask, n_modes, device="cuda"):
    """ρ_q(t) = Σ_j exp(iq·r_j(t)) over the selected atoms for every
    frame — complex128 ``(F, Nq)``.  ``n_modes`` are the integer modes
    from :func:`allowed_wavevectors`; positions may be wrapped or not
    (only their fractional part enters: wrapped on the host in float64,
    then float32 on ``device``).  Chunked over frames; the chunks' sums
    come back to the host once, as float64.
    """
    traj = np.asarray(traj)
    mask = np.asarray(mask, dtype=bool)
    n_modes = np.asarray(n_modes)
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    frac = np.asarray(traj[:, mask, :], dtype=np.float64) @ inv
    frac = (frac - np.floor(frac)).astype(np.float32)   # [0, 1)
    F, M, _ = frac.shape
    nq = len(n_modes)
    if M == 0 or nq == 0:
        return np.zeros((F, nq), dtype=np.complex128)
    device = torch.device(device)
    n_t = torch.as_tensor(np.asarray(n_modes.T, np.float32),
                          device=device)                # (3, Nq)
    chunk = min(F, max(1, _MAX_CHUNK_PHASES // max(1, M * nq)))
    frames = torch.as_tensor(frac, device=device)
    cs = torch.cat([_rho_chunk(frames[s:s + chunk], n_t)
                    for s in range(0, F, chunk)]).cpu().numpy()
    cs = cs.astype(np.float64)
    return cs[..., 0] + 1j * cs[..., 1]


def _autocorr_all_origins(rho):
    """All-origins complex autocorrelation per mode: ``(F, Nq)`` →
    real ``(F, Nq)`` with ``c[m] = Re Σ_τ ρ(τ+m)ρ*(τ) / (F−m)``
    (zero-padded FFT; exact to float64 rounding)."""
    F = rho.shape[0]
    P = np.fft.fft(rho, n=2 * F, axis=0)
    c = np.fft.ifft(P * np.conj(P), axis=0)[:F].real
    return c / (F - np.arange(F))[:, None]


def _shell_edges(mag, n_shells):
    """Equal-width |q| shells covering the enumerated modes."""
    lo, hi = float(mag.min()), float(mag.max())
    if n_shells < 1:
        raise ValueError("n_shells must be >= 1")
    edges = np.linspace(lo, hi, n_shells + 1)
    edges[-1] = np.nextafter(hi, np.inf)
    return edges


def static_structure_factor(traj, cell, mask, q_max, n_shells=24,
                            q_min=0.0, device="cuda"):
    """Shell-averaged static structure factor S(q) = ⟨|ρ_q|²⟩/N over
    frames and modes in each |q| shell.  Returns
    ``(q_centers, S, counts)`` — shell-mean |q|, S(q), and modes per
    shell (empty shells carry NaN).  ρ_q(t) runs on ``device``.
    """
    n, _, mag = allowed_wavevectors(cell, q_max, q_min=q_min)
    if len(n) == 0:
        raise ValueError("no allowed wavevectors below q_max for this "
                         "cell; raise q_max")
    rho = collective_density_modes(traj, cell, mask, n, device=device)
    N = int(np.asarray(mask, dtype=bool).sum())
    s_mode = (np.abs(rho) ** 2).mean(axis=0) / max(N, 1)
    return _shell_average(mag, n_shells, s_mode)


def coherent_scattering(traj, cell, mask, q_max, n_shells=24, q_min=0.0,
                        device="cuda"):
    """Coherent intermediate scattering function, shell-averaged:
    ``F(q, t) = ⟨Re ρ_q(t₀+t) ρ_q*(t₀)⟩ / N`` over all origins (FFT)
    and all modes in the shell.  Returns ``(q_centers, Fqt, counts)``
    with ``Fqt.shape == (n_shells, F)``; ``Fqt[:, 0]`` is S(q).  ρ_q(t)
    runs on ``device``; the autocorrelation on the host in float64.
    """
    n, _, mag = allowed_wavevectors(cell, q_max, q_min=q_min)
    if len(n) == 0:
        raise ValueError("no allowed wavevectors below q_max for this "
                         "cell; raise q_max")
    rho = collective_density_modes(traj, cell, mask, n, device=device)
    N = int(np.asarray(mask, dtype=bool).sum())
    corr = _autocorr_all_origins(rho) / max(N, 1)       # (F, Nq)
    q_c, F_shell, counts = _shell_average(mag, n_shells, corr.T)
    return q_c, F_shell, counts


def _shell_average(mag, n_shells, values):
    """Average ``values`` (``(Nq,)`` or ``(Nq, T)``) over |q| shells.
    Returns ``(q_centers, averaged, counts)``; empty shells are NaN."""
    edges = _shell_edges(mag, int(n_shells))
    idx = np.clip(np.digitize(mag, edges) - 1, 0, int(n_shells) - 1)
    values = np.asarray(values, dtype=np.float64)
    tail = values.shape[1:]
    out = np.full((int(n_shells),) + tail, np.nan)
    q_c = np.full(int(n_shells), np.nan)
    counts = np.zeros(int(n_shells), dtype=np.int64)
    for s in range(int(n_shells)):
        sel = idx == s
        counts[s] = sel.sum()
        if counts[s]:
            q_c[s] = mag[sel].mean()
            out[s] = values[sel].mean(axis=0)
    return q_c, out, counts
