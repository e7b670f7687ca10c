"""Mean-squared displacement and trajectory unwrapping (host, float64;
counterpart of ``sitator_tpu.ops.msd``).

Downstream kinetics the reference ecosystem computes by hand around
``sitator`` (tracer/collective diffusivity from an MD trajectory; the
reference itself stops at jump statistics, SURVEY.md §3.4):

- :func:`unwrap_trajectory`: wrapped → continuous coordinates by chaining
  minimum-image frame-to-frame displacements (triclinic-safe, one
  ``cumsum`` over the frame axis — no Python loop).
- :func:`msd_fft`: the exact O(F log F) time-origin-averaged MSD via the
  FFT autocorrelation identity (the "windowed MSD" algorithm), batched
  over atoms and Cartesian components as one ``rfft``.
- :func:`collective_msd_fft`: the same estimator applied to the summed
  (collective / charge) displacement, for D_sigma and the Haven ratio.

Deliberately host-side NumPy float64, like the host ``PBCCalculator``
(SURVEY.md §3.7): ``MSD(m) = (S1(m) - 2*S2(m))/(F-m)`` subtracts two
sums that each grow like ``F * |r|^2`` — catastrophic cancellation in
float32 on long drifting trajectories — and the whole analysis runs once
per trajectory (seconds even at 10^6 frames), so there is no device win
to trade that precision for.  The device hot path (per-frame assignment)
never calls this module.

Math (per signal x(t), F frames, lag m):
``S1(m) = sum_{t<F-m} (x(t)^2 + x(t+m)^2)`` via two cumulative sums and
``S2(m) = sum_{t<F-m} x(t) x(t+m)`` via a zero-padded real FFT.
Identical to the brute-force O(F^2) average over all time origins
(the reference's copy is tested against it in ``tests/test_diffusion.py``,
this one against the reference in ``tests/test_torch_msd.py``).
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.ops.pbc import PBCCalculator

__all__ = ["unwrap_trajectory", "drift_curve", "msd_fft",
           "msd_tensor_fft", "collective_msd_fft", "cross_msd_fft",
           "vacf_fft", "fit_diffusivity", "fit_window",
           "lag_statistics", "displacement_moments",
           "self_intermediate_scattering"]


def fit_window(n_frames, fit_range):
    """The (lo, hi) lag-index window that :func:`fit_diffusivity` fits
    over — the single source of truth for every consumer (the engines
    and the plots use it too, so the drawn fit always matches the
    fitted one)."""
    lo = max(1, int(fit_range[0] * n_frames))
    hi = max(lo + 2, int(fit_range[1] * n_frames))
    return lo, min(hi, n_frames)


def unwrap_trajectory(traj, cell, exact: bool = False):
    """Continuous coordinates from a wrapped ``(F, N, 3)`` trajectory.

    Frame-to-frame displacements are taken minimum-image (the physical
    assumption: no atom moves more than half a cell vector per frame —
    standard for MD output) and chained by a cumulative sum; frame 0 is
    kept as-is, so the result starts at the input's first frame.
    """
    traj = np.asarray(traj, dtype=np.float64)
    F, N = traj.shape[:2]
    calc = PBCCalculator(cell, exact=exact)
    raw = (traj[1:] - traj[:-1]).reshape(-1, 3)
    disp = np.asarray(calc._min_image_disp(raw)).reshape(F - 1, N, 3)
    out = np.empty_like(traj)
    out[0] = traj[0]
    np.cumsum(disp, axis=0, out=out[1:])
    out[1:] += traj[0]
    return out


def drift_curve(traj, cell, mask=None, exact: bool = False):
    """Rigid drift of a reference atom group: the ``(F, 3)`` mean
    displacement (relative to frame 0) of the ``mask``-selected atoms
    of a wrapped ``(F, N, 3)`` trajectory (``mask=None`` → all atoms).

    Subtracting this from an unwrapped trajectory moves the analysis
    into the reference group's mean frame — removing thermostat /
    host-lattice drift, which otherwise contaminates every MSD with a
    spurious ``(v·t)²`` term.  Frame-0 positions are unchanged.
    """
    traj = np.asarray(traj, dtype=np.float64)
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (traj.shape[1],):
            raise ValueError("drift reference mask must be (n_atoms,)")
        if not mask.any():
            raise ValueError("drift reference mask selects no atoms")
        traj = traj[:, mask, :]
    u = unwrap_trajectory(traj, cell, exact=exact)
    return u.mean(axis=1) - u[0].mean(axis=0)


def _acf_fft(x):
    """Linear (non-circular) autocorrelation of ``x`` (..., F) at lags
    0..F-1: ``acf[m] = sum_t x[t] x[t+m]``, via a 2F-padded real FFT."""
    F = x.shape[-1]
    n = 2 * F
    X = np.fft.rfft(x, n=n, axis=-1)
    return np.fft.irfft(X * np.conj(X), n=n, axis=-1)[..., :F]


def msd_fft(pos):
    """Time-origin-averaged MSD of an unwrapped ``(F, N, 3)`` trajectory.

    Returns ``(msd, msd_per_atom)``: ``msd`` is ``(F,)`` (mean over
    atoms), ``msd_per_atom`` is ``(N, F)`` — per-atom curves feed the
    jackknife error estimate in
    :class:`~sitator_tpu_torch.dynamics.diffusion.DiffusionAnalysis`.
    ``msd[0] == 0``.
    """
    pos = np.asarray(pos, dtype=np.float64)
    F = pos.shape[0]
    x = np.moveaxis(pos, 0, -1)                      # (N, 3, F)
    d = np.einsum("ncf,ncf->nf", x, x)               # (N, F)  |r(t)|^2
    acf = _acf_fft(x).sum(axis=1)                    # (N, F)  sum_c S2
    csum = np.concatenate(
        [np.zeros((d.shape[0], 1)), np.cumsum(d, axis=1)], axis=1)
    total = csum[:, -1:]
    m = np.arange(F)
    # S1(m) = sum_{t=0}^{F-m-1} d[t]  +  sum_{t=m}^{F-1} d[t]
    head = csum[:, F - m]
    tail = total - csum[:, m]
    per_atom = (head + tail - 2.0 * acf) / (F - m)
    per_atom[:, 0] = 0.0                             # exact zero at lag 0
    return per_atom.mean(axis=0), per_atom


def msd_tensor_fft(pos, per_atom_trace=False):
    """Time-origin-averaged displacement-covariance tensor of an
    unwrapped ``(F, N, 3)`` trajectory:
    ``T[m, a, b] = < (Δr_a)(Δr_b) >`` over all origins and atoms at lag
    ``m`` — the anisotropic generalization of :func:`msd_fft` (whose
    scalar MSD is this tensor's trace; asserted in
    ``tests/test_diffusion.py``).  Returns ``(F, 3, 3)``, symmetric in
    ``(a, b)``, exactly the O(F²) all-origins average (same S1/S2
    identity per component pair; the cross term uses the symmetrized
    FFT cross-correlation).  Fit each component's slope over a lag
    window to get the diffusion tensor ``D_ab = slope_ab / 2``.

    With ``per_atom_trace=True`` also returns the ``(N, F)`` per-atom
    scalar MSD curves (the per-atom tensor trace) — callers that need
    both the tensor and :func:`msd_fft`'s outputs get them from ONE
    FFT pass instead of two.
    """
    pos = np.asarray(pos, dtype=np.float64)
    F = pos.shape[0]
    x = np.moveaxis(pos, 0, -1)                      # (N, 3, F)
    n = 2 * F
    X = np.fft.rfft(x, n=n, axis=-1)                 # (N, 3, Fr)
    m = np.arange(F)
    denom = (F - m).astype(np.float64)
    out = np.empty((F, 3, 3))
    trace_pa = None
    for a in range(3):
        for b in range(a, 3):
            # S2_sym(m) = Σ_t x_a(t+m)x_b(t) + x_b(t+m)x_a(t)
            spec = X[:, a] * np.conj(X[:, b])
            cross = np.fft.irfft(spec + np.conj(spec), n=n,
                                 axis=-1)[..., :F]   # (N, F)
            d = x[:, a] * x[:, b]                    # (N, F)
            csum = np.concatenate(
                [np.zeros((d.shape[0], 1)), np.cumsum(d, axis=1)], axis=1)
            total = csum[:, -1:]
            head = csum[:, F - m]
            tail = total - csum[:, m]
            per_atom = (head + tail - cross) / denom
            per_atom[:, 0] = 0.0
            out[:, a, b] = out[:, b, a] = per_atom.mean(axis=0)
            if per_atom_trace and a == b:
                trace_pa = (per_atom if trace_pa is None
                            else trace_pa + per_atom)
    if per_atom_trace:
        return out, trace_pa
    return out


def cross_msd_fft(xa, xb):
    """Time-origin-averaged displacement cross-correlation of two
    vector time series ``(F, 3)``:
    ``C[m] = < Δx_a(t→t+m) · Δx_b(t→t+m) >`` over all origins — the
    Onsager cross term (``cross_msd_fft(x, x)`` is the MSD of ``x``).
    Same S1 − S2_sym identity as :func:`msd_tensor_fft`, with the dot
    product summed over components.  Returns ``(F,)`` float64.
    """
    xa = np.asarray(xa, dtype=np.float64).T            # (3, F)
    xb = np.asarray(xb, dtype=np.float64).T
    F = xa.shape[-1]
    n = 2 * F
    Xa = np.fft.rfft(xa, n=n, axis=-1)
    Xb = np.fft.rfft(xb, n=n, axis=-1)
    spec = (Xa * np.conj(Xb)).sum(axis=0)              # dot over comps
    cross = np.fft.irfft(spec + np.conj(spec), n=n)[:F]
    d = (xa * xb).sum(axis=0)                          # (F,)
    csum = np.concatenate([[0.0], np.cumsum(d)])
    m = np.arange(F)
    head = csum[F - m]
    tail = csum[-1] - csum[m]
    out = (head + tail - cross) / (F - m)
    out[0] = 0.0
    return out


def vacf_fft(vel):
    """Time-origin-averaged velocity autocorrelation of ``(F, N, 3)``
    velocities: ``Z[m] = < v(t+m) · v(t) >`` over all origins and
    atoms.  Returns ``(Z, Z_per_atom)`` — ``(F,)`` and ``(N, F)``.
    ``Z[0]`` is the mean squared speed; the Green–Kubo diffusivity is
    ``D = (1/3) ∫ Z dt`` (see
    :class:`~sitator_tpu_torch.dynamics.vibrational.VibrationalSpectrumAnalysis`).
    """
    vel = np.asarray(vel, dtype=np.float64)
    F = vel.shape[0]
    x = np.moveaxis(vel, 0, -1)                      # (N, 3, F)
    per_atom = _acf_fft(x).sum(axis=1) / (F - np.arange(F))
    return per_atom.mean(axis=0), per_atom


def collective_msd_fft(pos):
    """MSD of the summed displacement ``R(t) = sum_i [r_i(t) - r_i(0)]``
    (the collective / charge walk) — ``(F,)``.  Divide by N for the
    per-ion collective diffusivity entering the Haven ratio."""
    pos = np.asarray(pos, dtype=np.float64)
    R = (pos - pos[:1]).sum(axis=1, keepdims=True)   # (F, 1, 3)
    return msd_fft(R)[0]


def _lagged_displacements(pos, lag, origin_stride):
    """|Δr| magnitudes ``(n_origins * N,)`` at one lag (origins
    subsampled by ``origin_stride``)."""
    F = pos.shape[0]
    if not 0 <= lag < F:
        raise ValueError(f"lag {lag} outside 0..{F - 1}")
    origins = np.arange(0, F - lag, int(origin_stride))
    disp = pos[origins + lag] - pos[origins]
    return np.sqrt((disp ** 2).sum(-1)).ravel()


def lag_statistics(pos, lags, origin_stride=1, q=None):
    """Per-lag displacement statistics from ONE pass over the |Δr|
    magnitudes (each lag's array is built exactly once — the dominant
    O(lags·F·N) cost of the relaxation analyses).

    Returns ``(m2, m4, alpha2, fs)``: the second and fourth displacement
    moments, the non-Gaussian parameter ``α₂ = 3<r⁴>/(5<r²>²) − 1``, and
    — when ``q`` is given — the exact powder-averaged self-intermediate
    scattering ``F_s(q,t) = <sinc(q|Δr|)>`` (else ``fs`` is None).
    """
    pos = np.asarray(pos, dtype=np.float64)
    if q is not None:
        q = float(q)
        if q <= 0:
            raise ValueError("q must be positive")
    m2 = np.empty(len(lags))
    m4 = np.empty(len(lags))
    fs = np.empty(len(lags)) if q is not None else None
    for k, lag in enumerate(lags):
        r = _lagged_displacements(pos, int(lag), origin_stride)
        r2 = r * r
        m2[k] = r2.mean()
        m4[k] = (r2 * r2).mean()
        if q is not None:
            qr = q * r
            fs[k] = np.mean(np.where(qr > 1e-12, np.sin(qr)
                                     / np.where(qr > 1e-12, qr, 1.0), 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha2 = np.where(m2 > 0, 3.0 * m4 / (5.0 * m2 ** 2) - 1.0, 0.0)
    return m2, m4, alpha2, fs


def displacement_moments(pos, lags, origin_stride=1):
    """``<r²(t)>``, ``<r⁴(t)>`` and the non-Gaussian parameter
    ``α₂(t) = 3<r⁴>/(5<r²>²) − 1`` at the given frame lags.

    ``pos`` is an unwrapped ``(F, N, 3)`` trajectory.  α₂ vanishes for
    Gaussian displacement distributions; a positive peak at intermediate
    t is the standard signature of discrete-hop (dynamically
    heterogeneous) motion.  Returns ``(m2, m4, alpha2)``, each
    ``(len(lags),)``; α₂ at lag 0 (zero displacement) is defined as 0.
    """
    m2, m4, alpha2, _ = lag_statistics(pos, lags, origin_stride)
    return m2, m4, alpha2


def self_intermediate_scattering(pos, q, lags, origin_stride=1):
    """Isotropically averaged self-intermediate scattering function
    ``F_s(q, t)`` at wavevector magnitude ``q`` and the given lags.

    Uses the exact powder average ``<exp(iq·Δr)>_Ω = <sinc(q|Δr|)>`` —
    no sampled q-directions needed.  ``pos`` unwrapped ``(F, N, 3)``.
    Returns ``(len(lags),)``; F_s(q, 0) = 1.
    """
    return lag_statistics(pos, lags, origin_stride, q=q)[3]


def fit_diffusivity(times, msd, fit_range=(0.2, 0.5), dim=3):
    """Least-squares slope of ``msd`` over the relative lag window
    ``fit_range`` (fractions of the max lag), returned as
    ``(D, intercept)`` with ``D = slope / (2 * dim)``."""
    times = np.asarray(times, dtype=np.float64)
    msd = np.asarray(msd, dtype=np.float64)
    lo, hi = fit_window(len(times), fit_range)
    t, y = times[lo:hi], msd[lo:hi]
    A = np.stack([t, np.ones_like(t)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    return slope / (2.0 * dim), intercept
