"""2-D plots for the kinetics engines (MSD / Arrhenius / RDF / van Hove;
counterpart of ``sitator_tpu.visualization.kinetics``).

Same ``@plotter`` convention as the 3-D structure plots
(:mod:`sitator_tpu_torch.visualization.common`), but on 2-D axes: every
function accepts ``fig``/``ax`` and returns the figure.  The engines'
results are host NumPy arrays, so the plots are the reference's, line for
line.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.visualization.common import plotter

__all__ = ["plot_msd", "plot_arrhenius", "plot_rdf", "plot_van_hove",
           "plot_residence_survival", "plot_structure_factor",
           "plot_vdos", "plot_conductivity_spectrum",
           "plot_barrier_profiles", "plot_reactive_flux",
           "plot_implied_timescales", "plot_ck_test"]

_K_B_EV = 8.617333262e-5


@plotter(is3D=False)
def plot_msd(da, fig=None, ax=None, show_fit=True, show_atoms=False):
    """MSD vs lag time from a fitted
    :class:`~sitator_tpu_torch.dynamics.diffusion.DiffusionAnalysis` (tracer
    curve, optionally the per-atom spread and the fitted line)."""
    t = da.times_
    if show_atoms and hasattr(da, "msd_per_atom_"):
        for curve in da.msd_per_atom_:
            ax.plot(t, curve, color="0.8", lw=0.5, zorder=1)
    ax.plot(t, da.msd_, color="C0", lw=2, zorder=3, label="MSD")
    if show_fit:
        from sitator_tpu_torch.ops.msd import fit_window
        sl = slice(*fit_window(len(t), da.fit_range))
        ax.plot(t[sl], 6 * da.D_tracer_ * t[sl]
                + (da.msd_[sl] - 6 * da.D_tracer_ * t[sl]).mean(),
                "k--", zorder=4,
                label=f"fit: D = {da.D_tracer_:.3g} ± "
                      f"{da.D_tracer_err_:.2g}")
    ax.set_xlabel("lag time")
    ax.set_ylabel("MSD")
    ax.legend()


@plotter(is3D=False)
def plot_arrhenius(aa, temperatures, values, errors=None, fig=None,
                   ax=None):
    """Arrhenius plot (ln y vs 1000/T) with the fitted line from a
    :class:`~sitator_tpu_torch.dynamics.arrhenius.ArrheniusAnalysis`."""
    T = np.asarray(temperatures, dtype=np.float64)
    y = np.asarray(values, dtype=np.float64)
    x = 1000.0 / T
    if errors is not None:
        errors = np.asarray(errors, dtype=np.float64)
        ax.errorbar(x, y, yerr=errors, fmt="o", color="C0", capsize=3)
    else:
        ax.plot(x, y, "o", color="C0")
    xs = np.linspace(x.min(), x.max(), 100)
    ax.plot(xs, aa.prefactor_
            * np.exp(-aa.Ea_ev_ / (_K_B_EV * 1000.0 / xs)),
            "k--",
            label=f"Ea = {aa.Ea_ev_:.3g} ± {aa.Ea_err_ev_:.2g} eV")
    ax.set_yscale("log")
    ax.set_xlabel("1000 / T  [1/K]")
    ax.set_ylabel("D (or rate)")
    ax.legend()


@plotter(is3D=False)
def plot_rdf(ra, fig=None, ax=None, **plot_kwargs):
    """g(r) from a fitted
    :class:`~sitator_tpu_torch.dynamics.correlation.RDFAnalysis`."""
    ax.plot(ra.r_, ra.g_, **plot_kwargs)
    ax.axhline(1.0, color="0.7", lw=0.8, zorder=1)
    ax.set_xlabel("r")
    ax.set_ylabel("g(r)")


@plotter(is3D=False)
def plot_residence_survival(ra, sites=None, fig=None, ax=None,
                            cmap="viridis", show_fit=True):
    """Per-site residence-time survival curves ``P(residence > k)`` on a
    log scale, from a fitted
    :class:`~sitator_tpu_torch.dynamics.residence.ResidenceTimeAnalysis` —
    a memoryless (geometric) site is a straight line; curvature or a
    knee reveals the hidden sub-basins the analysis flags.  ``sites``
    selects which sites to draw (default: all tested sites, flagged
    ones with a thicker line)."""
    import matplotlib.pyplot as plt
    if sites is None:
        sites = [s for s in range(len(ra.segments_))
                 if np.isfinite(ra.p_value_[s])]
    if not len(sites):
        raise ValueError("no tested sites to plot (need >= min_samples "
                         "completed residences)")
    colors = plt.get_cmap(cmap)(np.linspace(0.15, 0.9, len(sites)))
    flagged = set(int(s) for s in ra.non_exponential_sites_)
    for s, c in zip(sites, colors):
        v = np.sort(ra.segments_[s])
        if not len(v):
            continue
        n = len(v)
        surv = 1.0 - np.arange(1, n + 1) / n
        label = f"site {s}"
        if s in flagged:
            label += " (non-memoryless)"
        ax.step(v, np.maximum(surv, 0.5 / n), where="post", color=c,
                lw=2.2 if s in flagged else 1.2, label=label)
        if show_fit:
            p = 1.0 / ra.mean_[s]
            ks = np.linspace(1, v.max(), 64)
            ax.plot(ks, (1.0 - p) ** ks, color=c, ls="--", lw=0.8,
                    zorder=1)
    ax.set_yscale("log")
    ax.set_xlabel("residence [frames]")
    ax.set_ylabel("P(residence > t)")
    ax.legend(fontsize="small")


@plotter(is3D=False)
def plot_structure_factor(sa, show_tau=True, fig=None, ax=None):
    """S(q) — and, on a twin axis, the per-shell relaxation time
    τ(q) — from a fitted
    :class:`~sitator_tpu_torch.dynamics.correlation.ScatteringAnalysis`;
    de Gennes narrowing shows as the τ(q) peak tracking the S(q)
    maximum.  Empty shells are skipped."""
    ok = np.asarray(sa.n_q_) > 0
    ax.plot(sa.q_[ok], sa.S_q_[ok], "o-", color="C0", label="S(q)")
    ax.axhline(1.0, color="0.7", lw=0.8, zorder=1)
    ax.set_xlabel("q")
    ax.set_ylabel("S(q)", color="C0")
    if show_tau and np.isfinite(sa.tau_q_[ok]).any():
        ax2 = ax.twinx()
        ax2.plot(sa.q_[ok], sa.tau_q_[ok], "s--", color="C3",
                 label="τ(q)")
        ax2.set_ylabel("τ(q)  [1/e time]", color="C3")


@plotter(is3D=False)
def plot_vdos(vs, show_gk=True, fig=None, ax=None):
    """Vibrational density of states — and, on a twin axis, the running
    Green–Kubo integral — from a fitted
    :class:`~sitator_tpu_torch.dynamics.vibrational.
    VibrationalSpectrumAnalysis`."""
    ax.plot(vs.freqs_, vs.vdos_, color="C0", label="VDOS")
    ax.set_xlabel("frequency  [cycles/time]")
    ax.set_ylabel("VDOS")
    if show_gk:
        # different x variable (lag time, not frequency) -> inset, not twinx
        ia = ax.inset_axes([0.55, 0.55, 0.42, 0.38])
        ia.plot(vs.times_, vs.D_gk_running_, color="C3", lw=1.0)
        ia.axhline(vs.D_gk_, color="C3", ls="--", lw=0.8)
        ia.set_title(f"D_GK(t) → {vs.D_gk_:.3g}", fontsize="small")
        ia.tick_params(labelsize="x-small")


@plotter(is3D=False)
def plot_conductivity_spectrum(ca, show_dc=True, fig=None, ax=None):
    """σ(ω) (log-log) — with the DC readouts marked — from a fitted
    :class:`~sitator_tpu_torch.dynamics.vibrational.
    ConductivitySpectrumAnalysis`."""
    ax.loglog(ca.freqs_[1:], ca.sigma_[1:], color="C0", label="σ(ω)")
    ax.set_xlabel("frequency  [cycles/time]")
    ax.set_ylabel("σ  [S/cm]")
    if show_dc:
        if np.isfinite(ca.sigma_dc_) and ca.sigma_dc_ > 0:
            ax.axhline(ca.sigma_dc_, color="C3", ls="--", lw=0.8,
                       label=f"σ_DC (GK) = {ca.sigma_dc_:.3g}")
        if (np.isfinite(ca.sigma_dc_spectral_)
                and ca.sigma_dc_spectral_ > 0):
            ax.axhline(ca.sigma_dc_spectral_, color="C2", ls=":",
                       lw=0.8,
                       label=f"σ_DC (spectral) = "
                             f"{ca.sigma_dc_spectral_:.3g}")
        ax.legend(fontsize="small")


@plotter(is3D=False)
def plot_barrier_profiles(pa, edges=None, max_profiles=12, fig=None,
                          ax=None):
    """Free-energy profiles F(s) along hop paths from a fitted
    :class:`~sitator_tpu_torch.dynamics.energetics.PathwayBarrierAnalysis`
    (``edges``: specific (i, j) pairs in either direction — a reversed
    pair is drawn from site j's end with F re-referenced to it;
    default: the ``max_profiles`` highest-barrier profiles)."""
    if edges is None:
        items = sorted(pa.profiles_.items(),
                       key=lambda kv: -float(np.nanmax(kv[1][1])))
        items = items[:max_profiles]
    else:
        items = []
        for i, j in edges:
            key = (min(i, j), max(i, j))
            if key not in pa.profiles_:
                raise ValueError(
                    f"no profile for edge ({i}, {j}) — off the jump "
                    "graph or its path crossed unsampled density")
            s, prof = pa.profiles_[key]
            if (i, j) != key:               # reversed request
                prof = prof[::-1] - prof[-1]
            items.append(((i, j), (s, prof)))
    for (i, j), (s, prof) in items:
        ax.plot(s, prof, lw=1.2, label=f"{i}→{j}")
    ax.set_xlabel("path coordinate  [length]")
    ax.set_ylabel("F  [eV]")
    ax.axhline(0.0, color="0.8", lw=0.6, zorder=0)
    # legend whenever the caller's requested budget allows labeling
    if edges is not None or len(items) <= max(max_profiles, 1):
        ax.legend(fontsize="x-small", ncol=2)


@plotter(is3D=False)
def plot_reactive_flux(tpa, sn, fig=None, ax=None, max_edges=80):
    """Reactive-flux network from a fitted
    :class:`~sitator_tpu_torch.dynamics.tpt.TransitionPathAnalysis`: every
    site at (forward committor, spread coordinate), the ``max_edges``
    strongest net-flux edges in gray (width ∝ flux), and the dominant
    pathways highlighted strongest-first.  The spread coordinate is the
    projection of the site centers onto their first principal axis —
    layout only, no physics."""
    q = tpa.q_plus_
    net = tpa.net_flux_
    centers = np.asarray(sn.centers, dtype=float)
    c0 = centers - centers.mean(axis=0)
    # first principal axis of the centers as the vertical spread
    _, _, vt = np.linalg.svd(c0, full_matrices=False)
    y = c0 @ vt[0]

    order = np.argsort(net, axis=None)[::-1]
    order = order[net.flat[order] > 0][:max_edges]
    wmax = float(net.flat[order[0]]) if len(order) else 1.0
    for k in order:
        i, j = divmod(int(k), len(net))
        ax.plot([q[i], q[j]], [y[i], y[j]], color="0.75",
                lw=0.5 + 3.5 * net[i, j] / wmax, zorder=1,
                solid_capstyle="round")
    w_max = max((w for _, w in tpa.pathways_), default=1.0)
    for rank, (path, width) in enumerate(tpa.pathways_):
        p = np.asarray(path)
        ax.plot(q[p], y[p], color=f"C{rank % 10}",
                lw=1.0 + 4.0 * width / w_max,
                zorder=2, solid_capstyle="round",
                label=f"#{rank + 1}: {'-'.join(map(str, path))}")

    # same relative liveness threshold as the committor attribute —
    # abandoned transients (pi at the power-iteration floor) must not
    # appear as phantom interior nodes
    pi = tpa.stationary_
    live = pi > 1e-9 * pi.max()
    mid = live & (q > 0) & (q < 1)
    ax.scatter(q[mid], y[mid], s=12 + 200 * tpa.stationary_[mid],
               color="0.45", zorder=3)
    src = np.zeros(len(q), bool)
    src[tpa.sources] = True
    snk = np.zeros(len(q), bool)
    snk[tpa.sinks] = True
    ax.scatter(q[src], y[src], s=70, marker="s", color="C0", zorder=4,
               label="A (sources)")
    ax.scatter(q[snk], y[snk], s=70, marker="D", color="C3", zorder=4,
               label="B (sinks)")
    ax.set_xlabel("forward committor  q⁺")
    ax.set_ylabel("site spread  [length]")
    ax.set_title(f"F = {tpa.rate_:.3g} reactive A→B "
                 "transitions/frame per ion")
    ax.legend(fontsize="x-small", loc="best")


@plotter(is3D=False)
def plot_van_hove(vh, part="self", fig=None, ax=None, cmap="viridis"):
    """Self (``part='self'``) or distinct (``'distinct'``) van Hove
    curves, one line per lag, from a fitted
    :class:`~sitator_tpu_torch.dynamics.correlation.VanHoveAnalysis`."""
    import matplotlib.pyplot as plt
    if part == "self":
        G = vh.G_self_
        ylabel = "P(r, t) = 4πr² G_s"
    elif part == "distinct":
        G = vh.G_distinct_
        ylabel = "G_d(r, t)"
    else:
        raise ValueError("part must be 'self' or 'distinct'")
    colors = plt.get_cmap(cmap)(np.linspace(0.15, 0.9, len(vh.lags)))
    for lag, curve, c in zip(vh.lags, G, colors):
        ax.plot(vh.r_, curve, color=c, label=f"t = {lag}")
    if part == "distinct":
        ax.axhline(1.0, color="0.7", lw=0.8, zorder=1)
    ax.set_xlabel("r")
    ax.set_ylabel(ylabel)
    ax.legend()


@plotter(is3D=False)
def plot_implied_timescales(ma, fig=None, ax=None, cmap="viridis"):
    """Implied relaxation timescales vs estimation lag from a fitted
    :class:`~sitator_tpu_torch.dynamics.markov.MarkovianityAnalysis` — the
    standard Markov-state-model validation plot: flat lines mean the
    site chain is Markovian, slow modes climbing with lag mean the
    sites alias hidden states.  The grey region ``t <= lag`` is
    unresolvable by construction."""
    import matplotlib.pyplot as plt
    lags = np.asarray(ma.lags_, dtype=float)
    T = ma.timescales_
    if T.shape[1] == 0:
        raise ValueError("no relaxation modes (fewer than two live "
                         "sites)")
    colors = plt.get_cmap(cmap)(np.linspace(0.15, 0.85, T.shape[1]))
    for k in range(T.shape[1]):
        ax.plot(lags, T[:, k], "o-", color=colors[k], ms=3.5,
                label=f"t{k + 1}")
    finite = T[np.isfinite(T) & (T > 0)]
    floor = 0.1 * min(float(finite.min()) if finite.size else lags[0],
                      lags[0])
    ax.fill_between([lags[0], lags[-1]], [lags[0], lags[-1]],
                    y2=floor, color="0.85", zorder=0)
    ax.plot([lags[0], lags[-1]], [lags[0], lags[-1]], color="0.6",
            lw=0.8, zorder=1)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("lag [frames]")
    ax.set_ylabel("implied timescale [frames]")
    ax.legend(fontsize="small", ncol=2)


@plotter(is3D=False)
def plot_ck_test(ma, fig=None, ax=None, cmap="viridis"):
    """Chapman–Kolmogorov panel from a fitted
    :class:`~sitator_tpu_torch.dynamics.markov.MarkovianityAnalysis`:
    measured set-residence probabilities (points, ±1σ window-deflated
    binomial error) against the base-lag model's prediction (dashed) —
    agreement within error at every lag validates the Markov model on
    its metastable sets."""
    import matplotlib.pyplot as plt
    if ma.ck_measured_.size == 0:
        raise ValueError("no Chapman–Kolmogorov data (lag grid has no "
                         "multiples of the base lag, or < 2 live "
                         "sites)")
    lags = np.asarray(ma.ck_lags_, dtype=float)
    n_sets = ma.ck_measured_.shape[0]
    colors = plt.get_cmap(cmap)(np.linspace(0.15, 0.85, n_sets))
    for s in range(n_sets):
        ax.errorbar(lags, ma.ck_measured_[s], yerr=ma.ck_stderr_[s],
                    fmt="o", color=colors[s], ms=4, capsize=2,
                    label=f"set {s} measured")
        ax.plot(lags, ma.ck_predicted_[s], "--", color=colors[s],
                lw=1.2, label=f"set {s} predicted")
    ax.set_xscale("log")
    ax.set_xlabel("lag [frames]")
    ax.set_ylabel("P(stay in set)")
    ax.set_ylim(0, 1.02)
    ax.legend(fontsize="x-small", ncol=2)
