"""Diffusion kinetics walkthrough — from a site analysis to transport
coefficients.

Beyond the reference's surface (upstream ``sitator`` stops at jump
statistics): tracer and collective diffusivities from the FFT
time-origin-averaged MSD, the Haven ratio, a Nernst–Einstein
conductivity estimate, and the site-discretization cross-check
(``SiteDiffusionAnalysis`` runs the same estimator on the ion-at-its-
site-center path — close agreement means the discrete site/jump picture
carries the transport physics).

Run:  python3 -m sitator_tpu_torch.examples.diffusion_kinetics
      [--device {cuda,cpu}]
"""
import sys

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork
from sitator_tpu_torch.dynamics import (
    ConcertedJumpAnalysis,
    ConductivitySpectrumAnalysis,
    DiffusionAnalysis,
    JumpAnalysis,
    KineticMonteCarlo,
    ScatteringAnalysis,
    SiteDiffusionAnalysis,
    VibrationalSpectrumAnalysis,
)
from sitator_tpu_torch.dynamics.kmc import transition_matrix_from_network
from sitator_tpu_torch.io import make_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "diffusion_kinetics"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device

    # --- 1. a hopping trajectory with known kinetics (lattice constant
    # a=4 Å, nominal jump rate 0.05/frame; treat frames as ps for
    # demonstration)
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=4000,
                                 jump_rate=0.05, seed=42)
    print(f"system: {md.structure}, {md.n_frames} frames, {md.n_ions} ions")

    # --- 2. site analysis as usual
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn = VoronoiSiteGenerator(merge_tol=0.05).run(sn)
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False, device=dev).run(sn, md.traj)
    st.set_real_traj(md.traj)
    ja = JumpAnalysis(verbose=False, device=dev)
    ja.run(st)
    print(f"sites: {st.site_network.n_sites}, jumps observed: {ja.n_jumps}")

    # --- 3. transport coefficients from the real trajectory
    da = DiffusionAnalysis(timestep=1.0,        # ps between frames
                           temperature=600.0,   # K, for Nernst-Einstein
                           charge=1.0,          # e (Li+)
                           verbose=False).run(st)
    print(f"D_tracer     = {da.D_tracer_:.4g} ± {da.D_tracer_err_:.2g} "
          "Å²/ps")
    print(f"D_collective = {da.D_collective_:.4g} Å²/ps   "
          f"(Haven ratio {da.haven_ratio_:.3g})")
    print(f"sigma(600 K) = {da.conductivity_:.4g} S/cm  [Nernst-Einstein]")

    # --- 4. cross-check against the site-discretized path: how much of
    # the kinetics does the discrete site/jump description carry?
    sd = SiteDiffusionAnalysis(timestep=1.0, verbose=False).run(st)
    ratio = sd.D_site_ / da.D_tracer_
    print(f"D_site       = {sd.D_site_:.4g} Å²/ps   "
          f"(D_site/D_tracer = {ratio:.3g})")
    assert 0.5 < ratio < 2.0, "site discretization lost the kinetics?"

    # --- 5. sanity: random-walk theory for this lattice. Ions hop between
    # body-center sites a=4 Å apart; an ideal 3-D walk with hop length L
    # and realized per-frame rate G has D = G * L^2 / 6. Use the
    # generator's ground-truth hop count (JumpAnalysis additionally sees
    # boundary flickers, which carry no net displacement).
    true_hops = md.true_n_ij.sum() - np.trace(md.true_n_ij)
    G = true_hops / (md.n_frames * md.n_ions)
    D_theory = G * 4.0 ** 2 / 6.0
    print(f"random-walk theory: D = {D_theory:.4g} Å²/ps "
          f"(measured/theory = {da.D_tracer_ / D_theory:.3g})")
    assert 0.7 < da.D_tracer_ / D_theory < 1.3

    # --- 6. correlation factor: SiteDiffusionAnalysis also reports the
    # uncorrelated jump-rate estimate D_jump = Σ n_ij·|ℓ_ij|²/(6MT) and
    # f = D_site/D_jump.  Uncorrelated hopping (this system) gives f ≈ 1;
    # back-correlated motion (flicker, correlated returns) gives f < 1.
    print(f"D_jump       = {sd.D_jump_:.4g} Å²/ps   "
          f"(correlation factor f = {sd.f_:.3g})")
    assert 0.6 < sd.f_ < 1.4

    # --- 7. kinetic Monte Carlo closure: resample the measured Markov
    # chain (P[i,j] = n_ij/t_i, a Gumbel-max walk on the device from a
    # seeded torch.Generator) with 4x the walkers and frames, and check the
    # re-measured statistics agree — the whole site decomposition is
    # self-consistent, and rare-event statistics can be tightened without
    # more MD.
    kmc = KineticMonteCarlo(n_walkers=4 * md.n_ions,
                            n_frames=4 * md.n_frames, seed=0,
                            verbose=False, device=dev)
    st_kmc = kmc.run(st.site_network)
    JumpAnalysis(verbose=False, device=dev).run(st_kmc)
    P_md = transition_matrix_from_network(st.site_network)
    P_kmc = transition_matrix_from_network(st_kmc.site_network)
    closure = np.abs(P_kmc - P_md).max()
    print(f"KMC closure: max |P_resampled - P_measured| = {closure:.4f} "
          f"({kmc.n_walkers} walkers x {kmc.n_frames} frames)")
    assert closure < 0.02

    # --- 8. cooperativity: group jumps into events via site handoffs.
    # This generator rejects hops into occupied sites, so real cooperation
    # is absent — the measured fraction is the chance-coincidence
    # baseline, the same thing a KMC resample (independent walkers) would
    # show.  In a real superionic conductor, MD cooperativity far above
    # the KMC baseline is the signature of string-like migration.
    cja = ConcertedJumpAnalysis(window=1, verbose=False)
    cja.run(st)
    print(f"cooperativity: {100 * cja.cooperativity_fraction_:.1f}% of "
          f"{cja.n_jumps_} jumps in multi-ion events "
          f"({cja.n_ring_events_} rings, {cja.n_chain_events_} chains)")

    # --- 9. directional hop correlation: consecutive jump vectors straight
    # from the label stream — an estimator of f independent of D fits.
    print(f"jump-vector correlation: <cos theta> = {sd.cos_theta_:.3f}, "
          f"f_angular = {sd.f_angular_:.3g} "
          f"({sd.n_jump_vector_pairs_} pairs)")

    # --- 10. anisotropy: the diffusion tensor from the same MSD
    # machinery.  This cubic lattice is isotropic, but with only 6 ions
    # the per-direction fits are noisy and eigenvalues always spread under
    # noise (eigenvalue repulsion) — trust the ratio only when it is large
    # compared to the relative error of D_tracer_ itself.  The trace is
    # exact: trace/3 == D_tracer (same estimator, same window).
    aniso = (f"{da.anisotropy_:.3g}" if np.isfinite(da.anisotropy_)
             else "n/a")
    print(f"D tensor eigvals = {np.round(da.D_eigvals_, 4)} Å²/ps "
          f"(apparent anisotropy {aniso}; trace/3 = "
          f"{np.trace(da.D_tensor_) / 3:.4g})")
    assert abs(np.trace(da.D_tensor_) / 3 - da.D_tracer_) < 1e-9

    # --- 11. what a scattering experiment would see: S(q) and the
    # coherent intermediate scattering function on the
    # lattice-commensurate q-grid (exact under PBC), plus the vibrational
    # spectrum and the Green–Kubo diffusivity from the VACF.
    sa = ScatteringAnalysis(q_max=2.5, n_shells=4, timestep=1.0,
                            verbose=False, device=dev).run(st)
    print("S(q) shells:", np.round(sa.S_q_, 2),
          "| tau_q:", np.round(sa.tau_q_, 1))
    vs = VibrationalSpectrumAnalysis(timestep=1.0, max_lag=800,
                                     integral_window=(0.05, 0.3),
                                     verbose=False).run(st)
    peak_f = vs.freqs_[int(np.argmax(vs.vdos_))]
    print(f"VDOS peak at {peak_f:.3f} cycles/ps; "
          f"D_GK = {vs.D_gk_:.4g} Å²/ps "
          f"(D_GK/D_tracer = {vs.D_gk_ / da.D_tracer_:.3g})")
    assert 0.3 < vs.D_gk_ / da.D_tracer_ < 3.0

    # --- 12. is the run even usable?  Built-in equilibration diagnostics:
    # the MSD log-log exponent (diffusive ~1) and the split-half
    # stationarity ratio (stationary ~1).
    print(f"equilibration: MSD exponent {da.msd_exponent_:.2f}, "
          f"split-half D2/D1 = {da.stationarity_ratio_:.2f}")
    assert 0.8 < da.msd_exponent_ < 1.2

    # --- 13. thermostat drift would silently inflate all of the above.
    # Inject a rigid drift, watch D blow up, then pin the analysis to the
    # host-lattice frame (drift_correction='static') and recover.
    drift = np.arange(md.n_frames)[:, None] * np.array([0.04, -0.02, 0.03])
    frac = (md.traj + drift[:, None, :]) @ np.linalg.inv(md.structure.cell)
    drifted = (frac - np.floor(frac)) @ md.structure.cell
    da_raw = DiffusionAnalysis(timestep=1.0, verbose=False).run(
        drifted, mobile_mask=md.mobile_mask, cell=md.structure.cell)
    da_fix = DiffusionAnalysis(timestep=1.0, drift_correction="static",
                               verbose=False).run(
        drifted, mobile_mask=md.mobile_mask, cell=md.structure.cell)
    print(f"drift demo: lab-frame D = {da_raw.D_tracer_:.4g} (exponent "
          f"{da_raw.msd_exponent_:.2f} — contaminated), host-frame D = "
          f"{da_fix.D_tracer_:.4g} vs clean {da.D_tracer_:.4g}")
    assert abs(da_fix.D_tracer_ - da.D_tracer_) < 0.05 * da.D_tracer_

    # --- 14. the AC conductivity spectrum sigma(omega) from the
    # Green-Kubo charge current — what impedance spectroscopy measures;
    # its DC plateau is the pairing-aware Onsager conductivity.
    ca = ConductivitySpectrumAnalysis([md.mobile_mask], charges=[1.0],
                                      timestep=1.0, temperature=600.0,
                                      verbose=False).run(
        md.traj, cell=md.structure.cell)
    print(f"sigma(omega): DC plateau {ca.sigma_dc_:.3g} S/cm (spectral "
          f"readout {ca.sigma_dc_spectral_:.3g}); vibrational peak at "
          f"{ca.freqs_[1 + int(np.argmax(ca.sigma_[1:]))]:.3f} cycles/ps")
    assert (ca.sigma_ >= 0).all()
    print("Diffusion walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
