"""Markov-model validation walkthrough — is the site picture trustworthy,
and how wrong could the rates be?

Beyond the reference's surface (upstream ``sitator`` reports point
estimates and never questions them).  Three tools, three questions:

1. ``MarkovianityAnalysis`` — is the site-resolution label chain even
   Markovian?  (Real MD never is at lag 1 — vibrational memory — the
   tool says at which lag the chain becomes usable.)
2. ``MergeSitesByMetastability`` — are sites over-split?  On a healthy
   network it must *withhold* (shown); on a split-site basis it
   reassembles the kinetic basins exactly (shown on an explicit
   synthetic refinement, the transparent stand-in for an over-eager
   density seeding).
3. ``ChainUncertaintyAnalysis`` — what does the finite trajectory
   actually pin down?  Credible intervals on timescales and per-edge
   rates.

Run:  python3 -m sitator_tpu_torch.examples.msm_validation
      [--device {cuda,cpu}]
"""
import sys

try:
    from sitator_tpu_torch.examples import _common
except ImportError:                     # run as a file from a checkout
    import _common

import numpy as np

from sitator_tpu_torch import SiteNetwork, SiteTrajectory
from sitator_tpu_torch.dynamics import (
    ChainUncertaintyAnalysis,
    JumpAnalysis,
    MarkovianityAnalysis,
    MergeSitesByMetastability,
    edge_probability_intervals,
)
from sitator_tpu_torch.io import make_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "msm_validation"


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device

    # --- 1. hopping MD + the standard pipeline
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=8000,
                                 jump_rate=0.01, seed=11)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn = VoronoiSiteGenerator(verbose=False).run(sn)
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False, device=dev).run(sn, md.traj)
    JumpAnalysis(verbose=False, device=dev).run(st)
    S = st.site_network.n_sites
    print(f"pipeline: {md.n_frames} frames, {md.n_ions} ions -> {S} sites")

    # --- 2. is the chain Markovian at these sites?  At lag 1 real MD
    # keeps vibrational memory; the implied-timescale test finds the lag
    # where the site chain becomes a faithful Markov model.
    ma = MarkovianityAnalysis(verbose=False).run(st)
    print(f"markovianity at lag 1: "
          f"{'Markovian' if ma.markovian_ else 'NON-Markovian'} "
          f"(slowest timescale drift "
          f"{100 * ma.timescale_drift_[0]:+.0f}% over lags "
          f"{ma.lags_[0]}..{ma.lags_[-1]})")
    print(f"recommended estimation lag: {ma.recommended_lag_} frames "
          "(where the slowest implied timescale has converged)")

    # --- 3a. the metastability merger on the REAL pipeline output: the
    # clustering genuinely over-split one of the 27 body-center sites into
    # two clusters (28 found) — the timescale-separation criterion catches
    # exactly that one split and nothing else
    ms = MergeSitesByMetastability(verbose=False, device=dev)
    st = ms.run(st)
    print(f"metastability merge on the pipeline output: separation "
          f"{ms.separation_:.0f}x -> {st.site_network.n_sites} sites "
          f"(the true body-center count)")
    assert st.site_network.n_sites == 27
    S = 27
    JumpAnalysis(verbose=False, device=dev).run(st)

    # ...and on the now-healthy network it must NOT cry wolf: withheld
    ms_again = MergeSitesByMetastability(verbose=False, device=dev)
    st_same = ms_again.run(st)
    assert st_same.site_network.n_sites == S
    print(f"re-run on the fixed network: merge withheld (best separation "
          f"{ms_again.separation_:.1f}x < {ms_again.min_separation:.0f}x) "
          f"— {S} sites kept")

    # --- 3b. ...and must fix a genuinely over-split basis.  Emulate an
    # over-eager refinement: every site split into a ±0.4 Å pair, the ion
    # flickering between the two pseudo-sites every few frames (what a
    # split-site seeding would measure).
    rng = np.random.default_rng(0)
    labels = np.asarray(st.traj)
    sub = rng.integers(0, 2, size=labels.shape).astype(np.int32)
    flip = rng.uniform(size=labels.shape) < 0.3      # fast intra-pair hops
    sub = np.where(flip, 1 - sub, sub)
    split_labels = np.where(labels >= 0, 2 * labels + sub, -1).astype(
        np.int32)
    delta = np.array([0.4, 0.0, 0.0])
    split_centers = np.empty((2 * S, 3))
    split_centers[0::2] = st.site_network.centers - delta
    split_centers[1::2] = st.site_network.centers + delta
    sn_split = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn_split.centers = split_centers
    st_split = SiteTrajectory(sn_split, split_labels)
    ja_split = JumpAnalysis(verbose=False, device=dev)
    ja_split.run(st_split)
    print(f"over-split basis: {2 * S} pseudo-sites, "
          f"{ja_split.n_jumps} apparent jumps (flicker-inflated)")

    ms2 = MergeSitesByMetastability(verbose=False, device=dev)
    st_fixed = ms2.run(st_split)
    print(f"metastability merge: separation {ms2.separation_:.0f}x -> "
          f"{st_fixed.site_network.n_sites} basins")
    # the recovered partition is exactly the original site decomposition:
    # each pseudo-site pair maps back to one original site
    pair_of = ms2.labels_.reshape(S, 2)
    lab0 = pair_of[:, 0]
    assert np.all((pair_of[:, 0] == pair_of[:, 1]) | (pair_of[:, 0] < 0)
                  | (pair_of[:, 1] < 0))
    visited = lab0[lab0 >= 0]
    assert len(np.unique(visited)) == len(visited)   # no two sites fused
    print("recovered partition == the original site decomposition "
          "(every pair reunited, no distinct sites fused)")
    ja_fixed = JumpAnalysis(verbose=False, device=dev)
    ja_fixed.run(st_fixed)
    print(f"jump count restored: {ja_fixed.n_jumps} "
          f"(was {ja_split.n_jumps} on the split basis)")

    # --- 4. what does the finite trajectory pin down?
    ua = ChainUncertaintyAnalysis(observables=("timescales", "stationary"),
                                  n_samples=300, seed=0, verbose=False,
                                  device=dev).run(st)
    t_lo, t_hi = ua.ci_["timescales"]
    print(f"slowest relaxation: {ua.mean_['timescales'][0]:.0f} frames, "
          f"95% CI [{t_lo[0]:.0f}, {t_hi[0]:.0f}] (300 posterior draws)")
    lo, hi = edge_probability_intervals(st, device=dev)
    n_ij = np.asarray(st.site_network.n_ij).copy()
    np.fill_diagonal(n_ij, 0)
    i, j = np.unravel_index(np.argmax(n_ij), n_ij.shape)
    print(f"busiest edge {i}->{j}: {int(n_ij[i, j])} jumps, per-frame "
          f"rate in [{lo[i, j]:.2e}, {hi[i, j]:.2e}] (95% credible)")
    print("MSM validation walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
