"""Temperature-series walkthrough — from independent runs to activation
energies, site-by-site.

Beyond the reference's surface (upstream ``sitator`` analyzes one
trajectory at a time): analyze each temperature's MD independently,
identify which site is which across the runs (`network.match_sites` —
independent analyses number sites independently!), then fit

- the scalar Arrhenius law on the tracer diffusivity
  (`ArrheniusAnalysis`), and
- the per-jump-pathway barriers `Ea_ij` across the site-matched
  networks (`EdgeArrheniusAnalysis`).

The hopping generator's jump rate is programmed to follow
``k(T) = nu exp(-Ea/kB T)``, so both fits have a known ground truth.

Run:  python3 -m sitator_tpu_torch.examples.temperature_series
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
    ArrheniusAnalysis,
    DiffusionAnalysis,
    EdgeArrheniusAnalysis,
    JumpAnalysis,
    RemoveUnoccupiedSites,
)
from sitator_tpu_torch.io import make_hopping_trajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.network import compare_site_networks
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

NAME = "temperature_series"
KB = 8.617333262e-5                    # eV/K
EA_TRUE, NU = 0.25, 0.5                # programmed barrier and prefactor


def main(argv=None):
    args = _common.parse_args(NAME, __doc__, argv)
    if _common.device_missing(NAME, args.device):
        return 1
    dev = args.device

    # --- 1. one full, independent analysis per temperature
    series, D, D_err = [], [], []
    for i, T in enumerate([700.0, 900.0, 1200.0]):
        rate = NU * np.exp(-EA_TRUE / (KB * T))
        md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=8,
                                     n_frames=12000, jump_rate=rate,
                                     seed=30 + i)
        sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
        sn = VoronoiSiteGenerator().run(sn)
        st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                              verbose=False, device=dev).run(sn, md.traj)
        st = RemoveUnoccupiedSites().run(st)
        JumpAnalysis(verbose=False, device=dev).run(st)
        st.set_real_traj(md.traj)
        da = DiffusionAnalysis(timestep=1.0, verbose=False).run(st)
        series.append((T, st.site_network))
        D.append(da.D_tracer_)
        D_err.append(da.D_tracer_err_)
        print(f"T={T:.0f} K: {st.site_network.n_sites} sites, "
              f"D = {da.D_tracer_:.4g} ± {da.D_tracer_err_:.2g} Å²/frame")

    # --- 2. which site is which?  independent runs number sites
    # independently; match everything onto the first network
    for k in (1, 2):
        rep = compare_site_networks(series[0][1], series[k][1], cutoff=2.0)
        print(f"site match {series[0][0]:.0f}K <-> {series[k][0]:.0f}K: "
              f"{rep['n_matched']} matched, mean offset "
              f"{rep['mean_distance']:.3f} Å")

    # --- 3. scalar Arrhenius on the tracer diffusivity
    aa = ArrheniusAnalysis(verbose=False).run([t for t, _ in series], D,
                                              errors=D_err)
    print(f"tracer-D Arrhenius: Ea = {aa.Ea_ev_:.3f} ± "
          f"{aa.Ea_err_ev_:.3f} eV (true {EA_TRUE})")
    assert abs(aa.Ea_ev_ - EA_TRUE) < 3 * aa.Ea_err_ev_ + 0.03

    # --- 4. per-pathway barriers across the matched networks
    ea = EdgeArrheniusAnalysis(min_counts=5, match_cutoff=2.0,
                               verbose=False).run(series)
    fitted = int(np.isfinite(ea.Ea_ij_).sum())
    print(f"edge Arrhenius: {fitted} pathways fitted, median Ea = "
          f"{np.nanmedian(ea.Ea_ij_):.3f} eV, site-level median = "
          f"{np.nanmedian(ea.Ea_site_):.3f} eV (true {EA_TRUE})")
    assert fitted >= 10
    assert abs(np.nanmedian(ea.Ea_site_) - EA_TRUE) < 0.05
    # Ea_ij / Ea_site now live on the reference network as attributes, so
    # SiteNetworkPlotter can color edges by barrier out of the box
    assert "Ea_ij" in series[0][1].edge_attributes
    print("Temperature-series walkthrough complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
