"""Plotting on matplotlib (counterpart of ``sitator_tpu.visualization``):
the 3-D structure and site-network plots, the ``SiteTrajectory`` plot
helpers and the 2-D kinetics plots.  matplotlib is imported when a plot is
drawn, not when this package is imported."""
from sitator_tpu_torch.visualization.common import (
    layers,
    plotter,
    species_color,
)
from sitator_tpu_torch.visualization.atoms import plot_atoms, plot_points
from sitator_tpu_torch.visualization.network_plot import (
    SiteNetworkPlotter,
    plot_frame,
    plot_particle_trajectory,
    plot_site,
)
from sitator_tpu_torch.visualization.kinetics import (
    plot_arrhenius,
    plot_msd,
    plot_rdf,
    plot_residence_survival,
    plot_structure_factor,
    plot_van_hove,
    plot_vdos,
    plot_conductivity_spectrum,
    plot_barrier_profiles,
    plot_reactive_flux,
    plot_implied_timescales,
    plot_ck_test,
)

__all__ = [
    "plotter", "layers", "species_color", "plot_atoms", "plot_points",
    "SiteNetworkPlotter", "plot_frame", "plot_site",
    "plot_particle_trajectory", "plot_msd", "plot_arrhenius", "plot_rdf",
    "plot_van_hove", "plot_residence_survival",
    "plot_structure_factor", "plot_vdos",
    "plot_conductivity_spectrum", "plot_barrier_profiles",
    "plot_reactive_flux", "plot_implied_timescales", "plot_ck_test",
]
