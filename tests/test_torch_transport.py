"""The port's transport engines against the JAX package's, on the CPU:
``DiffusionAnalysis``, ``SiteDiffusionAnalysis``, ``RelaxationAnalysis``,
``OnsagerAnalysis``, ``AverageVibrationalFrequency``,
``VibrationalSpectrumAnalysis`` and ``ConductivitySpectrumAnalysis``, each
through the SiteTrajectory route and the raw-trajectory route, on the
same seeded synthetic hopping MD (the generators are bit-equal by seed).
Also: every entry point of the slice that touches the device defaults to
``device="cuda"`` and does not fall back to the CPU.

Tolerance: host float64 NumPy in both packages — every fitted attribute
to 1e-12 relative."""
import inspect

import numpy as np
import pytest
import torch

import sitator_tpu.dynamics as rdyn
import sitator_tpu.io as rio
import sitator_tpu_torch.dynamics as pdyn
import sitator_tpu_torch.io as pio

from tests._torch_common import (assert_same_results,
                                 first_math_calls_on_one_thread,
                                 networks_of, trajectories)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

RTOL = 1e-12


@pytest.fixture(scope="module")
def hopping():
    """(reference st, port st, md) with JumpAnalysis run in both packages
    on the true site labels."""
    md = rio.make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6,
                                     n_frames=240, jump_rate=0.05, seed=21)
    md_port = pio.make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6,
                                          n_frames=240, jump_rate=0.05,
                                          seed=21)
    np.testing.assert_array_equal(md_port.traj, md.traj)
    sns = networks_of(md, centers=md.true_sites)
    st_ref, st = trajectories(sns, md.true_assignments, md.traj)
    rdyn.JumpAnalysis(verbose=False).run(st_ref)
    pdyn.JumpAnalysis(verbose=False, device="cpu").run(st)
    assert_same_results(st_ref.site_network, st.site_network)
    return st_ref, st, md


def _both(name, hopping, kw, route="st", **run_kw):
    st_ref, st, md = hopping
    want = getattr(rdyn, name)(verbose=False, **kw)
    got = getattr(pdyn, name)(verbose=False, **kw)
    a, b = (st_ref, st) if route == "st" else (md.traj, md.traj)
    # (engine, what run returned) of each package: some engines return
    # themselves, some a value, some the trajectory
    return (want, want.run(a, **run_kw)), (got, got.run(b, **run_kw))


DIFFUSION = [
    ("DiffusionAnalysis", dict(timestep=0.5)),
    ("DiffusionAnalysis", dict(timestep=0.5, temperature=600.0, charge=2.0,
                               fit_range=(0.1, 0.6), exact_unwrap=True)),
    ("DiffusionAnalysis", dict(drift_correction="static")),
    ("RelaxationAnalysis", dict(q=1.5, lags=[0, 1, 5, 20, 80],
                                origin_stride=2)),
    ("RelaxationAnalysis", dict(q=2.2, timestep=0.1,
                                drift_correction="static")),
    ("AverageVibrationalFrequency", dict(timestep=0.5)),
    ("AverageVibrationalFrequency", dict(freq_cut=(0.05, 0.3))),
    ("VibrationalSpectrumAnalysis", dict(timestep=0.5, max_lag=60)),
    ("VibrationalSpectrumAnalysis", dict(integral_window=(0.2, 0.6))),
]


@pytest.mark.parametrize("name,kw", DIFFUSION,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(DIFFUSION)])
def test_single_species_engines_on_the_site_trajectory(name, kw, hopping):
    assert_same_results(*_both(name, hopping, kw), rtol=RTOL)


@pytest.mark.parametrize("name", ["DiffusionAnalysis", "RelaxationAnalysis",
                                  "AverageVibrationalFrequency",
                                  "VibrationalSpectrumAnalysis"])
def test_single_species_engines_on_a_raw_trajectory(name, hopping):
    md = hopping[2]
    kw = {"q": 1.5} if name == "RelaxationAnalysis" else {}
    assert_same_results(*_both(name, hopping, kw, route="raw",
                               mobile_mask=md.mobile_mask,
                               cell=md.structure.cell), rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(timestep=0.5),
                                dict(fit_range=(0.02, 0.2))])
def test_site_diffusion(kw, hopping):
    assert_same_results(*_both("SiteDiffusionAnalysis", hopping, kw),
                        rtol=RTOL)


def _groups(md):
    mob = np.flatnonzero(md.mobile_mask)
    a = np.zeros_like(md.mobile_mask)
    a[mob[:3]] = True
    return a, md.mobile_mask & ~a


@pytest.mark.parametrize("kw", [
    dict(),
    dict(temperature=500.0, charges=[1.0, -1.0], timestep=0.5),
    dict(drift_correction="all"),
    dict(drift_correction="static", exact_unwrap=True)])
def test_onsager(kw, hopping):
    st_ref, st, md = hopping
    groups = _groups(md)
    assert_same_results(*_both("OnsagerAnalysis", hopping,
                               dict(groups=groups, **kw)), rtol=RTOL)
    if kw.get("drift_correction") is None:
        assert_same_results(*_both("OnsagerAnalysis", hopping,
                                   dict(groups=groups, **kw), route="raw",
                                   cell=md.structure.cell), rtol=RTOL)
    # named selections through the SiteTrajectory
    assert_same_results(*_both("OnsagerAnalysis", hopping,
                               dict(groups=["mobile"])), rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(charges=[1.0, 1.0]),
    dict(charges=[1.0, -2.0], timestep=0.5, temperature=700.0,
         n_segments=3, integral_window=(0.05, 0.2))])
def test_conductivity_spectrum(kw, hopping):
    md = hopping[2]
    groups = _groups(md)
    assert_same_results(*_both("ConductivitySpectrumAnalysis", hopping,
                               dict(groups=groups, **kw)), rtol=RTOL)
    assert_same_results(*_both("ConductivitySpectrumAnalysis", hopping,
                               dict(groups=groups, **kw), route="raw",
                               cell=md.structure.cell), rtol=RTOL)


def test_validation_matches_reference(hopping):
    md = hopping[2]
    traj = md.traj
    for dyn in (rdyn, pdyn):
        with pytest.raises(ValueError, match="fit_range"):
            dyn.DiffusionAnalysis(fit_range=(0.5, 0.2))
        with pytest.raises(ValueError, match="mobile_mask and cell"):
            dyn.DiffusionAnalysis(verbose=False).run(traj)
        with pytest.raises(ValueError, match="at least 8 frames"):
            dyn.DiffusionAnalysis(verbose=False).run(
                traj[:4], mobile_mask=md.mobile_mask, cell=md.structure.cell)
        with pytest.raises(ValueError, match="q must be positive"):
            dyn.RelaxationAnalysis(q=0.0)
        with pytest.raises(ValueError, match="at least one species group"):
            dyn.OnsagerAnalysis([])
        with pytest.raises(ValueError, match="one entry per group"):
            dyn.OnsagerAnalysis([md.mobile_mask], charges=[1.0, 2.0])
        with pytest.raises(ValueError, match="overlap"):
            dyn.OnsagerAnalysis([md.mobile_mask, md.mobile_mask],
                                verbose=False).run(traj,
                                                   cell=md.structure.cell)
        with pytest.raises(ValueError, match="n_segments"):
            dyn.ConductivitySpectrumAnalysis([md.mobile_mask], [1.0],
                                             n_segments=0)
        with pytest.raises(ValueError, match="integral_window"):
            dyn.VibrationalSpectrumAnalysis(integral_window=(0.5, 0.2))


DEVICE_ENTRY_POINTS = [
    ("sitator_tpu_torch.ops.correlation", "rdf"),
    ("sitator_tpu_torch.ops.correlation", "van_hove_distinct"),
    ("sitator_tpu_torch.ops.scattering", "collective_density_modes"),
    ("sitator_tpu_torch.ops.scattering", "static_structure_factor"),
    ("sitator_tpu_torch.ops.scattering", "coherent_scattering"),
    ("sitator_tpu_torch.dynamics", "RDFAnalysis"),
    ("sitator_tpu_torch.dynamics", "VanHoveAnalysis"),
    ("sitator_tpu_torch.dynamics", "ScatteringAnalysis"),
    ("sitator_tpu_torch.dynamics", "KineticMonteCarlo"),
    ("sitator_tpu_torch.dynamics", "PathwayBarrierAnalysis"),
]


@pytest.mark.parametrize("module,name", DEVICE_ENTRY_POINTS,
                         ids=[n for _, n in DEVICE_ENTRY_POINTS])
def test_device_entry_points_default_to_cuda(module, name):
    import importlib
    obj = getattr(importlib.import_module(module), name)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only "
                    "torch: checks that the default device is not swapped")
def test_no_fallback_to_the_cpu_without_cuda(hopping):
    st = hopping[1]
    md = hopping[2]
    cell = md.structure.cell
    calls = [
        lambda: pdyn.RDFAnalysis(verbose=False).run(st),
        lambda: pdyn.VanHoveAnalysis(lags=(0, 1), verbose=False).run(st),
        lambda: pdyn.ScatteringAnalysis(q_max=2.0, verbose=False).run(st),
        lambda: pdyn.KineticMonteCarlo(n_walkers=2, n_frames=3,
                                       verbose=False).run(st.site_network),
        lambda: pdyn.PathwayBarrierAnalysis(300.0, n_bins=8,
                                            verbose=False).run(st),
    ]
    from sitator_tpu_torch.ops import correlation, scattering
    calls += [
        lambda: correlation.rdf(md.traj, cell, md.mobile_mask),
        lambda: scattering.collective_density_modes(
            md.traj, cell, md.mobile_mask, np.eye(3, dtype=np.int32)),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
