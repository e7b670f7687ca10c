"""The port's ``ops/msd.py`` against the JAX package's, on the CPU: every
estimator (MSD, displacement tensor, cross-MSD, VACF, collective MSD, lag
statistics, displacement moments, self-intermediate scattering, drift,
diffusivity fit) on the same seeded trajectories.

Tolerance: both packages run the same host float64 NumPy code on the same
inputs, so every result is held to 1e-12 relative."""
import numpy as np
import pytest
import torch

from sitator_tpu.ops import msd as ref_msd
from sitator_tpu_torch.ops import msd as port_msd

from tests._torch_common import assert_same_results

torch.set_num_threads(2)

RTOL = 1e-12


def _walk(seed, F=97, N=5, scale=0.3):
    rng = np.random.default_rng(seed)
    steps = rng.normal(scale=scale, size=(F, N, 3))
    return np.cumsum(steps, axis=0) + rng.uniform(0, 5, size=(1, N, 3))


def _cell(triclinic):
    cell = np.diag([6.0, 7.0, 8.0])
    if triclinic:
        cell = cell + np.array([[0, 1.1, 0.4], [0, 0, 0.9], [0, 0, 0]])
    return cell


def _wrapped(pos, cell):
    frac = pos @ np.linalg.inv(cell)
    return (frac - np.floor(frac)) @ cell


def test_all_of_the_reference_is_ported():
    assert port_msd.__all__ == ref_msd.__all__


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["msd_fft", "collective_msd_fft",
                                  "vacf_fft"])
def test_single_input_estimators(name, seed):
    pos = _walk(seed)
    assert_same_results(getattr(ref_msd, name)(pos),
                        getattr(port_msd, name)(pos), RTOL, name)


@pytest.mark.parametrize("per_atom_trace", [False, True])
def test_msd_tensor_fft(per_atom_trace):
    pos = _walk(2, F=64)
    assert_same_results(ref_msd.msd_tensor_fft(pos, per_atom_trace),
                        port_msd.msd_tensor_fft(pos, per_atom_trace), RTOL)


def test_cross_msd_fft():
    a, b = _walk(3)[:, 0], _walk(4)[:, 1]
    assert_same_results(ref_msd.cross_msd_fft(a, b),
                        port_msd.cross_msd_fft(a, b), RTOL)


@pytest.mark.parametrize("q", [None, 1.7])
@pytest.mark.parametrize("stride", [1, 3])
def test_lag_statistics(q, stride):
    pos = _walk(5)
    lags = [0, 1, 4, 16, 50]
    assert_same_results(ref_msd.lag_statistics(pos, lags, stride, q),
                        port_msd.lag_statistics(pos, lags, stride, q), RTOL)
    assert_same_results(
        ref_msd.displacement_moments(pos, lags, stride),
        port_msd.displacement_moments(pos, lags, stride), RTOL)
    if q is not None:
        assert_same_results(
            ref_msd.self_intermediate_scattering(pos, q, lags, stride),
            port_msd.self_intermediate_scattering(pos, q, lags, stride),
            RTOL)


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_drift_curve(triclinic, use_mask):
    cell = _cell(triclinic)
    traj = _wrapped(_walk(6, N=7), cell)
    mask = (np.arange(7) % 2 == 0) if use_mask else None
    for exact in (False, True):
        assert_same_results(
            ref_msd.drift_curve(traj, cell, mask, exact),
            port_msd.drift_curve(traj, cell, mask, exact), RTOL)


@pytest.mark.parametrize("fit_range", [(0.2, 0.5), (0.02, 0.2)])
def test_fit_diffusivity_and_window(fit_range):
    pos = _walk(7, F=200)
    times = np.arange(200) * 0.5
    curve = ref_msd.msd_fft(pos)[0]
    assert_same_results(ref_msd.fit_diffusivity(times, curve, fit_range),
                        port_msd.fit_diffusivity(times, curve, fit_range),
                        RTOL)
    for F in (3, 10, 200):
        assert port_msd.fit_window(F, fit_range) == \
            ref_msd.fit_window(F, fit_range)


def test_errors_match():
    pos = _walk(8, F=10)
    for pkg in (ref_msd, port_msd):
        with pytest.raises(ValueError, match="outside"):
            pkg.lag_statistics(pos, [10])
        with pytest.raises(ValueError, match="positive"):
            pkg.lag_statistics(pos, [1], q=0.0)
        with pytest.raises(ValueError, match="selects no atoms"):
            pkg.drift_curve(pos, np.eye(3) * 9, np.zeros(5, bool))
        with pytest.raises(ValueError, match="must be"):
            pkg.drift_curve(pos, np.eye(3) * 9, np.ones(4, bool))
