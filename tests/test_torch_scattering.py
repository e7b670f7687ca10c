"""The port's scattering functions (``ops/scattering.py``) and
``ScatteringAnalysis`` against the JAX package's, on the CPU.

Tolerances:

- The q-grid, the shell edges and averages and the all-origins
  autocorrelation are host NumPy in both packages: exactly equal, or
  1e-12 relative for the float64 arithmetic.
- ρ_q(t) and what is built on it (S(q), F(q, t), φ, τ_q) within 1e-4 of
  the largest magnitude: both packages take float32 phases (mod 1, then
  cos/sin) and sum them over the atoms in float32, in different orders
  and with different trig implementations; each phase carries ~1e-5 rad.
"""
import numpy as np
import pytest
import torch

from sitator_tpu.dynamics import ScatteringAnalysis as RefScattering
from sitator_tpu.ops import scattering as ref_scat
from sitator_tpu_torch.dynamics import ScatteringAnalysis
from sitator_tpu_torch.ops import scattering as scat

from tests._torch_common import (first_math_calls_on_one_thread, networks,
                                 trajectories)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

RHO_RTOL = 1e-4          # float32 phases, see the module docstring
TRICLINIC = np.array([[9.0, 0, 0], [1.0, 8.0, 0], [0.5, 0.3, 7.0]])


def close(got, want, rtol=RHO_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    scale = np.abs(want[ok]).max()
    assert np.abs(got[ok] - want[ok]).max() <= rtol * scale


@pytest.mark.parametrize("cell", [np.eye(3) * 10.0, TRICLINIC],
                         ids=["cubic", "triclinic"])
@pytest.mark.parametrize("q_min", [0.0, 1.0])
def test_allowed_wavevectors_equal(cell, q_min):
    got = scat.allowed_wavevectors(cell, 3.0, q_min=q_min)
    want = ref_scat.allowed_wavevectors(cell, 3.0, q_min=q_min)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_density_modes_within_float32_phase_error(seed):
    rng = np.random.default_rng(seed)
    F, M = 6, 50
    traj = rng.uniform(-20, 20, size=(F, M, 3))    # deliberately unwrapped
    mask = rng.random(M) < 0.7
    n, q, _ = scat.allowed_wavevectors(TRICLINIC, q_max=4.0)
    rho = scat.collective_density_modes(traj, TRICLINIC, mask, n,
                                        device="cpu")
    assert rho.dtype == np.complex128 and rho.shape == (F, len(n))
    close(rho, ref_scat.collective_density_modes(traj, TRICLINIC, mask, n))
    # and against the float64 definition
    exact = np.exp(1j * np.einsum("fmx,kx->fmk", traj[:, mask], q)).sum(1)
    assert np.abs(rho - exact).max() < 5e-4 * mask.sum()


def test_density_modes_chunked_like_one_chunk(monkeypatch):
    rng = np.random.default_rng(2)
    traj = rng.uniform(0, 9, size=(7, 20, 3))
    n, _, _ = scat.allowed_wavevectors(np.eye(3) * 9.0, q_max=2.0)
    mask = np.ones(20, bool)
    whole = scat.collective_density_modes(traj, np.eye(3) * 9.0, mask, n,
                                          device="cpu")
    monkeypatch.setattr(scat, "_MAX_CHUNK_PHASES", 3 * 20 * len(n))
    np.testing.assert_array_equal(
        scat.collective_density_modes(traj, np.eye(3) * 9.0, mask, n,
                                      device="cpu"), whole)


def test_empty_selections():
    traj = np.zeros((3, 4, 3))
    n, _, _ = scat.allowed_wavevectors(np.eye(3) * 5.0, 2.0)
    out = scat.collective_density_modes(traj, np.eye(3) * 5.0,
                                        np.zeros(4, bool), n, device="cpu")
    np.testing.assert_array_equal(out, np.zeros((3, len(n)), complex))


def test_host_helpers_equal():
    rng = np.random.default_rng(5)
    rho = rng.normal(size=(33, 4)) + 1j * rng.normal(size=(33, 4))
    np.testing.assert_allclose(scat._autocorr_all_origins(rho),
                               ref_scat._autocorr_all_origins(rho),
                               rtol=1e-12)
    mag = np.sort(rng.uniform(0.5, 3.0, 40))
    vals = rng.normal(size=(40, 5))
    for n_shells in (1, 4, 60):
        np.testing.assert_array_equal(scat._shell_edges(mag, n_shells),
                                      ref_scat._shell_edges(mag, n_shells))
        for a, b in zip(scat._shell_average(mag, n_shells, vals),
                        ref_scat._shell_average(mag, n_shells, vals)):
            np.testing.assert_array_equal(a, b)


def _diffusing(seed, F=200, M=30, L=10.0, D=0.2):
    rng = np.random.default_rng(seed)
    steps = rng.normal(scale=np.sqrt(2 * D), size=(F - 1, M, 3))
    traj = np.concatenate([rng.uniform(0, L, size=(1, M, 3)),
                           np.zeros((F - 1, M, 3))], 0)
    traj[1:] = traj[:1] + np.cumsum(steps, 0)
    return traj


def test_structure_factor_and_coherent_scattering():
    traj = _diffusing(7)
    cell, mask = np.eye(3) * 10.0, np.ones(30, bool)
    got = scat.static_structure_factor(traj, cell, mask, 2.5, n_shells=4,
                                       device="cpu")
    want = ref_scat.static_structure_factor(traj, cell, mask, 2.5,
                                            n_shells=4)
    np.testing.assert_array_equal(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    got = scat.coherent_scattering(traj, cell, mask, 2.5, n_shells=4,
                                   device="cpu")
    want = ref_scat.coherent_scattering(traj, cell, mask, 2.5, n_shells=4)
    np.testing.assert_array_equal(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_scattering_analysis_matches_reference():
    F, M = 300, 24
    traj = _diffusing(13, F=F, M=M, L=9.0)
    cell = np.eye(3) * 9.0
    pos = np.concatenate([np.zeros((1, 3)), traj[0]])
    species = np.r_[16, np.full(M, 3)]
    static = np.r_[True, np.zeros(M, bool)]
    full = np.concatenate([np.zeros((F, 1, 3)), traj], axis=1)
    sns = networks(pos, species, cell, static, ~static)
    st_ref, st = trajectories(sns, np.zeros((F, M), np.int32), full)
    got = ScatteringAnalysis(q_max=2.5, n_shells=3, timestep=0.5,
                             verbose=False, device="cpu").run(st)
    want = RefScattering(q_max=2.5, n_shells=3, timestep=0.5,
                         verbose=False).run(st_ref)
    np.testing.assert_array_equal(got.q_, want.q_)
    np.testing.assert_array_equal(got.n_q_, want.n_q_)
    np.testing.assert_array_equal(got.times_, want.times_)
    for name in ("F_", "S_q_", "phi_"):
        close(getattr(got, name), getattr(want, name))
    # τ_q: a 1/e crossing interpolated on φ; φ moves by ≤ 2e-4
    np.testing.assert_allclose(got.tau_q_, want.tau_q_, rtol=1e-2)


def test_validation_matches_reference():
    for pkg, engine, kw in ((scat, ScatteringAnalysis, {"device": "cpu"}),
                            (ref_scat, RefScattering, {})):
        with pytest.raises(ValueError, match="q_max"):
            engine(q_max=0.0)
        with pytest.raises(ValueError, match="n_shells"):
            engine(q_max=1.0, n_shells=0)
        with pytest.raises(ValueError, match="positive"):
            pkg.allowed_wavevectors(np.eye(3) * 5.0, q_max=-1.0)
        for fn in (pkg.static_structure_factor, pkg.coherent_scattering):
            with pytest.raises(ValueError, match="no allowed wavevectors"):
                fn(np.zeros((2, 3, 3)), np.eye(3) * 5.0, np.ones(3, bool),
                   q_max=0.5, **kw)
