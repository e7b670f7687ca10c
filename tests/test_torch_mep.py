"""String-method path refinement in the port against the JAX package, on
the CPU: the gradient of the trilinear interpolation (analytic in the port,
``jax.grad`` in the reference), the row-wise ``interp``, and
``refine_string_paths`` on an analytic curved-channel landscape (a ridge
with a lateral gap, also across the periodic seam) and on a sampled density
in a triclinic cell.

Tolerances: gradients ``atol=1e-5`` of values up to 10; ``interp`` rows
``atol=1e-6``; nodes within 1e-5 Å after 1, 5 and 20 iterations and within
1e-3 Å after the default 300; the barrier read off the refined path within
1e-3 (kT).  Found on the channel inputs: nodes differ by at most 9.5e-7 Å
(one float32 ulp of the coordinates) after 20 iterations and 8.6e-6 Å after
300; the barriers (1.818 kT through the gap) differ by under 1e-15.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sitator_tpu.dynamics.energetics import _trilinear_periodic
from sitator_tpu.ops import density as rden
from sitator_tpu.ops import mep as rmep

from sitator_tpu_torch.ops import mep as pmep

from tests._torch_common import first_math_calls_on_one_thread

torch.set_num_threads(2)
first_math_calls_on_one_thread()

L = 12.0
N_BINS = 48
H, GAP, SX, SG = 6.0, 0.7, 0.8, 1.2
SADDLE = H * (1 - GAP)
TRICLINIC = np.array([[9.0, 0, 0], [2.0, 8.5, 0], [1.0, -1.5, 9.5]])


def _channel_rho(x_ridge):
    """exp(−V) of a Gaussian ridge in the plane x = x_ridge with a circular
    gap at (y, z) = (8, 6); saddle height through the gap H·(1 − GAP)."""
    i = (np.arange(N_BINS) + 0.5) / N_BINS * L
    pts = np.stack(np.meshgrid(i, i, i, indexing="ij"), axis=-1)
    d = pts - np.array([x_ridge, 8.0, 6.0])
    d -= L * np.round(d / L)
    ridge = np.exp(-d[..., 0] ** 2 / (2 * SX ** 2))
    gap = GAP * np.exp(-(d[..., 1] ** 2 + d[..., 2] ** 2) / (2 * SG ** 2))
    return np.exp(-H * ridge * (1.0 - gap))


def _barrier(rho, cell, pts):
    frac = pts @ np.linalg.inv(cell)
    prof = -np.log(_trilinear_periodic(rho, frac - np.floor(frac)))
    return prof.max() - prof[0]


def _straight(a, b, P):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a[None] + np.linspace(0, 1, P)[:, None] * (b - a)[None]


CHANNELS = {
    "interior": (6.0, [3.0, 6.0, 6.0], [9.0, 6.0, 6.0]),
    "seam": (0.0, [9.0, 6.0, 6.0], [15.0, 6.0, 6.0]),
}


@pytest.mark.parametrize("cell", [np.eye(3) * L, TRICLINIC],
                         ids=["cubic", "triclinic"])
def test_gradient_matches_autodiff(cell):
    rng = np.random.default_rng(0)
    log_rho = rng.normal(size=(7, 9, 8)).astype(np.float32)
    inv = np.linalg.inv(cell).astype(np.float32)
    pts = (rng.uniform(-1, 2, (5, 6, 3)) @ cell).astype(np.float32)
    n_bins = jnp.asarray(log_rho.shape)
    grad = jax.vmap(jax.vmap(jax.grad(
        lambda r: -rmep._interp_log_rho(jnp.asarray(log_rho),
                                        jnp.asarray(inv), n_bins, r))))
    want = np.asarray(grad(jnp.asarray(pts)))
    got = pmep._grad_neg_log_rho(torch.from_numpy(log_rho),
                                 torch.from_numpy(inv),
                                 torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (5, 6, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _interp_both(x, xp, fp):
    want = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                           jnp.asarray(fp[:, c])))
                     for c in range(fp.shape[1])], axis=1)
    got = pmep._interp_rows(torch.from_numpy(x), torch.from_numpy(xp)[None],
                            torch.from_numpy(fp)[None]).numpy()[0]
    return got, want


@pytest.mark.parametrize("case", ["random", "equal-abscissae", "end-points",
                                  "outside"])
def test_interp_rows_matches_jnp_interp(case):
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 1, 9)).astype(np.float32)
    xp[0], xp[-1] = 0.0, 1.0
    fp = rng.normal(size=(9, 3)).astype(np.float32)
    x = np.linspace(0, 1, 13, dtype=np.float32)
    if case == "equal-abscissae":
        # a zero-length segment: at the shared abscissa the later sample wins
        xp[4] = xp[3]
        x = np.concatenate([x, xp[3:5]])
    elif case == "end-points":
        x = np.array([0.0, 1.0, xp[1], xp[-2]], np.float32)
    elif case == "outside":
        x = np.array([-0.5, 0.0, 1.0, 1.5], np.float32)
    got, want = _interp_both(x, xp, fp)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if case == "equal-abscissae":
        np.testing.assert_array_equal(got[-1], fp[4])
    if case == "outside":
        np.testing.assert_array_equal(got[0], fp[0])
        np.testing.assert_array_equal(got[-1], fp[-1])


@pytest.mark.parametrize("iterations", [1, 5, 20])
@pytest.mark.parametrize("channel", list(CHANNELS))
def test_early_iterations_match_reference(channel, iterations):
    x_ridge, a, b = CHANNELS[channel]
    rho = _channel_rho(x_ridge)
    seeds = np.stack([_straight(a, b, 21),
                      _straight(a, np.add(b, [0.0, 1.5, -1.0]), 21)])
    cell = np.eye(3) * L
    want = rmep.refine_string_paths(rho, cell, seeds, iterations=iterations)
    got = pmep.refine_string_paths(rho, cell, seeds, iterations=iterations,
                                   device="cpu")
    assert got.dtype == np.float64 and got.shape == seeds.shape
    assert np.abs(want - seeds).max() > 0.01          # the string moved
    assert np.abs(got - want).max() < 1e-5
    np.testing.assert_allclose(got[:, [0, -1]], seeds[:, [0, -1]], atol=1e-5)


@pytest.mark.parametrize("channel", list(CHANNELS))
def test_default_run_matches_reference_and_finds_the_gap(channel):
    x_ridge, a, b = CHANNELS[channel]
    rho = _channel_rho(x_ridge)
    cell = np.eye(3) * L
    seed = _straight(a, b, 41)[None]
    want = rmep.refine_string_paths(rho, cell, seed)[0]
    got = pmep.refine_string_paths(rho, cell, seed, device="cpu")[0]
    assert np.abs(got - want).max() < 1e-3
    bw, bg = _barrier(rho, cell, want), _barrier(rho, cell, got)
    assert abs(bg - bw) < 1e-3
    assert bg == pytest.approx(SADDLE, rel=0.15)
    assert bg < 0.5 * _barrier(rho, cell, seed[0])


@pytest.mark.parametrize("kw", [dict(iterations=20),
                                dict(iterations=40, max_step=0.05,
                                     smoothing=0.0, rho_floor_rel=1e-4)],
                         ids=["defaults", "options"])
def test_sampled_density_triclinic_matches_reference(kw):
    """A Poisson-sampled density with empty bins (the floor matters) in a
    skewed cell, several edges of different directions at once."""
    rng = np.random.default_rng(3)
    grid = rng.poisson(0.4, (16, 16, 16)).astype(np.float64)
    rho = rden.smooth_density(grid, TRICLINIC, 0.5)
    ends = rng.uniform(0, 1, (6, 2, 3)) @ TRICLINIC
    seeds = np.stack([_straight(e[0], e[1], 11) for e in ends])
    want = rmep.refine_string_paths(rho, TRICLINIC, seeds, **kw)
    got = pmep.refine_string_paths(rho, TRICLINIC, seeds, device="cpu", **kw)
    assert np.abs(want - seeds).max() > 0.05
    assert np.abs(got - want).max() < 1e-5


def test_flat_landscape_leaves_straight_path_fixed():
    seed = _straight([1.0, 1.0, 1.0], [5.0, 3.0, 2.0], 17)[None]
    out = pmep.refine_string_paths(np.ones((8, 8, 8)), np.eye(3) * L, seed,
                                   iterations=50, device="cpu")
    np.testing.assert_allclose(out, seed, atol=1e-4)


def test_validation_and_degenerate_paths():
    rho = np.ones((4, 4, 4))
    for mod, kw in ((rmep, {}), (pmep, dict(device="cpu"))):
        with pytest.raises(ValueError, match="3-D grid"):
            mod.refine_string_paths(np.ones((4, 4)), np.eye(3),
                                    np.zeros((1, 5, 3)), **kw)
        with pytest.raises(ValueError, match=r"\(E, P, 3\)"):
            mod.refine_string_paths(rho, np.eye(3), np.zeros((5, 3)), **kw)
        with pytest.raises(ValueError, match="positive density"):
            mod.refine_string_paths(np.zeros((4, 4, 4)), np.eye(3),
                                    np.zeros((1, 5, 3)), **kw)
        # P < 3: no interior node, a copy comes back
        two = np.array([[[0.0, 0, 0], [1.0, 1, 1]]])
        out = mod.refine_string_paths(rho, np.eye(3) * 4, two, **kw)
        np.testing.assert_array_equal(out, two)
        assert out is not two
