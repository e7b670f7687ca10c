"""Bond-valence sums and the bond-valence site generator in the port
against the JAX package, on the CPU.

Tolerances: sums ``rtol=1e-5`` (float32 distances and exponentials on both
sides, float64 in and out); the generator's centres within 1e-4 Å with the
same count, vertex sets equal, ``bv_sum`` / ``bv_mismatch`` ``atol=1e-5``.
"""
import numpy as np
import pytest
import torch

from sitator_tpu.network import BondValenceSiteGenerator as RefGenerator
from sitator_tpu.ops import bondvalence as rbv

from sitator_tpu_torch.network import BondValenceSiteGenerator, match_sites
from sitator_tpu_torch.ops import bondvalence as pbv

from sitator_tpu_torch.network import min_image_distance_matrix

from tests._torch_common import first_math_calls_on_one_thread, networks

torch.set_num_threads(2)
first_math_calls_on_one_thread()

def _assert_same_sites(got, want, atol=1e-4):
    """The same centres (minimum image) in the same order."""
    assert got.n_sites == want.n_sites > 0
    D = min_image_distance_matrix(got.centers, want.centers,
                                  want.structure.cell)
    assert np.diag(D).max() < atol


TRICLINIC = np.array([[9.0, 0, 0], [2.0, 8.5, 0], [1.0, -1.5, 9.5]])
R0, B = 1.466, 0.37
A_FCC = 2 * (R0 + B * np.log(6.0))          # octahedral first shell sums to 1


def test_tables_copied_letter_for_letter():
    assert pbv.BV_R0 == rbv.BV_R0 and pbv.BV_B == rbv.BV_B
    assert list(pbv.BV_R0) == list(rbv.BV_R0)
    assert pbv.__all__ == rbv.__all__


@pytest.mark.parametrize("cell", [np.eye(3) * 9.0, TRICLINIC],
                         ids=["cubic", "triclinic"])
@pytest.mark.parametrize("kw", [dict(), dict(cutoff=3.5, b=0.45),
                                dict(chunk=64)],
                         ids=["default", "cutoff-b", "chunked"])
def test_bv_sums_match_reference(cell, kw):
    rng = np.random.default_rng(0)
    anions = rng.uniform(0, 1, (60, 3)) @ cell
    points = rng.uniform(-0.5, 1.5, (300, 3)) @ cell
    r0 = rng.uniform(1.4, 2.1, 60)
    want = rbv.bv_sums(points, anions, r0, cell, **kw)
    got = pbv.bv_sums(points, anions, r0, cell, device="cpu", **kw)
    assert got.dtype == np.float64 and got.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # scalar r0 broadcasts
    np.testing.assert_allclose(
        pbv.bv_sums(points[:20], anions, 1.8, cell, device="cpu", **kw),
        rbv.bv_sums(points[:20], anions, 1.8, cell, **kw), rtol=1e-5)


def test_bv_sums_analytic_cutoff_and_minimum_image():
    cell = np.eye(3) * 10.0
    anion = np.array([[0.5, 5.0, 5.0]])
    for d in (1.0, 1.5, 3.0):
        probe = np.array([[10.0 - d + 0.5, 5.0, 5.0]])   # across the seam
        got = pbv.bv_sums(probe, anion, R0, cell, device="cpu")[0]
        assert got == pytest.approx(np.exp((R0 - d) / B), rel=1e-5)
    # ``d < cutoff`` is strict: an anion at the cutoff counts for nothing
    probe = anion + np.array([[3.0, 0.0, 0.0]])
    assert pbv.bv_sums(probe, anion, R0, cell, cutoff=3.0,
                       device="cpu")[0] == 0.0
    assert pbv.bv_sums(probe, anion, R0, cell, cutoff=3.0001,
                       device="cpu")[0] > 0.0


@pytest.mark.parametrize("n_bins", [6, 11])
def test_bv_mismatch_grid_matches_reference(n_bins):
    rng = np.random.default_rng(2)
    anions = rng.uniform(0, 1, (40, 3)) @ TRICLINIC
    r0 = rng.uniform(1.4, 2.1, 40)
    want = rbv.bv_mismatch_grid(anions, r0, TRICLINIC, 1.0, n_bins=n_bins)
    got = pbv.bv_mismatch_grid(anions, r0, TRICLINIC, 1.0, n_bins=n_bins,
                               chunk=500, device="cpu")
    assert got.shape == (n_bins,) * 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="n_bins"):
        pbv.bv_mismatch_grid(anions, r0, TRICLINIC, 1.0, n_bins=1,
                             device="cpu")
    with pytest.raises(ValueError, match="no anions"):
        pbv.bv_mismatch_grid(anions[:0], r0[:0], TRICLINIC, 1.0,
                             device="cpu")


def _fcc_oxygen(n_cells=2, a=A_FCC, extra_static=False):
    """An FCC oxygen sublattice with a little frozen disorder (so no two
    holes tie to float32 noise) and one mobile Li."""
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                      [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    o_pos = ((grid[:, None, :] + basis[None]) * a).reshape(-1, 3)
    o_pos += np.random.default_rng(5).normal(scale=0.03, size=o_pos.shape)
    pos = np.concatenate([o_pos, [[0.5 * a, 0.0, 0.0]]])
    species = np.array([8] * len(o_pos) + [3])
    if extra_static:                       # a static cation that is no anion
        pos = np.concatenate([[[0.25 * a] * 3], pos])
        species = np.concatenate([[13], species])
    mobile = species == 3
    return networks(pos, species, np.eye(3) * (n_cells * a), ~mobile,
                    mobile), grid, a


@pytest.mark.parametrize("kw", [
    dict(),
    dict(r0=R0, mismatch_tol=0.2, n_vertices=4),
    dict(cation="Li", cutoff=5.0, min_distance=2.0),
], ids=["lookup", "explicit-r0", "named-cation"])
def test_bv_generator_matches_reference(kw):
    (rsn0, psn0), grid, a = _fcc_oxygen()
    kw = dict(v_ideal=1.0, n_bins=24, min_distance=1.2, verbose=False) | kw
    want = RefGenerator(**kw).run(rsn0)
    got = BondValenceSiteGenerator(device="cpu", **kw).run(psn0)
    _assert_same_sites(got, want)
    assert got.n_sites == 4 * len(grid)                   # octahedral holes
    for u, v in zip(got.vertices, want.vertices):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(got.bv_sum, want.bv_sum, atol=1e-5)
    np.testing.assert_allclose(got.bv_mismatch, want.bv_mismatch, atol=1e-5)
    oct_basis = np.array([[0.5, 0.0, 0.0], [0.0, 0.5, 0.0],
                          [0.0, 0.0, 0.5], [0.5, 0.5, 0.5]])
    truth = _fcc_oxygen()[0][1]
    truth.centers = ((grid[:, None, :] + oct_basis[None]) * a).reshape(-1, 3)
    mapping, dists = match_sites(got, truth)
    assert (mapping >= 0).all() and np.nanmax(dists) < 0.25


@pytest.mark.parametrize("anions", ["O", 8, ["O"], "mask"])
def test_bv_generator_anion_selections_match_reference(anions):
    (rsn0, psn0), grid, a = _fcc_oxygen(extra_static=True)
    if isinstance(anions, str) and anions == "mask":
        anions = np.asarray(psn0.structure.species) == 8
    kw = dict(anions=anions, n_bins=20, min_distance=1.2, verbose=False)
    want = RefGenerator(**kw).run(rsn0)
    got = BondValenceSiteGenerator(device="cpu", **kw).run(psn0)
    _assert_same_sites(got, want)


def test_bv_generator_validation():
    (rsn0, psn0), _, _ = _fcc_oxygen(extra_static=True)
    with pytest.raises(ValueError, match="mismatch_tol"):
        BondValenceSiteGenerator(mismatch_tol=0.0)
    with pytest.raises(ValueError, match="n_vertices"):
        BondValenceSiteGenerator(n_vertices=0)
    gen = BondValenceSiteGenerator(n_bins=8, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="no tabulated"):
        gen.run(psn0)                      # ("Li", "Al") is not in the table
    with pytest.raises(ValueError, match="no static atoms"):
        BondValenceSiteGenerator(anions="S", device="cpu").run(psn0)
    with pytest.raises(ValueError, match="non-static"):
        BondValenceSiteGenerator(anions=np.ones(psn0.structure.n_atoms, bool),
                                 device="cpu").run(psn0)
    with pytest.raises(ValueError, match="no grid point"):
        BondValenceSiteGenerator(anions="O", v_ideal=9.0, n_bins=8,
                                 verbose=False, device="cpu").run(psn0)
