"""Site descriptors in the port against the JAX package, on the CPU: real
spherical harmonics, the radial tables, ``soap_descriptors`` /
``soap_descriptors_env``, ``SOAPDescriptorAverages``,
``SiteCentersDescriptor``, ``SiteTypeAnalysis`` and
``MergeSitesByDescriptors``.  The same seeded NumPy inputs go through both.

Tolerances: harmonics ``atol=2e-6`` (f32 recurrences); the orthonormalizer
``W`` and the smearing table bit-equal (the same float64 NumPy code);
descriptors ``atol=2e-5`` on unit-norm rows.  The Gaussian basis agrees to
a few 1e-7; the polynomial basis with the delta density reaches 1.5e-5
because its projection ``g @ W`` cancels in float32 (raw values up to
``r_cut^(n_max+1)``): either package's product is about 1e-4 away from the
float64 product there, in values of magnitude 10.  Sampled probes, counts,
type partitions, merge groups and relabelled trajectories are equal.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu.io import make_fcc_hopping_trajectory
from sitator_tpu.site_descriptors import soap as rsoap
import sitator_tpu.site_descriptors as rdesc

import sitator_tpu_torch.site_descriptors as pdesc
from sitator_tpu_torch.site_descriptors import soap as psoap

from tests._torch_common import (first_math_calls_on_one_thread,
                                 networks_of, trajectories)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

ATOL = 2e-5
CELLS = {
    "orthorhombic": np.diag([9.0, 10.0, 11.0]),
    "triclinic": np.array([[9.0, 0, 0], [2.0, 8.5, 0], [1.0, -1.5, 9.5]]),
}
COMBOS = [("gauss", "delta"), ("gauss", "gauss"), ("poly", "delta"),
          ("poly", "gauss")]


def _unit_vectors(n, seed=0, dtype=np.float32):
    u = np.random.default_rng(seed).normal(size=(n, 3))
    u[:3] = np.eye(3)                       # the poles and the x, y axes
    u[3] = [0, 0, -1]
    return (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(dtype)


# -- harmonics ---------------------------------------------------------------

def _closed_form(l, u):
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    c = math.sqrt
    if l == 0:
        return np.stack([np.full_like(x, 0.5 / c(math.pi))], axis=1)
    if l == 1:                              # m = -1, 0, 1 → y, z, x
        k = c(3 / (4 * math.pi))
        return np.stack([k * y, k * z, k * x], axis=1)
    k = c(15 / math.pi)                     # m = -2..2
    return np.stack([0.5 * k * x * y, 0.5 * k * y * z,
                     0.25 * c(5 / math.pi) * (3 * z * z - 1),
                     0.5 * k * x * z, 0.25 * k * (x * x - y * y)], axis=1)


@pytest.mark.parametrize("l", [0, 1, 2])
def test_harmonics_closed_forms(l):
    u = _unit_vectors(200, dtype=np.float64)
    Y = psoap._real_sph_harm(torch.from_numpy(u), 2).numpy()
    np.testing.assert_allclose(Y[:, l * l:(l + 1) ** 2], _closed_form(l, u),
                               atol=1e-12)


@pytest.mark.parametrize("l_max", [0, 3, 6])
def test_harmonics_match_reference(l_max):
    u = _unit_vectors(300, seed=1)
    want = np.asarray(rsoap._real_sph_harm(jnp.asarray(u), l_max))
    got = psoap._real_sph_harm(torch.from_numpy(u), l_max).numpy()
    assert got.shape == want.shape == (300, (l_max + 1) ** 2)
    np.testing.assert_allclose(got, want, atol=2e-6)


# -- the host tables ---------------------------------------------------------

@pytest.mark.parametrize("basis", ["gauss", "poly"])
def test_radial_tables_bit_equal(basis):
    W = psoap.radial_orthonormalizer(4.5, 0.5, 6, basis)
    np.testing.assert_array_equal(
        W, rsoap.radial_orthonormalizer(4.5, 0.5, 6, basis))
    got, d_got = psoap.radial_smearing_table(4.5, 0.5, 6, 4, basis, W=W,
                                             n_grid=64, n_quad=512)
    want, d_want = rsoap.radial_smearing_table(4.5, 0.5, 6, 4, basis, W=W,
                                               n_grid=64, n_quad=512)
    np.testing.assert_array_equal(got, want)
    assert d_got == d_want
    with pytest.raises(ValueError, match="radial_basis"):
        psoap.radial_orthonormalizer(4.5, 0.5, 6, "bessel")


# -- descriptors -------------------------------------------------------------

def _system(cell, n_species, seed, n=70, n_probes=9):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)) @ cell
    species = rng.integers(0, n_species, n) + 8
    species[:n_species] = np.arange(n_species) + 8      # each one present
    probes = rng.uniform(0, 1, (n_probes, 3)) @ cell
    probes[0] = pos[5]                                  # a probe on an atom
    return probes, pos, species


@pytest.mark.parametrize("n_species", [1, 2])
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("basis,density", COMBOS)
def test_soap_descriptors_match_reference(basis, density, cell, n_species):
    cell = CELLS[cell]
    probes, pos, species = _system(cell, n_species, seed=3)
    kw = dict(r_cut=4.0, sigma=0.5, n_max=5, l_max=4, radial_basis=basis,
              density=density)
    want = rsoap.soap_descriptors(probes, pos, species, cell, **kw)
    got = psoap.soap_descriptors(probes, pos, species, cell, batch=4,
                                 device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == n_species ** 2 * 5 * 5 * 5
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("basis,density", COMBOS)
def test_soap_default_widths_match_reference(basis, density):
    """The shipped ``n_max=8, l_max=6, r_cut=5``, where the polynomial
    basis is at its worst conditioning."""
    cell = CELLS["triclinic"] * 1.3
    probes, pos, species = _system(cell, 2, seed=1, n=150, n_probes=6)
    want = rsoap.soap_descriptors(probes, pos, species, cell,
                                  radial_basis=basis, density=density)
    got = psoap.soap_descriptors(probes, pos, species, cell,
                                 radial_basis=basis, density=density,
                                 device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("basis,density", COMBOS)
def test_soap_env_path_matches_reference(basis, density):
    cell = CELLS["triclinic"]
    probes, pos, species = _system(cell, 2, seed=8)
    rng = np.random.default_rng(2)
    envs = np.stack([pos + 0.05 * rng.normal(size=pos.shape)
                     for _ in probes])
    kw = dict(r_cut=4.0, n_max=5, l_max=4, radial_basis=basis,
              density=density)
    want = rsoap.soap_descriptors_env(probes, envs, species, cell, **kw)
    got = psoap.soap_descriptors_env(probes, envs, species, cell, batch=4,
                                     device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # hoisted tables and a species list with an absent species
    W = psoap.radial_orthonormalizer(4.0, 0.5, 5, basis)
    table = (psoap.radial_smearing_table(4.0, 0.5, 5, 4, basis, W=W)[0]
             if density == "gauss" else None)
    kw.update(W=W, smear_table=table, species_list=np.array([8, 9, 10]))
    want = rsoap.soap_descriptors_env(probes, envs, species, cell, **kw)
    got = psoap.soap_descriptors_env(probes, envs, species, cell,
                                     device="cpu", **kw)
    assert got.shape[1] == 9 * 5 * 5 * 5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_soap_batches_do_not_change_rows():
    cell = CELLS["orthorhombic"]
    probes, pos, species = _system(cell, 2, seed=4, n_probes=11)
    one = psoap.soap_descriptors(probes, pos, species, cell, r_cut=4.0,
                                 n_max=4, l_max=3, device="cpu")
    for batch in (1, 4, 11):
        np.testing.assert_allclose(
            psoap.soap_descriptors(probes, pos, species, cell, r_cut=4.0,
                                   n_max=4, l_max=3, batch=batch,
                                   device="cpu"), one, atol=1e-6)


def test_soap_validation_and_tf32_refusal():
    cell = CELLS["orthorhombic"]
    probes, pos, species = _system(cell, 1, seed=4)
    for mod, kw in ((rsoap, {}), (psoap, dict(device="cpu"))):
        with pytest.raises(ValueError, match="density"):
            mod.soap_descriptors(probes, pos, species, cell, density="box",
                                 **kw)
    # the guard reads the global switch for a CUDA device only; it needs
    # no card to be asked
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        psoap._require_full_f32(torch.device("cpu"))
        with pytest.raises(RuntimeError, match="allow_tf32"):
            psoap._require_full_f32(torch.device("cuda"))
        torch.backends.cuda.matmul.allow_tf32 = False
        psoap._require_full_f32(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# -- the descriptor classes on the FCC tet/oct system ------------------------

@pytest.fixture(scope="module")
def fcc():
    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=16,
                                     n_frames=160, jump_rate=0.05,
                                     frozen_disorder=0.02, seed=11)
    sns = networks_of(md, centers=md.true_sites)
    sts = trajectories(sns, md.true_assignments, real_traj=md.traj)
    return md, sts


@pytest.mark.parametrize("density", ["delta", "gauss"])
def test_site_centers_descriptor_matches_reference(fcc, density):
    md, (rst, pst) = fcc
    kw = dict(r_cut=4.0, n_max=5, l_max=4, density=density)
    want, wc = rdesc.SiteCentersDescriptor(**kw).get_descriptors(rst)
    got, gc = pdesc.SiteCentersDescriptor(device="cpu", **kw) \
        .get_descriptors(pst.site_network)         # a bare network works too
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("density", ["delta", "gauss"])
@pytest.mark.parametrize("averages_n", [3, 1000])
def test_soap_averages_same_samples_and_counts(fcc, density, averages_n):
    """Both packages draw with ``default_rng(seed)`` in the same order, so
    they average the same probes: equal ``counts`` (the capped number of
    samples), descriptors within tolerance."""
    md, (rst, pst) = fcc
    kw = dict(r_cut=4.0, n_max=4, l_max=3, averages_n=averages_n, seed=7,
              density=density, verbose=False)
    want, wc = rdesc.SOAPDescriptorAverages(**kw).get_descriptors(rst)
    got, gc = pdesc.SOAPDescriptorAverages(device="cpu", **kw) \
        .get_descriptors(pst)
    np.testing.assert_array_equal(gc, wc)
    visits = np.bincount(md.true_assignments.ravel(),
                         minlength=len(md.true_sites))
    np.testing.assert_array_equal(gc, np.minimum(visits, averages_n))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[visits == 0], 0.0)


def test_soap_averages_errors(fcc):
    md, (rst, pst) = fcc
    bare = trajectories(networks_of(md, centers=md.true_sites),
                        md.true_assignments)[1]
    with pytest.raises(ValueError, match="real trajectory"):
        pdesc.SOAPDescriptorAverages(device="cpu").get_descriptors(bare)
    empty = trajectories(networks_of(md, centers=md.true_sites),
                         np.full_like(md.true_assignments, -1),
                         real_traj=md.traj)[1]
    with pytest.raises(ValueError, match="no assigned samples"):
        pdesc.SOAPDescriptorAverages(device="cpu").get_descriptors(empty)


def _partition(labels):
    """Labels renumbered by first appearance: equal iff the partitions are."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv]


@pytest.mark.parametrize("mode", [dict(n_types=2), dict(max_types=5)],
                         ids=["n_types", "elbow"])
@pytest.mark.parametrize("descriptor", ["centers", "averages"])
def test_site_type_analysis_partitions_equal(fcc, descriptor, mode):
    md, (rst, pst) = fcc
    if descriptor == "centers":
        rd = rdesc.SiteCentersDescriptor(r_cut=4.0)
        pd_ = pdesc.SiteCentersDescriptor(r_cut=4.0, device="cpu")
    else:
        kw = dict(r_cut=4.5, averages_n=8, verbose=False)
        rd = rdesc.SOAPDescriptorAverages(**kw)
        pd_ = pdesc.SOAPDescriptorAverages(device="cpu", **kw)
    rsta = rdesc.SiteTypeAnalysis(rd, verbose=False, **mode)
    psta = pdesc.SiteTypeAnalysis(pd_, verbose=False, **mode)
    rsta.run(rst)
    assert psta.run(pst) is pst
    want = rst.site_network.site_types
    got = pst.site_network.site_types
    assert got.dtype == np.int32
    np.testing.assert_array_equal(_partition(got), _partition(want))
    np.testing.assert_allclose(psta.descriptor_matrix,
                               rsta.descriptor_matrix, atol=ATOL)
    if "n_types" in mode and descriptor == "centers":
        # and the partition is the tetrahedral / octahedral one
        np.testing.assert_array_equal(_partition(got),
                                      _partition(md.true_site_types))
    rst.site_network.site_types = pst.site_network.site_types = None


@pytest.mark.parametrize("kw", [
    dict(similarity_threshold=0.98, distance_threshold=100.0),
    dict(similarity_threshold=0.98),                 # the 3 Å guard splits
    dict(similarity_threshold=0.999999, distance_threshold=None),
], ids=["far", "guarded", "strict"])
def test_merge_sites_by_descriptors_groups_equal(fcc, kw):
    md, (rst, pst) = fcc
    rdsc = rdesc.SiteCentersDescriptor(r_cut=4.0)
    pdsc = pdesc.SiteCentersDescriptor(r_cut=4.0, device="cpu")
    rm = rdesc.MergeSitesByDescriptors(rdsc, verbose=False, **kw)
    pm = pdesc.MergeSitesByDescriptors(pdsc, verbose=False, **kw)
    want_groups = sorted(tuple(g) for g in rm._get_merges(rst))
    got_groups = sorted(tuple(g) for g in pm._get_merges(pst))
    assert got_groups == want_groups
    want, got = rm.run(rst), pm.run(pst)
    assert got.site_network.n_sites == want.site_network.n_sites
    np.testing.assert_array_equal(got.traj, want.traj)
    np.testing.assert_allclose(got.site_network.centers,
                               want.site_network.centers, atol=1e-9)
    np.testing.assert_array_equal(got.site_network.occupancies,
                                  want.site_network.occupancies)
    if kw.get("distance_threshold") == 100.0:
        assert got.site_network.n_sites == 2        # tet and oct


def test_site_descriptors_exports():
    assert pdesc.__all__ == rdesc.__all__
    assert psoap.__all__ == rsoap.__all__
