"""Voronoi seeding in the port against the JAX package's (both SciPy on the
host over each package's own ``PBCCalculator``), on the same seeded
lattices.  Node centres and radii ``atol=1e-9``; vertex sets and node counts
equal.  One case carries the seeded network on through the port's
``prepare_engine_basis`` and the unique-atom kernel's plain version.
"""
import numpy as np
import pytest
import torch

import sitator_tpu as ref
from sitator_tpu.voronoi import (VoronoiSiteGenerator as RefGen,
                                 periodic_voronoi_nodes as ref_nodes)

import sitator_tpu_torch as port
from sitator_tpu_torch.ops.pbc import PBCCalculator
from sitator_tpu_torch.voronoi import (VoronoiSiteGenerator as PortGen,
                                       periodic_voronoi_nodes as port_nodes)

torch.set_num_threads(2)


def _cubic(n, a, jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    return (grid * a + rng.normal(scale=jitter, size=(n ** 3, 3)) * (jitter > 0),
            np.eye(3) * (n * a))


def _random(n, seed, cell):
    rng = np.random.default_rng(seed)
    cell = np.asarray(cell, float)
    return rng.random((n, 3)) @ cell, cell


TRICLINIC = [[9.0, 0, 0], [1.5, 8.0, 0], [0.5, 1.0, 10.0]]
LATTICES = {
    "cubic": (_cubic(3, 4.0), dict(merge_tol=0.1)),
    "cubic_jitter": (_cubic(3, 4.0, jitter=0.05, seed=3),
                     dict(merge_tol=1e-3)),
    "random": (_random(30, 5, np.eye(3) * 10.0), dict()),
    "random_triclinic": (_random(40, 6, TRICLINIC), dict(merge_tol=0.05)),
    "random_halo": (_random(30, 7, np.eye(3) * 10.0), dict(halo=8.0)),
}


def _assert_same_nodes(got, want):
    (gc, gv, gr), (wc, wv, wr) = got, want
    assert len(gc) == len(wc)
    np.testing.assert_allclose(gc, wc, atol=1e-9)
    np.testing.assert_allclose(gr, wr, atol=1e-9)
    assert len(gv) == len(wv)
    for a, b in zip(gv, wv):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(LATTICES))
def test_periodic_voronoi_nodes_match_reference(name):
    (pos, cell), kw = LATTICES[name]
    got = port_nodes(pos, cell, **kw)
    _assert_same_nodes(got, ref_nodes(pos, cell, **kw))
    assert all(len(v) >= 4 for v in got[1])
    if name == "cubic":
        assert len(got[0]) == 27 and all(len(v) == 8 for v in got[1])
        np.testing.assert_allclose(got[2], 4.0 * np.sqrt(3) / 2, atol=1e-6)
    if name == "cubic_jitter":
        # every node is equidistant from its defining atoms
        calc = PBCCalculator(cell)
        for c, v, r in zip(*got):
            np.testing.assert_allclose(calc.distances(c, pos[v]), r,
                                       atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_radical_nodes_match_reference(seed):
    pos, cell = _random(30, 10 + seed, np.eye(3) * 10.0)
    radii = np.random.default_rng(seed).uniform(0.5, 1.5, size=30)
    _assert_same_nodes(port_nodes(pos, cell, radii=radii),
                       ref_nodes(pos, cell, radii=radii))
    # equal radii reduce the power diagram to the standard one, the node
    # radius measured from the atoms' surfaces
    c1, v1, r1 = port_nodes(pos, cell, radii=np.ones(30))
    _assert_same_nodes((c1, v1, r1 + 1.0), port_nodes(pos, cell))


def test_too_few_atoms_raise():
    with pytest.raises(ValueError, match="at least 4"):
        port_nodes(np.zeros((3, 3)), np.eye(3))


def _site_network(pkg, pos, cell, n_mobile, seed):
    rng = np.random.default_rng(seed)
    mob = rng.random((n_mobile, 3)) @ cell
    s = pkg.Structure(np.concatenate([pos, mob]),
                      [16] * len(pos) + [3] * n_mobile, cell)
    return pkg.SiteNetwork(s, s.species == 16, s.species == 3)


GENERATORS = {
    "default": dict(merge_tol=0.05),
    "min_radius": dict(merge_tol=0.05, min_radius=3.0),
    "radial_dict": dict(radial=True, radii={16: 1.2}),
    "radial_array": dict(radial=True, radii=np.linspace(0.8, 1.4, 27)),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_matches_reference(name):
    pos, cell = _cubic(3, 4.0, jitter=0.05, seed=2)
    kw = GENERATORS[name]
    want = RefGen(verbose=False, **kw).run(
        _site_network(ref, pos, cell, 4, 1))
    got = PortGen(verbose=False, **kw).run(
        _site_network(port, pos, cell, 4, 1))
    assert isinstance(got, port.SiteNetwork)
    assert got.n_sites == want.n_sites > 0
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-9)
    np.testing.assert_allclose(got.site_radii, want.site_radii, atol=1e-9)
    for a, b in zip(got.vertices, want.vertices):
        np.testing.assert_array_equal(a, b)
        assert len(a) > 0
    if name == "min_radius":
        assert (got.site_radii >= 3.0).all()


def test_generator_argument_checks():
    with pytest.raises(ValueError, match="requires radii"):
        PortGen(radial=True)
    pos, cell = _cubic(3, 4.0)
    with pytest.raises(ValueError, match="n_static"):
        PortGen(radial=True, radii=np.ones(5), verbose=False).run(
            _site_network(port, pos, cell, 2, 0))


def test_seeded_network_feeds_the_unique_atom_kernel():
    """Voronoi seeds → ``prepare_engine_basis`` → K2's plain version gives
    the landmark vectors of the dense contraction (atol 2e-5, f32)."""
    from sitator_tpu_torch.ops import landmark as lmops
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    from sitator_tpu_torch.ops.landmark_mxu import (basis_from_jax,
                                                    mxu_landmark_blocks,
                                                    prepare_engine_basis)
    pos, cell = _cubic(4, 4.0, jitter=0.03, seed=4)
    sn = PortGen(merge_tol=0.05, verbose=False).run(
        _site_network(port, pos, cell, 5, 3))
    verts, vmask = sn.padded_vertices()
    sidx = np.flatnonzero(sn.static_mask)
    basis = prepare_engine_basis(
        verts, vmask, sn.centers, cell, midpoint=4.0, steepness=3.0,
        cutoff_shape="logistic", static_ref=sn.structure.positions[sidx],
        drift_budget=1.0)
    assert basis is not None
    rng = np.random.default_rng(0)
    frames = sn.structure.positions[None] + rng.normal(
        scale=0.05, size=(3,) + sn.structure.positions.shape)
    mobile = torch.as_tensor(frames[:, sn.mobile_mask], dtype=torch.float32)
    static = torch.as_tensor(frames[:, sidx], dtype=torch.float32)
    got = mxu_landmark_blocks(mobile, static, basis_from_jax(basis, "cpu"),
                              kernel_cell(cell), midpoint=4.0, steepness=3.0)
    A = lmops.vertex_membership_matrix(verts, vmask, len(sidx))
    c32 = torch.as_tensor(cell, dtype=torch.float32)
    want = lmops.landmark_vectors(mobile, static, A, c32,
                                  torch.linalg.inv(c32), 4.0, 3.0)
    assert got.shape == want.shape == (3, 5, sn.n_sites)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
