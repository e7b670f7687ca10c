"""Network analyses of the port against the JAX package's (NumPy/SciPy on
the host in both), on the same seeded networks: site matching, pathways and
percolation, the conduction-bottleneck readout, graph export and site
volumes.  Integer outputs (mappings, pathway ids, dimensions, critical
sites) equal; distances, betweenness, volumes ``atol=1e-9``.
"""
import numpy as np
import pytest
import torch

import sitator_tpu as ref
from sitator_tpu import network as rnet

import sitator_tpu_torch as port
from sitator_tpu_torch import network as pnet

torch.set_num_threads(2)

CELL = np.eye(3) * 10.0
TRICLINIC = np.array([[9.0, 0, 0], [1.5, 8.0, 0], [0.5, 1.0, 10.0]])


def _net(pkg, centers, cell=CELL, types=None, n_ij=None, n_mobile=1):
    structure = pkg.Structure(np.zeros((1 + n_mobile, 3)),
                              [16] + [3] * n_mobile, np.asarray(cell))
    sn = pkg.SiteNetwork(structure, structure.species == 16,
                         structure.species == 3)
    sn.centers = np.asarray(centers, dtype=np.float64)
    if types is not None:
        sn.site_types = np.asarray(types, np.int32)
    if n_ij is not None:
        sn.add_edge_attribute("n_ij", np.asarray(n_ij, np.int64))
    return sn


# -- compare -------------------------------------------------------------------

def _match_case(name):
    rng = np.random.default_rng(3)
    if name == "permuted_jittered":
        a = rng.uniform(0, 10, (12, 3))
        b = a[rng.permutation(12)] + rng.normal(scale=0.05, size=(12, 3))
        b[::3] += [10.0, 0, 0]
        return dict(a=a, b=b)
    if name == "rectangular":
        return dict(a=[[1.0, 1, 1], [5.0, 5, 5]],
                    b=[[1.1, 1, 1], [5.0, 5.1, 5], [8.0, 8, 8]])
    if name == "cutoff":
        return dict(a=[[1.0, 1, 1], [3.3, 3.3, 3.3]], b=[[1.1, 1, 1]],
                    cutoff=1.0)
    if name == "cutoff_kills_all":
        return dict(a=[[1.0, 1, 1], [3.3, 3.3, 3.3]], b=[[1.1, 1, 1]],
                    cutoff=0.01)
    if name == "typed":
        return dict(a=[[1.0, 1, 1], [5.0, 5, 5], [9.0, 9, 9]],
                    b=[[1.05, 1, 1], [5.0, 5.05, 5]], ta=[0, 1, 0],
                    tb=[0, 0], cutoff=1.0)
    if name == "triclinic":
        a = rng.random((15, 3)) @ TRICLINIC
        b = a[rng.permutation(15)][:11] + rng.normal(scale=0.1, size=(11, 3))
        return dict(a=a, b=b, cell=TRICLINIC, cutoff=2.0)
    if name == "empty":
        return dict(a=np.zeros((0, 3)), b=[[1.0, 1, 1]])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["permuted_jittered", "rectangular",
                                  "cutoff", "cutoff_kills_all", "typed",
                                  "triclinic", "empty"])
def test_match_and_compare_match_reference(name):
    c = _match_case(name)
    cell = c.get("cell", CELL)
    nets = {pkg: (_net(pkg, c["a"], cell, c.get("ta")),
                  _net(pkg, c["b"], cell, c.get("tb")))
            for pkg in (ref, port)}
    wm, wd = rnet.match_sites(*nets[ref], cutoff=c.get("cutoff"))
    gm, gd = pnet.match_sites(*nets[port], cutoff=c.get("cutoff"))
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gd, wd, atol=1e-9, equal_nan=True)
    want = rnet.compare_site_networks(*nets[ref], cutoff=c.get("cutoff"))
    got = pnet.compare_site_networks(*nets[port], cutoff=c.get("cutoff"))
    assert set(got) == set(want)
    for k in ("mapping", "unmatched_a", "unmatched_b"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["n_matched"] == want["n_matched"]
    assert got["type_agreement"] == want["type_agreement"]
    for k in ("mean_distance", "max_distance", "distances"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9,
                                   equal_nan=True)
    np.testing.assert_allclose(
        pnet.min_image_distance_matrix(c["a"], c["b"], cell),
        rnet.min_image_distance_matrix(c["a"], c["b"], cell), atol=1e-12)


def test_match_rejects_different_cells():
    with pytest.raises(ValueError, match="different cells"):
        pnet.match_sites(_net(port, [[1.0, 1, 1]]),
                         _net(port, [[1.0, 1, 1]], cell=np.eye(3) * 12.0))


# -- pathways --------------------------------------------------------------------

def _grid_network(n, dims, seed=None, drop=0.0):
    """Sites on an ``n``-per-side grid with hops between neighbours along
    the first ``dims`` axes (periodic); ``drop`` removes a seeded share of
    the edges."""
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    centers = (grid + 0.5) * (10.0 / n)
    S = len(grid)
    index = {tuple(g): i for i, g in enumerate(grid)}
    n_ij = np.zeros((S, S), np.int64)
    rng = np.random.default_rng(seed)
    for i, g in enumerate(grid):
        for ax in range(dims):
            h = g.copy()
            h[ax] = (h[ax] + 1) % n
            if rng.random() >= drop:
                n_ij[i, index[tuple(h)]] = 1 + rng.integers(0, 5)
    return centers, n_ij


PATHWAYS = {
    "chain_1d": (_grid_network(3, 1), dict()),
    "sheets_2d": (_grid_network(3, 2), dict()),
    "grid_3d": (_grid_network(3, 3), dict()),
    "thinned": (_grid_network(4, 3, seed=1, drop=0.5), dict()),
    "threshold": (_grid_network(3, 3, seed=2),
                  dict(connectivity_threshold=3)),
    "min_sites": (_grid_network(4, 3, seed=3, drop=0.7),
                  dict(minimum_n_sites=4)),
}


@pytest.mark.parametrize("name", list(PATHWAYS))
def test_pathway_analysis_matches_reference(name):
    (centers, n_ij), kw = PATHWAYS[name]
    rsn, psn = _net(ref, centers, n_ij=n_ij), _net(port, centers, n_ij=n_ij)
    want = rnet.DiffusionPathwayAnalysis(verbose=False, **kw)
    want.run(rsn)
    got = pnet.DiffusionPathwayAnalysis(verbose=False, device="cpu", **kw)
    assert got.run(psn) is psn
    assert got.n_pathways == want.n_pathways
    np.testing.assert_array_equal(got.pathway_dims, want.pathway_dims)
    np.testing.assert_array_equal(got.pathway_percolating,
                                  want.pathway_percolating)
    np.testing.assert_array_equal(psn.diffusion_pathway,
                                  rsn.diffusion_pathway)
    dims = {"chain_1d": 1, "sheets_2d": 2, "grid_3d": 3}
    if name in dims:
        assert set(got.pathway_dims) == {dims[name]}


def test_pathway_analysis_from_a_trajectory_computes_n_ij():
    rng = np.random.default_rng(6)
    centers = rng.uniform(0, 10, (6, 3))
    traj = rng.integers(0, 6, size=(200, 3)).astype(np.int32)
    res = {}
    for pkg, pa in ((ref, rnet.DiffusionPathwayAnalysis(verbose=False)),
                    (port, pnet.DiffusionPathwayAnalysis(verbose=False,
                                                         device="cpu"))):
        st = pkg.SiteTrajectory(_net(pkg, centers, n_mobile=3), traj.copy())
        pa.run(st)
        res[pkg] = (st.site_network.n_ij, st.site_network.diffusion_pathway)
    np.testing.assert_array_equal(res[port][0], res[ref][0])
    np.testing.assert_array_equal(res[port][1], res[ref][1])
    with pytest.raises(ValueError, match="no n_ij"):
        pnet.DiffusionPathwayAnalysis(verbose=False).run(
            _net(port, centers))


# -- graph -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chain_1d", "sheets_2d", "thinned"])
def test_conduction_bottlenecks_match_reference(name):
    pytest.importorskip("networkx")
    (centers, n_ij), _ = PATHWAYS[name]
    rsn, psn = _net(ref, centers, n_ij=n_ij), _net(port, centers, n_ij=n_ij)
    want = rnet.ConductionBottleneckAnalysis(verbose=False).run(rsn)
    got = pnet.ConductionBottleneckAnalysis(verbose=False,
                                            device="cpu").run(psn)
    assert got.base_dim_ == want.base_dim_
    np.testing.assert_allclose(got.betweenness_, want.betweenness_,
                               atol=1e-9)
    np.testing.assert_array_equal(got.candidates_, want.candidates_)
    np.testing.assert_array_equal(got.removal_dims_, want.removal_dims_)
    np.testing.assert_array_equal(got.critical_sites_, want.critical_sites_)
    np.testing.assert_allclose(psn.betweenness, rsn.betweenness, atol=1e-9)
    with pytest.raises(ValueError, match=">= 1"):
        pnet.ConductionBottleneckAnalysis(connectivity_threshold=0)


def test_to_networkx_matches_reference():
    pytest.importorskip("networkx")
    (centers, n_ij), _ = PATHWAYS["thinned"]
    graphs = []
    for pkg, mod in ((ref, rnet), (port, pnet)):
        sn = _net(pkg, centers, n_ij=n_ij,
                  types=np.arange(len(centers)) % 3)
        sn.add_site_attribute("occupancies",
                              np.linspace(0, 1, len(centers)))
        sn.add_edge_attribute("p_ij", n_ij / np.maximum(
            n_ij.sum(1, keepdims=True), 1))
        graphs.append(mod.to_networkx(sn, edge_threshold=1.0))
        with pytest.raises(ValueError, match="no edge attribute"):
            mod.to_networkx(sn, edge_attr="nope")
    want, got = graphs
    assert dict(got.nodes(data=True)) == dict(want.nodes(data=True))
    assert sorted(got.edges) == sorted(want.edges)
    for e in want.edges:
        assert got.edges[e] == pytest.approx(want.edges[e])


# -- site volumes ------------------------------------------------------------------

@pytest.mark.parametrize("seed,wrap", [(0, False), (1, True)])
def test_site_volumes_match_reference(seed, wrap):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.3, 5.0, 5.0] if wrap else [2.0, 2, 2],
                        [7.0, 7, 7], [5.0, 1, 8]])
    F, M = 60, 3
    traj = rng.integers(0, 2, size=(F, M)).astype(np.int32)
    traj[rng.random((F, M)) < 0.1] = -1
    traj[:3, 0] = 2                      # site 2: too few points
    real = np.zeros((F, 1 + M, 3))
    lab = np.where(traj >= 0, traj, 0)
    real[:, 1:] = (centers[lab] + rng.normal(scale=0.3, size=(F, M, 3))) % 10
    out = {}
    for pkg, mod in ((ref, rnet), (port, pnet)):
        st = pkg.SiteTrajectory(_net(pkg, centers, n_mobile=M), traj.copy())
        st.set_real_traj(real)
        assert mod.SiteVolumes(verbose=False).run(st) is st
        out[pkg] = st.site_network
    for name in ("site_volumes", "site_surface_areas"):
        got, want = (out[p].get_site_attribute(name) for p in (port, ref))
        np.testing.assert_allclose(got, want, atol=1e-9, equal_nan=True)
        assert np.isfinite(got[:2]).all() and np.isnan(got[2])
    st = port.SiteTrajectory(_net(port, centers, n_mobile=M), traj.copy())
    st.set_real_traj(real)
    with pytest.raises(ValueError, match="< 4 assigned points"):
        pnet.SiteVolumes(error_on_insufficient=True, verbose=False).run(st)


def test_network_package_exports():
    for name in ("MergeSitesBase", "MergeSitesByDistance",
                 "DiffusionPathwayAnalysis", "SiteVolumes", "match_sites",
                 "compare_site_networks", "min_image_distance_matrix",
                 "to_networkx", "ConductionBottleneckAnalysis",
                 "DensitySiteGenerator", "BondValenceSiteGenerator"):
        assert name in pnet.__all__ and hasattr(pnet, name)
    import sitator_tpu.network as rnet
    assert sorted(pnet.__all__) == sorted(rnet.__all__)
