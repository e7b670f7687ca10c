"""Merging by dynamics in the port against the JAX package, on the CPU: MCL,
``MergeSitesByDynamics`` / ``MergeSitesByDistance``, the two filters,
``StreamingLandmarkAnalysis.merge_network``, the ``mcl`` clustering backend,
``DotProdClassifier`` and ``jump_lag_by_type``.  The same seeded NumPy
inputs go through both packages.

Tolerances: converged MCL matrices ``atol=1e-5`` (f32 products summed in
another order); partitions, labels, trajectories, vertex sets, site types
and counts equal; site centres ``atol=1e-9`` (both float64 NumPy); cluster
centres and confidences ``atol=1e-6`` (f32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sitator_tpu as ref
from sitator_tpu import dynamics as rdyn
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.landmark.cluster import get_backend as ref_backend
from sitator_tpu.ops import mcl as rmcl
from sitator_tpu.util import DotProdClassifier as RefClassifier

import sitator_tpu_torch as port
from sitator_tpu_torch import dynamics as pdyn
from sitator_tpu_torch.landmark.cluster import get_backend as port_backend
from sitator_tpu_torch.ops import mcl as pmcl
from sitator_tpu_torch.util import DotProdClassifier as PortClassifier

torch.set_num_threads(2)


# -- the same system in both packages -----------------------------------------

def _network(pkg, centers, *, n_mobile=3, n_static=6, seed=0, a=10.0,
             site_types=None, vertices=None):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, a, size=(n_static + n_mobile, 3))
    species = np.array([16] * n_static + [3] * n_mobile)
    s = pkg.Structure(pos, species, np.eye(3) * a)
    sn = pkg.SiteNetwork(s, s.species == 16, s.species == 3)
    sn.centers = np.asarray(centers, float)
    if vertices is not None:
        sn.vertices = vertices
    if site_types is not None:
        sn.site_types = np.asarray(site_types)
    return sn


def _both(centers, traj, **kw):
    """(reference SiteTrajectory, port SiteTrajectory) of one system."""
    traj = np.asarray(traj, np.int32)
    kw.setdefault("n_mobile", traj.shape[1])
    return (ref.SiteTrajectory(_network(ref, centers, **kw), traj.copy()),
            port.SiteTrajectory(_network(port, centers, **kw), traj.copy()))


def _assert_same_st(got, want):
    np.testing.assert_array_equal(got.traj, want.traj)
    gs, ws = got.site_network, want.site_network
    assert gs.n_sites == ws.n_sites
    np.testing.assert_allclose(gs.centers, ws.centers, atol=1e-9)
    assert gs.has_vertices == ws.has_vertices
    if ws.has_vertices:
        for a, b in zip(gs.vertices, ws.vertices):
            np.testing.assert_array_equal(a, b)
    if ws.site_types is None:
        assert gs.site_types is None
    else:
        np.testing.assert_array_equal(gs.site_types, ws.site_types)
    assert set(gs.site_attributes) == set(ws.site_attributes)
    for name in ws.site_attributes:
        np.testing.assert_allclose(gs.get_site_attribute(name),
                                   ws.get_site_attribute(name), atol=1e-12)


def _block_graph(seed, sizes, strong=10.0, weak=0.05):
    """A symmetric graph of dense blocks (weights near ``strong``) joined
    by a few weak edges: clear gaps, so the partition is the blocks."""
    rng = np.random.default_rng(seed)
    S = sum(sizes)
    A = np.zeros((S, S))
    lo = 0
    for n in sizes:
        blk = strong * (0.5 + rng.random((n, n)))
        A[lo:lo + n, lo:lo + n] = (blk + blk.T) / 2
        lo += n
    edges = np.cumsum(sizes)[:-1]
    for e in edges:
        A[e - 1, e] = A[e, e - 1] = weak * rng.random()
    return A


GRAPHS = [(0, (3, 3)), (1, (4, 2, 5)), (2, (1, 6, 1, 3)), (3, (8, 8, 8, 8)),
          (4, (2,) * 9)]


# -- MCL -----------------------------------------------------------------------

@pytest.mark.parametrize("inflation,expansion", [(2.0, 2), (1.6, 2), (2.0, 3)])
@pytest.mark.parametrize("seed,sizes", GRAPHS)
def test_mcl_iterate_matches_reference(seed, sizes, inflation, expansion):
    A = _block_graph(seed, sizes).astype(np.float32)
    want = np.asarray(rmcl.mcl_iterate(jnp.asarray(A), inflation,
                                       expansion=expansion))
    got = pmcl.mcl_iterate(torch.from_numpy(A), inflation,
                           expansion=expansion).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    same, iters = pmcl._mcl_loop(torch.from_numpy(A), inflation,
                                 expansion=expansion)
    np.testing.assert_array_equal(same.numpy(), got)
    assert 0 < iters < 100
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)


@pytest.mark.parametrize("inflation", [2.0, 1.4])
@pytest.mark.parametrize("seed,sizes", GRAPHS)
def test_markov_cluster_partitions_equal(seed, sizes, inflation):
    A = _block_graph(seed, sizes)
    want = rmcl.markov_cluster(A, inflation=inflation)
    got = pmcl.markov_cluster(A, inflation=inflation, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if inflation == 2.0:
        bounds = np.cumsum((0,) + sizes)
        assert sorted(tuple(g) for g in got) == sorted(
            tuple(range(a, b)) for a, b in zip(bounds[:-1], bounds[1:]))


@pytest.mark.parametrize("max_iters", [0, 1, 2, 5])
def test_mcl_iteration_count_is_the_reference_loop(max_iters):
    """``max_iters`` bounds the loop as the reference's ``while_loop`` does
    (tested before each body, the first pass against +inf)."""
    A = _block_graph(5, (3, 4)).astype(np.float32)
    want = np.asarray(rmcl.mcl_iterate(jnp.asarray(A), 2.0,
                                       max_iters=max_iters))
    got, iters = pmcl._mcl_loop(torch.from_numpy(A), 2.0,
                                max_iters=max_iters)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert iters == max_iters


def test_mcl_expansion_is_matrix_power():
    rng = np.random.default_rng(3)
    T = rng.random((5, 5))
    T = T / T.sum(0, keepdims=True)
    got = pmcl.mcl_iterate(torch.from_numpy(T.astype(np.float32)), 1.0,
                           expansion=3, max_iters=1, prune=0.0).numpy()
    want = np.linalg.matrix_power(T, 3)
    np.testing.assert_allclose(got, want / want.sum(0, keepdims=True),
                               atol=1e-5)


def test_mcl_identity_no_merge():
    assert len(pmcl.markov_cluster(np.eye(5), device="cpu")) == 5


# -- mergers -------------------------------------------------------------------

def _flicker_traj(seed, n=300):
    rng = np.random.default_rng(seed)
    col = rng.integers(0, 2, size=n).astype(np.int32)
    col[200:210] = 2
    return np.stack([col, np.zeros(n, np.int32), np.ones(n, np.int32)], 1)


DYNAMICS_CASES = {
    "flicker_pair": dict(
        centers=[[1.0, 1, 1], [1.5, 1, 1], [6, 6, 6]],
        traj=_flicker_traj(0), kw=dict(distance_threshold=2.0), n_out=2),
    "distance_guard": dict(
        centers=[[1.0, 1, 1], [6.0, 6, 6]],
        traj=np.tile([0, 1], 100)[:, None],
        kw=dict(distance_threshold=2.0), n_out=2),
    "no_guard": dict(
        centers=[[1.0, 1, 1], [6.0, 6, 6]],
        traj=np.tile([0, 1], 100)[:, None],
        kw=dict(distance_threshold=None), n_out=1),
    "site_types": dict(
        centers=[[1.0, 1, 1], [1.5, 1, 1], [6, 6, 6]],
        traj=_flicker_traj(1), kw=dict(distance_threshold=2.0),
        net=dict(site_types=[0, 1, 0]), n_out=3),
    "vertices_union": dict(
        centers=[[1.0, 1, 1], [1.5, 1, 1], [6, 6, 6]],
        traj=_flicker_traj(2),
        kw=dict(distance_threshold=2.0, inflation=1.5),
        net=dict(vertices=[[0, 1, 2], [1, 2, 3], [3, 4, 5]]), n_out=2),
    "uniform_self_loop": dict(
        centers=[[1.0, 1, 1], [1.5, 1, 1], [6, 6, 6]],
        traj=_flicker_traj(4),
        kw=dict(distance_threshold=2.0, self_loop=1.0, max_iters=50),
        n_out=None),
    "wrap_around": dict(
        centers=[[0.2, 1, 1], [9.9, 1, 1], [5, 5, 5]],
        traj=_flicker_traj(3), kw=dict(distance_threshold=1.0), n_out=2),
}


@pytest.mark.parametrize("name", list(DYNAMICS_CASES))
def test_merge_by_dynamics_matches_reference(name):
    c = DYNAMICS_CASES[name]
    rst, pst = _both(c["centers"], c["traj"], **c.get("net", {}))
    want = rdyn.MergeSitesByDynamics(verbose=False, **c["kw"]).run(rst)
    got = pdyn.MergeSitesByDynamics(verbose=False, device="cpu",
                                    **c["kw"]).run(pst)
    _assert_same_st(got, want)
    if c["n_out"] is not None:
        assert got.site_network.n_sites == c["n_out"]
    # the jump statistics the merger computed on the way are the same
    np.testing.assert_array_equal(pst.site_network.n_ij,
                                  rst.site_network.n_ij)


def test_merge_by_dynamics_on_random_hops_matches_reference():
    """A seeded random walk over 12 sites laid out in close pairs."""
    rng = np.random.default_rng(11)
    base = rng.uniform(1, 9, size=(6, 3))
    centers = np.concatenate([base, base + [0.4, 0, 0]])
    n, M = 400, 4
    traj = np.empty((n, M), np.int32)
    cur = rng.integers(0, 6, size=M)
    for f in range(n):
        move = rng.random(M) < 0.02
        cur = np.where(move, rng.integers(0, 6, size=M), cur)
        traj[f] = cur + 6 * rng.integers(0, 2, size=M)   # flicker in pair
    traj[rng.random(traj.shape) < 0.05] = -1
    rst, pst = _both(centers, traj)
    want = rdyn.MergeSitesByDynamics(verbose=False).run(rst)
    got = pdyn.MergeSitesByDynamics(verbose=False, device="cpu").run(pst)
    _assert_same_st(got, want)
    assert got.site_network.n_sites < 12


DISTANCE_CASES = {
    "pbc_single_linkage": dict(
        centers=[[1.0, 1, 1], [1.4, 1, 1], [5, 5, 5], [9.9, 1, 1]],
        traj=[[0, 1, 2], [3, 1, 2]], kw=dict(threshold=1.2), n_out=2),
    "types_block": dict(
        centers=[[1.0, 1, 1], [1.2, 1, 1], [1.1, 1.2, 1]],
        traj=np.zeros((4, 3)), kw=dict(threshold=1.0),
        net=dict(site_types=[0, 1, 0]), n_out=2),
    "types_ignored": dict(
        centers=[[1.0, 1, 1], [1.2, 1, 1], [1.1, 1.2, 1]],
        traj=np.zeros((4, 3)), kw=dict(threshold=1.0, check_types=False),
        net=dict(site_types=[0, 1, 0]), n_out=1),
    "nothing_close": dict(
        centers=[[1.0, 1, 1], [5, 5, 5], [8, 2, 6]],
        traj=[[0, 1, 2], [-1, 1, 0]], kw=dict(threshold=0.5), n_out=3),
}


@pytest.mark.parametrize("name", list(DISTANCE_CASES))
def test_merge_by_distance_matches_reference(name):
    c = DISTANCE_CASES[name]
    rst, pst = _both(c["centers"], c["traj"], **c.get("net", {}))
    want = rdyn.MergeSitesByDistance(verbose=False, **c["kw"]).run(rst)
    got = pdyn.MergeSitesByDistance(verbose=False, **c["kw"]).run(pst)
    _assert_same_st(got, want)
    assert got.site_network.n_sites == c["n_out"]


def test_overlapping_merge_groups_raise():
    from sitator_tpu_torch.network import MergeSitesBase

    class Overlap(MergeSitesBase):
        def _get_merges(self, st):
            return [[0, 1], [1, 2]]

    _, pst = _both([[1.0, 1, 1], [1.2, 1, 1], [1.4, 1, 1]], [[0, 1, 2]])
    with pytest.raises(ValueError, match="overlap"):
        Overlap(verbose=False).run(pst)


# -- filters -------------------------------------------------------------------

@pytest.mark.parametrize("threshold,traj", [
    (0.0, [[0, 2, 4], [0, 2, 4]]),
    (0.4, [[0, 2, 4], [0, 2, 1], [0, 3, 1]]),
    (0.0, [[-1, 2, -1], [2, 2, -1]]),
])
def test_remove_unoccupied_sites_matches_reference(threshold, traj):
    rng = np.random.default_rng(2)
    rst, pst = _both(rng.uniform(0, 10, (5, 3)), traj)
    for st in (rst, pst):
        st.site_network.add_site_attribute("site_radii", np.arange(5.0))
        st.site_network.add_edge_attribute(
            "w", np.arange(25.0).reshape(5, 5))
    want = rdyn.RemoveUnoccupiedSites(threshold, verbose=False).run(rst)
    got = pdyn.RemoveUnoccupiedSites(threshold, verbose=False).run(pst)
    _assert_same_st(got, want)
    np.testing.assert_array_equal(got.site_network.w, want.site_network.w)


@pytest.mark.parametrize("frame_threshold,col", [
    (2, [0, 0, 0, 1, 0, 0, 2, 2, 2, 2, 1, 2, 2, 0]),
    (2, [0, -1, 0, 1, -1, 0, 0]),
    (3, [0, 0, 1, 1, 0, 0, 2, 1, 2, 2, 2, 0, 0, 0, 1]),
    (1, [0, 1, 0, 1, 0]),
])
def test_remove_short_jumps_matches_reference(frame_threshold, col):
    rng = np.random.default_rng(4)
    rst, pst = _both(rng.uniform(0, 10, (3, 3)), np.asarray(col)[:, None])
    want = rdyn.RemoveShortJumps(frame_threshold, verbose=False).run(rst)
    got = pdyn.RemoveShortJumps(frame_threshold, verbose=False).run(pst)
    np.testing.assert_array_equal(got.traj, want.traj)
    if frame_threshold == 2 and len(col) == 14:
        np.testing.assert_array_equal(
            got.traj[:, 0], [0, 0, 0, 0, 0, 0, 2, 2, 2, 2, 2, 2, 2, 0])


def test_seeded_random_labels_through_both_filters():
    rng = np.random.default_rng(8)
    traj = rng.integers(-1, 7, size=(200, 5))
    rst, pst = _both(rng.uniform(0, 10, (9, 3)), traj)
    want = rdyn.RemoveUnoccupiedSites(verbose=False).run(
        rdyn.RemoveShortJumps(3, verbose=False).run(rst))
    got = pdyn.RemoveUnoccupiedSites(verbose=False).run(
        pdyn.RemoveShortJumps(3, verbose=False).run(pst))
    _assert_same_st(got, want)
    assert got.site_network.n_sites == 7


# -- jump_lag_by_type ------------------------------------------------------------

def test_jump_lag_by_type_matches_reference():
    rng = np.random.default_rng(5)
    traj = rng.integers(-1, 6, size=(300, 4))
    rst, pst = _both(rng.uniform(0, 10, (6, 3)), traj,
                     site_types=[0, 0, 1, 1, 2, 1])
    rja = rdyn.JumpAnalysis(verbose=False)
    rja.run(rst)
    pja = pdyn.JumpAnalysis(verbose=False, device="cpu")
    pja.run(pst)
    tw, want = rja.jump_lag_by_type(rst.site_network)
    tg, got = pja.jump_lag_by_type(pst.site_network)
    np.testing.assert_array_equal(tg, tw)
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    pst.site_network.site_types = None
    with pytest.raises(ValueError, match="site_types"):
        pja.jump_lag_by_type(pst.site_network)


# -- merge_network ---------------------------------------------------------------

@pytest.mark.parametrize("distance_threshold", [3.0, 0.45, None])
def test_merge_network_matches_reference(distance_threshold):
    """A streamed-result network made by hand: seeded hop counts over sites
    laid out in pairs and triples, heavy flicker inside each group."""
    rng = np.random.default_rng(13)
    base = rng.uniform(1, 9, size=(7, 3))
    group = np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 5, 5, 6])
    centers = base[group] + 0.3 * rng.random((12, 3))
    n_ij = rng.integers(0, 3, size=(12, 12))
    same = group[:, None] == group[None, :]
    n_ij = np.where(same, rng.integers(40, 90, size=(12, 12)), n_ij)
    np.fill_diagonal(n_ij, 0)
    occ = rng.random(12)
    occ[9] = 0.0
    nets = []
    for pkg in (ref, port):
        sn = _network(pkg, centers)
        sn.add_edge_attribute("n_ij", n_ij.astype(np.int64))
        sn.add_site_attribute("occupancies", occ)
        nets.append(sn)
    want, wmap = JaxStreaming.merge_network(
        nets[0], distance_threshold=distance_threshold, verbose=False)
    got, gmap = port.StreamingLandmarkAnalysis.merge_network(
        nets[1], distance_threshold=distance_threshold, verbose=False,
        device="cpu")
    np.testing.assert_array_equal(gmap, wmap)
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-9)
    np.testing.assert_array_equal(got.n_ij, want.n_ij)
    np.testing.assert_allclose(got.occupancies, want.occupancies, atol=1e-12)
    np.testing.assert_allclose(got.p_ij, want.p_ij, atol=1e-12)
    assert got.n_sites < 12
    assert np.all(np.diag(got.n_ij) == 0)


# -- clustering backends ---------------------------------------------------------

def _landmark_vectors(seed, n_proto=5, per=60, dim=24, noise=0.05):
    rng = np.random.default_rng(seed)
    protos = np.abs(rng.normal(size=(n_proto, dim))) * (
        rng.random((n_proto, dim)) < 0.3)
    protos[np.arange(n_proto), np.arange(n_proto)] += 1.0
    X = np.repeat(protos, per, axis=0) + noise * np.abs(
        rng.normal(size=(n_proto * per, dim)))
    X = X[rng.permutation(len(X))]
    return (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed,params,min_samples", [
    (0, {}, 5), (1, {"inflation": 2.0}, 1), (2, {"max_samples": 100}, 10),
    (3, {"similarity_threshold": 0.999999}, 50),
])
def test_mcl_backend_matches_reference(seed, params, min_samples):
    lv = _landmark_vectors(seed)
    want = ref_backend("mcl").do_landmark_clustering(lv, params, min_samples)
    got = port_backend("mcl").do_landmark_clustering(lv, params, min_samples,
                                                     device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    if seed == 0:
        assert 2 <= len(got[0]) <= 5 and (got[1] >= 0).all()
    if seed == 3:           # no edges, so no cluster reaches min_samples
        assert len(got[0]) == 0 and (got[1] == -1).all()


def test_mcl_backend_is_registered():
    """``clustering_algorithm='mcl'`` resolves in the port's engines."""
    assert port_backend("mcl").__name__.endswith("cluster.mcl")
    with pytest.raises(ValueError, match="mcl"):
        port_backend("nope")


@pytest.mark.parametrize("seed,threshold,min_samples", [(0, 0.9, 1),
                                                        (1, 0.8, 10),
                                                        (2, 0.95, 3)])
def test_dotprod_classifier_matches_reference(seed, threshold, min_samples):
    X = _landmark_vectors(seed) * 3.0           # the classifier normalises
    want = RefClassifier(threshold=threshold, min_samples=min_samples)
    got = PortClassifier(threshold=threshold, min_samples=min_samples,
                         device="cpu")
    with pytest.raises(ValueError, match="not been fit"):
        got.n_clusters
    lw, cw = want.fit_predict(X, return_confidences=True)
    lg, cg = got.fit_predict(X, return_confidences=True)
    assert got.n_clusters == want.n_clusters
    np.testing.assert_allclose(got.cluster_centers, want.cluster_centers,
                               atol=1e-6)
    np.testing.assert_array_equal(lg, lw)
    np.testing.assert_allclose(cg, cw, atol=1e-6)
    np.testing.assert_array_equal(got.predict(X[:17], threshold=0.5),
                                  want.predict(X[:17], threshold=0.5))
