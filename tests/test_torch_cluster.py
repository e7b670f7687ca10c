"""The port's dot-product clustering against the JAX reference: equal
labels and active sets, centres within 1e-5; a backend registered by name
runs ``LandmarkAnalysis`` in both packages to the same trajectory."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis as JaxLandmarkAnalysis
from sitator_tpu.landmark.cluster import dotprod as jdot
from sitator_tpu.landmark.cluster import register_backend as jax_register
from sitator_tpu.ops import cluster as jcl
from sitator_tpu.voronoi import VoronoiSiteGenerator
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.landmark.cluster import (dotprod as tdot, get_backend,
                                                register_backend)
from sitator_tpu_torch.ops import cluster as tcl

torch.set_num_threads(2)


def _samples(seed, n_clusters=6, per=40, d=24, noise=0.15):
    """Unit rows scattered around ``n_clusters`` random positive
    directions, plus a few zero rows (ions that saw no landmark)."""
    r = np.random.default_rng(seed)
    dirs = r.random((n_clusters, d)) ** 4
    X = np.repeat(dirs, per, axis=0) + noise * r.random((n_clusters * per, d))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X[r.choice(len(X), 5, replace=False)] = 0.0
    return X[r.permutation(len(X))].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_max", [4, 32])
def test_dotprod_fit_matches_reference(seed, k_max):
    X = _samples(seed)
    want = jcl.dotprod_fit(jnp.asarray(X), k_max=k_max, cluster_threshold=0.9,
                           min_samples=3)
    got = tcl.dotprod_fit(torch.from_numpy(X), k_max=k_max,
                          cluster_threshold=0.9, min_samples=3)
    assert got.n_clusters == want.n_clusters > 0
    np.testing.assert_array_equal(got.active.numpy(),
                                  np.asarray(want.active))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               atol=1e-5)


def test_seed_skips_uncoverable_rows():
    """Rows with norm below the threshold can never be covered by a unit
    centre, so they never seed (else seeding would spin on them)."""
    X = _samples(3)
    X[:7] *= 0.5                      # sub-threshold norms, seen first
    want_c, want_k = jcl._seed(jnp.asarray(X),
                               jnp.sum(jnp.asarray(X) ** 2, 1) >= 0.81,
                               16, 0.9)
    got = tcl.dotprod_fit(torch.from_numpy(X), k_max=16,
                          cluster_threshold=0.9)
    ref = jcl.dotprod_fit(jnp.asarray(X), k_max=16, cluster_threshold=0.9)
    assert got.n_clusters == ref.n_clusters
    got_c, got_k = tcl._seed(torch.from_numpy(X),
                             (torch.from_numpy(X) ** 2).sum(1) >= 0.81, 16,
                             0.9)
    assert got_k == int(want_k)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_refine_matches_reference():
    X = _samples(4)
    c0, k = jcl._seed(jnp.asarray(X), jnp.ones(len(X), bool), 8, 0.9)
    want_c, want_n = jcl.dotprod_refine(jnp.asarray(X), c0, k, 8, 0.9,
                                        n_iters=5)
    got_c, got_n = tcl.dotprod_refine(torch.from_numpy(X),
                                      torch.from_numpy(np.array(c0)),
                                      int(k), 8, 0.9, n_iters=5)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)


@pytest.mark.parametrize("params", [
    {}, {"fit_max_samples": 64, "predict_block": 50}])
def test_dotprod_backend_matches_reference(params):
    X = _samples(5, n_clusters=8)
    params = dict(params, clustering_threshold=0.9, assignment_threshold=0.8)
    want = jdot.do_landmark_clustering(X, params, min_samples=10)
    got = get_backend("dotprod").do_landmark_clustering(
        X, params, min_samples=10, device="cpu")
    counts, labels, confs, centers = got
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(labels, want[1])
    np.testing.assert_allclose(confs, want[2], atol=1e-5)
    np.testing.assert_allclose(centers, want[3], atol=1e-5)
    assert got[0].sum() > 0


def test_get_backend_rejects_unknown():
    with pytest.raises(ValueError, match="unknown clustering backend"):
        get_backend("kmeans")
    with pytest.raises(TypeError):
        get_backend(3)
    assert get_backend(tdot) is tdot


class _DominantLandmark:
    """A module-like backend in NumPy: every sample goes to the landmark
    it is nearest (its largest component), a site for each landmark that
    holds at least ``min_samples`` samples; confidence = that component
    of the unit row.  ``calls`` records the keywords it was given."""

    def __init__(self, takes_device):
        self.calls = []
        if takes_device:
            def do_landmark_clustering(lv, params, min_samples,
                                       verbose=False, device=None):
                self.calls.append({"verbose": verbose, "device": device})
                return self._cluster(lv, params, min_samples)
        else:
            def do_landmark_clustering(lv, params, min_samples,
                                       verbose=False):
                self.calls.append({"verbose": verbose})
                return self._cluster(lv, params, min_samples)
        self.do_landmark_clustering = do_landmark_clustering

    @staticmethod
    def _cluster(lv, params, min_samples):
        lv = np.asarray(lv, np.float64)
        top = lv.argmax(1)
        seen = lv.max(1) >= params["floor"]
        landmarks, counts = np.unique(top[seen], return_counts=True)
        landmarks = landmarks[counts >= min_samples]
        counts = counts[counts >= min_samples]
        site = np.full(lv.shape[1], -1)
        site[landmarks] = np.arange(len(landmarks))
        labels = np.where(seen, site[top], -1).astype(np.int32)
        confs = np.where(labels >= 0, lv.max(1), 0.0).astype(np.float32)
        return counts, labels, confs, np.eye(lv.shape[1])[landmarks]


@pytest.mark.parametrize("takes_device", [False, True],
                         ids=["reference_contract", "with_device"])
def test_registered_backend_runs_landmark_analysis(takes_device):
    """``register_backend`` in both packages: a module-like backend under a
    new name drives ``LandmarkAnalysis(clustering_algorithm=name)`` in each
    to the same trajectory, confidences within 1e-5.  The port hands
    ``device`` only to a backend that takes it (one written to the
    reference's contract is called as the reference calls it)."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=80,
                                 jump_rate=0.02, seed=31)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    frames = md.traj.astype(np.float32)
    name = f"dominant_landmark_{takes_device}"
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False,
              clustering_algorithm=name, clustering_params={"floor": 0.5})
    ref_backend, port_backend = (_DominantLandmark(takes_device)
                                 for _ in range(2))
    jax_register(name, ref_backend)
    register_backend(name, port_backend)
    assert get_backend(name) is port_backend
    want = JaxLandmarkAnalysis(**kw).run(seeds, frames)
    got = LandmarkAnalysis(device="cpu", **kw).run(seeds, frames)
    assert len(port_backend.calls) == len(ref_backend.calls) == 1
    assert port_backend.calls[0] == (
        {"verbose": False, "device": torch.device("cpu")} if takes_device
        else {"verbose": False})
    assert got.site_network.n_sites == want.site_network.n_sites > 1
    np.testing.assert_array_equal(got.traj, want.traj)
    assert (got.traj >= 0).mean() > 0.5
    np.testing.assert_allclose(got.confidences, want.confidences, atol=1e-5)
    np.testing.assert_allclose(got.site_network.centers,
                               want.site_network.centers, atol=1e-4)
