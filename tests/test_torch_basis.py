"""The port's host-side basis builder (a NumPy copy of the reference's)
must give the reference's arrays exactly: ``uidx``, ``A``, ``kill``,
``site_order``, ``inv_order``, ``ref_u``, ``anchors``, ``preshift``,
``s_tile``, ``n_st`` and ``UP``."""
import numpy as np
import pytest
import torch

from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu_torch.ops import landmark_mxu as tmx
from tests.test_landmark_mxu import _system

torch.set_num_threads(2)


def _sc_basis_inputs(n_c, shear=None, a=4.0):
    """Simple-cubic lattice of ``n_c``^3 sites, 8 corner atoms each."""
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cell = np.eye(3) * a * n_c
    if shear is not None:
        cell = cell + np.asarray(shear) * a * n_c
    verts = np.zeros((len(grid), 8), np.int32)
    for j, d in enumerate(np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                               indexing="ij"),
                                   -1).reshape(-1, 3)):
        v = (grid + d) % n_c
        verts[:, j] = (v[:, 0] * n_c + v[:, 1]) * n_c + v[:, 2]
    vmask = np.ones_like(verts, bool)
    site_pos = ((grid + 0.5) / n_c) @ cell
    static_ref = (grid / n_c) @ cell
    return verts, vmask, site_pos, cell, static_ref


def _assert_same_basis(bt, bj):
    for k in ("s_tile", "n_st", "UP", "cost_ratio", "preshift"):
        assert bt[k] == bj[k], k
    np.testing.assert_array_equal(bt["site_order"], np.asarray(
        bj["site_order"]))
    for k in ("uidx", "A", "kill", "inv_order", "ref_u", "anchors"):
        assert (k in bt) == (k in bj), k
        if k in bj:
            want = np.asarray(bj[k])
            got = bt[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def _random_inputs():
    """The random system of ``tests/test_landmark_mxu.py``."""
    cell, _, static, verts, vmask, _, site_pos = _system(
        np.random.default_rng(11), S=150)
    return verts, vmask, site_pos, cell, static[0]


CASES = {
    # 343 sites: several kd tiles and a padded last tile
    "sc7": lambda: _sc_basis_inputs(7),
    "random": _random_inputs,
    "triclinic": lambda: _sc_basis_inputs(
        7, shear=[[0, 0, 0], [0.2, 0, 0], [-0.1, 0.15, 0]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("s_tile", [64, 128, 256])
def test_prepare_mxu_basis_equal(case, s_tile):
    verts, vmask, site_pos, cell, _ = CASES[case]()
    _assert_same_basis(
        tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=s_tile),
        jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=s_tile))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_prepare_mxu_basis_with_reference_geometry_equal(case,
                                                         cutoff_shape):
    verts, vmask, site_pos, cell, static_ref = CASES[case]()
    kw = dict(s_tile=128, static_ref=static_ref, midpoint=2.0,
              steepness=30.0, cutoff_shape=cutoff_shape,
              vibration_margin=0.1)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    _assert_same_basis(bt, bj)


def test_preshift_basis_equal():
    """A cell large enough for the preshift route (16^3 sites)."""
    verts, vmask, site_pos, cell, static_ref = _sc_basis_inputs(16)
    kw = dict(s_tile=128, static_ref=static_ref, midpoint=3.0,
              steepness=4.0, cutoff_shape="logistic_r2")
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    assert bj["preshift"]
    _assert_same_basis(bt, bj)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("drift_budget", [None, 0.5])
def test_prepare_engine_basis_and_choose_s_tile_equal(case, drift_budget):
    verts, vmask, site_pos, cell, static_ref = CASES[case]()
    kw = dict(midpoint=4.0, steepness=3.0, cutoff_shape="logistic_r2",
              static_ref=static_ref, drift_budget=drift_budget)
    bt = tmx.prepare_engine_basis(verts, vmask, site_pos, cell, **kw)
    bj = jmx.prepare_engine_basis(verts, vmask, site_pos, cell, **kw)
    assert (bt is None) == (bj is None)
    if bj is not None:
        _assert_same_basis(bt, bj)
    assert tmx.choose_s_tile(verts, vmask, site_pos, cell) \
        == jmx.choose_s_tile(verts, vmask, site_pos, cell)


def test_no_sharing_basis_is_rejected_by_both():
    r = np.random.default_rng(3)
    verts = np.arange(64 * 5, dtype=np.int32).reshape(64, 5)
    vmask = np.ones_like(verts, bool)
    site_pos = r.random((64, 3)) * 10
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, np.eye(3) * 10,
                               s_tile=64)
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, np.eye(3) * 10,
                               s_tile=64)
    assert not tmx.mxu_supported(bt) and not jmx.mxu_supported(bj)
    _assert_same_basis(bt, bj)


def test_basis_from_jax_round_trip():
    verts, vmask, site_pos, cell, static_ref = _sc_basis_inputs(16)
    kw = dict(s_tile=128, static_ref=static_ref, midpoint=3.0,
              steepness=4.0, cutoff_shape="logistic_r2")
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    moved = tmx.basis_from_jax(bj, "cpu")
    _assert_same_basis(moved, bj)
    _assert_same_basis(tmx.basis_from_jax(bt, "cpu"), bj)
    centers = np.random.default_rng(5).random((4, len(verts)))
    np.testing.assert_array_equal(tmx.permute_centers(centers, moved),
                                  jmx.permute_centers(centers, bj))
