"""The port's landmark math against the JAX reference on the CPU: the dense
``ops/landmark.py`` functions, and the plain PyTorch versions of the three
kernels (K1 unique-atom assign, K2 unique-atom landmark vectors, K3 gather
assign) against the Pallas kernels run in interpret mode.

Tolerances: landmark vectors ``rtol=1e-4, atol=1e-6`` (f32 sums in another
order, then ``exp``); confidences ``atol=1e-5`` with f32 similarity
operands and ``1e-2`` with bf16; labels equal wherever the reference's f32
top-2 margin exceeds 1e-5 (f32) or 8e-3 (bf16, about 2 bf16 ulps near 1)
and the best similarity is not within the confidence tolerance of the
threshold.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu.ops import landmark as jlm
from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu.ops import landmark_pallas as jlp
from sitator_tpu.ops import pbc as jpbc
from sitator_tpu_torch.ops import kernel_common as tkc
from sitator_tpu_torch.ops import landmark as tlm
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops import landmark_pallas as tlp
from sitator_tpu_torch.ops import pbc as tpbc
from tests.test_landmark_mxu import _sc_system, _system

torch.set_num_threads(2)

LV_TOL = dict(rtol=1e-4, atol=1e-6)
THR = 0.3
TRICLINIC = np.array([[11.0, 0, 0], [0.25 * 11, 12.0, 0],
                      [-0.15 * 11, 0.2 * 11, 13.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_system(cell_kind, seed, **kw):
    r = np.random.default_rng(seed)
    cell = TRICLINIC if cell_kind == "triclinic" else None
    return _system(r, cell=cell, **kw)


def _reference_margin(cell, mobile, static, verts, vmask, centers, *,
                      midpoint, steepness, cutoff_shape, peak_evening):
    """f32 top-1 minus top-2 similarity and top-1, from the reference's
    dense route, with the kernels' zero padded centre columns."""
    A = jlm.vertex_membership_matrix(verts, vmask, static.shape[1])
    lv = jlm.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), midpoint, steepness,
        cutoff_shape=cutoff_shape)
    lvn, _ = jlm.normalize_landmark_vectors(jlm.peak_even(lv, peak_evening))
    sims = np.asarray(lvn) @ centers.T
    sims = np.concatenate(
        [sims, np.zeros(sims.shape[:-1] + ((-len(centers)) % 128,))], -1)
    top = -np.sort(-sims, axis=-1)[..., :2]
    return top[..., 0] - top[..., 1], top[..., 0]


def _assert_assign(got, want, margin, top1, bf16):
    gl, gc = (x.numpy() for x in got)
    wl, wc = (np.asarray(x) for x in want)
    atol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose(gc, wc, rtol=0, atol=atol)
    gate = (margin <= (8e-3 if bf16 else 1e-5)) | (np.abs(top1 - THR) <= atol)
    assert (~gate).any(), "every label is inside the margin gate"
    np.testing.assert_array_equal(gl[~gate], wl[~gate])


# -- dense ops/landmark.py and ops/pbc.py ------------------------------------

@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
def test_dense_landmark_vectors(cutoff_shape, cell_kind):
    cell, mobile, static, verts, vmask, centers, _ = _random_system(
        cell_kind, 3)
    A_j = jlm.vertex_membership_matrix(verts, vmask, static.shape[1])
    A_t = tlm.vertex_membership_matrix(verts, vmask, static.shape[1])
    np.testing.assert_array_equal(np.asarray(A_j), A_t.numpy())
    inv = np.linalg.inv(cell).astype(np.float32)
    want = jlm.landmark_vectors(jnp.asarray(mobile), jnp.asarray(static),
                                A_j, jnp.asarray(cell), jnp.asarray(inv),
                                3.0, 4.0, cutoff_shape=cutoff_shape)
    got = tlm.landmark_vectors(_t(mobile), _t(static), A_t, _t(cell),
                               _t(inv), 3.0, 4.0, cutoff_shape=cutoff_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LV_TOL)


@pytest.mark.parametrize("mode", ["none", "clip"])
def test_dense_peak_even_normalize_with_ties(mode):
    r = np.random.default_rng(5)
    lv = r.random((3, 4, 9)).astype(np.float32)
    lv[0, 0, [2, 5]] = 2.0            # a repeated maximum
    lv[1, 1] = 0.0                    # an all-zero row stays zero
    want = jlm.normalize_landmark_vectors(jlm.peak_even(jnp.asarray(lv),
                                                        mode))
    got = tlm.normalize_landmark_vectors(tlm.peak_even(_t(lv), mode))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"])
def test_dense_assign_to_centers(matmul_dtype):
    r = np.random.default_rng(7)
    lv = r.random((2, 20, 12)).astype(np.float32)
    lv /= np.linalg.norm(lv, axis=-1, keepdims=True)
    centers = r.random((6, 12)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    centers[4] = centers[1]           # an exact tie: the first index wins
    active = np.array([True, True, False, True, True, True])
    want_l, want_c = jlm.assign_to_centers(
        jnp.asarray(lv), jnp.asarray(centers), jnp.asarray(active), 0.8,
        matmul_dtype=None if matmul_dtype is None else jnp.bfloat16)
    got_l, got_c = tlm.assign_to_centers(
        _t(lv), _t(centers), _t(active), 0.8,
        matmul_dtype=None if matmul_dtype is None else torch.bfloat16)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_dense_static_drift_and_min_image():
    r = np.random.default_rng(9)
    cell = TRICLINIC
    inv = np.linalg.inv(cell).astype(np.float32)
    ref = (r.random((30, 3)) @ cell).astype(np.float32)
    blk = (ref[None] + r.normal(scale=0.3, size=(4, 30, 3))
           + np.array([cell[0] * 2])).astype(np.float32)
    want = jlm.static_drift_per_frame(jnp.asarray(blk), jnp.asarray(ref),
                                      jnp.asarray(cell), jnp.asarray(inv))
    got = tlm.static_drift_per_frame(_t(blk), _t(ref), _t(cell), _t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(tlm.max_static_drift(_t(blk), _t(ref), _t(cell), _t(inv))),
        float(jlm.max_static_drift(jnp.asarray(blk), jnp.asarray(ref),
                                   jnp.asarray(cell), jnp.asarray(inv))),
        rtol=1e-5)
    d = (r.normal(size=(50, 3)) * 20).astype(np.float32)
    for exact in (False, True):
        np.testing.assert_allclose(
            tpbc.min_image_disp(_t(d), _t(cell), _t(inv), exact=exact),
            np.asarray(jpbc.min_image_disp(jnp.asarray(d), jnp.asarray(cell),
                                           jnp.asarray(inv), exact=exact)),
            atol=2e-5)


def test_pbc_calculator_copy_matches():
    r = np.random.default_rng(11)
    cell = TRICLINIC.astype(np.float64)
    pts = r.random((12, 3)) @ cell
    w = r.random(12)
    for exact in (False, True):
        a, b = jpbc.PBCCalculator(cell, exact), tpbc.PBCCalculator(cell,
                                                                   exact)
        np.testing.assert_array_equal(a.pairwise_distances(pts),
                                      b.pairwise_distances(pts))
        np.testing.assert_array_equal(a.average(pts, w), b.average(pts, w))
        np.testing.assert_array_equal(a.min_image(pts[0], pts),
                                      b.min_image(pts[0], pts))


def test_merge_top2_matches_global_top2():
    r = np.random.default_rng(13)
    lv = r.random((5, 40)).astype(np.float32)
    lv[0, [3, 31]] = 1.5              # the maximum twice, in two tiles
    lv[1, 7] = 1.5                    # once
    acc = torch.zeros((5, 2))
    for lo in range(0, 40, 16):
        acc = tkc.merge_top2(acc, _t(lv[:, lo:lo + 16]))
    want = np.asarray(jnp.sort(jnp.asarray(lv), axis=-1)[:, ::-1][:, :2])
    np.testing.assert_array_equal(acc.numpy(), want)


# -- K2: unique-atom landmark vectors ----------------------------------------

@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
def test_k2_plain_matches_reference(cutoff_shape, cell_kind):
    cell, mobile, static, verts, vmask, _, site_pos = _random_system(
        cell_kind, 17, S=150)
    kcell = tkc.kernel_cell(cell).numpy()
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    want = jmx.mxu_landmark_blocks(
        jnp.asarray(mobile), jnp.asarray(static), bj, jnp.asarray(kcell),
        midpoint=3.0, steepness=4.0, interpret=True,
        cutoff_shape=cutoff_shape)
    got = tmx.mxu_landmark_blocks(_t(mobile), _t(static), bt, kcell,
                                  midpoint=3.0, steepness=4.0,
                                  cutoff_shape=cutoff_shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LV_TOL)


def _preshift_case(cutoff_shape):
    """The smallest simple-cubic cell whose kd tiles pass the preshift
    bound at this cutoff: 16^3 sites, s_tile 128."""
    mid, steep = (4.0, 6.0) if cutoff_shape == "logistic_r2" else (4.5, 12.0)
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system(
        n_c=16, M=6, B=2, K=8)
    # ions near the face shared by two sites: both see the ion, so the
    # clipped rows keep two landmarks under the steep cutoff
    r = np.random.default_rng(41)
    mobile = (site_pos[r.choice(len(site_pos), 6, replace=False)][None]
              + np.array([2.0, 0.0, 0.0])
              + r.normal(scale=0.15, size=(2, 6, 3))).astype(np.float32)
    kw = dict(s_tile=128, static_ref=np.asarray(static[0], np.float64),
              midpoint=mid, steepness=steep, cutoff_shape=cutoff_shape)
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw)
    assert bj["preshift"] and bt["preshift"]
    return cell, mobile, static, verts, vmask, centers, bj, bt, mid, steep


@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_k2_plain_matches_reference_preshift(cutoff_shape):
    cell, mobile, static, _, _, _, bj, bt, mid, steep = _preshift_case(
        cutoff_shape)
    kcell = np.diag(cell).astype(np.float32)
    want = jmx.mxu_landmark_blocks(
        jnp.asarray(mobile), jnp.asarray(static), bj, jnp.asarray(kcell),
        midpoint=mid, steepness=steep, interpret=True,
        cutoff_shape=cutoff_shape)
    got = tmx.mxu_landmark_blocks(_t(mobile), _t(static), bt, kcell,
                                  midpoint=mid, steepness=steep,
                                  cutoff_shape=cutoff_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LV_TOL)


# -- K1: unique-atom assign --------------------------------------------------

@pytest.mark.parametrize("peak_evening", ["none", "clip"])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
@pytest.mark.parametrize("cutoff_shape,mxu_bf16", [
    ("logistic", False), ("logistic_r2", False), ("logistic_r2", True)])
def test_k1_plain_matches_reference(cutoff_shape, mxu_bf16, cell_kind,
                                    peak_evening):
    cell, mobile, static, verts, vmask, centers, site_pos = _random_system(
        cell_kind, 19, S=200, K=8)   # 2 tiles at s_tile 128: cross-tile top-2
    kcell = tkc.kernel_cell(cell).numpy()
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=mxu_bf16,
              cutoff_shape=cutoff_shape, peak_evening=peak_evening)
    want = jmx.mxu_assign_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                 bj, jnp.asarray(kcell),
                                 jmx.permute_centers(centers, bj),
                                 interpret=True, **kw)
    got = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                tmx.permute_centers(centers, bt), **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape=cutoff_shape, peak_evening=peak_evening)
    _assert_assign(got, want, margin, top1, mxu_bf16)


@pytest.mark.parametrize("peak_evening", ["none", "clip"])
@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_k1_plain_matches_reference_preshift(cutoff_shape, peak_evening):
    cell, mobile, static, verts, vmask, centers, bj, bt, mid, steep = \
        _preshift_case(cutoff_shape)
    kcell = np.diag(cell).astype(np.float32)
    kw = dict(midpoint=mid, steepness=steep, threshold=THR, mxu_bf16=False,
              cutoff_shape=cutoff_shape, peak_evening=peak_evening)
    want = jmx.mxu_assign_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                 bj, jnp.asarray(kcell),
                                 jmx.permute_centers(centers, bj),
                                 interpret=True, **kw)
    got = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                tmx.permute_centers(centers, bt), **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=mid,
        steepness=steep, cutoff_shape=cutoff_shape,
        peak_evening=peak_evening)
    _assert_assign(got, want, margin, top1, False)


# -- K3: gather assign -------------------------------------------------------

@pytest.mark.parametrize("peak_evening,full_mask", [
    ("none", False), ("clip", True), ("none", True), ("clip", False)])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
@pytest.mark.parametrize("cutoff_shape,mxu_bf16", [
    ("logistic", False), ("logistic_r2", True)])
def test_k3_plain_matches_reference(cutoff_shape, mxu_bf16, cell_kind,
                                    peak_evening, full_mask):
    cell, mobile, static, verts, vmask, centers, _ = _random_system(
        cell_kind, 23, S=150, K=8)
    if full_mask:
        vmask = np.ones_like(vmask)
    kcell = tkc.kernel_cell(cell).numpy()
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, s_tile=128,
              mxu_bf16=mxu_bf16, cutoff_shape=cutoff_shape,
              peak_evening=peak_evening, full_mask=full_mask)
    want = jlp.fused_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(kcell), jnp.asarray(centers),
        interpret=True, **kw)
    got = tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask,
                                  kcell, centers, **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape=cutoff_shape, peak_evening=peak_evening)
    _assert_assign(got, want, margin, top1, mxu_bf16)


def test_k1_plain_matches_k3_plain():
    """The gather <-> unique-atom label identity, in the port alone."""
    cell, mobile, static, verts, vmask, centers, site_pos = _random_system(
        "orthorhombic", 29, S=150, K=8)
    kcell = tkc.kernel_cell(cell).numpy()
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=False,
              cutoff_shape="logistic_r2")
    la, ca = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                   tmx.permute_centers(centers, bt), **kw)
    lb, cb = tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask,
                                     kcell, centers, s_tile=128, **kw)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    np.testing.assert_allclose(ca.numpy(), cb.numpy(), atol=2e-5)


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run the plain versions: no kernel is
    built or launched, so no launch is counted."""
    before = (tmx.mxu_assign_blocks.launches,
              tmx.mxu_landmark_blocks.launches,
              tlp.fused_assign_blocks.launches)
    cell, mobile, static, verts, vmask, centers, site_pos = _random_system(
        "orthorhombic", 31)
    kcell = tkc.kernel_cell(cell).numpy()
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                          tmx.permute_centers(centers, bt), midpoint=3.0,
                          steepness=4.0, threshold=THR)
    tmx.mxu_landmark_blocks(_t(mobile), _t(static), bt, kcell, midpoint=3.0,
                            steepness=4.0)
    tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask, kcell,
                            centers, midpoint=3.0, steepness=4.0,
                            threshold=THR, s_tile=128)
    assert (tmx.mxu_assign_blocks.launches,
            tmx.mxu_landmark_blocks.launches,
            tlp.fused_assign_blocks.launches) == before


def test_wrappers_reject_bad_inputs():
    cell, mobile, static, verts, vmask, centers, site_pos = _random_system(
        "orthorhombic", 37)
    kcell = tkc.kernel_cell(cell).numpy()
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    with pytest.raises(TypeError):
        tmx.mxu_landmark_blocks(_t(mobile).double(), _t(static), bt, kcell,
                                midpoint=3.0, steepness=4.0)
    with pytest.raises(ValueError):
        tmx.mxu_assign_blocks(_t(mobile[0]), _t(static), bt, kcell,
                              tmx.permute_centers(centers, bt),
                              midpoint=3.0, steepness=4.0, threshold=THR)
    with pytest.raises(ValueError, match="peak_evening"):
        tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask, kcell,
                                centers, midpoint=3.0, steepness=4.0,
                                threshold=THR, peak_evening="flat")
