"""K1s (``mxu_assign_blocks(skew=True)``) in the port against K1 and against
the JAX package's skew kernel in interpret mode, on the CPU.

K1s computes the same function as K1, only with its site tiles overlapped,
so on CPU tensors both run the same plain version and must be bit-equal.
Against the reference: the gate and tolerances of the K1 parity test in
``tests/test_torch_landmark_kernels.py`` (confidences ``atol=1e-5`` with f32
similarity operands and ``1e-2`` with bf16; labels equal wherever the
reference's f32 top-2 margin exceeds 1e-5, or 8e-3 with bf16, and the best
similarity is not within the confidence tolerance of the threshold).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu.ops import landmark as jlm
from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu_torch.ops import kernel_common as tkc
from sitator_tpu_torch.ops import landmark_mxu as tmx
from tests.test_landmark_mxu import _sc_system, _system
from tests.test_torch_landmark_kernels import (THR, TRICLINIC,
                                               _assert_assign,
                                               _reference_margin)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _skew_pair(mobile, static, basis, kcell, centers, **kw):
    args = (_t(mobile), _t(static), basis, kcell,
            tmx.permute_centers(centers, basis))
    return (tmx.mxu_assign_blocks(*args, skew=False, **kw),
            tmx.mxu_assign_blocks(*args, skew=True, **kw))


@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
@pytest.mark.parametrize("cutoff_shape,mxu_bf16", [
    ("logistic", False), ("logistic_r2", False), ("logistic_r2", True)])
def test_skew_plain_is_bit_equal_to_k1(cutoff_shape, mxu_bf16, cell_kind):
    r = np.random.default_rng(31)
    cell = TRICLINIC if cell_kind == "triclinic" else None
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=200, K=8, cell=cell)     # 2 tiles at s_tile 128
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    (la, ca), (ls, cs) = _skew_pair(
        mobile, static, bt, tkc.kernel_cell(cell).numpy(), centers,
        midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=mxu_bf16,
        cutoff_shape=cutoff_shape)
    assert torch.equal(la, ls)
    assert torch.equal(ca.view(torch.int32), cs.view(torch.int32))


def test_skew_matches_reference_f32():
    """The reference's ``_system`` case of its skew test, f32 similarities."""
    r = np.random.default_rng(31)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=150, K=8)
    kcell = np.diag(cell).astype(np.float32)
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=False,
              cutoff_shape="logistic_r2")
    want = jmx.mxu_assign_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                 bj, jnp.asarray(kcell),
                                 jmx.permute_centers(centers, bj), skew=True,
                                 interpret=True, **kw)
    got = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                tmx.permute_centers(centers, bt), skew=True,
                                **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape="logistic_r2", peak_evening="none")
    _assert_assign(got, want, margin, top1, False)


def test_skew_matches_reference_preshift_bf16():
    """The reference's ``_sc_system`` case: preshift basis, bf16
    similarities (the production configuration).  Ions sit near sites and
    the centres are the unit landmark vectors of ions on 8 sites, so the
    labels are not all inside the bf16 margin gate."""
    cell, _, static, verts, vmask, _, site_pos = _sc_system(n_c=16)
    r = np.random.default_rng(43)
    picked = r.choice(len(site_pos), 8, replace=False)
    mobile = (site_pos[picked[:6]][None]
              + r.normal(scale=0.3, size=(2, 6, 3))).astype(np.float32)
    lv = jlm.landmark_vectors(
        jnp.asarray(site_pos[picked][None], jnp.float32),
        jnp.asarray(static[:1]),
        jlm.vertex_membership_matrix(verts, vmask, static.shape[1]),
        jnp.asarray(cell), jnp.asarray(np.linalg.inv(cell), jnp.float32),
        3.0, 4.0, cutoff_shape="logistic_r2")[0]
    centers = np.asarray(lv / jnp.linalg.norm(lv, axis=1, keepdims=True))
    kw_b = dict(s_tile=128, static_ref=np.asarray(static[0], np.float64),
                midpoint=3.0, steepness=4.0, cutoff_shape="logistic_r2")
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw_b)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, **kw_b)
    assert bj["preshift"] and bt["preshift"]
    kcell = np.diag(cell).astype(np.float32)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=True,
              cutoff_shape="logistic_r2")
    want = jmx.mxu_assign_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                 bj, jnp.asarray(kcell),
                                 jmx.permute_centers(centers, bj), skew=True,
                                 interpret=True, **kw)
    got = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                tmx.permute_centers(centers, bt), skew=True,
                                **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape="logistic_r2", peak_evening="none")
    _assert_assign(got, want, margin, top1, True)


def test_skew_with_clip_raises():
    r = np.random.default_rng(33)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=150, K=8)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    with pytest.raises(ValueError, match="skew"):
        tmx.mxu_assign_blocks(_t(mobile), _t(static), bt,
                              np.diag(cell).astype(np.float32),
                              tmx.permute_centers(centers, bt), midpoint=3.0,
                              steepness=4.0, threshold=THR,
                              cutoff_shape="logistic_r2",
                              peak_evening="clip", skew=True)


def test_skew_on_cpu_counts_no_launch():
    """On CPU tensors K1s runs its plain version: neither counter moves."""
    before = (tmx.mxu_assign_blocks.launches,
              tmx.mxu_assign_blocks.skew_launches)
    r = np.random.default_rng(35)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(r)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    tmx.mxu_assign_blocks(_t(mobile), _t(static), bt,
                          np.diag(cell).astype(np.float32),
                          tmx.permute_centers(centers, bt), midpoint=3.0,
                          steepness=4.0, threshold=THR, skew=True)
    assert (tmx.mxu_assign_blocks.launches,
            tmx.mxu_assign_blocks.skew_launches) == before


@pytest.mark.parametrize("cell_kind,cutoff_shape,mxu_bf16", [
    ("orthorhombic", "logistic", False), ("triclinic", "logistic", False),
    ("orthorhombic", "logistic_r2", True), ("triclinic", "logistic_r2", True)])
def test_skew_matches_reference_cases(cell_kind, cutoff_shape, mxu_bf16):
    """K1s's plain path against the reference's skew kernel in interpret
    mode across cells, cutoffs and similarity precisions (two kd tiles,
    so the skew's cross-tile carry is exercised)."""
    r = np.random.default_rng(19)
    cell = TRICLINIC if cell_kind == "triclinic" else None
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=200, K=8, cell=cell)
    kcell = tkc.kernel_cell(cell).numpy()
    bj = jmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=THR, mxu_bf16=mxu_bf16,
              cutoff_shape=cutoff_shape)
    want = jmx.mxu_assign_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                 bj, jnp.asarray(kcell),
                                 jmx.permute_centers(centers, bj), skew=True,
                                 interpret=True, **kw)
    got = tmx.mxu_assign_blocks(_t(mobile), _t(static), bt, kcell,
                                tmx.permute_centers(centers, bt), skew=True,
                                **kw)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape=cutoff_shape, peak_evening="none")
    _assert_assign(got, want, margin, top1, mxu_bf16)
