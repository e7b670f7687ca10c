"""K3's route on the card, through its plain twins, on the CPU.

- ``row_prep_plain`` (the norm in the kernels' lane-strided order: lane
  ``l`` sums ``fmaf(x, x, n2)`` over columns ``l, l + 32, ...``, then the
  xor-shuffle tree) equals the exact norm on exact inputs and the clip
  equals the reference's second-largest cap;
- the bf16 route's twin (the gather stage writes the bf16 copy and
  ``inv_norm`` itself) fed to ``blocked_assign_plain`` equals the f32
  route (the f32 lv, then ``row_prep``) fed to it, bit for bit;
- ``_gather_route_plain`` (the card's partition) agrees with the JAX
  package's K3 in interpret mode: labels equal outside the margin gate of
  ``tests/test_torch_landmark_kernels.py``, confidences within its
  tolerance;
- a far site overflows ``q`` to +inf and gets an exact 0, never NaN, in
  the port's plain version as in the reference;
- the kernel wrappers refuse what the kernels do not take.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sitator_tpu.ops import landmark_pallas as jlp
from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.ops import kernel_common as tkc
from sitator_tpu_torch.ops import landmark_pallas as tlp
from tests.test_torch_landmark_kernels import (THR, _assert_assign,
                                               _random_system,
                                               _reference_margin)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(cell_kind, cutoff_shape, full_mask, seed=23, **kw):
    cell, mobile, static, verts, vmask, centers, _ = _random_system(
        cell_kind, seed, S=150, K=8)
    if full_mask:
        vmask = np.ones_like(vmask)
    kcell = tkc.kernel_cell(cell).numpy()
    args = tlp._gather_inputs(
        _t(mobile), _t(static), verts, vmask, kcell, centers, midpoint=3.0,
        steepness=4.0, threshold=THR, s_tile=128, cutoff_shape=cutoff_shape,
        full_mask=full_mask, **kw)
    return args, (cell, mobile, static, verts, vmask, centers, kcell)


def _dyadic(rng, shape):
    return torch.from_numpy(rng.integers(0, 17, shape).astype(np.float32)
                            / 16)


@pytest.mark.parametrize("SP", [32, 96, 256])
def test_lane_strided_norm_is_exact_on_exact_inputs(SP):
    lv = _dyadic(np.random.default_rng(SP), (40, SP))
    lv[3] = 0.0                               # an all-zero row
    inv, rows = tkc.row_prep_plain(lv, peak_clip=False)
    n2 = (lv.double() ** 2).sum(1)
    want = torch.rsqrt(torch.clamp_min(n2.float(), 1e-24))
    assert torch.equal(rows, lv)
    assert torch.equal(inv, want)
    assert inv[3] == torch.rsqrt(torch.tensor(1e-24))   # the floor


def test_lane_strided_norm_and_clip_on_random_rows():
    rng = np.random.default_rng(7)
    lv = torch.from_numpy(rng.random((64, 128)).astype(np.float32))
    lv[0, [5, 77]] = 2.0                      # a repeated maximum
    inv, rows = tkc.row_prep_plain(lv, peak_clip=True)
    top2 = tkc.merge_top2(torch.zeros((64, 2)), lv)
    want_rows = torch.minimum(lv, top2[:, 1:2])
    assert torch.equal(rows, want_rows)
    assert float(rows[0].max()) == 2.0        # a repeated max is its own cap
    np.testing.assert_allclose(
        inv.numpy(), torch.rsqrt((want_rows.double() ** 2).sum(1)).numpy(),
        rtol=2e-7)


@pytest.mark.parametrize("full_mask", [False, True])
@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
def test_bf16_route_twin_equals_f32_route(cell_kind, cutoff_shape,
                                          full_mask):
    """The bf16 route's outputs (bf16 copy + inv_norm from the gather
    stage) into the tail's blocks equal the f32 route's (the f32 lv, then
    row_prep) bit for bit."""
    args, _ = _inputs(cell_kind, cutoff_shape, full_mask)
    kw = {k: args[k] for k in ("triclinic", "r2_cutoff", "full_mask")}
    lv = tlp._gather_lv_rows_plain(args["mob"], args["vp"], args["mask"],
                                   args["params"], **kw)
    inv_f32, rows = tkc.row_prep_plain(lv, peak_clip=False)
    thr = float(args["params"][-1])
    want = tkc.blocked_assign_plain(rows, inv_f32, args["cpad"], thr,
                                    mxu_bf16=True)
    labels, confs, inv, rows_b = tlp._gather_route_plain(
        **dict(args, peak_clip=False, mxu_bf16=True))
    lvb = rows_b.to(torch.bfloat16)
    got = tkc.blocked_assign_plain(lvb.float(), inv, args["cpad"], thr,
                                   mxu_bf16=True)
    assert torch.equal(inv.view(torch.int32), inv_f32.view(torch.int32))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(labels.reshape(-1), want[0])
    assert (labels >= -1).all() and torch.isfinite(confs).all()


@pytest.mark.parametrize("peak_evening,mxu_bf16", [
    ("none", True), ("clip", False), ("none", False)])
@pytest.mark.parametrize("cell_kind", ["orthorhombic", "triclinic"])
def test_route_twin_matches_reference(cell_kind, peak_evening, mxu_bf16):
    """The card's partition (lane-strided norm, blocked arg-max) against
    the JAX package's K3 in interpret mode."""
    args, (cell, mobile, static, verts, vmask, centers, kcell) = _inputs(
        cell_kind, "logistic_r2", False, seed=29, mxu_bf16=mxu_bf16,
        peak_evening=peak_evening)
    M = mobile.shape[1]
    labels, confs, _, _ = tlp._gather_route_plain(**args)
    want = jlp.fused_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(kcell), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=THR, s_tile=128,
        mxu_bf16=mxu_bf16, cutoff_shape="logistic_r2",
        peak_evening=peak_evening, interpret=True)
    margin, top1 = _reference_margin(
        cell, mobile, static, verts, vmask, centers, midpoint=3.0,
        steepness=4.0, cutoff_shape="logistic_r2", peak_evening=peak_evening)
    _assert_assign((labels[:, :M], confs[:, :M]), want, margin, top1,
                   mxu_bf16)


@pytest.mark.parametrize("full_mask", [False, True])
@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_far_sites_overflow_to_an_exact_zero(cutoff_shape, full_mask):
    """A steep cutoff makes a far vertex's factor 1 + e^x overflow, so
    q is +inf and the landmark entry an exact 0 (the clamp at -80 keeps e
    from flushing to 0, which would give inf * 0 = NaN); near sites stay
    finite and positive.  The reference agrees."""
    cell, mobile, static, verts, vmask, centers, _ = _random_system(
        "orthorhombic", 31, S=150, K=8)
    if full_mask:
        vmask = np.ones_like(vmask)
    # site 0's vertices close around ion 0: one entry that stays positive
    static = static.copy()
    offsets = np.random.default_rng(3).normal(scale=0.5, size=(1, 5, 3))
    static[:, verts[0]] = mobile[:, :1] + offsets.astype(np.float32)
    kcell = tkc.kernel_cell(cell).numpy()
    kw = dict(midpoint=3.0, steepness=30.0, threshold=THR, s_tile=128,
              cutoff_shape=cutoff_shape, full_mask=full_mask)
    args = tlp._gather_inputs(_t(mobile), _t(static), verts, vmask, kcell,
                              centers, **kw)
    lv = tlp._gather_lv_rows_plain(
        args["mob"], args["vp"], args["mask"], args["params"],
        triclinic=args["triclinic"], r2_cutoff=args["r2_cutoff"],
        full_mask=full_mask)
    assert torch.isfinite(lv).all()
    assert (lv[:, :150] == 0).any()          # a vertex beyond ~6 A
    assert lv[0, 0] > 0
    got = tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask,
                                  kcell, centers, **kw)
    want = jlp.fused_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(kcell), jnp.asarray(centers),
        interpret=True, **kw)
    assert torch.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-2)


def test_gather_wrappers_reject_bad_inputs():
    args, _ = _inputs("orthorhombic", "logistic_r2", True)
    kw = dict(triclinic=False, r2_cutoff=True, full_mask=True)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.lv_gather(args["mob"], args["vp"], args["mask"],
                        args["params"], bf16=True, **kw)
    with pytest.raises(ValueError, match="MP % 32"):
        _cuda.lv_gather(args["mob"][:, :, :100].contiguous(), args["vp"],
                        args["mask"], args["params"], bf16=False, **kw)
    lv = torch.zeros((128, args["cpad"].shape[0]), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.sims_argmax(lv, torch.ones(128), args["cpad"])
    with pytest.raises(ValueError, match="multiple of 128"):
        _cuda.sims_argmax(lv, torch.ones(128), args["cpad"][:, :100])


def test_gather_on_cpu_counts_no_launch():
    before = tlp.fused_assign_blocks.launches
    args, (cell, mobile, static, verts, vmask, centers, kcell) = _inputs(
        "orthorhombic", "logistic_r2", False)
    for bf16 in (True, False):
        tlp.fused_assign_blocks(_t(mobile), _t(static), verts, vmask, kcell,
                                centers, midpoint=3.0, steepness=4.0,
                                threshold=THR, s_tile=128, mxu_bf16=bf16,
                                cutoff_shape="logistic_r2")
    assert tlp.fused_assign_blocks.launches == before
