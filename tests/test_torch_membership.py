"""The sparse membership lists of the ``lv_tile`` kernel and the partition of
the CUDA assignment tail, on the CPU.

- ``membership_lists`` rebuilds every basis's membership matrix ``A``
  exactly (the bench basis, a triclinic one, Voronoi-like bases with uneven
  vertex counts and repeated vertices, a basis built by the reference);
- summing over a column's nonzeros only, in ascending order, is bit-equal
  to the sequential sum over every unique atom, as ``lv_tile`` relies on:
  the accumulator starts at +0 and ``logc`` is finite and <= 0, so every
  skipped term adds a zero that changes nothing (a -0 product to +0 gives
  +0), including ``logc`` values that underflow to -0;
- ``blocked_assign_plain``, the plain twin of the tail's blocks (128 x 256
  with bf16 operands, an odd last block of 128 columns; 64 x 128 in f32),
  its per-block arg-max and the merge, equals ``tiled_assign_plain`` on
  labels and confidences, with ties placed across block borders."""
import numpy as np
import pytest
import torch

from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops.kernel_common import (blocked_assign_plain,
                                                 tiled_assign_plain)
from tests.test_landmark_mxu import _system
from tests.test_torch_basis import _sc_basis_inputs

torch.set_num_threads(2)


def _voronoi_like(seed, repeats=False):
    """Random sites with 1-5 valid vertices each (the reference test
    system); with ``repeats`` some sites list one atom twice, so ``A`` holds
    multiplicities of 2."""
    cell, _, static, verts, vmask, _, site_pos = _system(
        np.random.default_rng(seed), S=300, N=120, V=5)
    if repeats:
        verts = verts.copy()
        verts[::7, 1] = verts[::7, 0]
        vmask = vmask.copy()
        vmask[::7, :2] = True
    return verts, vmask, site_pos, cell


BASES = {
    "bench": lambda: _sc_basis_inputs(21)[:4],
    "triclinic": lambda: _sc_basis_inputs(
        7, shear=[[0, 0, 0], [0.2, 0, 0], [-0.1, 0.15, 0]])[:4],
    "voronoi_like": lambda: _voronoi_like(5),
    "repeated_vertices": lambda: _voronoi_like(6, repeats=True),
}


def _rebuild(idx, mult, UP):
    n_st, s_tile, vmax = idx.shape
    A = np.zeros((n_st, UP, s_tile), np.float32)
    t, c, j = np.nonzero(idx >= 0)
    A[t, idx[t, c, j], c] = mult[t, c, j]
    return A


@pytest.mark.parametrize("case", sorted(BASES))
def test_lists_rebuild_the_membership_exactly(case):
    verts, vmask, site_pos, cell = BASES[case]()
    s_tile = 128 if case in ("bench", "triclinic") else 64
    basis = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell,
                                  s_tile=s_tile)
    A = basis["A"]
    idx, mult = (x.numpy() for x in tmx.membership_lists(A))
    counts = (A != 0).sum(1).numpy()
    n_st, UP, _ = A.shape
    assert idx.shape == mult.shape == (n_st, s_tile, int(counts.max()))
    assert idx.dtype == np.int32 and mult.dtype == np.float32
    np.testing.assert_array_equal(_rebuild(idx, mult, UP), A.numpy())
    # ascending, padded with -1 after the last entry, multiplicity 0 there
    valid = idx >= 0
    np.testing.assert_array_equal(valid.sum(-1), counts)
    assert (valid[..., :-1] >= valid[..., 1:]).all()
    inc = np.diff(np.where(valid, idx, UP + np.arange(idx.shape[-1])),
                  axis=-1)
    assert (inc > 0).all()
    assert (mult[~valid] == 0).all() and (mult[valid] > 0).all()
    if case == "repeated_vertices":
        assert (mult == 2).any()


def test_lists_from_a_reference_basis():
    """A basis the reference built (carried over by ``basis_from_jax``)
    gives the same lists as the port's own."""
    verts, vmask, site_pos, cell = _voronoi_like(9)
    bj = tmx.basis_from_jax(jmx.prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=128), "cpu")
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    for a, b in zip(tmx.membership_lists(bj["A"]),
                    tmx.membership_lists(bt["A"])):
        assert torch.equal(a, b)


def test_lists_are_made_once_per_basis_and_device():
    verts, vmask, site_pos, cell = _voronoi_like(4)
    basis = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=64)
    first = tmx._members(basis, basis["A"])
    assert tmx._members(basis, basis["A"]) is first
    assert basis["members"][basis["A"].device][0] is first


def _sequential(logc, A_t, ks, fused):
    """f32 sum over ``ks`` in order, one term at a time: ``acc + logc·a``
    rounded after the product and after the sum, or (``fused``) as an FMA
    (the product and the sum exact in float64, rounded once: exact, since
    a multiplicity is a small integer)."""
    acc = np.zeros(logc.shape[0], np.float32)
    for k, a in ks:
        if fused:
            acc = (acc.astype(np.float64)
                   + logc[:, k].astype(np.float64) * a).astype(np.float32)
        else:
            acc = acc + logc[:, k] * np.float32(a)
    return acc


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["voronoi_like", "repeated_vertices"])
def test_sparse_sum_is_bit_equal_to_the_dense_sum(case, fused):
    verts, vmask, site_pos, cell = BASES[case]()
    basis = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=64)
    A = basis["A"].numpy()
    idx, mult = (x.numpy() for x in tmx.membership_lists(basis["A"]))
    n_st, UP, s_tile = A.shape
    rng = np.random.default_rng(7)
    for t in range(n_st):
        # log cutoffs <= 0 of every magnitude: -0 (underflowed), denormal,
        # tiny, ordinary and large
        logc = -np.exp(rng.uniform(-110.0, 5.0, (16, UP))).astype(
            np.float32)
        logc[:, ::5] = -0.0
        logc[:, 1::11] = -np.float32(1e-45)
        logc[0, :] = -0.0
        assert np.signbit(logc[0]).all() and (logc <= 0).all()
        for c in range(s_tile):
            dense = _sequential(logc, A[t], [(k, A[t, k, c])
                                             for k in range(UP)], fused)
            ks = [(int(k), m) for k, m in zip(idx[t, c], mult[t, c])
                  if k >= 0]
            sparse = _sequential(logc, A[t], ks, fused)
            np.testing.assert_array_equal(dense.view(np.int32),
                                          sparse.view(np.int32))
            if not ks:
                assert not np.signbit(sparse).any()   # +0, not -0
            np.testing.assert_array_equal(np.exp(dense), np.exp(sparse))


def _dyadic(rng, shape):
    """Multiples of 1/16 in [0, 1]: exact in bf16, and every product and
    sum below is exact in f32, whatever its order."""
    return torch.from_numpy(rng.integers(0, 17, shape).astype(np.float32)
                            / 16)


@pytest.mark.parametrize("mxu_bf16", [True, False])
@pytest.mark.parametrize("rows,KP", [(300, 640), (256, 512), (64, 128)])
def test_blocked_tail_equals_tiled_plain(rows, KP, mxu_bf16):
    rng = np.random.default_rng(rows + KP)
    n_tiles, s_tile = 3, 32
    lv = _dyadic(rng, (rows, n_tiles * s_tile))
    cpad = _dyadic(rng, (n_tiles * s_tile, KP))
    # ties across the borders of 128- and 256-column blocks, and with the
    # odd last block of 128 columns
    for dst, src in ((KP - 1, 0), (KP // 2, KP // 2 - 1), (127, 128 % KP),
                     (KP - 129, 5)):
        if 0 <= dst < KP and 0 <= src < KP:
            cpad[:, dst] = cpad[:, src]
    # a few rows whose best centre lies in the last block
    lv[:8] = cpad[:, KP - 1]
    inv_norm = torch.rsqrt(torch.clamp_min((lv * lv).sum(-1), 1e-24))
    sims = (lv @ cpad) * inv_norm[:, None]
    thr = float(sims.amax(1).median())         # half the rows unassigned

    def tile_lv(lo, hi, t):
        return lv[None, :, t * s_tile:(t + 1) * s_tile]

    want_l, want_c = tiled_assign_plain(tile_lv, 1, rows, n_tiles, s_tile,
                                        cpad, thr, frame_chunk=1,
                                        peak_clip=False, mxu_bf16=mxu_bf16)
    got_l, got_c = blocked_assign_plain(lv, inv_norm, cpad, thr,
                                        mxu_bf16=mxu_bf16)
    assert torch.equal(got_l, want_l[0])
    assert torch.equal(got_c.view(torch.int32), want_c[0].view(torch.int32))
    assert (got_l < 0).any() and (got_l >= 0).any()
    tied = (sims == sims.amax(1, keepdim=True)).sum(1) > 1
    assert tied.any()
    assert (got_l[:8] == 0).all()        # the tie with column 0 wins
