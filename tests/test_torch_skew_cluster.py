"""The partition of the tensor-core K1s kernel (``csrc/assign_skew_wgmma.cu``)
through its plain twin, on the CPU.

``clustered_assign_plain`` splits every 64-row tile's centre columns over
a cluster of CTAs of 256 columns each (the power of two at or above KP /
256, at most 8), merges the CTAs in column order and carries the running
arg-max across passes of 8 CTAs.  On exact (dyadic) inputs, where every
similarity is exact in any summation order, it must equal
``blocked_assign_plain`` (the tail K1 runs) bit for bit, with ties placed
inside CTAs, across CTA borders, across pass borders and in a CTA past KP.
The K1s wrapper refuses what the kernel does not take.
"""
import numpy as np
import pytest
import torch

from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops.kernel_common import (blocked_assign_plain,
                                                 clustered_assign_plain,
                                                 skew_cluster_size)
from tests.test_landmark_mxu import _system
from tests.test_torch_landmark_kernels import THR

torch.set_num_threads(2)


def _dyadic(rng, shape):
    return torch.from_numpy(rng.integers(0, 17, shape).astype(np.float32)
                            / 16)


@pytest.mark.parametrize("KP,want", [
    (128, 1), (256, 1), (384, 2), (512, 2), (640, 4), (1024, 4), (1152, 8),
    (2048, 8), (2176, 8)])
def test_cluster_size(KP, want):
    assert skew_cluster_size(KP) == want


@pytest.mark.parametrize("KP", [128, 384, 1024, 2176])
def test_cluster_partition_equals_blocked_tail(KP):
    rng = np.random.default_rng(KP)
    rows, SP = 200, 96
    lv = _dyadic(rng, (rows, SP))
    C = _dyadic(rng, (SP, KP))
    # ties: inside a CTA, across CTA borders (255 | 256, 511 | 512), across
    # the pass border (2047 | 2048) and between the first and last column
    for dst, src in ((100, 99), (256, 255), (512, 511), (2048, 2047),
                     (KP - 1, 0)):
        if dst < KP and src < KP:
            C[:, dst] = C[:, src]
    lv[:8] = C[:, KP - 1]                 # best centre in the last block
    lv[8:16] = C[:, min(KP, 2048) - 1]    # ... at the end of the first pass
    inv_norm = torch.rsqrt(torch.clamp_min((lv * lv).sum(-1), 1e-24))
    sims = (lv @ C) * inv_norm[:, None]
    thr = float(sims.amax(1).median())   # about half the rows unassigned
    want = blocked_assign_plain(lv, inv_norm, C, thr, mxu_bf16=True)
    got = clustered_assign_plain(lv, inv_norm, C, thr)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert (got[0] < 0).any() and (got[0] >= 0).any()
    tied = (sims == sims.amax(1, keepdim=True)).sum(1) > 1
    assert tied.any()
    assert (got[0][:8] == 0).all()        # the tie with column 0 wins


def _skew_args(KP=256):
    r = np.random.default_rng(41)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=150, K=8)
    bt = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    args = tmx._kernel_inputs(torch.from_numpy(mobile),
                              torch.from_numpy(static), bt,
                              np.diag(cell).astype(np.float32),
                              [3.0, 4.0, THR])
    midx, mmul = tmx.membership_lists(args["A"])
    SP = args["A"].shape[0] * args["A"].shape[2]
    ctr = torch.zeros((KP, SP), dtype=torch.bfloat16)
    return args, midx, mmul, ctr


def test_skew_wrapper_rejects_bad_inputs():
    args, midx, mmul, ctr = _skew_args()
    kw = dict(triclinic=False, r2_cutoff=True, preshift=False)
    pos = (args["mob"], args["vpu"], midx, mmul, args["kill"],
           args["anchors"])
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.assign_skew_wgmma(*pos, ctr, args["params"], **kw)
    with pytest.raises(ValueError, match="KP % 128"):
        _cuda.assign_skew_wgmma(*pos, ctr[:100], args["params"], **kw)
    with pytest.raises(ValueError, match="MP % 64"):
        _cuda.assign_skew_wgmma(args["mob"][:, :, :96].contiguous(),
                                *pos[1:], ctr, args["params"], **kw)


def test_skew_f32_wrapper_rejects_bad_inputs():
    args, _, _, _ = _skew_args()
    C = torch.zeros((args["A"].shape[0] * args["A"].shape[2], 256))
    with pytest.raises(ValueError, match="nj"):
        _cuda.assign_skew(args["mob"], args["vpu"], args["A"], args["kill"],
                          args["anchors"], C, args["params"], n_valid=256,
                          nj=3, triclinic=False, r2_cutoff=True,
                          preshift=False)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.assign_skew(args["mob"], args["vpu"], args["A"], args["kill"],
                          args["anchors"], C, args["params"], n_valid=256,
                          nj=2, triclinic=False, r2_cutoff=True,
                          preshift=False)
