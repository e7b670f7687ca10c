"""What keeps the port's kernels and replicas on the right card, on the CPU:
the launchers' device rule (``ops._cuda.launch_device_error``: a kernel
input must lie on the current CUDA device, the one whose stream the launch
takes) and the version counters by which a frame mesh renews a replica
that was written in place (``parallel.mesh._versions``), and the dense
route's log-space product in products of a fixed row count
(``ops.landmark.contract_rows``, which a card's ``landmark_vectors`` uses
so that a row's bits do not depend on how many frames a shard holds).
Their CUDA side (launches on cards 1..n, replicas on other cards, the
dense route on 4 cards) is checked by ``chip_smoke.py``'s real-card mesh
phase; the CPU paths of the wrappers launch nothing and count no card."""
import numpy as np
import pytest
import torch

from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.ops import landmark_pallas as tlp
from sitator_tpu_torch.ops._cuda import launch_device_error
from sitator_tpu_torch.ops.landmark import contract_rows
from sitator_tpu_torch.parallel.mesh import _versions

torch.set_num_threads(2)


@pytest.mark.parametrize("device,current", [("cuda:0", 0), ("cuda:3", 3)])
def test_a_tensor_on_the_current_card_launches(device, current):
    assert launch_device_error(torch.device(device), current) is None


@pytest.mark.parametrize("device,current", [
    ("cuda:1", 0), ("cuda:0", 3), ("cuda:3", 2)])
def test_a_tensor_on_another_card_is_refused(device, current):
    """The rule names both cards and the guard that would fix the call."""
    err = launch_device_error(torch.device(device), current)
    assert err is not None
    assert f"on {device}" in err and f"cuda:{current} is the current" in err
    assert f"torch.cuda.device({device})" in err


def test_a_host_tensor_is_refused():
    err = launch_device_error(torch.device("cpu"), 0)
    assert err is not None and "CUDA tensor is needed" in err


def test_versions_move_with_in_place_writes():
    """A tensor's version counter moves with every in-place write, and a
    dict's tuple with any of its tensor values'; non-tensor values (the
    basis's per-device caches) do not count; an inference tensor has
    none."""
    x = torch.zeros(4)
    basis = {"A": torch.ones(2, 2), "n_st": 1, "members": {}}
    v0, d0 = _versions(x), _versions(basis)
    x.add_(1.0)
    assert _versions(x) != v0
    basis["members"]["cuda:1"] = ("lists", None)
    basis["cell_dev"] = {}
    assert _versions(basis) == d0
    basis["A"][0, 0] = 2.0
    assert _versions(basis) != d0
    with torch.inference_mode():
        frozen = torch.zeros(2)
    assert _versions(frozen) is None


def test_the_plain_versions_count_no_card():
    """On CPU tensors the wrappers run their plain versions: no launch, no
    card counted."""
    from sitator_tpu_torch.ops.kernel_common import kernel_cell
    rng = np.random.default_rng(0)
    cell = np.diag([6.0, 6.0, 6.0])
    static = torch.as_tensor(rng.random((2, 8, 3)) * 6.0, dtype=torch.float32)
    mobile = torch.as_tensor(rng.random((2, 3, 3)) * 6.0, dtype=torch.float32)
    verts = np.arange(8, dtype=np.int32).reshape(2, 4)
    vmask = np.ones((2, 4), bool)
    centers = torch.eye(2)
    before = (dict(tmx.mxu_assign_blocks.launches_by_card),
              dict(tmx.mxu_landmark_blocks.launches_by_card),
              dict(tlp.fused_assign_blocks.launches_by_card))
    labels, _ = tlp.fused_assign_blocks(
        mobile, static, torch.as_tensor(verts), torch.as_tensor(vmask),
        kernel_cell(cell), centers, midpoint=2.0, steepness=3.0,
        threshold=0.1, s_tile=128)
    assert labels.shape == (2, 3)
    assert (dict(tmx.mxu_assign_blocks.launches_by_card),
            dict(tmx.mxu_landmark_blocks.launches_by_card),
            dict(tlp.fused_assign_blocks.launches_by_card)) == before


@pytest.mark.parametrize("rows", [64, 100])
def test_fixed_row_products_do_not_depend_on_the_frame_count(rows):
    """``contract_rows`` of 16 frames x 37 ions equals the one product
    within f32 rounding (1e-5 relative), and equals bit for bit its own
    result on the frames taken 4, 2 or 1 at a time (a frame shard's view):
    every row goes through a product of ``rows`` rows, the last one
    zero-padded."""
    rng = np.random.default_rng(rows)
    logc = torch.as_tensor(-rng.random((16, 37, 90)) * 50.0,
                           dtype=torch.float32)
    A = torch.as_tensor(rng.integers(0, 3, (90, 70)), dtype=torch.float32)
    whole = contract_rows(logc, A, rows)
    assert whole.shape == (16, 37, 70)
    np.testing.assert_allclose(whole.numpy(), (logc @ A).numpy(), rtol=1e-5)
    for nf in (4, 2, 1):
        parts = torch.cat([contract_rows(logc[i:i + nf], A, rows)
                           for i in range(0, 16, nf)])
        assert torch.equal(parts, whole), nf
    assert torch.equal(contract_rows(logc, A, None), logc @ A)
