"""K1's landmark stage on the card: which form of ``lv_tile`` each call
takes, and the counters that show it, on the CPU with the kernel library
faked (every C entry records its arguments and returns 0).

- K1 with bf16 similarity operands and no clip (the default) launches
  ``lv_tile``'s whole-row form once (the bf16 rows and ``inv_norm``, no f32
  scratch), marks the end of the landmark stage, then the tensor-core
  product and the merge: no ``row_prep``;
- K1 with ``peak_evening='clip'``, f32 operands or a tile width that is
  no multiple of 32 launches the f32 form
  into a ``(B, MP, SP)`` scratch and the whole tail (``row_prep``, the
  mark, the product, the merge); K2 launches the f32 form alone, into the
  caller's site order;
- ``_cuda.lv_tile.rows_launches`` / ``.f32_launches`` count each form's
  launches, and ``StreamingLandmarkAnalysis.run_trace_["lv_tile"]`` holds
  the launches made during the run (none on a CPU device).
"""
import types

import numpy as np
import pytest
import torch

import sitator_tpu_torch as port
from sitator_tpu_torch.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.ops import landmark_mxu as tmx
from sitator_tpu_torch.util import timing
from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

torch.set_num_threads(2)

# argument positions of sit_lv_tile
COL_MAP, OUT, LVB, INV_NORM, M_OUT, OUT_COLS = 6, 7, 8, 9, 12, 17


def _sc_system(n_c=5, n_ions=20, frames=2, K=16, seed=0, a=4.0):
    """A simple-cubic host of ``n_c``^3 atoms with a site at each cube
    centre (its 8 corners as vertices), ions near random sites, unit
    random centres: ``(mobile, static, verts, vmask, site_pos, cell,
    centers)``."""
    rng = np.random.default_rng(seed)
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cell = np.eye(3, dtype=np.float32) * a * n_c
    verts = np.zeros((len(grid), 8), np.int32)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(-1, 3)
    for j, d in enumerate(corners):
        v = (grid + d) % n_c
        verts[:, j] = (v[:, 0] * n_c + v[:, 1]) * n_c + v[:, 2]
    site_pos = ((grid + 0.5) * a).astype(np.float32)
    static = np.broadcast_to(grid * a, (frames,) + grid.shape).astype(
        np.float32)
    at = site_pos[rng.choice(len(grid), n_ions, replace=False)]
    mobile = (at + rng.normal(0, 0.3, (frames, n_ions, 3))).astype(
        np.float32)
    centers = rng.random((K, len(grid))).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return (mobile, static, verts, np.ones_like(verts, bool), site_pos,
            cell, centers)


@pytest.fixture(scope="module")
def system():
    mobile, static, verts, vmask, site_pos, cell, centers = _sc_system()
    basis = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    return (torch.from_numpy(mobile), torch.from_numpy(static.copy()),
            basis, cell, centers)


@pytest.fixture
def fake_library(monkeypatch):
    """The kernel library replaced by entries that record ``(name, args)``
    in ``.calls``, and CPU tensors let through the launchers' device
    check; ``util.timing.stage_mark()`` records ``("mark", ())``."""
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    names = ("sit_lv_tile", "sit_row_prep", "sit_sims_wgmma", "sit_sims_fma",
             "sit_argmax_merge", "sit_lv_gather")
    lib = types.SimpleNamespace(calls=calls, **{n: entry(n) for n in names})
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "launch_device_error", lambda *a: None)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    with timing.stage_marks(lambda: calls.append(("mark", ()))):
        yield lib


def _k1_args(system, *, mxu_bf16, peak_evening):
    mobile, static, basis, cell, centers = system
    args = tmx._assign_inputs(mobile, static, basis, cell,
                              tmx.permute_centers(centers, basis),
                              midpoint=3.0, steepness=4.0, threshold=0.35,
                              mxu_bf16=mxu_bf16, peak_evening=peak_evening)
    return dict(args, members=tmx.membership_lists(args["A"]))


def _launches():
    return _cuda.lv_tile.rows_launches, _cuda.lv_tile.f32_launches


def test_default_k1_takes_the_whole_row_form(system, fake_library):
    args = _k1_args(system, mxu_bf16=True, peak_evening="none")
    B, _, MP = args["mob"].shape
    n_st, _, s_tile = args["A"].shape
    SP = n_st * s_tile
    before = _launches()
    labels, confs = tmx._mxu_assign_cuda(**args)
    names = [n for n, _ in fake_library.calls]
    assert names == ["sit_lv_tile", "mark", "sit_sims_wgmma",
                     "sit_argmax_merge"]
    lv = fake_library.calls[0][1]
    assert lv[COL_MAP] is None and lv[OUT] is None
    assert lv[LVB] is not None and lv[INV_NORM] is not None
    assert (lv[M_OUT], lv[OUT_COLS]) == (MP, SP)
    # the product reads the stage's own bf16 rows and inv_norm
    wg = fake_library.calls[2][1]
    assert (wg[0], wg[2]) == (lv[LVB], lv[INV_NORM])
    assert _launches() == (before[0] + 1, before[1])
    assert labels.shape == confs.shape == (B, MP)


@pytest.mark.parametrize("mxu_bf16,peak_evening,product", [
    (True, "clip", "sit_sims_wgmma"), (False, "none", "sit_sims_fma"),
    (False, "clip", "sit_sims_fma")])
def test_clip_and_f32_operands_keep_the_f32_form(system, fake_library,
                                                 mxu_bf16, peak_evening,
                                                 product):
    args = _k1_args(system, mxu_bf16=mxu_bf16, peak_evening=peak_evening)
    B, _, MP = args["mob"].shape
    n_st, _, s_tile = args["A"].shape
    SP = n_st * s_tile
    before = _launches()
    tmx._mxu_assign_cuda(**args)
    names = [n for n, _ in fake_library.calls]
    assert names == ["sit_lv_tile", "sit_row_prep", "mark", product,
                     "sit_argmax_merge"]
    lv, prep = fake_library.calls[0][1], fake_library.calls[1][1]
    assert lv[LVB] is None and lv[INV_NORM] is None
    assert lv[OUT] is not None and (lv[M_OUT], lv[OUT_COLS]) == (MP, SP)
    # row_prep reads the scratch the stage wrote: (rows, cols, clip)
    assert prep[0] == lv[OUT]
    assert prep[3:6] == (B * MP, SP, int(peak_evening == "clip"))
    assert (prep[1] is not None) == mxu_bf16      # the bf16 copy
    assert _launches() == (before[0], before[1] + 1)


def test_tile_width_off_the_lanes_keeps_the_f32_form(fake_library):
    mobile, static, verts, vmask, site_pos, cell, centers = _sc_system()
    basis = tmx.prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=16)
    args = _k1_args((torch.from_numpy(mobile), torch.from_numpy(static.copy()),
                     basis, cell, centers), mxu_bf16=True,
                    peak_evening="none")
    B, _, MP = args["mob"].shape
    n_st, _, s_tile = args["A"].shape
    assert s_tile % 32 == 16 and (n_st * s_tile) % 64 == 0
    before = _launches()
    tmx._mxu_assign_cuda(**args)
    names = [n for n, _ in fake_library.calls]
    assert names == ["sit_lv_tile", "sit_row_prep", "mark", "sit_sims_wgmma",
                     "sit_argmax_merge"]
    lv, prep = fake_library.calls[0][1], fake_library.calls[1][1]
    assert lv[LVB] is None and lv[OUT] is not None
    assert prep[0] == lv[OUT] and prep[1] is not None   # the bf16 copy
    assert prep[3:6] == (B * MP, n_st * s_tile, 0)
    assert _launches() == (before[0], before[1] + 1)


def test_k2_takes_the_f32_form_alone(system, fake_library):
    mobile, static, basis, cell, _ = system
    args = tmx._lv_inputs(mobile, static, basis, cell, midpoint=3.0,
                          steepness=4.0)
    args["members"] = tmx.membership_lists(args["A"])
    before = _launches()
    lv = tmx._mxu_lv_cuda(**args)
    assert [n for n, _ in fake_library.calls] == ["sit_lv_tile"]
    call = fake_library.calls[0][1]
    M, S = mobile.shape[1], len(basis["inv_order"])
    assert call[LVB] is None and call[COL_MAP] is not None
    assert (call[M_OUT], call[OUT_COLS]) == (M, S)
    assert lv.shape == (mobile.shape[0], M, S) and lv.dtype == torch.float32
    assert _launches() == (before[0], before[1] + 1)


def test_whole_rows_need_whole_lanes(system, fake_library):
    args = _k1_args(system, mxu_bf16=True, peak_evening="none")
    idx, mult = args["members"]
    n_st, s_tile, vmax = idx.shape
    cut = s_tile - 16          # a tile width that is no multiple of 32
    idx, mult = idx[:, :cut].contiguous(), mult[:, :cut].contiguous()
    kill = args["kill"].view(n_st, s_tile)[:, :cut].reshape(-1)
    with pytest.raises(ValueError, match="s_tile % 32"):
        _cuda.lv_tile(args["mob"], args["vpu"], idx, mult, kill.contiguous(),
                      args["anchors"], args["params"], triclinic=False,
                      r2_cutoff=False, preshift=False)
    assert fake_library.calls == []


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=300,
                                 jump_rate=0.03, seed=9)
    sn0 = port.SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False,
              block_frames=100, use_fused=True)
    centers = port.StreamingLandmarkAnalysis(device="cpu", **kw).fit_centers(
        seeds, ArrayTrajectory(md.traj))
    return md, seeds, centers, kw


def test_run_record_holds_the_launches_of_its_run(md_system, tmp_path,
                                                   monkeypatch):
    md, seeds, centers, kw = md_system
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", store_labels=str(tmp_path / "a.npy"), **kw)
    eng.run(seeds, md.traj, centers=centers)
    assert eng.route_ == "mxu"
    assert eng.run_trace_["lv_tile"] == dict(rows=0, f32=0)   # plain K1

    # a stand-in for the card: each K1 block counts one whole-row launch
    made = []
    plain = tmx.mxu_assign_blocks

    def counted(*a, **k):
        out = plain(*a, **k)
        _cuda.lv_tile.rows_launches += 1
        made.append(1)
        return out
    monkeypatch.setattr(tmx, "mxu_assign_blocks", counted)
    _cuda.lv_tile.rows_launches += 5     # launches before the run
    eng = port.StreamingLandmarkAnalysis(
        device="cpu", store_labels=str(tmp_path / "b.npy"), **kw)
    eng.run(seeds, md.traj, centers=centers)
    assert len(made) == -(-md.traj.shape[0] // kw["block_frames"])
    assert eng.run_trace_["lv_tile"] == dict(rows=len(made), f32=0)
    assert timing.recent_runs()[-1]["lv_tile"] == dict(rows=len(made),
                                                       f32=0)
