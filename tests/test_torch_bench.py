"""The port's chip-measurement tools (``sitator_tpu_torch.tools``: ``bench``,
``ab_s_tile``, ``ab_skew``, ``validate_preshift_streaming``) on the CPU at
small sizes, held to the JAX package on the same NumPy inputs:

- the bench step per mode (K1, K3, the dense route; then the prefix-form
  jump statistics and the checksum) against the reference's functions called
  as ``bench.py``'s step body calls them (the Pallas kernels in interpret
  mode): labels equal wherever the f32 top-2 margin exceeds 8e-3 and the best
  similarity is not within 1e-2 of the threshold, ``n_ij`` and the checksum
  equal; K1 against both of the reference's ``centers_store_f32``
  settings.  The frames are the bench's, with the ions moved to each
  other's sites inside each block so that jumps are tallied;
- the FLOP count on the port's bench-width basis equal to the reference's;
- each A/B tool at a lattice of 20 cells (the smallest where the preshift
  bound holds at both tiles), both sides equal and held to the reference's
  K1 step (its checksum, and for ``ab_skew`` its labels outside the gate),
  and the preshift validation against the reference's dense streaming
  engine;
- the probe: a healthy one passes; one that raises and one that hangs past
  its timeout make ``main()`` exit 1 with the reason on stderr, no metric
  line and no re-exec; without a card every tool exits 1.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as ref_bench
import sitator_tpu as ref
from sitator_tpu.landmark import StreamingLandmarkAnalysis as JaxStreaming
from sitator_tpu.ops import landmark as jlm
from sitator_tpu.ops import landmark_mxu as jmx
from sitator_tpu.ops.jumps import _jump_stats_parallel as jax_jump_stats
from sitator_tpu.ops.landmark_pallas import fused_assign_blocks as jax_fused

from sitator_tpu_torch.tools import ab_s_tile, ab_skew, bench, bench_config
from sitator_tpu_torch.tools import validate_preshift_streaming as vps

from tests._torch_common import first_math_calls_on_one_thread, networks

torch.set_num_threads(2)

first_math_calls_on_one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_cells=5, n_ions=20, k_centers=32)
N_BLOCKS, BLOCK = 2, 4


def _hopping_frames(system, n_frames, seed=7):
    """The bench's frames, with the ions on each other's sites from the
    middle of every block on (a cyclic shift of the ions), so that every
    block holds jumps."""
    static, mobile = system.frames(n_frames, seed)
    shifted = np.roll(mobile, 1, axis=1)
    for lo in range(0, n_frames, BLOCK):
        mobile[lo + BLOCK // 2:lo + BLOCK] = shifted[lo + BLOCK // 2:
                                                     lo + BLOCK]
    return static, mobile


@pytest.fixture(scope="module")
def small():
    sy = bench_config.build_system(**SMALL)
    centers = bench.site_centers(sy, "cpu")
    static, mobile = _hopping_frames(sy, N_BLOCKS * BLOCK)
    return sy, centers, static, mobile


def _jax_labels(mode, sy, centers, static, mobile, centers_store_f32=True):
    """The reference's step body on each block: labels, ``n_ij`` and the
    checksum ``n_ij.sum() + labels.sum()``; K1 with the reference's
    ``centers_store_f32``."""
    cell = np.asarray(sy.cell)
    cell_diag = jnp.asarray(np.diag(cell).astype(np.float32))
    verts = np.asarray(sy.verts)
    vmask = np.ones_like(verts, bool)
    K = len(centers)
    if mode == "mxu":
        s_tile = jmx.choose_s_tile(verts, vmask, sy.sites, cell)
        basis = jmx.prepare_mxu_basis(
            verts, vmask, sy.sites, cell, s_tile=s_tile, static_ref=sy.host,
            midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
            cutoff_shape=bench.CUTOFF)
        ps = basis["preshift"]
        bd = dict(uidx=basis["uidx"], A=basis["A"], kill=basis["kill"],
                  s_tile=basis["s_tile"], n_st=basis["n_st"],
                  UP=basis["UP"], cost_ratio=0.0, site_order=None,
                  preshift=ps,
                  ref_u=basis["ref_u"] if ps else jnp.zeros(
                      (basis["n_st"], basis["UP"], 3), jnp.float32),
                  anchors=basis["anchors"] if ps else jnp.zeros(
                      (basis["n_st"], 3), jnp.float32))
        c_mxu = jnp.asarray(jmx.permute_centers(centers, basis))
    else:
        A = jlm.vertex_membership_matrix(verts, vmask, sy.n_static)
    out = []
    for lo in range(0, len(static), BLOCK):
        st = jnp.asarray(static[lo:lo + BLOCK])
        mo = jnp.asarray(mobile[lo:lo + BLOCK])
        kw = dict(midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
                  threshold=bench.ASSIGN_THR, cutoff_shape=bench.CUTOFF)
        if mode == "mxu":
            labels, _ = jmx.mxu_assign_blocks(
                mo, st, bd, cell_diag, c_mxu, interpret=True,
                centers_store_f32=centers_store_f32, **kw)
        elif mode == "fused":
            labels, _ = jax_fused(mo, st, jnp.asarray(verts),
                                  jnp.ones_like(verts, dtype=bool),
                                  cell_diag, jnp.asarray(centers),
                                  s_tile=256, mxu_bf16=True, full_mask=True,
                                  interpret=True, **kw)
        else:
            # bench.py's dense mode leaves the cutoff at 'logistic'; the
            # port's bench runs every mode with the bench's CUTOFF
            lv = jlm.landmark_vectors(
                mo, st, A, jnp.asarray(cell), jnp.asarray(
                    np.linalg.inv(cell).astype(np.float32)),
                bench.MIDPOINT, bench.STEEPNESS, matmul_dtype=jnp.bfloat16,
                cutoff_shape=bench.CUTOFF)
            lv_n, _ = jlm.normalize_landmark_vectors(lv)
            labels, _ = jlm.assign_to_centers(
                lv_n, jnp.asarray(centers), jnp.ones(K, bool),
                bench.ASSIGN_THR, matmul_dtype=jnp.bfloat16)
        stats = jax_jump_stats(labels, K)
        out.append((np.asarray(labels), np.asarray(stats["n_ij"]),
                    int(stats["n_ij"].sum() + labels.sum())))
    return out


@pytest.mark.parametrize("mode,store", [
    ("mxu", True), ("mxu", False)] + [(m, True) for m in bench.MODES
                                      if m != "mxu"])
def test_bench_step_matches_reference(small, mode, store):
    """Each mode against the reference's step; the port's one K1 route
    against both of the reference's ways to store the centres (``store``:
    its ``centers_store_f32``)."""
    sy, centers, static, mobile = small
    blocks = bench.device_blocks(static, mobile, "cpu", BLOCK)
    assign, basis = bench.ASSIGNERS[mode](sy, "cpu", centers)
    got, total = bench.run_blocks(assign, blocks, len(centers))
    want = _jax_labels(mode, sy, centers, static, mobile,
                       centers_store_f32=store)
    margin, top1 = bench.top2_margin(sy, blocks, centers)
    labels = np.concatenate([g[0].numpy() for g in got])
    ref_labels = np.concatenate([w[0] for w in want])
    open_rows = ~bench.gated(margin, top1)
    assert open_rows.sum() > 0.9 * open_rows.size
    np.testing.assert_array_equal(labels[open_rows], ref_labels[open_rows])
    assert (labels >= 0).all()
    for (_, _, stats), (_, n_ij, _) in zip(got, want):
        np.testing.assert_array_equal(stats["n_ij"].numpy(), n_ij)
        assert n_ij.sum() > 0
    assert int(total) == sum(w[2] for w in want)
    reps, b, checksum = bench.gpu_fps(sy, mode, "cpu", centers=centers,
                                      blocks=blocks, reps=2)
    assert checksum == int(total) and len(reps) == 2
    assert (b is None) == (mode != "mxu")


def test_bench_checksum_under_random_centres(small):
    """With the bench's own random centres every label is −1 and no jump is
    tallied, in every mode: the checksum is ``-n_frames * n_ions``."""
    sy, _, static, mobile = small
    blocks = bench.device_blocks(static, mobile, "cpu", BLOCK)
    for mode in bench.MODES:
        _, _, checksum = bench.gpu_fps(sy, mode, "cpu", blocks=blocks,
                                       reps=1)
        assert checksum == -len(static) * SMALL["n_ions"], mode


def test_kernel_flops_per_frame_equals_reference():
    sy = bench_config.build_system()
    got = bench.kernel_flops_per_frame(bench.mxu_basis(sy))
    cell, verts, _, _, _ = ref_bench.build_system()
    vmask = np.ones_like(verts, bool)
    s_tile = jmx.choose_s_tile(verts, vmask, sy.sites, cell)
    basis = jmx.prepare_mxu_basis(
        verts, vmask, sy.sites, cell, s_tile=s_tile, static_ref=sy.host,
        midpoint=ref_bench.MIDPOINT, steepness=ref_bench.STEEPNESS,
        cutoff_shape=ref_bench.CUTOFF)
    want = ref_bench.kernel_flops_per_frame(basis)
    assert isinstance(got, int) and got == want
    assert round(got / 1e9, 2) == 18.56


def test_device_peak_by_card_name():
    assert bench.device_peak_bf16("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.device_peak_bf16("NVIDIA H100 SXM5 80GB") == 989e12
    assert bench.device_peak_bf16("NVIDIA A100-SXM4-80GB") is None


@pytest.fixture(scope="module")
def preshift_case():
    sy = bench_config.build_system(n_cells=20, n_ions=20, k_centers=32)
    centers = bench.site_centers(sy, "cpu")
    blocks = bench.bench_blocks(sy, "cpu", N_BLOCKS, BLOCK)
    return sy, centers, blocks


@pytest.fixture(scope="module")
def preshift_ref(preshift_case):
    """The reference's K1 step on the A/B frames: ``(labels (F, M),
    checksum)``, and the rows outside the precision gate."""
    sy, centers, blocks = preshift_case
    want = _jax_labels(
        "mxu", sy, centers, np.concatenate([s.numpy() for s, _ in blocks]),
        np.concatenate([m.numpy() for _, m in blocks]))
    margin, top1 = bench.top2_margin(sy, blocks, centers)
    open_rows = ~bench.gated(margin, top1)
    assert open_rows.sum() > 0.9 * open_rows.size
    return (np.concatenate([w[0] for w in want]), sum(w[2] for w in want),
            open_rows)


def test_ab_s_tile_sides_equal(preshift_case, preshift_ref):
    sy, centers, blocks = preshift_case
    res = ab_s_tile.ab(sy, "cpu", centers=centers, blocks=blocks, rounds=1)
    assert res["labels_equal"] and res["checksums_equal"]
    assert res["max_conf_diff"] <= 1e-2 and res["assigned"] == 1.0
    assert res["tiles"] == {128: dict(n_st=63, UP=256),
                            256: dict(n_st=32, UP=512)}
    assert [name for name, _ in res["segments"]] == [128, 256]
    assert res["ratio_256_over_128"] > 0
    # the checksum is the reference's K1 step
    assert res["checksum"] == preshift_ref[1]


def test_ab_s_tile_refuses_a_basis_without_preshift(small):
    sy, centers, static, mobile = small
    with pytest.raises(bench.CheckFailed, match="preshift"):
        ab_s_tile.ab(sy, "cpu", centers=centers, rounds=1,
                     blocks=bench.device_blocks(static, mobile, "cpu",
                                                BLOCK))


def test_ab_skew_sides_equal(preshift_case, preshift_ref, monkeypatch):
    sy, centers, blocks = preshift_case
    seen, real = {}, ab_skew.sides

    def spy(*a, **k):
        out = real(*a, **k)
        seen.update(out[0])
        return out
    monkeypatch.setattr(ab_skew, "sides", spy)
    res = ab_skew.ab(sy, "cpu", centers=centers, blocks=blocks, reps=1)
    assert res["bitwise_equal"] and res["max_conf_diff"] == 0.0
    assert res["labels_compared"] > 0.9 * len(blocks) * BLOCK * 20
    assert res["assigned"] == 1.0
    # both sides' labels are the reference's K1 step outside the gate
    want, _, open_rows = preshift_ref
    assert sorted(seen) == ["plain", "skew"]
    for labels, _ in seen.values():
        np.testing.assert_array_equal(labels[open_rows], want[open_rows])


def test_preshift_validation_against_reference(tmp_path):
    n_frames, block = 40, 20
    res = vps.validate("cpu", n_frames=n_frames, block_frames=block)
    assert res["sites"] == 4096 and res["route_fused"] == "mxu"
    assert res["route_dense"] == "dense" and res["label_agreement"] == 1.0
    assert res["jumps"] > 0
    # the dense route, which the kernel route was held to, against the
    # reference's dense streaming engine on the same trajectory
    md, sn = vps.cage_network(n_frames)
    got, labels, _ = vps.run(sn, md.traj, False, "cpu",
                             str(tmp_path / "port.npy"), block)
    s = md.structure
    ref_sn, _ = networks(s.positions, s.species, s.cell, md.static_mask,
                         md.mobile_mask, centers=sn.centers,
                         vertices=sn.vertices)
    want_path = str(tmp_path / "ref.npy")
    want = JaxStreaming(cutoff_midpoint=vps.MIDPOINT,
                        cutoff_steepness=vps.STEEPNESS,
                        cutoff_shape=vps.CUTOFF, block_frames=block,
                        use_fused=False, store_labels=want_path,
                        verbose=False).run(ref_sn, md.traj)
    assert isinstance(want, ref.SiteNetwork)
    np.testing.assert_array_equal(labels, np.load(want_path))
    np.testing.assert_array_equal(got.n_ij, want.n_ij)
    np.testing.assert_allclose(got.occupancies, want.occupancies,
                               atol=1e-12)


# -- the probe and the card ---------------------------------------------------

class _Exec(BaseException):
    pass


@pytest.fixture()
def no_exec(monkeypatch):
    def execve(*a):
        raise _Exec(a)

    def measure(*a, **k):
        raise AssertionError("measured without a usable card")
    monkeypatch.setattr(os, "execve", execve)
    monkeypatch.setattr(bench, "measure", measure)


def test_healthy_probe_passes(monkeypatch):
    monkeypatch.setattr(bench, "probe_work", lambda: "NVIDIA H100 80GB HBM3")
    assert bench.probe_device(5.0) == {"ok": True,
                                       "name": "NVIDIA H100 80GB HBM3",
                                       "err": None}


def test_raising_probe_exits_1_without_a_record(monkeypatch, capsys,
                                                no_exec):
    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(bench, "probe_work", broken)
    assert bench.main([]) == 1
    out, err = capsys.readouterr()
    assert "illegal memory access" in err and "no usable CUDA device" in err
    assert "metric" not in out and out.strip() == ""


def test_hung_probe_times_out(monkeypatch, capsys, no_exec):
    ev = threading.Event()
    monkeypatch.setattr(bench, "probe_work", lambda: ev.wait() or "x")
    monkeypatch.setattr(bench, "PROBE_TIMEOUT_S", 0.2)
    try:
        assert bench.main([]) == 1
    finally:
        ev.set()
    out, err = capsys.readouterr()
    assert "timed out after 0.2 s" in err and out.strip() == ""


@pytest.mark.parametrize("tool", [ab_s_tile, ab_skew, vps])
def test_tools_exit_1_without_a_card(tool, capsys):
    assert not torch.cuda.is_available()
    assert tool.main([]) == 1
    out, err = capsys.readouterr()
    assert "no usable CUDA device" in err and out.strip() == ""


def test_bench_module_exits_1_without_a_card():
    proc = subprocess.run([sys.executable, "-m",
                           "sitator_tpu_torch.tools.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no usable CUDA device" in proc.stderr
    assert not any(line.strip().startswith("{")
                   for line in proc.stdout.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "")
