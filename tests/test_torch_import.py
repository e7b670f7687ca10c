"""The port imports torch and never JAX: a fresh interpreter with JAX
blocked imports ``sitator_tpu_torch`` and runs the tiny slice end to end on
the CPU (``LandmarkAnalysis`` → ``JumpAnalysis``, ``SpmdLandmarkPipeline``,
``StreamingLandmarkAnalysis`` fit and run), and no source file of the
package imports JAX."""
import pathlib
import re
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]

SLICE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None            # any import of jax now fails
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import sitator_tpu_torch as port
    from sitator_tpu_torch import SiteNetwork, Structure

    rng = np.random.default_rng(0)
    n_c, a, n_ions, n_frames = 3, 4.0, 3, 24
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cell = np.eye(3) * a * n_c
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(-1, 3)
    verts = [((grid + d) % n_c) @ [n_c * n_c, n_c, 1] for d in corners]
    verts = np.stack(verts, 1)
    host, sites = grid * a, (grid + 0.5) * a
    occ = rng.choice(len(sites), n_ions, replace=False)
    site_of = np.repeat(occ[None], n_frames, 0)
    site_of[n_frames // 2:, 0] = np.setdiff1d(np.arange(len(sites)), occ)[0]
    frames = np.concatenate([
        host[None] + rng.normal(scale=0.05, size=(n_frames,) + host.shape),
        sites[site_of] + rng.normal(scale=0.2, size=(n_frames, n_ions, 3))],
        axis=1).astype(np.float32)
    mask = np.arange(len(host) + n_ions) < len(host)
    sn = SiteNetwork(Structure(frames[0], np.r_[np.full(len(host), 16),
                                                np.full(n_ions, 3)], cell),
                     mask, ~mask)
    sn.centers = sites
    sn.vertices = list(verts)

    la = port.LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                               use_fused=True, verbose=False, device="cpu")
    st = la.run(sn, frames)
    port.JumpAnalysis(verbose=False, device="cpu").run(st)
    assert st.site_network.n_ij.sum() > 0
    for use_fused in (True, False):
        pipe = port.SpmdLandmarkPipeline(
            sn, np.eye(len(sites))[:8], np.ones(8, bool),
            cutoff_midpoint=4.0, cutoff_steepness=3.0, use_fused=use_fused,
            assignment_threshold=0.0, device="cpu")
        labels, confs, stats = pipe.run_block(frames[:12])
        pipe.run_block(frames[12:], carry=(stats["last_sites"],
                                           stats["last_res"]))
        assert labels.shape == (12, n_ions) and np.isfinite(confs).all()
    for use_fused in (True, False):
        sla = port.StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=10,
            fit_frames=12, use_fused=use_fused, verbose=False, device="cpu")
        centers = sla.fit_centers(sn, frames)
        out = sla.run(sn, frames, centers=centers)
        assert sla.route_ == ("mxu" if use_fused else "dense")
        assert out.n_sites == len(centers) > 0
        assert out.occupancies.sum() > 0 and out.n_ij.sum() > 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "triton"))
    assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
    print("SLICE-OK")
""")


def test_port_runs_the_slice_without_jax():
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SLICE-OK" in proc.stdout


def test_no_source_file_imports_jax():
    pkg = ROOT / "sitator_tpu_torch"
    offenders = [f"{p.relative_to(ROOT)}:{i}"
                 for p in sorted(pkg.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if re.match(r"\s*(import jax|from jax)\b", line)]
    assert not offenders, offenders


def test_kernel_sources_ship_with_the_package():
    csrc = ROOT / "sitator_tpu_torch" / "csrc"
    names = sorted(p.name for p in csrc.iterdir()
                   if p.suffix in (".cu", ".cuh"))
    assert names == ["assign_skew.cu", "assign_tail.cu",
                     "landmark_common.cuh", "lv_gather.cu", "lv_tile.cu"]
