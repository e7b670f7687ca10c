"""The port imports torch and never JAX nor the JAX package: a fresh
interpreter with JAX blocked (and, in a second one, ``sitator_tpu`` too, by
a meta-path finder) imports ``sitator_tpu_torch`` and runs the tiny slice
end to end on the CPU (``LandmarkAnalysis`` → ``JumpAnalysis``,
``SpmdLandmarkPipeline``, ``StreamingLandmarkAnalysis`` fit and run; in a
third, Voronoi seeds → streaming at the shipped run-ahead depth → merging →
pathways; in a fourth, density seeds → landmark analysis → SOAP →
``MergeSitesByDescriptors``; in a fifth, every transport and kinetics
engine; in a sixth, the command line through ``python -m``), and no source
file of the package imports either.  The port's own copy of the data model
behaves as the reference's."""
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sitator_tpu.core import sitetraj as ref_sitetraj
from sitator_tpu_torch.core import sitetraj as port_sitetraj

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


GUARD = textwrap.dedent("""
    import importlib.abc
    import sys

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sitator_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
""")

GUARDED_SLICE = GUARD + textwrap.dedent("""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import sitator_tpu_torch as port
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory, Structure
    from sitator_tpu_torch.io import ArrayTrajectory

    rng = np.random.default_rng(1)
    n_c, a, n_ions, n_frames = 3, 4.0, 3, 16
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(-1, 3)
    verts = np.stack([((grid + d) % n_c) @ [n_c * n_c, n_c, 1]
                      for d in corners], 1)
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
                                                np.full(n_ions, 3)],
                               np.eye(3) * a * n_c), mask, ~mask)
    sn.centers = sites
    sn.vertices = list(verts)

    la = port.LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                               verbose=False, device="cpu")
    st = la.run(sn, frames)
    assert isinstance(st, SiteTrajectory)
    port.JumpAnalysis(verbose=False, device="cpu").run(st)
    assert st.site_network.n_ij.sum() > 0
    st.assign_to_last_known_site()
    import matplotlib
    matplotlib.use("Agg")
    st.set_real_traj(frames)
    assert st.plot_frame(0).axes and st.plot_site(0).axes
    sla = port.StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=6,
        fit_frames=8, verbose=False, device="cpu")
    centers = sla.fit_centers(sn, ArrayTrajectory(frames))
    out = sla.run(sn, frames, centers=centers)
    assert out.occupancies.sum() > 0
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu"))
    assert not bad, bad
    print("GUARDED-OK")
""")


NEW_MODULES = [
    "ops.mcl", "ops.pbc", "network", "network.merging", "network.compare",
    "network.pathways", "network.graph", "network.site_volumes",
    "dynamics.merge_dynamics", "dynamics.filters", "landmark.cluster.mcl",
    "util.dotprod", "voronoi", "voronoi.generator",
]

SEED_TO_PATHWAYS = GUARD + textwrap.dedent("""
    import importlib
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import sitator_tpu_torch as port
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory, Structure
    for name in %r:
        importlib.import_module("sitator_tpu_torch." + name)
    from sitator_tpu_torch.dynamics import (MergeSitesByDynamics,
                                            RemoveUnoccupiedSites)
    from sitator_tpu_torch.network import DiffusionPathwayAnalysis
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    rng = np.random.default_rng(2)
    n_c, a, n_ions, n_frames = 3, 4.0, 4, 120
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    host, sites = grid * a, (grid + 0.5) * a
    # every ion hops along x through the periodic boundary
    start = rng.choice(len(sites), n_ions, replace=False)
    step = (np.arange(n_frames)[:, None] // 12) * n_c * n_c
    site_of = (start[None] + step) %% len(sites)
    frames = np.concatenate([
        host[None] + rng.normal(scale=0.03, size=(n_frames,) + host.shape),
        sites[site_of] + rng.normal(scale=0.15, size=(n_frames, n_ions, 3))],
        axis=1).astype(np.float32)
    mask = np.arange(len(host) + n_ions) < len(host)
    sn0 = SiteNetwork(Structure(frames[0], np.r_[np.full(len(host), 16),
                                                 np.full(n_ions, 3)],
                                np.eye(3) * a * n_c), mask, ~mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.3, verbose=False).run(sn0)
    assert seeds.n_sites >= len(sites) and all(
        len(v) >= 4 for v in seeds.vertices)

    # seed -> stream (run-ahead, the shipped depth) -> merge -> pathways
    sla = port.StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=25,
        fit_frames=60, minimum_site_occupancy=0.0, verbose=False,
        device="cpu")
    assert sla.pipeline_depth == 2
    out = sla.run(seeds, frames)
    assert out.n_ij.sum() > 0
    merged, remap = port.StreamingLandmarkAnalysis.merge_network(
        out, verbose=False, device="cpu")
    assert merged.n_sites <= out.n_sites and len(remap) == out.n_sites
    assert merged.n_ij.sum() <= out.n_ij.sum()
    dpa = DiffusionPathwayAnalysis(verbose=False, device="cpu")
    dpa.run(merged)
    assert dpa.n_pathways >= 1 and dpa.pathway_percolating.any()

    # the classic chain on the same seeds
    st = port.LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                               minimum_site_occupancy=0.0, verbose=False,
                               device="cpu").run(seeds, frames)
    port.JumpAnalysis(verbose=False, device="cpu").run(st)
    st = RemoveUnoccupiedSites(verbose=False).run(
        MergeSitesByDynamics(verbose=False, device="cpu").run(st))
    assert isinstance(st, SiteTrajectory) and st.site_network.n_sites > 0
    DiffusionPathwayAnalysis(verbose=False, device="cpu").run(st)
    assert (st.site_network.diffusion_pathway >= 0).any()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu"))
    assert not bad, bad
    print("PATHWAYS-OK")
""") % (NEW_MODULES,)


DESCRIPTOR_MODULES = [
    "io", "io.synthetic", "util.elbow", "landmark.calibrate",
    "site_descriptors", "site_descriptors.soap", "site_descriptors.typing",
    "site_descriptors.merge_descriptors", "ops.density", "ops.bondvalence",
    "ops.mep", "ops.msd", "network.density_sites", "network.bond_valence",
    "misc", "misc.navgs", "misc.recenter",
]

SEED_TO_DESCRIPTORS = GUARD + textwrap.dedent("""
    import importlib
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import sitator_tpu_torch as port
    for name in %r:
        importlib.import_module("sitator_tpu_torch." + name)
    from sitator_tpu_torch import SiteNetwork
    from sitator_tpu_torch.io import make_hopping_trajectory
    from sitator_tpu_torch.landmark import suggest_cutoff
    from sitator_tpu_torch.network import (BondValenceSiteGenerator,
                                           DensitySiteGenerator)
    from sitator_tpu_torch.ops.density import density_grid, smooth_density
    from sitator_tpu_torch.ops.mep import refine_string_paths
    from sitator_tpu_torch.site_descriptors import (MergeSitesByDescriptors,
                                                    SiteCentersDescriptor,
                                                    SOAPDescriptorAverages)

    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=300,
                                 jump_rate=0.05, seed=3)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    # seed (density) -> cutoff -> landmark analysis
    seeds = DensitySiteGenerator(n_bins=36, sigma=0.5, threshold=0.02,
                                 min_distance=1.5, verbose=False,
                                 device="cpu").run(sn0, md.traj)
    assert seeds.n_sites >= 6 and seeds.has_vertices
    mid, steep = suggest_cutoff(seeds, md.traj)
    st = port.LandmarkAnalysis(cutoff_midpoint=mid, cutoff_steepness=steep,
                               verbose=False, device="cpu").run(seeds, md.traj)
    st.set_real_traj(md.traj)
    n_before = st.site_network.n_sites
    # SOAP per site, both descriptors
    kw = dict(r_cut=4.0, n_max=4, l_max=3)
    avg, counts = SOAPDescriptorAverages(averages_n=4, verbose=False,
                                         device="cpu", **kw).get_descriptors(st)
    assert avg.shape[0] == n_before and counts.max() == 4
    assert np.isfinite(avg).all()
    # every site of the ideal lattice has the same environment: the
    # descriptor merge groups what the 4.5 A guard lets through
    merged = MergeSitesByDescriptors(
        SiteCentersDescriptor(device="cpu", **kw), similarity_threshold=0.9,
        distance_threshold=4.5, verbose=False).run(st)
    assert 1 <= merged.site_network.n_sites < n_before
    assert (merged.traj >= 0).sum() == (st.traj >= 0).sum()
    # a string on the density the seeds came from
    rho = smooth_density(density_grid(md.traj, md.structure.cell,
                                      mask=md.mobile_mask, n_bins=24,
                                      device="cpu"), md.structure.cell, 0.5)
    c = seeds.centers
    path = c[0] + np.linspace(0, 1, 9)[:, None] * (c[1] - c[0])
    out = refine_string_paths(rho, md.structure.cell, path[None],
                              iterations=10, device="cpu")
    assert out.shape == (1, 9, 3) and np.isfinite(out).all()
    # and the bond-valence seeds of the same host
    bv = BondValenceSiteGenerator(r0=2.4, n_bins=16, verbose=False,
                                  device="cpu").run(sn0)
    assert bv.n_sites >= 1
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                        "sklearn"))
    assert not bad, bad
    print("DESCRIPTORS-OK")
""") % (DESCRIPTOR_MODULES,)


TRANSPORT_MODULES = [
    "ops.msd", "ops.correlation", "ops.scattering", "dynamics.diffusion",
    "dynamics.correlation", "dynamics.onsager", "dynamics.vibrational",
    "dynamics.kmc", "dynamics.metastable", "dynamics.markov",
    "dynamics.uncertainty", "dynamics.tpt", "dynamics.residence",
    "dynamics.arrhenius", "dynamics.energetics", "dynamics.vacancy",
    "dynamics.concerted", "dynamics.balance",
]

TRANSPORT = GUARD + textwrap.dedent("""
    import importlib
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for name in %r:
        importlib.import_module("sitator_tpu_torch." + name)
    import sitator_tpu_torch.dynamics as dyn
    from sitator_tpu_torch import SiteNetwork, SiteTrajectory
    from sitator_tpu_torch.io import make_hopping_trajectory

    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=120,
                                 jump_rate=0.05, seed=4)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn.centers = md.true_sites
    st = SiteTrajectory(sn, md.true_assignments)
    st.set_real_traj(md.traj)
    dyn.JumpAnalysis(verbose=False, device="cpu").run(st)
    cpu = dict(verbose=False, device="cpu")
    rdf = dyn.RDFAnalysis(select_b="static", n_bins=40, **cpu).run(st)
    assert np.isfinite(rdf.g_).all() and rdf.g_.max() > 1
    vh = dyn.VanHoveAnalysis(lags=(0, 4), n_bins=20, **cpu).run(st)
    assert vh.G_distinct_.shape == (2, 20)
    sa = dyn.ScatteringAnalysis(q_max=2.5, n_shells=4, **cpu).run(st)
    assert sa.F_.shape == (4, 120)
    quiet = dict(verbose=False)
    da = dyn.DiffusionAnalysis(**quiet).run(st)
    oa = dyn.OnsagerAnalysis(["mobile"], **quiet).run(st)
    cs = dyn.ConductivitySpectrumAnalysis(["mobile"], [1.0], **quiet).run(st)
    assert np.isfinite([da.D_tracer_, oa.L_[0, 0]]).all()
    kmc = dyn.KineticMonteCarlo(n_walkers=8, n_frames=50, seed=1, **cpu)
    out = kmc.run(st.site_network)
    assert out.traj.shape == (50, 8)
    pb = dyn.PathwayBarrierAnalysis(600.0, n_bins=16, min_jumps=2,
                                    path="string", string_iterations=5,
                                    **cpu).run(st)
    assert len(pb.paths_) > 0
    dyn.MarkovianityAnalysis(**quiet).run(st)
    dyn.ChainUncertaintyAnalysis(n_samples=10, **cpu).run(st)
    dyn.ConcertedJumpAnalysis(**quiet).run(st)
    dyn.VacancyAnalysis(**quiet).run(st)
    dyn.DetailedBalanceAnalysis(**quiet).run(st)
    dyn.ResidenceTimeAnalysis(n_mc=10, **quiet).run(st)
    dyn.SiteFreeEnergyAnalysis(600.0, **quiet).run(st)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                        "sklearn"))
    assert not bad, bad
    print(" ".join(dyn.__all__))
    print("TRANSPORT-OK")
""") % (TRANSPORT_MODULES,)


CLI_MODULES = [
    "cli", "__main__", "compat", "io.formats", "io.native",
    "io.tensorstore_io", "io.ase_adapter", "util.timing", "util.zeo",
    "visualization", "visualization.common", "visualization.atoms",
    "visualization.network_plot", "visualization.kinetics",
]

CLI_WITHOUT_JAX = GUARD + textwrap.dedent("""
    import importlib
    import runpy
    import matplotlib
    matplotlib.use("Agg")
    for name in %r:
        importlib.import_module("sitator_tpu_torch." + name)
    import sitator_tpu_torch.compat as compat
    compat.install()
    from sitator.dynamics import JumpAnalysis
    assert JumpAnalysis.__module__ == "sitator_tpu_torch.dynamics.jump_analysis"
    compat.uninstall()
    from sitator_tpu_torch.io import make_hopping_trajectory, write_xyz
    from sitator_tpu_torch.io.native import FastXYZTrajectory
    from sitator_tpu_torch.io import open_trajectory

    md = make_hopping_trajectory(n_cells=2, a=4.0, n_ions=2, n_frames=80,
                                 jump_rate=0.05, seed=3)
    write_xyz("md.xyz", md.structure, md.traj)
    assert type(open_trajectory("md.xyz")) is FastXYZTrajectory

    def module_main(*argv):
        sys.argv = ["sitator_tpu_torch", "--device", "cpu", *argv]
        try:
            runpy.run_module("sitator_tpu_torch", run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            return e.code
        return None

    assert module_main("convert", "md.xyz", "md.npy") == 0
    assert module_main("analyze", "md.npy", "--mobile", "Li",
                       "--cutoff-midpoint", "4.0", "--streaming",
                       "--block-frames", "32", "--out", "r.npz") == 0
    import numpy as np
    assert np.load("r.npz.labels.npy").shape == (80, 2)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                        "sklearn"))
    assert not bad, bad
    print("CLI-OK")
""") % (CLI_MODULES,)


def test_cli_without_jax(tmp_path):
    """``python -m sitator_tpu_torch --device cpu`` converts a text
    trajectory (through the native decoder) and streams the converted
    ``.npy``, with ``jax`` and ``sitator_tpu`` blocked; every module of the
    command-line slice imports (the plots under Agg, the ``sitator``
    shim installed and removed)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CLI_WITHOUT_JAX],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "CLI-OK" in proc.stdout
    assert "streamed 80 frames" in proc.stdout


def test_io_exports_cover_the_reference():
    """The port's ``io.__all__`` is the reference's, in its order, then the
    port's own ``TrajectoryReader``; ``util``, ``visualization`` and
    ``dynamics`` export the reference's names."""
    import sitator_tpu.io as ref_io
    import sitator_tpu.util as ref_util
    import sitator_tpu.visualization as ref_viz
    import sitator_tpu_torch.io as port_io
    import sitator_tpu_torch.util as port_util
    import sitator_tpu_torch.visualization as port_viz
    assert port_io.__all__ == ref_io.__all__ + ["TrajectoryReader"]
    for name in port_io.__all__:
        assert getattr(port_io, name).__module__.startswith(
            "sitator_tpu_torch."), name
    assert port_util.__all__ == ref_util.__all__
    assert port_viz.__all__ == ref_viz.__all__
    import sitator_tpu
    import sitator_tpu_torch
    assert sitator_tpu_torch.__version__ == sitator_tpu.__version__


def test_native_sources_ship_with_the_package():
    """The fast-IO decoders' sources are package data (the library is built
    from them at first use), and the reference's artefact is never there."""
    native = ROOT / "sitator_tpu_torch" / "io" / "native"
    assert sorted(p.name for p in native.iterdir()
                  if p.suffix == ".cpp") == ["fastlmp.cpp", "fastxd.cpp",
                                             "fastxyz.cpp", "h5codec.cpp",
                                             "zarrcodec.cpp"]
    text = (ROOT / "pyproject.toml").read_text()
    assert '"sitator_tpu_torch.io.native" = ["*.cpp"]' in text
    assert 'sitator-tpu-torch = "sitator_tpu_torch.cli:main"' in text


WITHOUT_LIBRARIES = textwrap.dedent("""
    import importlib.abc
    import sys
    import tempfile

    BLOCKED = ("jax", "jaxlib", "sitator_tpu", "sklearn", "tensorstore",
               "networkx")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from sitator_tpu_torch import SiteNetwork, cli
    from sitator_tpu_torch.io import (ArrayTrajectory, TensorstoreTrajectory,
                                      convert_to_zarr,
                                      make_fcc_hopping_trajectory,
                                      open_trajectory, write_xyz)
    from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
    from sitator_tpu_torch.network import ConductionBottleneckAnalysis
    from sitator_tpu_torch.site_descriptors import (SiteCentersDescriptor,
                                                    SiteTypeAnalysis)
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=6,
                                     n_frames=120, jump_rate=0.05, seed=3)
    tmp = tempfile.mkdtemp()
    seeds = VoronoiSiteGenerator().run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    kw = dict(cutoff_midpoint=3.1, cutoff_steepness=4.0, block_frames=48,
              verbose=False, device="cpu")
    want = None
    for fmt in (2, 3):
        store = os.path.join(tmp, f"md{fmt}.zarr")
        convert_to_zarr(ArrayTrajectory(md.traj, md.structure), store,
                        chunk_frames=32, zarr_format=fmt)
        reader = open_trajectory(store)
        assert isinstance(reader, TensorstoreTrajectory)
        assert np.array_equal(reader[:], md.traj.astype(np.float32))
        sla = StreamingLandmarkAnalysis(**kw)
        centers = sla.fit_centers(seeds, reader)
        out = sla.run(seeds, reader, centers=centers)
        mem = StreamingLandmarkAnalysis(**kw).run(seeds, md.traj,
                                                  centers=centers)
        assert np.array_equal(out.n_ij, mem.n_ij) and out.n_ij.sum() > 0
    xyz = os.path.join(tmp, "md.xyz")
    write_xyz(xyz, md.structure, md.traj[:40])
    for flag in ("--zarr", "--zarr3"):
        dst = os.path.join(tmp, f"cli{flag[2:]}.zarr")
        assert cli.main(["--device", "cpu", "convert", xyz, dst,
                         flag]) == 0
        assert len(open_trajectory(dst)) == 40

    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn.centers = md.true_sites
    sta = SiteTypeAnalysis(SiteCentersDescriptor(r_cut=4.0, device="cpu"),
                           n_types=2, verbose=False, device="cpu")
    sta.run(sn)
    assert np.array_equal(sn.site_types, md.true_site_types) or \
        np.array_equal(sn.site_types, 1 - md.true_site_types)
    SiteTypeAnalysis(SiteCentersDescriptor(r_cut=4.0, device="cpu"),
                     max_types=4, verbose=False, device="cpu").run(sn)
    assert sn.site_types.max() >= 1

    cba = ConductionBottleneckAnalysis(verbose=False, device="cpu").run(out)
    assert cba.betweenness_.shape == (out.n_sites,)
    assert np.isfinite(cba.betweenness_).all() and cba.betweenness_.max() > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("LIBRARIES-OK")
""")


def test_zarr_typing_bottlenecks_without_sklearn_tensorstore_networkx():
    """With ``sklearn``, ``tensorstore`` and ``networkx`` unimportable (as
    on the machine with the card), and ``jax`` and ``sitator_tpu`` too:
    ``convert_to_zarr`` (v2 and v3) → ``open_trajectory`` →
    ``StreamingLandmarkAnalysis`` fit and run equal to the in-memory run,
    ``cli convert --zarr/--zarr3``, ``SiteTypeAnalysis`` (forced count
    and elbow) and ``ConductionBottleneckAnalysis``."""
    proc = subprocess.run([sys.executable, "-c", WITHOUT_LIBRARIES],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LIBRARIES-OK" in proc.stdout


def test_transport_and_kinetics_without_jax():
    """The transport and kinetics modules import, and each of their
    engines runs on a small hopping trajectory, with ``jax`` and
    ``sitator_tpu`` blocked; the port's ``dynamics`` exports the
    reference's names in the reference's order."""
    import sitator_tpu.dynamics as ref_dynamics
    import sitator_tpu_torch.dynamics as port_dynamics
    assert port_dynamics.__all__ == ref_dynamics.__all__
    assert len(port_dynamics.__all__) == 32
    proc = subprocess.run([sys.executable, "-c", TRANSPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "TRANSPORT-OK" in proc.stdout
    assert proc.stdout.splitlines()[-2].split() == ref_dynamics.__all__


def test_seed_landmark_soap_descriptor_merge_without_jax():
    """The descriptor and seeding modules import, and a density seed →
    landmark → SOAP → ``MergeSitesByDescriptors`` run completes, with
    ``jax`` and ``sitator_tpu`` blocked (and without loading ``sklearn``)."""
    proc = subprocess.run([sys.executable, "-c", SEED_TO_DESCRIPTORS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DESCRIPTORS-OK" in proc.stdout


def test_seed_stream_merge_pathways_without_jax():
    """The new modules import, and a small seed → stream (depth 2) → merge
    → pathways run completes, with ``jax`` and ``sitator_tpu`` blocked."""
    proc = subprocess.run([sys.executable, "-c", SEED_TO_PATHWAYS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PATHWAYS-OK" in proc.stdout


NORTHSTAR = textwrap.dedent("""
    import importlib.abc
    import sys
    import tempfile

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                      "bench"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import torch
    torch.set_num_threads(1)
    from sitator_tpu_torch.tools import bench_config, northstar_run
    assert bench_config.build_system().n_static == 9261
    with tempfile.TemporaryDirectory() as tmp:
        rc = northstar_run.main(["--small", "--device", "cpu", "--blocks",
                                 "3", "--workdir", tmp])
    assert rc == 0, rc
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                           "bench"))
    assert not loaded, loaded
    print("NORTHSTAR-OK")
""")


def test_northstar_tool_without_jax_or_bench():
    """The north-star tool and the port's bench geometry import, and the
    tool runs at ``--small`` on the CPU, with ``jax``, ``sitator_tpu``
    and ``bench`` blocked."""
    proc = subprocess.run([sys.executable, "-c", NORTHSTAR], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NORTHSTAR-OK" in proc.stdout


BENCH_TOOLS = textwrap.dedent("""
    import importlib.abc
    import sys

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                      "bench"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import torch
    torch.set_num_threads(1)
    from sitator_tpu_torch.tools import (ab_s_tile, ab_skew, bench,
                                         bench_config,
                                         validate_preshift_streaming)
    sy = bench_config.build_system(n_cells=4, n_ions=6, k_centers=16)
    centers = bench.site_centers(sy, "cpu")
    sums = {mode: bench.gpu_fps(sy, mode, "cpu", centers=centers,
                                blocks=bench.bench_blocks(sy, "cpu", 2, 3),
                                reps=1)[2] for mode in bench.MODES}
    assert len(set(sums.values())) == 1, sums
    for tool in (bench, ab_s_tile, ab_skew, validate_preshift_streaming):
        assert tool.main([]) == 1            # no card here
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                           "bench"))
    assert not loaded, loaded
    print("BENCH-TOOLS-OK")
""")


def test_bench_tools_without_jax_or_bench():
    """The port's bench and its A/B and validation tools import, the bench
    step runs in every mode at a small size on the CPU with equal
    checksums, and each tool exits 1 without a card, with ``jax``,
    ``sitator_tpu`` and the top-level ``bench`` blocked."""
    proc = subprocess.run([sys.executable, "-c", BENCH_TOOLS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "BENCH-TOOLS-OK" in proc.stdout


def test_no_source_file_imports_bench():
    files = sorted((ROOT / "sitator_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if re.match(r"\s*(import bench\b|from bench import)", line)]
    assert not offenders, offenders


def test_port_imports_nothing_of_sitator_tpu():
    proc = subprocess.run([sys.executable, "-c", GUARDED_SLICE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "GUARDED-OK" in proc.stdout


def test_no_source_file_imports_sitator_tpu():
    files = sorted((ROOT / "sitator_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if re.search(r"(from|import) sitator_tpu(\.| |$)", line)]
    assert not offenders, offenders


def _labels_with_gaps(seed, n_frames=40, n_ions=9):
    """Seeded labels with runs of -1 of every length, a leading run on
    some ions and one ion never assigned."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, size=(n_frames, n_ions))
    for _ in range(25):
        i = rng.integers(n_ions)
        lo = rng.integers(n_frames)
        labels[lo:lo + rng.integers(1, 8), i] = -1
    labels[:5, 0] = -1                  # a leading run
    labels[:, -1] = -1                  # never assigned
    return labels.astype(np.int32)


@pytest.mark.parametrize("frame_threshold", [None, 0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_to_last_known_site_matches_reference(seed, frame_threshold):
    labels = _labels_with_gaps(seed)
    got = port_sitetraj.SiteTrajectory(None, labels.copy())
    want = ref_sitetraj.SiteTrajectory(None, labels.copy())
    after_got = got.assign_to_last_known_site(frame_threshold)
    after_want = want.assign_to_last_known_site(frame_threshold)
    np.testing.assert_array_equal(got.traj, want.traj)
    assert got.traj.dtype == want.traj.dtype == np.int32
    assert after_got == after_want


def test_port_data_model_round_trips_with_the_reference(tmp_path):
    """A network saved by either package loads in the other with equal
    arrays (``Structure.__eq__`` checks the class, so arrays are
    compared)."""
    from sitator_tpu.core import SiteNetwork as RefSN, Structure as RefS
    from sitator_tpu_torch.core import SiteNetwork, Structure
    rng = np.random.default_rng(3)
    pos = rng.random((6, 3)) * 5
    mask = np.arange(6) < 4
    for make_sn, make_s, load in ((SiteNetwork, Structure, RefSN.load),
                                  (RefSN, RefS, SiteNetwork.load)):
        sn = make_sn(make_s(pos, [8] * 4 + [3] * 2, np.eye(3) * 5), mask,
                     ~mask)
        sn.centers = rng.random((3, 3))
        sn.vertices = [[0, 1], [1, 2, 3], [0]]
        sn.add_site_attribute("occupancies", np.arange(3.0))
        sn.save(tmp_path / "sn.npz")
        back = load(tmp_path / "sn.npz")
        for k in ("positions", "species", "cell", "pbc"):
            np.testing.assert_array_equal(getattr(back.structure, k),
                                          getattr(sn.structure, k))
        np.testing.assert_array_equal(back.centers, sn.centers)
        np.testing.assert_array_equal(back.occupancies, sn.occupancies)
        assert [list(v) for v in back.vertices] == [list(v)
                                                     for v in sn.vertices]


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
    assert names == ["assign_skew.cu", "assign_skew_wgmma.cu",
                     "assign_tail.cu", "hopper_common.cuh", "jump_fold.cu",
                     "landmark_common.cuh", "lv_gather.cu", "lv_tile.cu",
                     "sims_wgmma.cu"]


EXAMPLES_AND_DOC_TOOLS = textwrap.dedent("""
    import importlib.abc
    import sys

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                      "bench"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import importlib
    import pkgutil

    import sitator_tpu_torch.examples as ex
    from sitator_tpu_torch.examples import _common, _parity
    from sitator_tpu_torch.tools import gen_api_docs, line_coverage
    helpers = {"_common", "_parity"}
    names = [m.name for m in pkgutil.iter_modules(ex.__path__)]
    assert len(names) == 14 and helpers <= set(names), names
    for name in names:
        mod = importlib.import_module(f"sitator_tpu_torch.examples.{name}")
        assert name in helpers or callable(mod.main), name
    assert not _parity.differences("x", "1 a", "1 a", ["/tmp"])
    assert "## `sitator_tpu_torch.ops`" in gen_api_docs.generate()
    assert line_coverage.PACKAGE == "sitator_tpu_torch"
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sitator_tpu",
                                           "bench"))
    assert not loaded, loaded
    print("EXAMPLES-OK")
""")


def test_examples_and_doc_tools_without_jax_or_bench():
    """The port's walkthroughs (``_common``, ``_parity`` and every example
    module), its API-doc generator and its line-coverage tool import, and
    the generator runs, with ``jax``, ``sitator_tpu`` and the top-level
    ``bench`` blocked."""
    proc = subprocess.run([sys.executable, "-c", EXAMPLES_AND_DOC_TOOLS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "EXAMPLES-OK" in proc.stdout
