"""The port's plots against the reference's, on matplotlib's Agg backend:
the same inputs give the same artists — line and scatter coordinates,
collections' segments, sizes and colours, image arrays, titles and axis
labels — compared as data, not pixels (equal arrays: both draw the same
host NumPy).  Also the ``SiteTrajectory.plot_*`` methods and
``JumpAnalysis.plot_jump_lag``, which delegate to the plots, and the CLI's
``--report DIR``, which writes the reference's file names and sections."""
import contextlib
import io
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import sitator_tpu.visualization as ref_viz  # noqa: E402
import sitator_tpu_torch.dynamics as dyn  # noqa: E402
import sitator_tpu_torch.visualization as port_viz  # noqa: E402
from sitator_tpu_torch import SiteNetwork, SiteTrajectory  # noqa: E402
from sitator_tpu_torch.io import make_hopping_trajectory  # noqa: E402

from tests._torch_common import (first_math_calls_on_one_thread,  # noqa
                                 networks, trajectories)

first_math_calls_on_one_thread()


def _collection(c):
    out = {"type": type(c).__name__}
    for name in ("_offsets3d", "_segments3d"):
        if getattr(c, name, None) is not None:
            out[name] = [np.asarray(a, dtype=float)
                         for a in getattr(c, name)]
    for name in ("get_offsets", "get_array", "get_sizes", "get_linewidths",
                 "get_facecolor", "get_edgecolor", "get_paths"):
        try:
            v = getattr(c, name)()
        except (AttributeError, ValueError):
            continue
        if name == "get_paths":
            v = [p.vertices for p in v]
        out[name] = v if v is None or name == "get_paths" \
            else np.asarray(v, dtype=float)
    return out


def artists(fig):
    """Every drawn datum of a figure, axes by axes."""
    out = []
    for ax in fig.axes:
        d = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
             "ylabel": ax.get_ylabel(), "name": ax.name,
             "lines": [], "collections": [], "images": [], "texts": [],
             "patches": len(ax.patches)}
        if ax.name == "3d":
            d["zlabel"] = ax.get_zlabel()
        for ln in ax.lines:
            data = (ln.get_data_3d() if hasattr(ln, "get_data_3d")
                    else ln.get_data())
            d["lines"].append((ln.get_label(), ln.get_color(),
                               ln.get_linestyle(),
                               [np.asarray(a, dtype=float) for a in data]))
        d["collections"] = [_collection(c) for c in ax.collections]
        d["images"] = [np.asarray(im.get_array()) for im in ax.images]
        d["texts"] = [t.get_text() for t in ax.texts]
        legend = ax.get_legend()
        d["legend"] = ([t.get_text() for t in legend.get_texts()]
                       if legend is not None else None)
        out.append(d)
    return out


def assert_same_artists(want, got, where="fig"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same_artists(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_artists(w, g, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def _both(plot_name, *args, **kw):
    figs = [getattr(v, plot_name)(*args, **kw) for v in (ref_viz, port_viz)]
    data = [artists(f) for f in figs]
    plt.close("all")
    assert data[0], f"{plot_name} drew no axes"
    assert_same_artists(*data, where=plot_name)
    return data[1]


@pytest.fixture(scope="module")
def hopping():
    """A hopping run with its true sites and labels, and the transport,
    kinetics and Markov engines run on it (the port's, on the CPU)."""
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=400,
                                 jump_rate=0.05, seed=4)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn.centers = md.true_sites
    st = SiteTrajectory(sn, md.true_assignments)
    st.set_real_traj(md.traj)
    cpu = dict(verbose=False, device="cpu")
    dyn.JumpAnalysis(**cpu).run(st)
    quiet = dict(verbose=False)
    res = {"st": st, "md": md}
    res["da"] = dyn.DiffusionAnalysis(timestep=1.0, **quiet).run(st)
    res["rdf"] = dyn.RDFAnalysis(select_b="static", n_bins=40, **cpu).run(st)
    res["vh"] = dyn.VanHoveAnalysis(lags=(0, 4, 8), n_bins=20,
                                    **cpu).run(st)
    res["sa"] = dyn.ScatteringAnalysis(q_max=2.5, n_shells=4, **cpu).run(st)
    res["vs"] = dyn.VibrationalSpectrumAnalysis(**quiet).run(st)
    res["ca"] = dyn.ConductivitySpectrumAnalysis(["mobile"], [1.0],
                                                 **quiet).run(st)
    res["rta"] = dyn.ResidenceTimeAnalysis(n_mc=10, **quiet)
    res["rta"].run(st)
    res["pa"] = dyn.PathwayBarrierAnalysis(600.0, n_bins=16, min_jumps=2,
                                           **cpu).run(st)
    res["ma"] = dyn.MarkovianityAnalysis(lags=(1, 2, 4, 8),
                                         **quiet).run(st)
    x = st.site_network.centers[:, 0]
    lo = np.flatnonzero(x <= np.quantile(x, 0.2))
    hi = np.flatnonzero(x >= np.quantile(x, 0.8))
    res["tpa"] = dyn.TransitionPathAnalysis(lo, hi, **quiet)
    res["tpa"].run(st)
    T = np.array([600.0, 800.0, 1000.0, 1200.0])
    D = 3e-3 * np.exp(-0.3 / (8.617333262e-5 * T))
    res["arr"] = (dyn.ArrheniusAnalysis(**quiet).run(T, D), T, D)
    return res


KINETICS = [
    ("plot_msd", lambda r: ((r["da"],), {})),
    ("plot_msd", lambda r: ((r["da"],), {"show_atoms": True,
                                         "show_fit": False})),
    ("plot_arrhenius", lambda r: (r["arr"], {"errors": 0.05 * r["arr"][2]})),
    ("plot_rdf", lambda r: ((r["rdf"],), {})),
    ("plot_van_hove", lambda r: ((r["vh"],), {"part": "self"})),
    ("plot_van_hove", lambda r: ((r["vh"],), {"part": "distinct"})),
    ("plot_residence_survival", lambda r: ((r["rta"],), {"sites": [
        s for s, seg in enumerate(r["rta"].segments_) if len(seg)][:5]})),
    ("plot_structure_factor", lambda r: ((r["sa"],), {})),
    ("plot_vdos", lambda r: ((r["vs"],), {})),
    ("plot_conductivity_spectrum", lambda r: ((r["ca"],), {})),
    ("plot_barrier_profiles", lambda r: ((r["pa"],), {})),
    ("plot_reactive_flux", lambda r: ((r["tpa"], r["st"].site_network), {})),
    ("plot_implied_timescales", lambda r: ((r["ma"],), {})),
    ("plot_ck_test", lambda r: ((r["ma"],), {})),
]


@pytest.mark.parametrize("i", range(len(KINETICS)),
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(KINETICS)])
def test_kinetics_plots_draw_the_same_artists(hopping, i):
    name, make = KINETICS[i]
    args, kw = make(hopping)
    drawn = _both(name, *args, **kw)
    assert any(d["lines"] or d["collections"] or d["images"]
               for d in drawn), name


def test_plot_errors_match(hopping):
    for v in (ref_viz, port_viz):
        with pytest.raises(ValueError):
            v.plot_van_hove(hopping["vh"], part="bogus")
        with pytest.raises(ValueError, match="no tested sites"):
            v.plot_residence_survival(hopping["rta"], sites=[])
    plt.close("all")


@pytest.fixture(scope="module")
def annotated():
    """Both packages' SiteTrajectory over the same small annotated
    network (types, occupancies, n_ij, real frames)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 8, (10, 3))
    mask = np.arange(10) < 8
    sns = networks(pos, [16] * 8 + [3] * 2, np.eye(3) * 8.0, mask, ~mask,
                   centers=rng.uniform(0, 8, (4, 3)),
                   vertices=[np.sort(rng.choice(8, 3, replace=False))
                             for _ in range(4)],
                   site_types=[0, 0, 1, 1])
    occ = np.array([0.5, 0.2, 0.9, 0.1])
    n_ij = rng.integers(0, 5, size=(4, 4)).astype(float)
    n_ij[0, 3] = np.nan                    # one-directional attribute
    for sn in sns:
        sn.add_site_attribute("occupancies", occ)
        sn.add_edge_attribute("n_ij", n_ij)
    traj = rng.integers(-1, 4, size=(6, 2)).astype(np.int32)
    return trajectories(sns, traj, real_traj=rng.uniform(0, 8, (6, 10, 3)))


@pytest.mark.parametrize("method,args", [
    ("plot_frame", (0,)), ("plot_frame", (5,)), ("plot_site", (2,)),
    ("plot_particle_trajectory", (1,)),
])
def test_site_trajectory_plot_methods(annotated, method, args):
    figs = [getattr(st, method)(*args) for st in annotated]
    data = [artists(f) for f in figs]
    plt.close("all")
    assert_same_artists(*data, where=method)
    assert data[1][0]["collections"], method


@pytest.mark.parametrize("kw", [
    dict(site_size_attr="occupancies", site_color_attr="occupancies"),
    dict(edge_attr="n_ij", edge_threshold=1.0),
    dict(),
])
def test_site_network_plotter(annotated, kw):
    figs = [v.SiteNetworkPlotter(**kw).plot(st.site_network)
            for v, st in zip((ref_viz, port_viz), annotated)]
    data = [artists(f) for f in figs]
    plt.close("all")
    assert_same_artists(*data, where="SiteNetworkPlotter")


def test_atoms_points_and_layers(annotated):
    st = annotated[1]
    s = st.site_network.structure
    _both("plot_atoms", s)
    _both("plot_atoms", s, mask=st.site_network.mobile_mask, show_cell=False)
    _both("plot_points", st.site_network.centers, cell=s.cell)
    figs = [v.layers((v.plot_atoms, dict(structure=s)),
                     (v.plot_points, dict(points=st.site_network.centers,
                                          cell=s.cell)))
            for v in (ref_viz, port_viz)]
    data = [artists(f) for f in figs]
    plt.close("all")
    assert_same_artists(*data, where="layers")
    assert ref_viz.species_color(3) == port_viz.species_color(3)
    np.testing.assert_array_equal(ref_viz.species_color(77),
                                  port_viz.species_color(77))


def test_visualization_exports_cover_the_reference():
    assert port_viz.__all__ == ref_viz.__all__
    for name in port_viz.__all__:
        assert getattr(port_viz, name).__module__.startswith(
            "sitator_tpu_torch.visualization"), name


def test_plot_jump_lag(annotated):
    import sitator_tpu.dynamics as ref_dyn
    figs = []
    for mod, st, kw in ((ref_dyn, annotated[0], {}),
                        (dyn, annotated[1], {"device": "cpu"})):
        ja = mod.JumpAnalysis(verbose=False, **kw)
        with pytest.raises(ValueError, match="has not been run"):
            ja.plot_jump_lag()
        ja.run(st)
        figs.append(ja.plot_jump_lag())
        fig, ax = plt.subplots()
        assert ja.plot_jump_lag(ax=ax) is fig
    data = [artists(f) for f in figs]
    plt.close("all")
    assert_same_artists(*data, where="plot_jump_lag")
    assert data[1][0]["images"] and data[1][0]["xlabel"] == "to site"


def test_report_writes_the_reference_files(tmp_path):
    """``--report DIR`` with every section on: the same file names, the
    same sections and the same figures' artists as the reference's."""
    import sitator_tpu.cli as ref_cli
    import sitator_tpu_torch.cli as port_cli
    from sitator_tpu.io import write_xyz
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=1200,
                                 jump_rate=0.05, seed=11)
    path = str(tmp_path / "md.xyz")
    write_xyz(path, md.structure, md.traj)
    argv = ["analyze", path, "--mobile", "Li", "--cutoff-midpoint", "4.0",
            "--cutoff-steepness", "3.0", "--timestep", "1.0",
            "--temperature", "600", "--barriers", "--diagnose", "--tpt", "x",
            "--onsager", "Li:+1", "--relaxation", "1.57", "--uncertainty",
            "16"]
    texts = {}
    for k, run in (("ref", ref_cli.main),
                   ("port", lambda a: port_cli.main(["--device", "cpu",
                                                     *a]))):
        rep = str(tmp_path / k)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert run(argv + ["--report", rep]) == 0
        texts[k] = open(os.path.join(rep, "report.md")).read()
    names = {k: sorted(os.listdir(tmp_path / k)) for k in texts}
    assert names["port"] == names["ref"]
    for png in ("site_network.png", "msd.png", "implied_timescales.png",
                "reactive_flux.png", "report.md"):
        assert png in names["port"], png
    assert texts["port"].splitlines()[0] == \
        "# sitator_tpu_torch analysis report"
    assert "- generated by sitator_tpu_torch 0.7.0" in texts["port"]
    heads = {k: [ln for ln in t.splitlines() if ln.startswith(("#", "!["))]
             for k, t in texts.items()}
    assert heads["port"][1:] == heads["ref"][1:]
