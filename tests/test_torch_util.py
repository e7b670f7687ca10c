"""The port's ``util.timing``, ``util.zeo`` and ``compat`` on the CPU:
``StageTimer``'s report, a ``torch.profiler`` trace written under the trace
directory, the Zeo++ wrapper's error contract and parsers against the
reference's (equal arrays, equal messages), and the ``sitator`` shim over
the port's modules, which refuses while the JAX package's shim holds the
name, and is refused by it in turn."""
import json
import os
import stat
import subprocess
import sys
import warnings

import numpy as np
import pytest

import sitator_tpu
import sitator_tpu.compat as ref_compat
import sitator_tpu.util.zeo as ref_zeo
import sitator_tpu_torch
import sitator_tpu_torch.compat as compat
import sitator_tpu_torch.util as port_util
import sitator_tpu_torch.util.zeo as port_zeo
from sitator_tpu_torch.util.timing import StageTimer, device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ timing --
def test_stage_timer_report():
    t = StageTimer("demo")
    with t.stage("alpha"):
        sum(range(1000))
    with t.stage("beta"):
        sum(range(1000))
    assert [n for n, _ in t.stages] == ["alpha", "beta"]
    rep = t.report()
    assert rep.splitlines()[0] == "demo timing:"
    assert "alpha" in rep and "beta" in rep and "TOTAL" in rep
    assert abs(sum(s for _, s in t.stages) - t.total) < 1e-12
    empty = StageTimer().report(log=True)
    assert "TOTAL" in empty and StageTimer().total == 0.0


def _trace_events(d):
    files = sorted(d.rglob("*.pt.trace.json"))
    assert files, f"no trace under {d}: {list(d.rglob('*'))}"
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The trace is a Chrome trace (``traceEvents``), as TensorBoard's
    profiler plugin and Perfetto read it, and holds the traced operator."""
    import torch
    d = tmp_path / "trace"
    with device_trace(str(d)):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    names = {e.get("name") for e in _trace_events(d)}
    assert "aten::matmul" in names or "aten::mm" in names, sorted(names)[:40]


def test_stage_timer_traces_a_stage(tmp_path):
    import torch
    t = StageTimer()
    with t.stage("traced", trace_dir=str(tmp_path / "t")):
        torch.ones(4, 4) + 1.0
    with t.stage("plain"):
        pass
    assert [n for n, _ in t.stages] == ["traced", "plain"]
    assert _trace_events(tmp_path / "t")
    assert port_util.StageTimer is StageTimer
    assert port_util.device_trace is device_trace


def test_util_exports_cover_the_reference():
    import sitator_tpu.util as ref_util
    assert port_util.__all__ == ref_util.__all__
    for name in port_util.__all__:
        assert getattr(port_util, name).__module__.startswith(
            "sitator_tpu_torch."), name


# --------------------------------------------------------------------- zeo --
NT2 = {
    "sectioned-1": "Vertex table:\n0 1.25 2.5 3.75 0.92 1 2 3 4\n"
                   "1 4.0 5.0 6.0 0.55 2 3 4 1\n\nEdge table:\n"
                   "0 -> 1 0.4 0 0 0 2.75\n1 -> 0 0.4 0 0 0 2.75\n",
    "sectioned-0": "Vertex table:\n0 1.0 1.0 1.0 0.7 0 1 2 3\n"
                   "1 2.0 2.0 2.0 0.6 3 2 1 0\n\nEdge table:\n"
                   "0 -> 1 0.3 0 0 0 1.7\n",
    "markerless": "some header\n0 1.0 2.0 3.0 0.8 1 2 3 4\n"
                  "1 2.0 3.0 4.0 0.7 4 3 2 1\nunrelated trailing text\n",
    "ambiguous": "Vertex table:\n0 1.0 1.0 1.0 0.5 1 2\n\nEdge table:\n",
    "out-of-range": "Vertex table:\n0 1.0 1.0 1.0 0.5 7 8\n\nEdge table:\n",
    "empty": "",
    "garbage": "Vertex table:\n0 nan inf -inf 1e400 1 2\nEdge table:\n",
}


def _zeo_structure(pkg):
    cell = np.array([[6.0, 0, 0], [0, 7.0, 0], [0, 0, 8.0]])
    pos = np.array([[0.5, 0.5, 0.5], [3.0, 3.5, 4.0], [1.0, 6.0, 2.0],
                    [5.0, 1.0, 7.0]])
    return pkg.Structure(pos, np.array([16, 16, 16, 3], np.int32), cell)


def _parse(zeo, pkg, path):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            out = zeo.Zeopy._parse_nt2(path, _zeo_structure(pkg))
        except ValueError as e:
            out = ("ValueError", str(e))
    return out, [str(x.message).replace("sitator_tpu_torch", "sitator_tpu")
                 for x in w]


@pytest.mark.parametrize("case", sorted(NT2))
def test_parse_nt2_equals_the_reference(tmp_path, case):
    p = tmp_path / "net.nt2"
    p.write_text(NT2[case])
    got, got_w = _parse(port_zeo, sitator_tpu_torch, str(p))
    want, want_w = _parse(ref_zeo, sitator_tpu, str(p))
    assert got_w == want_w and any("experimental" in m for m in got_w)
    if isinstance(want[0], str):
        assert got == want
        return
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)


def test_write_cssr_equals_the_reference(tmp_path):
    paths = [str(tmp_path / f"{k}.cssr") for k in ("ref", "port")]
    ref_zeo.Zeopy._write_cssr(_zeo_structure(sitator_tpu), paths[0])
    port_zeo.Zeopy._write_cssr(_zeo_structure(sitator_tpu_torch), paths[1])
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()


def test_missing_binary_raises_zeopp_not_found():
    with pytest.raises(port_zeo.ZeoppNotFoundError, match="native periodic"):
        with port_zeo.Zeopy(executable="definitely-not-a-real-binary-xyz"):
            pass
    assert issubclass(port_zeo.ZeoppNotFoundError, RuntimeError)
    with pytest.raises(port_zeo.ZeoppNotFoundError) as e:
        with port_zeo.Zeopy(executable="definitely-not-a-real-binary-xyz"):
            pass
    assert "sitator_tpu_torch.voronoi.VoronoiSiteGenerator" in str(e.value)


def test_zeopy_against_a_mock_binary(tmp_path, monkeypatch):
    """The whole wrapper against a stand-in ``network`` that records its
    arguments and answers with an nt2 made from the port's own Voronoi
    decomposition: the flags are the reference's, and the parsed net is
    the port's decomposition."""
    from sitator_tpu_torch import SiteNetwork, Structure
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator
    grid = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    s = Structure(grid * 4.0, np.full(8, 16), np.eye(3) * 8.0)
    seeds = VoronoiSiteGenerator(verbose=False).run(
        SiteNetwork(s, np.ones(8, bool), np.zeros(8, bool)))
    nt2 = tmp_path / "baked.nt2"
    with open(nt2, "w") as f:
        f.write("Vertex table:\n")
        for i, (c, v, r) in enumerate(zip(seeds.centers, seeds.vertices,
                                          seeds.site_radii)):
            ids = " ".join(str(int(a) + 1) for a in v)
            f.write(f"{i} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} {r:.6f} {ids}\n")
        f.write("\nEdge table:\n0 -> 1 0.5\n")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "network"
    exe.write_text(f"""#!/bin/sh
echo "$@" > {tmp_path}/argv.txt
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-nt2" ]; then out="$a"; fi
  prev="$a"
done
cp {nt2} "$out"
""")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    with pytest.warns(UserWarning, match="experimental"):
        with port_zeo.Zeopy() as z:
            nodes, verts, radii = z.voronoi(s)
    argv = (tmp_path / "argv.txt").read_text().split()
    assert "-nt2" in argv and "-nor" in argv and argv[-1].endswith(".cssr")
    np.testing.assert_allclose(nodes, seeds.centers, atol=1e-5)
    np.testing.assert_allclose(radii, seeds.site_radii, atol=1e-5)
    for got, want in zip(verts, seeds.vertices):
        assert set(got.tolist()) == set(int(a) for a in want)
    with pytest.warns(UserWarning, match="experimental"):
        with port_zeo.Zeopy() as z:
            z.voronoi(s, radial=True, radii={"S": 1.8})
    argv = (tmp_path / "argv.txt").read_text().split()
    assert "-r" in argv and "-nor" not in argv


# ------------------------------------------------------------------ compat --
@pytest.fixture()
def shim():
    compat.install()
    yield
    compat.uninstall()


def test_compat_layout_is_the_references():
    assert list(compat.REFERENCE_LAYOUT) == list(ref_compat.REFERENCE_LAYOUT)
    for name, (target, symbols) in compat.REFERENCE_LAYOUT.items():
        ref_target, ref_symbols = ref_compat.REFERENCE_LAYOUT[name]
        assert target == ref_target.replace("sitator_tpu",
                                            "sitator_tpu_torch", 1)
        assert symbols == ref_symbols


def test_shim_serves_the_ports_modules(shim):
    from sitator import SiteNetwork, SiteTrajectory, Structure  # noqa: F401
    from sitator.landmark import LandmarkAnalysis
    from sitator.dynamics.JumpAnalysis import JumpAnalysis
    from sitator.util.PBCCalculator import PBCCalculator
    from sitator.visualization import SiteNetworkPlotter
    from sitator.site_descriptors.SOAP import SOAPDescriptorAverages
    import sitator.util.zeo
    import sitator
    assert SiteNetwork is sitator_tpu_torch.SiteNetwork
    assert LandmarkAnalysis is sitator_tpu_torch.LandmarkAnalysis
    assert JumpAnalysis is sitator_tpu_torch.JumpAnalysis
    assert PBCCalculator.__module__ == "sitator_tpu_torch.ops.pbc"
    assert SiteNetworkPlotter.__module__.startswith("sitator_tpu_torch.")
    assert SOAPDescriptorAverages.__module__.startswith("sitator_tpu_torch.")
    assert sitator.util.zeo.Zeopy is port_zeo.Zeopy
    assert sitator.__version__ == sitator_tpu_torch.__version__ \
        == sitator_tpu.__version__
    for ref_name, port_name in [("sitator.dynamics", "dynamics"),
                                ("sitator.network", "network"),
                                ("sitator.util", "util"),
                                ("sitator.visualization", "visualization")]:
        mod = sys.modules[ref_name]
        real = sys.modules["sitator_tpu_torch." + port_name]
        for sym in real.__all__:
            assert getattr(mod, sym) is getattr(real, sym), (ref_name, sym)
    assert not hasattr(sitator_tpu_torch, "__sitator_tpu_torch_compat__")


def test_a_sitator_script_runs_on_the_port(shim):
    from sitator import SiteNetwork
    from sitator.dynamics import JumpAnalysis, RemoveUnoccupiedSites
    from sitator.landmark import LandmarkAnalysis
    from sitator.voronoi import VoronoiSiteGenerator
    from sitator_tpu_torch.io import make_hopping_trajectory
    md = make_hopping_trajectory(n_cells=2, a=4.0, n_ions=2, n_frames=150,
                                 jump_rate=0.02, seed=9)
    sn = VoronoiSiteGenerator(merge_tol=0.05).run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False, device="cpu").run(sn, md.traj)
    st = RemoveUnoccupiedSites().run(st)
    JumpAnalysis(device="cpu").run(st)
    assert st.site_network.n_sites > 0
    assert st.site_network.n_ij.shape == (st.site_network.n_sites,) * 2


def test_each_shim_refuses_while_the_other_holds_sitator():
    ref_compat.install()
    try:
        with pytest.raises(RuntimeError, match="sitator_tpu.compat"):
            compat.install()
        with pytest.raises(RuntimeError, match="sitator_tpu.compat"):
            compat.install(force=True)
        compat.uninstall()                 # not its shim: a no-op
        import sitator
        assert sitator.SiteNetwork is sitator_tpu.SiteNetwork
    finally:
        ref_compat.uninstall()
    compat.install()
    try:
        with pytest.raises(RuntimeError, match="already imported"):
            ref_compat.install()
        ref_compat.uninstall()             # not its shim: a no-op
        import sitator
        assert sitator.SiteNetwork is sitator_tpu_torch.SiteNetwork
    finally:
        compat.uninstall()
    assert "sitator" not in sys.modules


def test_install_refuses_a_real_sitator_then_force():
    sys.modules["sitator"] = type(sys)("sitator")
    try:
        with pytest.raises(RuntimeError, match="already imported"):
            compat.install()
        compat.install(force=True)
        import sitator
        assert getattr(sitator, "__sitator_tpu_torch_compat__", False)
        compat.install()                   # repeated: a no-op
    finally:
        compat.uninstall()
        sys.modules.pop("sitator", None)
    sys.modules["sitator"] = type(sys)("sitator")
    try:
        compat.uninstall()                 # never deletes a real one
        assert "sitator" in sys.modules
    finally:
        del sys.modules["sitator"]


def test_shim_in_a_fresh_interpreter():
    code = ("import sitator_tpu_torch.compat as c; c.install()\n"
            "from sitator import SiteNetwork\n"
            "from sitator.landmark import LandmarkAnalysis\n"
            "import sys\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sitator_tpu')]\n"
            "print('COMPAT_OK', SiteNetwork.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "COMPAT_OK sitator_tpu_torch.core.sitenet" in out.stdout
