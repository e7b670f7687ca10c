"""Both command lines on the same files: ``sitator_tpu.cli`` and the port's
``sitator_tpu_torch.cli --device cpu`` print the same summary lines and save
results that load equal through either package.

Tolerances: every non-numeric token of a line is equal and every integer
exact; a printed float may differ by one unit in its last printed digit
(the engines' float32 work on either side).  Saved arrays: integers
(labels, ``n_ij``, counts) exact, floats to 1e-6 relative."""
import contextlib
import io
import os
import re

import numpy as np
import pytest

import sitator_tpu as ref
import sitator_tpu.io
import sitator_tpu.cli as ref_cli
import sitator_tpu_torch as port
import sitator_tpu_torch.cli as port_cli
from sitator_tpu.io import make_hopping_trajectory, write_xyz

from tests._torch_common import (assert_same_results,
                                 first_math_calls_on_one_thread)

first_math_calls_on_one_thread()

C = ["--cutoff-midpoint", "4.0", "--cutoff-steepness", "3.0"]


def _run(pkg, argv):
    """(rc or the SystemExit message, stdout, stderr) of one CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = (ref_cli.main(argv) if pkg == "ref"
                  else port_cli.main(["--device", "cpu", *argv]))
        except SystemExit as e:
            rc = str(e).replace("sitator_tpu_torch", "sitator_tpu")
    return rc, out.getvalue(), err.getvalue()


_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _same_line(a, b):
    if a == b:
        return True
    if _NUM.split(a) != _NUM.split(b):
        return False
    for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
        if x == y:
            continue
        if not re.search(r"[.eE]", x + y):
            return False                      # integers are exact
        mant = x.split("e")[0].split("E")[0]
        decimals = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(x.lower().split("e")[1]) if "e" in x.lower() else 0
        if abs(float(x) - float(y)) > 1.0001 * 10.0 ** (exp - decimals):
            return False
    return True


def assert_same_output(want, got):
    assert got[0] == want[0], (got[0], want[0])
    for stream in (1, 2):
        w, g = want[stream].splitlines(), got[stream].splitlines()
        # log records name their package's logger
        w = [l.replace("sitator_tpu.", "sitator_tpu_torch.") for l in w]
        assert len(g) == len(w), ("\n".join(w), "\n".join(g))
        for lw, lg in zip(w, g):
            assert _same_line(lw, lg), (lw, lg)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_parity")
    out = {}
    for name, kw in {"md.xyz": dict(n_cells=2, n_ions=2, n_frames=150,
                                    jump_rate=0.03, seed=8),
                     "tpt.xyz": dict(n_cells=3, n_ions=6, n_frames=1200,
                                     jump_rate=0.05, seed=11)}.items():
        md = make_hopping_trajectory(a=4.0, **kw)
        write_xyz(str(d / name), md.structure, md.traj)
        out[name] = str(d / name)
    out["dir"] = d
    return out


ANALYZE = {
    "eager-transport": ["md.xyz", "--mobile", "Li", *C, "--timestep", "1.0",
                        "--temperature", "600"],
    "streaming": ["md.xyz", "--mobile", "Li", *C, "--streaming",
                  "--block-frames", "64"],
    "merge-dynamics": ["tpt.xyz", "--mobile", "Li", *C,
                       "--merge-dynamics", "2.0"],
    "tpt-onsager-diagnose": ["tpt.xyz", "--mobile", "Li", *C, "--tpt", "x",
                             "--timestep", "1.0", "--temperature", "600",
                             "--onsager", "Li:+1", "--uncertainty", "16",
                             "--bottlenecks", "--diagnose"],
    "streaming-tpt": ["tpt.xyz", "--mobile", "Li", *C, "--streaming",
                      "--block-frames", "512", "--tpt", "z:0.2",
                      "--uncertainty", "16", "--timestep", "1.0"],
    "vacancies-concerted": ["tpt.xyz", "--mobile", "3", *C, "--vacancies",
                            "--concerted", "--debounce", "2"],
}


@pytest.mark.parametrize("case", sorted(ANALYZE))
def test_analyze_prints_the_reference_summary(files, case):
    argv = ANALYZE[case]
    argv = ["analyze", files[argv[0]], *argv[1:]]
    assert_same_output(_run("ref", argv), _run("port", argv))


def _load_both(path, kind):
    """The saved file through both packages' loaders."""
    return [getattr(pkg, kind).load(path) for pkg in (ref, port)]


@pytest.mark.parametrize("streaming", [False, True])
def test_saved_results_load_equal_in_both_packages(files, tmp_path,
                                                   streaming):
    outs = {}
    for pkg in ("ref", "port"):
        outs[pkg] = str(tmp_path / f"{pkg}.npz")
        argv = ["analyze", files["tpt.xyz"], "--mobile", "Li", *C,
                "--out", outs[pkg]]
        if streaming:
            argv += ["--streaming", "--block-frames", "256", "--debounce",
                     "3"]
        else:
            argv += ["--timestep", "1.0", "--uncertainty", "8"]
        got = _run(pkg, argv)
        assert got[0] == 0, got
    # a streaming run with a transform saves a SiteTrajectory, and its
    # spilled labels are equal too
    kind = "SiteTrajectory"
    want = _load_both(outs["ref"], kind)
    got = _load_both(outs["port"], kind)
    for w, g in zip(want, got):
        assert_same_results(w, g, rtol=1e-6, where="saved")
    if streaming:
        np.testing.assert_array_equal(np.load(outs["port"] + ".labels.npy"),
                                      np.load(outs["ref"] + ".labels.npy"))


def test_streaming_network_saved_equal(files, tmp_path):
    """Without a transform the streaming route saves a SiteNetwork."""
    outs = {}
    for pkg in ("ref", "port"):
        outs[pkg] = str(tmp_path / f"{pkg}.npz")
        got = _run(pkg, ["analyze", files["tpt.xyz"], "--mobile", "Li", *C,
                         "--streaming", "--block-frames", "300", "--out",
                         outs[pkg]])
        assert got[0] == 0 and "site network saved to" in got[1], got
    for w, g in zip(_load_both(outs["ref"], "SiteNetwork"),
                    _load_both(outs["port"], "SiteNetwork")):
        assert_same_results(w, g, rtol=1e-6, where="network")
    np.testing.assert_array_equal(np.load(outs["port"] + ".labels.npy"),
                                  np.load(outs["ref"] + ".labels.npy"))


def test_info_convert_and_analyze_the_converted_file(files, tmp_path):
    outs = {}
    for pkg in ("ref", "port"):
        outs[pkg] = str(tmp_path / f"{pkg}.npy")
    for argv in (["info", files["md.xyz"]],):
        assert_same_output(_run("ref", argv), _run("port", argv))
    runs = [_run(pkg, ["convert", files["md.xyz"], outs[pkg]])
            for pkg in ("ref", "port")]
    assert [r[1].replace(outs["port"], outs["ref"]) for r in runs[1:]] \
        == [runs[0][1]]
    np.testing.assert_array_equal(np.load(outs["port"]), np.load(outs["ref"]))
    with open(outs["ref"] + ".structure.xyz") as a, \
            open(outs["port"] + ".structure.xyz") as b:
        assert a.read() == b.read()
    # each package analyses the other's .npy (native convert, memmap read)
    for pkg, other in (("ref", "port"), ("port", "ref")):
        argv = ["analyze", outs[other], "--mobile", "Li", *C,
                "--streaming", "--block-frames", "64"]
        assert_same_output(_run("ref", argv), _run("port", argv))
    assert_same_output(_run("ref", ["info", outs["port"]]),
                       _run("port", ["info", outs["ref"]]))


def test_convert_to_zarr_equal(files, tmp_path):
    pytest.importorskip("tensorstore")
    from sitator_tpu.io import TensorstoreTrajectory
    outs = [str(tmp_path / f"{pkg}.zarr") for pkg in ("ref", "port")]
    for pkg, out in zip(("ref", "port"), outs):
        assert _run(pkg, ["convert", files["md.xyz"], out, "--zarr3"])[0] == 0
    a, b = (TensorstoreTrajectory(o) for o in outs)
    np.testing.assert_array_equal(b[0:150], a[0:150])
    assert_same_output(_run("ref", ["info", outs[1]]),
                       _run("port", ["info", outs[0]]))


def _host_cif(path):
    a = 2 * (1.466 + 0.37 * np.log(6.0))
    lines = ["data_t", f"_cell_length_a {a:.6f}", f"_cell_length_b {a:.6f}",
             f"_cell_length_c {a:.6f}", "_cell_angle_alpha 90",
             "_cell_angle_beta 90", "_cell_angle_gamma 90", "loop_",
             "_atom_site_type_symbol", "_atom_site_fract_x",
             "_atom_site_fract_y", "_atom_site_fract_z"]
    lines += [f"O {x} {y} {z}" for x, y, z in
              [(0, 0, 0), (.5, .5, 0), (.5, 0, .5), (0, .5, .5)]]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _matched(got, want):
    """For each of ``got``'s sites the index of ``want``'s nearest one
    (minimum image) and that distance."""
    cell = want.structure.cell
    f = (got.centers[:, None] - want.centers[None]) @ np.linalg.inv(cell)
    d = np.linalg.norm((f - np.round(f)) @ cell, axis=-1)
    j = d.argmin(1)
    return j, d[np.arange(len(j)), j]


@pytest.mark.parametrize("method", ["voronoi", "bv"])
def test_sites_equal(tmp_path, method):
    """Voronoi sites are equal.  On the ideal FCC host the bond-valence
    mismatch of neighbouring grid points ties to float32 noise, so the
    minimum picked may be the next grid point (0.16 Å here): each site
    matches one of the reference's within one grid step, one to one, with
    the same mismatch (a perturbed host picks the same points:
    ``tests/test_torch_bond_valence.py``)."""
    cif = _host_cif(tmp_path / "host.cif")
    outs, runs = {}, {}
    for pkg in ("ref", "port"):
        outs[pkg] = str(tmp_path / f"{pkg}.npz")
        runs[pkg] = _run(pkg, ["sites", cif, "--mobile", "Li", "--method",
                               method, "--supercell", "2", "2", "2",
                               "--bv-mismatch-tol", "0.3", "--out", outs[pkg],
                               "--xyz", str(tmp_path / f"{pkg}.cif")])
    norm = [r[1].replace(str(tmp_path / "port"), str(tmp_path / "ref"))
            for r in (runs["ref"], runs["port"])]
    assert norm[1] == norm[0]
    for w, g in zip(_load_both(outs["ref"], "SiteNetwork"),
                    _load_both(outs["port"], "SiteNetwork")):
        if method == "voronoi":
            assert_same_results(w, g, rtol=1e-9, where="sites")
            continue
        assert g.n_sites == w.n_sites > 0
        j, d = _matched(g, w)
        assert sorted(j) == list(range(w.n_sites)) and d.max() < 0.2, d
        np.testing.assert_allclose(g.bv_mismatch, w.bv_mismatch[j],
                                   rtol=0, atol=1e-6)
    got, want = (ref.io.read_cif(str(tmp_path / f"{k}.cif"))
                 for k in ("port", "ref"))
    np.testing.assert_array_equal(np.sort(got.species), np.sort(want.species))


def test_arrhenius_equal(tmp_path):
    KB = 8.617333262e-5
    specs = []
    for i, T in enumerate([700.0, 900.0, 1200.0]):
        md = make_hopping_trajectory(
            n_cells=3, a=4.0, n_ions=8, n_frames=1500,
            jump_rate=0.5 * np.exp(-0.25 / (KB * T)), seed=40 + i)
        path = str(tmp_path / f"md{int(T)}.xyz")
        write_xyz(path, md.structure, md.traj)
        specs.append(f"{T:g}={path}")
    outs = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in ("ref", "port")}
    runs = [_run(pkg, ["arrhenius", *specs, "--mobile", "Li", *C,
                       "--timestep", "1.0", "--min-counts", "2",
                       "--out", outs[pkg]]) for pkg in ("ref", "port")]
    runs[1] = (runs[1][0], runs[1][1].replace(outs["port"], outs["ref"]),
               runs[1][2])
    assert_same_output(*runs)
    for w, g in zip(_load_both(outs["ref"], "SiteNetwork"),
                    _load_both(outs["port"], "SiteNetwork")):
        assert_same_results(w, g, rtol=1e-6, where="arrhenius")


MALFORMED = [
    ["analyze", "md.xyz", "--mobile", "79"],
    ["analyze", "md.xyz", "--mobile", "Li", "--merge-metastable", "1"],
    ["analyze", "md.xyz", "--mobile", "Li", "--uncertainty", "1"],
    ["analyze", "md.xyz", "--mobile", "Li", "--tpt", "x:0.9"],
    ["analyze", "md.xyz", "--mobile", "Li", "--onsager", "Li"],
    ["analyze", "md.xyz", "--mobile", "Li", "--onsager", "Li:+1,Li:-1"],
    ["analyze", "md.xyz", "--mobile", "Li", "--barriers"],
    ["analyze", "md.xyz", "--mobile", "Li", "--sites", "bv",
     "--bv-mismatch-tol", "1e-9"],
    ["arrhenius", "bogus", "--mobile", "Li"],
    ["arrhenius", "700=a.xyz", "700=b.xyz", "--mobile", "Li"],
    ["convert", "md.xyz", "md.bogus"],
    ["analyze", "host.cif", "--mobile", "Li"],
    ["info", "junk.bin"],
]


@pytest.mark.parametrize("argv", MALFORMED, ids=[" ".join(a[:1] + a[2:])
                                                  for a in MALFORMED])
def test_malformed_invocations_exit_with_the_reference_message(
        files, argv):
    d = files["dir"]
    (d / "host.cif").write_text("data_x\n_cell_length_a 4\n")
    (d / "junk.bin").write_bytes(b"\x00\x01\x02garbage")
    argv = [files.get(a, str(d / a)) if a.endswith((".xyz", ".cif", ".bin",
                                                    ".bogus")) and i == 1
            else a for i, a in enumerate(argv)]
    want, got = _run("ref", argv), _run("port", argv)
    assert isinstance(want[0], str), want
    assert_same_output(want, got)


def test_streaming_warnings_equal(files):
    argv = ["analyze", files["md.xyz"], "--mobile", "Li", "--streaming",
            "--block-frames", "64", "--timestep", "1.0", "--onsager",
            "Li:+1", "--relaxation", "1.57", "--debounce", "2"]
    want, got = _run("ref", argv), _run("port", argv)
    assert "ignored with --streaming" in want[2]
    assert_same_output(want, got)
