"""The port's file IO against the reference's, on the CPU: a file written
by either package is read equal by the other (the writers emit the same
bytes), the native decoders equal the port's Python parsers, an index cache
written by one package is read by the other, and malformed or truncated
input raises the same error with the same message in both.

Tolerances: the writers' bytes and every Python reader's arrays are equal;
the native XYZ and LAMMPS decoders equal the Python parsers bit for bit in
float32; the native XDATCAR decoder multiplies float32 fractions by the
float32 cell (the reference's design, kept), so it holds to the Python
parser within 4 float32 ulp of the largest coordinate and equals the
reference's native decoder bit for bit."""
import os

import numpy as np
import pytest

import sitator_tpu as ref
import sitator_tpu.io.formats as ref_formats
import sitator_tpu.io.native as ref_native
import sitator_tpu_torch as port
import sitator_tpu_torch.io.formats as port_formats
import sitator_tpu_torch.io.native as port_native

PKGS = {"ref": (ref, ref_formats, ref_native),
        "port": (port, port_formats, port_native)}
OTHER = {"ref": "port", "port": "ref"}


def _structure(pkg, seed=0, n_static=40, n_mobile=10, cell=None):
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * 12.0 if cell is None else np.asarray(cell, float)
    n = n_static + n_mobile
    return PKGS[pkg][0].Structure(rng.uniform(0, 1, (n, 3)) @ cell,
                                  ["S"] * n_static + ["Li"] * n_mobile, cell)


def _traj(seed=1, n_frames=12, n_atoms=50, cell=None):
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * 12.0 if cell is None else np.asarray(cell, float)
    t = rng.uniform(-0.4, 1.6, size=(n_frames, n_atoms, 3)) @ cell
    t[3, 7] = [1.25e-3, -4.5e2, 3.0e0]      # exponent-format parse path
    return t


TRICLINIC = [[9.0, 0.0, 0.0], [1.5, 8.0, 0.0], [-0.7, 1.1, 10.0]]

# (writer, file name, eager reader returning (structure, traj))
TRAJ_WRITERS = [
    ("write_xyz", "t.extxyz",
     lambda fm, p: fm.read_xyz(p, index="all")),
    ("write_xdatcar", "XDATCAR", lambda fm, p: fm.read_xdatcar(p)),
    ("write_lammps_dump", "t.lammpstrj",
     lambda fm, p: fm.read_lammps_dump(p)),
]


@pytest.mark.parametrize("cell", [None, TRICLINIC],
                         ids=["cubic", "triclinic"])
@pytest.mark.parametrize("writer,name,read", TRAJ_WRITERS,
                         ids=[w[0] for w in TRAJ_WRITERS])
@pytest.mark.parametrize("by", ["ref", "port"])
def test_trajectory_written_by_one_is_read_equal_by_the_other(
        tmp_path, by, writer, name, read, cell):
    s = _structure(by, cell=cell)
    traj = _traj(cell=cell)
    paths = {}
    for pkg in ("ref", "port"):
        paths[pkg] = str(tmp_path / pkg / name)
        os.makedirs(os.path.dirname(paths[pkg]))
        getattr(PKGS[pkg][1], writer)(paths[pkg], _structure(pkg, cell=cell),
                                      traj)
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read(), f"{writer} bytes differ"
    s_want, t_want = read(PKGS[by][1], paths[by])
    s_got, t_got = read(PKGS[OTHER[by]][1], paths[by])
    np.testing.assert_array_equal(t_got, t_want)
    np.testing.assert_array_equal(s_got.species, s_want.species)
    np.testing.assert_array_equal(s_got.cell, s_want.cell)
    np.testing.assert_array_equal(s_got.positions, s_want.positions)
    assert s.n_atoms == s_got.n_atoms


STRUCT_WRITERS = [("write_poscar", "POSCAR", "read_poscar", {}),
                  ("write_poscar", "POSCAR", "read_poscar",
                   {"direct": False}),
                  ("write_cif", "s.cif", "read_cif", {}),
                  ("write_structure", "CONTCAR", "read_structure", {}),
                  ("write_structure", "s.cif", "read_structure", {}),
                  ("write_structure", "s.xyz", "read_structure", {})]


@pytest.mark.parametrize("writer,name,reader,kw", STRUCT_WRITERS,
                         ids=[f"{w}-{n}-{bool(k)}"
                              for w, n, _, k in STRUCT_WRITERS])
@pytest.mark.parametrize("by", ["ref", "port"])
def test_structure_written_by_one_is_read_equal_by_the_other(
        tmp_path, by, writer, name, reader, kw):
    paths = {}
    for pkg in ("ref", "port"):
        paths[pkg] = str(tmp_path / pkg / name)
        os.makedirs(os.path.dirname(paths[pkg]))
        getattr(PKGS[pkg][1], writer)(
            paths[pkg], _structure(pkg, cell=TRICLINIC, seed=5), **kw)
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    want = getattr(PKGS[by][1], reader)(paths[by])
    got = getattr(PKGS[OTHER[by]][1], reader)(paths[by])
    for k in ("positions", "species", "cell"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_cif_symmetry_expansion_equal(tmp_path):
    p = tmp_path / "sym.cif"
    p.write_text("""data_x
_cell_length_a 5.0
_cell_length_b 5.0
_cell_length_c 5.0
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
_symmetry_space_group_name_H-M 'F m -3 m'
loop_
_symmetry_equiv_pos_as_xyz
'x, y, z'
'x+1/2, y+1/2, z'
'x+1/2, y, z+1/2'
'x, y+1/2, z+1/2'
'-x, -y, -z'
loop_
_atom_site_label
_atom_site_type_symbol
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
_atom_site_occupancy
Na1 Na1+ 0.0000(2) 0 0 1.0
Cl1 Cl1- 0.5 0.5 0.5 1.0
""")
    want = ref_formats.read_cif(str(p))
    got = port_formats.read_cif(str(p))
    assert got.n_atoms == want.n_atoms == 8
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.species, want.species)


def _npt_xyz(path, n_frames=5):
    rng = np.random.default_rng(7)
    frac = rng.random((3, 3))
    with open(path, "w") as f:
        for t in range(n_frames):
            cell = np.eye(3) * (8.0 + 0.1 * t)
            f.write(f"3\nLattice=\"{' '.join(map(str, cell.ravel()))}\" "
                    "Properties=species:S:1:pos:R:3\n")
            for sym, p in zip(["Li", "S", "S"], frac @ cell):
                f.write(f"{sym} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")


def _npt_xdatcar(path, n_frames=4):
    rng = np.random.default_rng(8)
    frac = rng.random((2, 3))
    with open(path, "w") as f:
        for t in range(n_frames):
            a = 8.0 + 0.2 * t
            f.write(f"npt\n1.0\n {a} 0 0\n 0 {a} 0\n 0 0 {a}\nLi S\n1 1\n")
            f.write(f"Direct configuration= {t + 1}\n")
            for x in frac:
                f.write(" %.10f %.10f %.10f\n" % tuple(x))


def _npt_lammps(path, n_frames=4, scaled=False):
    rng = np.random.default_rng(9)
    frac = rng.random((2, 3))
    cols = "xs ys zs" if scaled else "x y z"
    with open(path, "w") as f:
        for t in range(n_frames):
            a = 8.0 + 0.2 * t
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n2\n"
                    f"ITEM: BOX BOUNDS pp pp pp\n0 {a}\n0 {a}\n0 {a}\n"
                    f"ITEM: ATOMS id type {cols}\n")
            for i, x in enumerate(frac if scaled else frac * a):
                f.write(f"{i + 1} {i + 1} {x[0]:.10f} {x[1]:.10f} "
                        f"{x[2]:.10f}\n")


NPT = [("npt.extxyz", _npt_xyz, lambda fm, p, **k: fm.read_xyz(
            p, index="all", **k)),
       ("XDATCAR_npt", _npt_xdatcar, lambda fm, p, **k: fm.read_xdatcar(
           p, **k)),
       ("npt.lammpstrj", _npt_lammps, lambda fm, p, **k:
        fm.read_lammps_dump(p, **k))]


@pytest.mark.parametrize("name,make,read", NPT, ids=[n for n, _, _ in NPT])
def test_variable_cell_rescale_and_error_equal(tmp_path, name, make, read):
    p = str(tmp_path / name)
    make(p)
    s_want, t_want = read(ref_formats, p, variable_cell="rescale")
    s_got, t_got = read(port_formats, p, variable_cell="rescale")
    np.testing.assert_array_equal(t_got, t_want)
    np.testing.assert_array_equal(s_got.cell, s_want.cell)
    errors = []
    for fm in (ref_formats, port_formats):
        with pytest.raises(ValueError, match="variable_cell") as e:
            read(fm, p)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    # the converted .npy bakes the rescale in, identically
    outs = [str(tmp_path / f"{k}.npy") for k in ("ref", "port")]
    for fm, out in zip((ref_formats, port_formats), outs):
        fm.convert_to_npy(p, out, variable_cell="rescale")
    np.testing.assert_array_equal(np.load(outs[1]), np.load(outs[0]))
    with open(outs[0] + ".structure.xyz") as a, \
            open(outs[1] + ".structure.xyz") as b:
        assert a.read() == b.read()


def test_scaled_lammps_npt_equal(tmp_path):
    p = str(tmp_path / "scaled.lammpstrj")
    _npt_lammps(p, scaled=True)
    _, want = ref_formats.read_lammps_dump(p, variable_cell="rescale")
    _, got = port_formats.read_lammps_dump(p, variable_cell="rescale")
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- the decoders --
NATIVE = [("t.extxyz", "write_xyz", "FastXYZTrajectory", "XYZTrajectory"),
          ("XDATCAR", "write_xdatcar", "FastXDATCARTrajectory",
           "XDATCARTrajectory"),
          ("t.lammpstrj", "write_lammps_dump", "FastLammpsTrajectory",
           "LammpsDumpTrajectory")]


@pytest.fixture(scope="module")
def native_files(tmp_path_factory):
    assert port_native.get_lib() is not None, "g++ is needed here"
    d = tmp_path_factory.mktemp("native")
    traj = _traj(n_frames=20)
    out = {}
    for name, writer, _, _ in NATIVE:
        p = str(d / name)
        getattr(port_formats, writer)(p, _structure("port"), traj)
        out[name] = p
    return out, traj


@pytest.mark.parametrize("name,writer,fast,slow", NATIVE,
                         ids=[n[2] for n in NATIVE])
def test_native_decoder_equals_python_parser(native_files, name, writer,
                                             fast, slow):
    files, traj = native_files
    p = files[name]
    r = getattr(port_native, fast)(p, cache_index=False)
    py = getattr(port_formats, slow)(p)
    theirs = getattr(ref_native, fast)(p, cache_index=False)
    n = len(traj)
    assert len(r) == len(py) == n and r.n_atoms == py.n_atoms
    got, want = r[0:n], py[0:n]
    assert got.dtype == want.dtype == np.float32
    if fast == "FastXDATCARTrajectory":
        ulp = np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, theirs[0:n])
    # int keys: one (A, 3) frame, negative from the end; slices clip
    np.testing.assert_array_equal(r[-1], got[-1])
    np.testing.assert_array_equal(r[-n], got[0])
    np.testing.assert_array_equal(r[5], got[5])
    np.testing.assert_array_equal(r[n - 3:n + 10], got[n - 3:])
    assert r[4:4].shape == (0, r.n_atoms, 3)
    for bad in (n, -n - 1):
        with pytest.raises(IndexError):
            r[bad]
    with pytest.raises(ValueError, match="contiguous"):
        r[0:n:2]
    np.testing.assert_array_equal(r.structure.species,
                                  py.structure.species)
    np.testing.assert_array_equal(r.structure.cell, py.structure.cell)


def test_native_long_comment_lines(tmp_path):
    """Comment lines far past any fixed line buffer keep the index in
    step."""
    rng = np.random.default_rng(2)
    n_atoms, n_frames = 5, 4
    traj = rng.uniform(0, 9, size=(n_frames, n_atoms, 3))
    f = str(tmp_path / "long.extxyz")
    with open(f, "w") as fh:
        for fr in range(n_frames):
            fh.write(f"{n_atoms}\n")
            fh.write('Lattice="9 0 0 0 9 0 0 0 9" junk='
                     + "x" * (100_000 + fr) + "\n")
            for a in range(n_atoms):
                fh.write("S %.6f %.6f %.6f\n" % tuple(traj[fr, a]))
    r = port_native.FastXYZTrajectory(f, cache_index=False)
    want = port_formats.XYZTrajectory(f)[0:n_frames]
    np.testing.assert_array_equal(r[0:n_frames], want)
    np.testing.assert_array_equal(
        r[0:n_frames],
        ref_native.FastXYZTrajectory(f, cache_index=False)[0:n_frames])


@pytest.mark.parametrize("name,writer,fast,slow", NATIVE,
                         ids=[n[2] for n in NATIVE])
@pytest.mark.parametrize("by", ["ref", "port"])
def test_index_cache_written_by_one_is_read_by_the_other(
        tmp_path, monkeypatch, by, name, writer, fast, slow):
    p = str(tmp_path / name)
    getattr(port_formats, writer)(p, _structure("port"), _traj(n_frames=9))
    first = getattr(PKGS[by][2], fast)(p)
    cache = p + first._cache_suffix
    assert os.path.exists(cache)
    reader_cls = getattr(PKGS[OTHER[by]][2], fast)
    assert reader_cls._cache_suffix == first._cache_suffix

    def no_scan(self, offsets, cap):
        raise AssertionError("index scanned despite a valid cache")

    monkeypatch.setattr(reader_cls, "_index_call", no_scan)
    second = reader_cls(p)
    np.testing.assert_array_equal(second._offsets, first._offsets)
    assert (len(second), second.n_atoms) == (len(first), first.n_atoms)
    np.testing.assert_array_equal(second[0:9], first[0:9])
    monkeypatch.undo()
    # a rewritten file invalidates the cache in both packages
    getattr(port_formats, writer)(p, _structure("port"), _traj(n_frames=11))
    os.utime(p, ns=(1, 1))
    assert len(reader_cls(p)) == len(getattr(PKGS[by][2], fast)(p)) == 11


def test_native_library_builds_into_the_build_directory():
    """The port builds its own copies of the decoders into ``build/``
    (gitignored), never next to its sources, and never loads the
    reference's artefact."""
    assert port_native.get_lib() is not None
    lib = port_native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib.exists()
    assert os.path.relpath(lib, root).split(os.sep)[0] == "build"
    assert lib.parent.name.startswith("sitator_tpu_torch-fastio-")
    src_dir = os.path.dirname(port_native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".bin")]
    for name in ("fastxyz.cpp", "fastxd.cpp", "fastlmp.cpp"):
        with open(os.path.join(src_dir, name), "rb") as a, open(
                os.path.join(os.path.dirname(ref_native.__file__), name),
                "rb") as b:
            assert a.read() == b.read(), name


def test_open_trajectory_prefers_the_native_decoder(native_files):
    files, traj = native_files
    for name, _, fast, _ in NATIVE:
        r = port_formats.open_trajectory(files[name])
        assert type(r) is getattr(port_native, fast)


# --------------------------------------------------------- error contract --
def _cases():
    """(file name, text, reader, kwargs): malformed or truncated input."""
    hdr = "c\n1.0\n 4 0 0\n 0 4 0\n 0 0 4\n"
    cif_cell = ("data_x\n_cell_length_a 4.0\n_cell_length_b 4.0\n"
                "_cell_length_c 4.0\n_cell_angle_alpha 90\n"
                "_cell_angle_beta 90\n_cell_angle_gamma 90\n")
    return [
        ("empty.xyz", "", "read_xyz", {}),
        ("empty2.xyz", "", "read_xyz", {"index": "all"}),
        ("one.xyz", '1\nLattice="4 0 0 0 4 0 0 0 4"\nLi 1 1 1\n',
         "read_xyz", {"index": 3}),
        ("bad.xyz", '1\nLattice="4 0 0 0 4"\nLi 1 1 1\n', "read_xyz", {}),
        ("nopos.xyz", '1\nLattice="4 0 0 0 4 0 0 0 4" '
         'Properties=species:S:1:charge:R:1\nLi 0.1\n', "read_xyz", {}),
        ("nocell.cif", "data_x\n_cell_length_a 4.0\nloop_\n"
         "_atom_site_label\n_atom_site_fract_x\n_atom_site_fract_y\n"
         "_atom_site_fract_z\nLi1 0 0 0\n", "read_cif", {}),
        ("nosites.cif", cif_cell, "read_cif", {}),
        ("badel.cif", cif_cell + "loop_\n_atom_site_type_symbol\n"
         "_atom_site_fract_x\n_atom_site_fract_y\n_atom_site_fract_z\n"
         "Qq 0 0 0\n", "read_cif", {}),
        ("nosym.cif", cif_cell + "_symmetry_space_group_name_H-M 'P m'\n"
         "loop_\n_atom_site_type_symbol\n_atom_site_fract_x\n"
         "_atom_site_fract_y\n_atom_site_fract_z\nLi 0 0 0\n",
         "read_cif", {}),
        ("wrapped.cif", cif_cell + "loop_\n_atom_site_type_symbol\n"
         "_atom_site_fract_x\n_atom_site_fract_y\n_atom_site_fract_z\n"
         "Li 0 0\n", "read_cif", {}),
        ("XDATCAR", hdr + "Li\n1\n", "read_xdatcar", {}),
        ("EMPTY", "", "read_xdatcar", {}),
        ("EMPTYP", "", "read_poscar", {}),
        ("L2", "c\n1.0\n 4 0 0\n 0 4 0\n", "read_poscar", {}),
        ("LSHORT", "c\n1.0\n 4 0 0\n 0 4 0\n 0 0\n", "read_poscar", {}),
        ("NOSPEC", hdr, "read_poscar", {}),
        ("NOCOUNT", hdr + "Li\n", "read_poscar", {}),
        ("NOMODE", hdr + "Li\n2\n", "read_poscar", {}),
        ("MIDCOORD", hdr + "Li\n2\nDirect\n0.1 0.2 0.3\n", "read_poscar", {}),
        ("XTRUNC", "c\n1.0\n 4 0 0\n", "read_xdatcar", {}),
        ("XMID", hdr + "Li\n2\nDirect\n0.1 0.2 0.3\n", "read_xdatcar", {}),
        ("XCOUNTS", hdr + "Li\n1\nDirect configuration= 1\n0.1 0.1 0.1\n"
         + hdr + "Li\n2\nDirect configuration= 2\n0.1 0.1 0.1\n"
         "0.2 0.2 0.2\n", "read_xdatcar", {"variable_cell": "rescale"}),
        ("box.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
         "ITEM: SOMETHING ELSE\n", "read_lammps_dump", {}),
        ("natoms.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: ATOMS id x y z\n",
         "read_lammps_dump", {}),
        ("neg.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n-1\n",
         "read_lammps_dump", {}),
        ("cols.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
         "ITEM: BOX BOUNDS pp pp pp\n0 4\n0 4\n0 4\nITEM: ATOMS id q\n1 0\n",
         "read_lammps_dump", {}),
        ("none.lammpstrj", "", "read_lammps_dump", {}),
        ("vc.xyz", "", "read_xyz", {"index": "all",
                                    "variable_cell": "bogus"}),
        ("empty3.xyz", "", "convert_to_npy", {}),
        ("b.npy", None, "convert_to_npy", {}),
        ("junk.bin", b"\x00\x01\x02garbage", "open_trajectory", {}),
    ]


@pytest.mark.parametrize("name,text,fn,kw", _cases(),
                         ids=[c[0] for c in _cases()])
def test_malformed_input_raises_the_reference_error(tmp_path, name, text,
                                                    fn, kw):
    p = tmp_path / name
    if text is None:
        np.save(str(p), np.zeros((2, 1, 3), np.float32))
    elif isinstance(text, bytes):
        p.write_bytes(text)
    else:
        p.write_text(text)
    args = (str(p),)
    if fn == "convert_to_npy":
        args += (str(tmp_path / "out.npy"),)
    errors = []
    for fm in (ref_formats, port_formats):
        with pytest.raises(Exception) as e:
            getattr(fm, fn)(*args, **kw)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == "ValueError", errors[0]


NATIVE_ERRORS = [
    ("bad.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: ATOMS id x y z\n",
     "FastLammpsTrajectory"),
    ("bad2.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n2\n",
     "FastLammpsTrajectory"),
    ("scaled.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
     "ITEM: BOX BOUNDS pp pp pp\n0 4\n0 4\n0 4\n"
     "ITEM: ATOMS id xs ys zs\n1 0.1 0.2 0.3\n", "FastLammpsTrajectory"),
    ("group.lammpstrj", "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n2\n"
     "ITEM: BOX BOUNDS pp pp pp\n0 4\n0 4\n0 4\nITEM: ATOMS id x y z\n"
     "5 1 1 1\n9 2 2 2\n", "FastLammpsTrajectory"),
    ("pos_first.xyz", '1\nLattice="4 0 0 0 4 0 0 0 4" '
     'Properties=pos:R:3:species:S:1\n1 1 1 Li\n', "FastXYZTrajectory"),
    ("npt.xyz", '1\nLattice="4 0 0 0 4 0 0 0 4"\nLi 1 1 1\n'
     '1\nLattice="5 0 0 0 5 0 0 0 5"\nLi 1 1 1\n', "FastXYZTrajectory"),
    ("nan.xyz", '1\nLattice="4 0 0 0 4 0 0 0 4"\nLi nan 1 1\n',
     "FastXYZTrajectory"),
]


@pytest.mark.parametrize("name,text,cls", NATIVE_ERRORS,
                         ids=[c[0] for c in NATIVE_ERRORS])
def test_native_refusals_match_the_reference(tmp_path, name, text, cls):
    """What the native decoders refuse (so ``open_trajectory`` falls back
    to the Python parsers) they refuse with the reference's error."""
    p = tmp_path / name
    p.write_text(text)
    errors = []
    for nat in (ref_native, port_native):
        try:
            r = getattr(nat, cls)(str(p), cache_index=False)
            r[0:len(r)]
        except Exception as e:      # the contract is type and message
            errors.append((type(e).__name__, str(e)))
        else:
            errors.append(None)
    assert errors[0] == errors[1]
    assert errors[0] is not None, "the reference accepts this file"
    # and open_trajectory gives the same answer in both packages
    outcome = []
    for fm in (ref_formats, port_formats):
        try:
            r = fm.open_trajectory(str(p))
            outcome.append((type(r).__name__, r[0:len(r)].tobytes()))
        except Exception as e:      # the contract is type and message
            outcome.append((type(e).__name__, str(e)))
    assert outcome[0] == outcome[1]


def test_sniffing_and_structure_format_equal(tmp_path):
    names = {"a.xyz": '1\nLattice="4 0 0 0 4 0 0 0 4"\nLi 1 1 1\n',
             "traj.txt": '1\nLattice="4 0 0 0 4 0 0 0 4"\nLi 1 1 1\n',
             "XDATCAR_x": "c\n1.0\n4 0 0\n0 4 0\n0 0 4\nLi\n1\n",
             "xd.dat": "12.5\n1.0\n4 0 0\n0 4 0\n0 0 4\nLi\n1\n",
             "d.dump": "ITEM: TIMESTEP\n0\n",
             "lmp.out": "ITEM: TIME\n0.0\nITEM: TIMESTEP\n0\n",
             "POSCAR": "x\n1.0\n 4 0 0\n 0 4 0\n 0 0 4\nLi\n1\nDirect\n0 0 0\n",
             "host.vasp": "x\n", "CONTCAR.cif": "data_x\n",
             "a.xdatcar": "x\n", "free.xyz": "1\nProperties=foo\nLi 1 2 3\n",
             "junk.bin": "garbage\n"}
    for name, text in names.items():
        (tmp_path / name).write_text(text)
    np.save(str(tmp_path / "n.dat"), np.zeros((1, 1, 3)))
    os.replace(str(tmp_path / "n.dat.npy"), str(tmp_path / "n.dat"))
    for p in sorted(tmp_path.iterdir()):
        assert (port_formats.sniff_format(str(p))
                == ref_formats.sniff_format(str(p))), p.name
        assert (port_formats.structure_format(str(p))
                == ref_formats.structure_format(str(p))), p.name
    assert port_formats.sniff_format(str(tmp_path)) is None


@pytest.mark.parametrize("by", ["ref", "port"])
def test_convert_to_npy_and_sidecar_read_across(tmp_path, by):
    src = str(tmp_path / "md.extxyz")
    port_formats.write_xyz(src, _structure("port"), _traj(n_frames=7))
    out = str(tmp_path / "md.npy")
    s, _ = PKGS[by][1].convert_to_npy(src, out)
    assert os.path.exists(port_formats.structure_sidecar_path(out))
    assert (port_formats.structure_sidecar_path(out)
            == ref_formats.structure_sidecar_path(out))
    readers = [fm.open_trajectory(out) for fm in (ref_formats, port_formats)]
    assert type(readers[1]) is port_formats.NpyTrajectory
    np.testing.assert_array_equal(readers[1][0:7], readers[0][0:7])
    np.testing.assert_array_equal(readers[1].structure.species,
                                  readers[0].structure.species)
    np.testing.assert_array_equal(readers[1].structure.cell, s.cell)
    # a reader source converts blockwise, without a structure: no sidecar
    out2 = str(tmp_path / "md2.npy")
    PKGS[OTHER[by]][1].convert_to_npy(
        port_formats.ArrayTrajectory(np.load(out)), out2)
    np.testing.assert_array_equal(np.load(out2), np.load(out))
    assert not os.path.exists(port_formats.structure_sidecar_path(out2))


def test_npz_and_h5_readers_equal(tmp_path):
    arr = np.random.default_rng(3).random((4, 5, 3)).astype(np.float32)
    np.savez(str(tmp_path / "t.npz"), positions=arr)
    got = port_formats.open_trajectory(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(got[0:4], arr)
    h5py = pytest.importorskip("h5py")
    with h5py.File(str(tmp_path / "t.h5"), "w") as f:
        f["positions"] = arr
    readers = [fm.open_trajectory(str(tmp_path / "t.h5"))
               for fm in (ref_formats, port_formats)]
    assert type(readers[1]) is port_formats.H5Trajectory
    np.testing.assert_array_equal(readers[1][1:3], readers[0][1:3])
    for r in readers:
        r.close()


@pytest.mark.parametrize("zarr_format", [2, 3])
@pytest.mark.parametrize("by", ["ref", "port"])
def test_zarr_store_written_by_one_is_read_by_the_other(tmp_path, by,
                                                        zarr_format):
    pytest.importorskip("tensorstore")
    import sitator_tpu.io.tensorstore_io as ref_ts
    import sitator_tpu_torch.io.tensorstore_io as port_ts
    ts = {"ref": ref_ts, "port": port_ts}
    src = str(tmp_path / "md.extxyz")
    port_formats.write_xyz(src, _structure("port"), _traj(n_frames=9))
    out = str(tmp_path / "md.zarr")
    ts[by].convert_to_zarr(src, out, chunk_frames=4,
                           zarr_format=zarr_format)
    want = ref_ts.TensorstoreTrajectory(out)
    got = port_formats.open_trajectory(out)
    assert type(got) is port_ts.TensorstoreTrajectory
    np.testing.assert_array_equal(got[0:9], want[0:9])
    np.testing.assert_array_equal(got.structure.cell, want.structure.cell)
    # the two-pass text route (rescale) and the guards
    npt = str(tmp_path / "npt.extxyz")
    _npt_xyz(npt)
    outs = []
    for k, mod in ts.items():
        o = str(tmp_path / f"{k}_npt.zarr")
        mod.convert_to_zarr(npt, o, variable_cell="rescale",
                            zarr_format=zarr_format)
        outs.append(port_ts.TensorstoreTrajectory(o)[0:5])
    np.testing.assert_array_equal(outs[1], outs[0])
    for mod in ts.values():
        with pytest.raises(ValueError, match="zarr_format must be 2 or 3"):
            mod.convert_to_zarr(npt, str(tmp_path / "x.zarr"),
                                zarr_format="3")


def test_ase_adapter_needs_ase(monkeypatch):
    import sys
    from sitator_tpu_torch.io import ase_adapter
    monkeypatch.setitem(sys.modules, "ase", None)
    for fn in (ase_adapter.from_ase, ase_adapter.to_ase,
               ase_adapter.trajectory_from_ase):
        with pytest.raises(ImportError, match="ASE is not installed"):
            fn(object())
