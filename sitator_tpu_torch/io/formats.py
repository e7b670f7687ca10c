"""Structure & trajectory file IO (counterpart of ``sitator_tpu.io.formats``;
host NumPy, copied so the port imports nothing of the JAX package).

ASE is not a dependency, so the package owns its formats:

- extended XYZ (``Lattice=...`` comment convention) read/write for
  structures and multi-frame trajectories;
- VASP XDATCAR and LAMMPS text dumps, each with a streaming O(1)-memory
  generator (``iread_*``) and an eager reader;
- POSCAR/CONTCAR and CIF structures (CIF symmetry expanded to P1);
- ``.npy`` (memmapped), ``.npz`` and HDF5 trajectory readers behind one
  ``TrajectoryReader`` protocol: ``len()``, ``reader[lo:hi] -> (n, A, 3)``;
- :func:`convert_to_npy` — stream any text format into the memmapped
  ``.npy`` the streaming engine prefers (two passes, O(1) memory);
- :class:`ChunkedFeeder`, a background-thread prefetcher that overlaps host
  IO/decode with device compute for the streaming pipeline.

Text formats open through the multithreaded native decoders of
:mod:`sitator_tpu_torch.io.native` when they build and accept the file.
The writers' default comment / data-block names are the reference's, so
both packages write the same bytes for the same input.
"""
from __future__ import annotations

import logging
import os
import re
import threading
import queue as _queue

import numpy as np

logger = logging.getLogger(__name__)

from sitator_tpu_torch.core.structure import (Structure, number_to_symbol,
                                              symbol_to_number)

__all__ = [
    "read_xyz", "write_xyz", "iread_xyz",
    "read_poscar", "read_cif", "read_structure", "write_poscar",
    "write_cif", "write_structure",
    "read_xdatcar", "read_lammps_dump",
    "write_xdatcar", "write_lammps_dump",
    "iread_xdatcar", "iread_lammps_dump", "convert_to_npy",
    "structure_sidecar_path",
    "NpyTrajectory", "NpzTrajectory", "H5Trajectory", "XYZTrajectory",
    "XDATCARTrajectory", "LammpsDumpTrajectory",
    "ArrayTrajectory", "open_trajectory", "ChunkedFeeder",
    "TrajectoryReader",
]


_LATTICE_RE = re.compile(r'Lattice\s*=\s*"([^"]+)"', re.IGNORECASE)
_PROPS_RE = re.compile(r'Properties\s*=\s*"?([A-Za-z0-9_:]+)"?',
                       re.IGNORECASE)


def _parse_properties(comment):
    """Whitespace-field offsets of the species and pos columns from an
    extxyz ``Properties=`` declaration (each property contributes its
    declared column count).  Returns ``(species_field or None,
    pos_field)``; files without a declaration use the plain-xyz
    convention ``(0, 1)``."""
    m = _PROPS_RE.search(comment)
    if not m:
        return 0, 1
    parts = m.group(1).split(":")
    if len(parts) < 3 or len(parts) % 3:
        # not a real name:kind:count declaration (free-text comment that
        # happens to contain "Properties=...") — historical tolerant layout
        return 0, 1
    off = 0
    species_f = pos_f = None
    for i in range(0, len(parts) - 2, 3):
        name, _kind, cnt = parts[i], parts[i + 1], parts[i + 2]
        if not cnt.isdigit():
            return 0, 1                       # malformed -> tolerant layout
        if name.lower() == "species":
            species_f = off
        elif name.lower() == "pos":
            pos_f = off
        off += int(cnt)
    if pos_f is None:
        raise ValueError(
            f"extxyz Properties declares no pos field: {m.group(1)!r}")
    return species_f, pos_f

# Variable-cell (NPT) policy, shared by all text readers.  The SiteNetwork
# data model assumes ONE cell per analysis (as the reference does —
# SURVEY.md §3.1/§3.7); per-frame cells are bridged to it by
# ``ops.pbc.rescale_to_cell``: an affine, fractional-preserving map into
# the first frame's cell.  Exact for homogeneous cell fluctuations — sites
# live in fractional space, so they become stationary in the reference
# cell; no wrapping is applied, so unwrapped coordinates stay continuous.
_VC_POLICIES = ("error", "rescale")


def _check_vc(variable_cell):
    if variable_cell not in _VC_POLICIES:
        raise ValueError(f"variable_cell must be one of {_VC_POLICIES}, "
                         f"got {variable_cell!r}")


def _vc_error(fmt, detail=""):
    return ValueError(
        f"variable-cell {fmt} with variable_cell='error' — the SiteNetwork "
        "data model assumes one cell; pass variable_cell='rescale' to map "
        "every frame into the first frame's cell (exact for homogeneous "
        f"NPT fluctuations){detail}")


def _parse_comment(comment):
    m = _LATTICE_RE.search(comment)
    if not m:
        return None
    vals = np.array([float(x) for x in m.group(1).split()])
    if vals.size != 9:
        raise ValueError(f"bad Lattice= entry: {m.group(1)!r}")
    return vals.reshape(3, 3)


def iread_xyz(path):
    """Yield ``Structure`` per frame from an (ext)xyz file.

    Each frame carries its own ``Lattice=`` cell (extxyz allows per-frame
    cells); single-cell consumers go through :func:`_iread_xyz_fixedcell`.
    Cell-less (non-periodic) files get one synthetic bounding box computed
    from the first frame and shared by all frames, so downstream PBC math
    sees a consistent cell.
    """
    synth_cell = None
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            n = int(line)
            comment = f.readline()
            cell = _parse_comment(comment)
            # honor the Properties= column layout (pos-first files, extra
            # per-atom columns like forces); absent -> species, x, y, z
            sp_f, pos_f = _parse_properties(comment)
            species = np.empty(n, dtype=np.int32)
            pos = np.empty((n, 3), dtype=np.float64)
            for i in range(n):
                parts = f.readline().split()
                if sp_f is None:
                    species[i] = 0                    # no species column
                else:
                    s = parts[sp_f]
                    species[i] = (int(s) if s.isdigit()
                                  else symbol_to_number(s))
                pos[i] = [float(x) for x in parts[pos_f:pos_f + 3]]
            if cell is None:
                if synth_cell is None:
                    # non-periodic xyz: bounding box with margin
                    span = pos.max(0) - pos.min(0) + 10.0
                    synth_cell = np.diag(span)
                cell = synth_cell
            yield Structure(pos, species, cell)


def _iread_xyz_fixedcell(path, variable_cell="error"):
    """Bridge :func:`iread_xyz` to the single-cell data model: yields
    ``(shared_structure, pos (A, 3))`` pairs, handling per-frame ``Lattice=``
    changes per the ``variable_cell`` policy (see module note above)."""
    _check_vc(variable_cell)
    ref = None
    for s in iread_xyz(path):
        if ref is None:
            ref = s
            yield ref, s.positions
        elif np.allclose(s.cell, ref.cell, atol=1e-8):
            yield ref, s.positions
        elif variable_cell == "error":
            raise _vc_error("extxyz (per-frame Lattice=)")
        else:
            from sitator_tpu_torch.ops.pbc import rescale_to_cell
            yield ref, rescale_to_cell(s.positions, s.cell, ref.cell)


def read_xyz(path, index=None, variable_cell="error"):
    """Read an (ext)xyz file.  ``index=None`` → first frame as a
    ``Structure``; ``index='all'`` → (structure0, traj (F, A, 3)).
    ``variable_cell``: 'error' (default) raises if frames carry differing
    ``Lattice=`` cells; 'rescale' maps them into the first frame's cell."""
    if index is None:
        try:
            return next(iread_xyz(path))
        except StopIteration:
            raise ValueError(f"no frames found in {path}") from None
    if index == "all":
        first = None
        traj = []
        for first, pos in _iread_xyz_fixedcell(path, variable_cell):
            traj.append(pos)
        if first is None:
            raise ValueError(f"no frames found in {path}")
        return first, np.stack(traj)
    raise ValueError("index must be None or 'all'")


def write_xyz(path, structure, traj=None, mode="w"):
    """Write a ``Structure`` (plus optional trajectory positions (F, A, 3))
    as extended XYZ."""
    cellstr = " ".join(f"{x:.10g}" for x in structure.cell.ravel())
    syms = structure.symbols
    frames = (traj if traj is not None
              else structure.positions[None, :, :])
    with open(path, mode) as f:
        for pos in frames:
            f.write(f"{structure.n_atoms}\n")
            f.write(f'Lattice="{cellstr}" Properties=species:S:1:pos:R:3\n')
            for s, p in zip(syms, pos):
                f.write(f"{s} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")


def _header_fields(f, what, fmt, n=None):
    """Read one header line and split it, raising a clear truncation error
    instead of the cryptic numpy/float failures a cut-off file produces.

    ``n`` (optional) additionally requires at least that many fields —
    a lattice row with two numbers is as truncated as a missing line.
    """
    toks = f.readline().split()
    if not toks or (n is not None and len(toks) < n):
        raise ValueError(f"{fmt} header truncated: missing or short "
                         f"{what} line (empty or cut-off file?)")
    return toks


def _header_cell_rows(f, fmt):
    """The three lattice-vector rows, with truncation diagnostics."""
    return np.array([[float(x) for x in
                      _header_fields(f, f"lattice row {i + 1}", fmt, n=3)[:3]]
                     for i in range(3)])


def read_poscar(path):
    """VASP POSCAR/CONTCAR → :class:`Structure` (single frame).

    Handles VASP5 (symbols line) and VASP4 (counts only — species
    become 1, 2, ...) headers, the ``Selective dynamics`` line,
    ``Direct`` and ``Cartesian`` coordinates, and the negative-scale
    (target volume) convention.  The natural way to hand a screening
    structure to the no-trajectory workflows (bond-valence seeding,
    Voronoi seeding).
    """
    with open(path) as f:
        f.readline()                                  # comment
        scale = float(_header_fields(f, "scale", "POSCAR")[0])
        raw_cell = _header_cell_rows(f, "POSCAR")
        if scale < 0:
            scale = (-scale / abs(np.linalg.det(raw_cell))) ** (1.0 / 3.0)
        cell = raw_cell * scale
        toks = _header_fields(f, "species/counts", "POSCAR")
        if all(t.lstrip("-").isdigit() for t in toks):
            counts = [int(x) for x in toks]           # VASP4
            species = np.concatenate([
                np.full(c, i + 1, dtype=np.int32)
                for i, c in enumerate(counts)])
        else:
            symbols = toks
            counts = [int(x) for x in
                      _header_fields(f, "counts", "POSCAR")]
            species = np.concatenate([
                np.full(c, symbol_to_number(symbols[i]), dtype=np.int32)
                for i, c in enumerate(counts)])
        n = sum(counts)
        line = f.readline().strip()
        if line[:1].lower() == "s":                   # Selective dynamics
            line = f.readline().strip()
        if not line:
            raise ValueError("POSCAR header truncated: missing coordinate "
                             "mode line (empty or cut-off file?)")
        cartesian = line[:1].lower() in ("c", "k")
        coords = np.array([
            [float(x) for x in
             _header_fields(f, f"coordinate row {i + 1}/{n}", "POSCAR",
                            n=3)[:3]]
            for i in range(n)])
    pos = coords * scale if cartesian else coords @ cell
    return Structure(pos, species, cell)


def write_poscar(path, structure, comment="sitator_tpu", direct=True):
    """Write a :class:`Structure` as a VASP5 POSCAR (species grouped in
    first-appearance order; ``direct=False`` writes Cartesian).
    :func:`read_poscar` round-trips it to text precision (note: atoms
    are reordered to group species — the written order is the POSCAR
    convention, not necessarily the input order)."""
    species = np.asarray(structure.species)
    seen = list(dict.fromkeys(species.tolist()))
    order = np.concatenate([np.flatnonzero(species == z) for z in seen])
    counts = [int((species == z).sum()) for z in seen]
    pos = structure.positions[order]
    with open(path, "w") as f:
        f.write(f"{comment}\n1.0\n")
        for row in structure.cell:
            f.write(f" {row[0]:.10f} {row[1]:.10f} {row[2]:.10f}\n")
        f.write(" ".join(number_to_symbol(int(z)) for z in seen) + "\n")
        f.write(" ".join(str(c) for c in counts) + "\n")
        if direct:
            f.write("Direct\n")
            coords = pos @ np.linalg.inv(structure.cell)
        else:
            f.write("Cartesian\n")
            coords = pos
        for c in coords:
            f.write(f" {c[0]:.10f} {c[1]:.10f} {c[2]:.10f}\n")


def _cif_number(tok):
    """CIF numeric token → float ('0.3450(2)' uncertainty syntax and
    bare numbers; '.'/'?' unknowns raise)."""
    tok = tok.split("(")[0]
    return float(tok)


def _cif_element(tok):
    """CIF species token → element symbol ('Li1+', 'O2-', 'Fe3+',
    'Li_a' → Li/O/Fe/Li)."""
    sym = ""
    for ch in tok:
        if ch.isalpha():
            sym += ch
            if len(sym) == 2:
                break
        else:
            break
    # try two-letter then one-letter ('Cl' vs 'C'); CIF capitalization
    # is Element-style already
    for cand in (sym, sym[:1]):
        try:
            symbol_to_number(cand)
            return cand
        except ValueError:
            continue
    raise ValueError(f"cannot read an element from CIF token {tok!r}")


def _parse_symop(op):
    """One CIF symmetry operation ('‑x+1/2, y, z' style) → affine
    ``(R (3, 3), t (3,))`` acting on fractional coordinates."""
    import re as _re
    R = np.zeros((3, 3))
    t = np.zeros(3)
    comps = op.replace(" ", "").lower().split(",")
    if len(comps) != 3:
        raise ValueError(f"bad CIF symop {op!r}")
    for r, comp in enumerate(comps):
        for term in _re.findall(r"[+-]?[^+-]+", comp):
            sign = -1.0 if term.startswith("-") else 1.0
            body = term.lstrip("+-")
            if body in ("x", "y", "z"):
                R[r, "xyz".index(body)] += sign
            elif "/" in body:
                num, den = body.split("/")
                t[r] += sign * float(num) / float(den)
            else:
                try:
                    t[r] += sign * float(body)
                except ValueError:
                    raise ValueError(
                        f"unsupported CIF symop term {term!r} in "
                        f"{op!r}") from None
    return R, t


def read_cif(path):
    """CIF → :class:`Structure`: cell parameters, the ``atom_site``
    loop (fractional or Cartesian coordinates), symbols from
    ``_atom_site_type_symbol`` (falling back to the label),
    ``0.345(2)`` uncertainty syntax stripped.

    Symmetry IS applied: when the file carries a
    ``_symmetry_equiv_pos_as_xyz`` / ``_space_group_symop`` loop, every
    operation is applied to the asymmetric unit and coincident images
    (special positions) deduplicated, yielding the full P1 cell.  A
    non-P1 space-group NAME without an operation loop raises — silently
    applying no symmetry would drop atoms.
    """
    import shlex

    params = {}
    loops = []
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.lower().startswith("loop_"):
            tags = []
            i += 1
            while i < len(lines) and lines[i].strip().startswith("_"):
                tags.append(lines[i].split()[0].strip().lower())
                i += 1
            rows = []
            while i < len(lines):
                row = lines[i].strip()
                if (not row or row.startswith("_")
                        or row.startswith("#")
                        or row.lower().startswith(("loop_", "data_"))):
                    break
                try:
                    rows.append(shlex.split(row))   # honors 'x, y, z'
                except ValueError:
                    rows.append(row.split())
                i += 1
            loops.append((tags, rows))
            continue
        if ln.startswith("_"):
            parts = ln.split(None, 1)
            if len(parts) == 2:
                params[parts[0].lower()] = parts[1].strip().strip("'\"")
        i += 1

    # collect symmetry operations (identity if none declared)
    symops = None
    for tags, rows in loops:
        op_tags = [t for t in tags
                   if t.endswith("_as_xyz") or t.endswith("_operation_xyz")]
        if op_tags:
            icol = tags.index(op_tags[0])
            # unquoted 'x, y, z' shatters into tokens; when the op is
            # the trailing column, rejoin the tail (legacy CIFs)
            symops = [_parse_symop(" ".join(r[icol:])
                                   if icol == len(tags) - 1
                                   else r[icol])
                      for r in rows if len(r) > icol]
    sg = (params.get("_symmetry_space_group_name_h-m")
          or params.get("_space_group_name_h-m_alt"))
    if symops is None:
        if sg is not None and sg.replace(" ", "") != "P1":
            raise ValueError(
                f"CIF space group {sg!r} has no symmetry-operation "
                "loop to expand with — add the symop loop or expand "
                "to P1 first (applying no symmetry would drop atoms)")
        symops = [(np.eye(3), np.zeros(3))]

    need = ["_cell_length_a", "_cell_length_b", "_cell_length_c",
            "_cell_angle_alpha", "_cell_angle_beta",
            "_cell_angle_gamma"]
    missing = [k for k in need if k not in params]
    if missing:
        raise ValueError(f"CIF missing cell parameters: {missing}")
    a, b, c = (_cif_number(params[k]) for k in need[:3])
    al, be, ga = (np.radians(_cif_number(params[k])) for k in need[3:])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c ** 2 - cx ** 2 - cy ** 2, 0.0))
    cell = np.array([[a, 0.0, 0.0],
                     [b * np.cos(ga), b * np.sin(ga), 0.0],
                     [cx, cy, cz]])

    for tags, rows in loops:
        if "_atom_site_fract_x" in tags or "_atom_site_cartn_x" in tags:
            frac_mode = "_atom_site_fract_x" in tags
            base = "_atom_site_fract_" if frac_mode else "_atom_site_cartn_"
            # CIF column order is arbitrary: index each coordinate tag
            # individually (assuming x/y/z contiguity silently misreads
            # files with e.g. _atom_site_occupancy between them)
            icoord = [tags.index(base + ax) for ax in "xyz"]
            sym_tag = ("_atom_site_type_symbol"
                       if "_atom_site_type_symbol" in tags
                       else "_atom_site_label")
            isym = tags.index(sym_tag)
            species, coords = [], []
            for r in rows:
                if len(r) < len(tags):
                    raise ValueError(
                        f"CIF atom_site row has {len(r)} fields for "
                        f"{len(tags)} columns — wrapped loop packets "
                        "are not supported; rejoin them onto one line "
                        f"(row: {' '.join(r)[:60]!r})")
                species.append(symbol_to_number(_cif_element(r[isym])))
                coords.append([_cif_number(r[k]) for k in icoord])
            species = np.asarray(species, dtype=np.int32)
            coords = np.asarray(coords, dtype=np.float64)
            frac = (coords if frac_mode
                    else coords @ np.linalg.inv(cell))
            # identity-only files (P1, the common machine-written case,
            # incl. write_cif's own output) have no special positions to
            # deduplicate — merging near-coincident DISTINCT atoms there
            # would silently change the atom count (split/disordered
            # positions are legitimate structures)
            if len(symops) == 1 and np.allclose(
                    symops[0][0], np.eye(3)) and np.allclose(
                    symops[0][1], 0.0):
                f0 = frac - np.floor(frac)
                return Structure(f0 @ cell, species, cell)
            # expand the asymmetric unit through every operation and
            # deduplicate coincident images (special positions).  The
            # tolerance must be a true metric ball: grid-bucket keys
            # miss near-duplicates straddling a bucket boundary (real
            # for 3-decimal CIFs with 1/3-family special positions,
            # where images differ by ~1e-3, not ~1e-15).  One
            # vectorized kept-array comparison per image is O(N²) in
            # elementwise numpy ops — fast even for 192-op CIFs.
            all_sp = np.tile(species, len(symops))
            imgs = []
            for R, t in symops:
                img = frac @ R.T + t
                imgs.append(img - np.floor(img))
            all_frac = np.concatenate(imgs)
            kept_frac = np.empty_like(all_frac)
            kept_sp = np.empty_like(all_sp)
            n_kept = 0
            for fr, z in zip(all_frac, all_sp):
                if n_kept:
                    d = kept_frac[:n_kept] - fr
                    d -= np.round(d)                  # wrap-aware
                    dup = np.any((np.abs(d).max(axis=1) < 1e-3)
                                 & (kept_sp[:n_kept] == z))
                    if dup:
                        continue
                kept_frac[n_kept] = fr
                kept_sp[n_kept] = z
                n_kept += 1
            pos = kept_frac[:n_kept] @ cell
            return Structure(pos, kept_sp[:n_kept], cell)
    raise ValueError("CIF has no atom_site loop with coordinates")


def write_cif(path, structure, data_name="sitator_tpu"):
    """Write a :class:`Structure` as a P1 CIF: cell parameters, an
    explicit identity symmetry operation, and a fractional
    ``atom_site`` loop (labels ``<symbol><ordinal>`` per species).

    CIF stores the cell as lengths+angles, so :func:`read_cif`
    round-trips the FRACTIONAL geometry and cell parameters to text
    precision in the canonical orientation — the original Cartesian
    orientation (and handedness, for negative-volume cells) is not
    representable in the format.  Atom count round-trips exactly:
    :func:`read_cif` only deduplicates coincident images when a file
    carries a non-trivial symmetry loop (special positions), never for
    the identity-only P1 files this writer emits.
    """
    from sitator_tpu_torch.core.structure import cell_to_parameters
    params = cell_to_parameters(structure.cell)
    abc, angles = params[:3], params[3:]
    frac = structure.frac_positions
    species = np.asarray(structure.species)
    counts = {}
    with open(path, "w") as f:
        f.write(f"data_{data_name}\n")
        for tag, val in zip(("a", "b", "c"), abc):
            f.write(f"_cell_length_{tag} {val:.10f}\n")
        for tag, val in zip(("alpha", "beta", "gamma"), angles):
            f.write(f"_cell_angle_{tag} {val:.10f}\n")
        f.write("_symmetry_space_group_name_H-M 'P 1'\n")
        f.write("loop_\n_symmetry_equiv_pos_as_xyz\n'x, y, z'\n")
        f.write("loop_\n_atom_site_label\n_atom_site_type_symbol\n"
                "_atom_site_fract_x\n_atom_site_fract_y\n"
                "_atom_site_fract_z\n")
        for z, fr in zip(species, frac):
            sym = number_to_symbol(int(z))
            counts[sym] = counts.get(sym, 0) + 1
            f.write(f"{sym}{counts[sym]} {sym} "
                    f"{fr[0]:.10f} {fr[1]:.10f} {fr[2]:.10f}\n")


def write_structure(path, structure):
    """Single-structure writer dispatch mirroring :func:`read_structure`:
    POSCAR/CONTCAR (by name or ``.vasp``/``.poscar``), ``.cif``, else
    extended XYZ — the same :func:`structure_format` authority."""
    fmt = structure_format(path)
    if fmt == "poscar":
        return write_poscar(path, structure)
    if fmt == "cif":
        return write_cif(path, structure)
    return write_xyz(path, structure)


def structure_format(path):
    """Filename classification for single-structure files:
    ``'poscar' | 'cif' | 'xyz'`` — the single dispatch authority shared
    by :func:`read_structure` and the CLI ``info`` command.  ``.cif``
    wins over a POSCAR-ish basename (``POSCAR.cif`` is a CIF)."""
    name = str(path).rsplit("/", 1)[-1].upper()
    if name.endswith(".CIF"):
        return "cif"
    if name.endswith(".XDATCAR") or name.startswith("XDATCAR"):
        return "xyz"        # explicitly a trajectory, never a POSCAR
    if (name.startswith(("POSCAR", "CONTCAR"))
            or name.endswith((".VASP", ".POSCAR"))):
        return "poscar"
    return "xyz"


def read_structure(path):
    """Single-structure reader dispatch: POSCAR/CONTCAR (by name or
    ``.vasp``/``.poscar``), ``.cif``, else extended XYZ."""
    fmt = structure_format(path)
    if fmt == "poscar":
        return read_poscar(path)
    if fmt == "cif":
        return read_cif(path)
    return read_xyz(path)


def write_xdatcar(path, structure, traj=None, comment="sitator_tpu"):
    """Write a ``Structure`` (plus optional trajectory ``(F, A, 3)``
    cartesian) as a fixed-cell VASP5 XDATCAR.

    The format requires atoms grouped into contiguous same-species blocks;
    structures with interleaved species raise (reorder first — a silent
    permutation here would desynchronize the written file from every
    index-based mask/attribute the caller holds).  Positions are written
    fractional without wrapping, so the round-trip through
    :func:`read_xdatcar` is exact up to the text precision.
    """
    species = structure.species
    # contiguous species runs -> (symbol, count) blocks
    change = np.flatnonzero(np.diff(species)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(species)]])
    blocks = [(number_to_symbol(species[s]), int(e - s))
              for s, e in zip(starts, ends)]
    if len({sym for sym, _ in blocks}) != len(blocks):
        raise ValueError(
            "XDATCAR needs contiguous same-species blocks; this structure "
            "interleaves species — reorder atoms (and masks) first")
    frames = (traj if traj is not None
              else structure.positions[None, :, :])
    inv = structure.cell_inv
    with open(path, "w") as f:
        f.write(f"{comment}\n  1.0\n")
        for row in structure.cell:
            f.write("  %.16f %.16f %.16f\n" % tuple(row))
        f.write("  " + " ".join(sym for sym, _ in blocks) + "\n")
        f.write("  " + " ".join(str(c) for _, c in blocks) + "\n")
        for t, pos in enumerate(frames):
            f.write(f"Direct configuration= {t + 1:5d}\n")
            for x in np.asarray(pos) @ inv:
                f.write("  %.16f %.16f %.16f\n" % tuple(x))


def write_lammps_dump(path, structure, traj=None, timestep_stride=1):
    """Write a ``Structure`` (plus optional trajectory ``(F, A, 3)``
    cartesian) as a LAMMPS text dump (``id type x y z`` columns, atom
    ``type`` = atomic number so species round-trip through
    :func:`read_lammps_dump`).

    The cell must be in the LAMMPS convention — diagonal, or lower
    triangular (rows ``[lx,0,0], [xy,ly,0], [xz,yz,lz]``); general rotated
    cells raise (rotating them into convention would silently rotate the
    coordinates too).
    """
    cell = structure.cell
    if not np.allclose([cell[0, 1], cell[0, 2], cell[1, 2]], 0.0,
                       atol=1e-10):
        raise ValueError(
            "LAMMPS dumps need a diagonal or lower-triangular cell "
            "(rows [lx,0,0],[xy,ly,0],[xz,yz,lz]); rotate the structure "
            "into that convention first")
    triclinic = not np.allclose([cell[1, 0], cell[2, 0], cell[2, 1]], 0.0,
                                atol=1e-10)
    lx, ly, lz = cell[0, 0], cell[1, 1], cell[2, 2]
    xy, xz, yz = cell[1, 0], cell[2, 0], cell[2, 1]
    frames = (traj if traj is not None
              else structure.positions[None, :, :])
    species = structure.species
    with open(path, "w") as f:
        for t, pos in enumerate(frames):
            f.write("ITEM: TIMESTEP\n%d\n" % (t * timestep_stride))
            f.write("ITEM: NUMBER OF ATOMS\n%d\n" % structure.n_atoms)
            if triclinic:
                # bounding-box form: readers undo these exact shifts
                f.write("ITEM: BOX BOUNDS xy xz yz pp pp pp\n")
                f.write("%.16f %.16f %.16f\n"
                        % (min(0.0, xy, xz, xy + xz),
                           lx + max(0.0, xy, xz, xy + xz), xy))
                f.write("%.16f %.16f %.16f\n"
                        % (min(0.0, yz), ly + max(0.0, yz), xz))
                f.write("%.16f %.16f %.16f\n" % (0.0, lz, yz))
            else:
                f.write("ITEM: BOX BOUNDS pp pp pp\n")
                for L in (lx, ly, lz):
                    f.write("0.0 %.16f\n" % L)
            f.write("ITEM: ATOMS id type x y z\n")
            for i in range(structure.n_atoms):
                f.write("%d %d %.16f %.16f %.16f\n"
                        % (i + 1, species[i], *np.asarray(pos)[i]))


def parse_xdatcar_header(f):
    """Parse an XDATCAR's fixed header from an open text file: handles
    both VASP5 (symbols + counts lines) and VASP4 (counts only) styles.
    Leaves the file positioned at the first ``Direct configuration`` line
    and returns ``(cell, species, counts, header_end_byte_offset)`` — the
    single header-format authority shared by the Python reader and the
    native decoder's precheck."""
    f.readline()                                    # comment
    return _parse_xdatcar_header_body(f)


def _parse_xdatcar_header_body(f):
    """Header parse with the comment line already consumed — also used for
    the repeated mid-file headers of variable-cell (NPT) XDATCARs."""
    scale = float(_header_fields(f, "scale", "XDATCAR")[0])
    cell = _header_cell_rows(f, "XDATCAR")
    if scale < 0:
        # VASP convention: a negative scale is the desired cell VOLUME
        scale = (-scale / abs(np.linalg.det(cell))) ** (1.0 / 3.0)
    cell = cell * scale
    species_line = _header_fields(f, "species/counts", "XDATCAR")
    v4 = all(t.lstrip("-").isdigit() for t in species_line)
    if v4:
        # old VASP4 style: no symbols line, species_line IS the counts
        counts = [int(x) for x in species_line]
        symbols = None
    else:
        symbols = species_line
        counts = [int(x) for x in
                  _header_fields(f, "counts", "XDATCAR")]
    header_end = f.tell()
    species = np.concatenate([
        np.full(c, i + 1 if v4 else symbol_to_number(symbols[i]),
                dtype=np.int32)
        for i, c in enumerate(counts)])
    return cell, species, counts, header_end


def iread_xdatcar(path, variable_cell="error"):
    """Stream a VASP XDATCAR (the reference's AIMD workhorse format, read
    via ASE there — SURVEY.md §3.9 item 5): yields ``(Structure, pos)``
    pairs where ``pos (A, 3)`` is the frame's cartesian positions and the
    Structure (cell/species) is shared.  O(1) memory — feed
    :func:`convert_to_npy` for million-frame files.

    Variable-cell (NPT) files repeat the whole header before each frame;
    ``variable_cell='rescale'`` maps every frame into the FIRST header's
    cell (XDATCAR stores fractional coordinates, so the map is exactly
    ``frac @ ref_cell`` — no inverse needed); the default 'error' raises.
    """
    _check_vc(variable_cell)
    with open(path) as f:
        cell, species, counts, _ = parse_xdatcar_header(f)
        ref_cell = cell
        n_atoms = sum(counts)
        structure = None

        line = f.readline()
        while line:
            ls = line.strip()
            if not ls:
                line = f.readline()
                continue
            if not ls.lower().startswith("direct"):
                # a repeated header: `line` is its comment line
                if variable_cell == "error":
                    raise _vc_error(
                        "XDATCAR (repeated header)",
                        f"; offending line: {ls[:40]!r}")
                cell, _, counts2, _ = _parse_xdatcar_header_body(f)
                if counts2 != counts:
                    raise ValueError(
                        "atom counts changed mid-XDATCAR "
                        f"({counts} -> {counts2}); cannot continue")
                line = f.readline()
                continue
            frac = np.empty((n_atoms, 3), dtype=np.float64)
            for i in range(n_atoms):
                row = f.readline().split()
                if len(row) < 3:
                    raise ValueError(
                        "XDATCAR frame truncated: coordinate row "
                        f"{i + 1}/{n_atoms} missing or short (cut-off "
                        "file?)")
                frac[i] = [float(x) for x in row[:3]]
            pos = frac @ (ref_cell if variable_cell == "rescale" else cell)
            if structure is None:
                structure = Structure(pos, species, ref_cell)
            yield structure, pos
            line = f.readline()


def read_xdatcar(path, variable_cell="error"):
    """Eager XDATCAR read: ``(Structure, traj (F, A, 3) cartesian)``.
    See :func:`iread_xdatcar` for the streaming variant."""
    structure = None
    frames = []
    for structure, pos in iread_xdatcar(path, variable_cell=variable_cell):
        frames.append(pos)
    if structure is None:
        raise ValueError(f"no frames found in {path}")
    return structure, np.stack(frames)


_LMP_COORD_SETS = (("x", "y", "z"), ("xu", "yu", "zu"), ("xs", "ys", "zs"),
                   ("xsu", "ysu", "zsu"))


def iread_lammps_dump(path, variable_cell="error"):
    """Stream a LAMMPS text dump (``dump atom``/``dump custom`` styles):
    yields ``(Structure, pos (A, 3))`` per frame with O(1) memory.

    Handles orthogonal and triclinic ``BOX BOUNDS`` (tilt factors),
    cartesian (``x y z``), unwrapped (``xu yu zu``) and scaled
    (``xs ys zs`` / ``xsu ysu zsu``) coordinate columns, and sorts by atom
    ``id`` when present.  Atom ``type`` becomes the species number.
    The cell is taken from the first frame; NPT runs with per-frame box
    bounds need ``variable_cell='rescale'`` (affine map into the first
    frame's box — see the module note), else they raise.
    """
    _check_vc(variable_cell)
    species = None
    cell = None
    ref_origin = None
    structure = None
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith("ITEM: TIMESTEP"):
                continue
            f.readline()                               # timestep value
            item = f.readline()
            if not item.startswith("ITEM: NUMBER OF ATOMS"):
                raise ValueError(
                    f"malformed LAMMPS dump header: expected "
                    f"'ITEM: NUMBER OF ATOMS', got {item!r}")
            n_atoms = int(f.readline())
            if n_atoms < 0:
                raise ValueError(f"negative atom count {n_atoms}")
            item = f.readline()
            if not item.startswith("ITEM: BOX BOUNDS"):
                raise ValueError(
                    f"malformed LAMMPS dump header: expected "
                    f"'ITEM: BOX BOUNDS', got {item!r}")
            triclinic = "xy" in item
            rows = [np.array([float(x) for x in f.readline().split()])
                    for _ in range(3)]
            if triclinic:
                (xlb, xhb, xy), (ylb, yhb, xz), (zlo, zhi, yz) = rows
                xlo = xlb - min(0.0, xy, xz, xy + xz)
                xhi = xhb - max(0.0, xy, xz, xy + xz)
                ylo = ylb - min(0.0, yz)
                yhi = yhb - max(0.0, yz)
                this_cell = np.array([[xhi - xlo, 0, 0],
                                      [xy, yhi - ylo, 0],
                                      [xz, yz, zhi - zlo]])
                origin = np.array([xlo, ylo, zlo])
            else:
                (xlo, xhi), (ylo, yhi), (zlo, zhi) = \
                    (r[:2] for r in rows)
                this_cell = np.diag([xhi - xlo, yhi - ylo, zhi - zlo])
                origin = np.array([xlo, ylo, zlo])
            if cell is None:
                cell = this_cell
                ref_origin = origin
            elif (variable_cell == "error"
                  and not np.allclose(cell, this_cell, atol=1e-8)):
                raise _vc_error("LAMMPS dump (per-frame box bounds)")
            item = f.readline()
            if not item.startswith("ITEM: ATOMS"):
                raise ValueError(
                    f"malformed LAMMPS dump header: expected "
                    f"'ITEM: ATOMS', got {item!r}")
            cols = item.split()[2:]
            cidx = None
            scaled = False
            for cset in _LMP_COORD_SETS:
                if all(c in cols for c in cset):
                    cidx = [cols.index(c) for c in cset]
                    scaled = cset[0].startswith("xs")
                    break
            if cidx is None:
                raise ValueError(f"no coordinate columns in {cols}")
            id_i = cols.index("id") if "id" in cols else None
            ty_i = cols.index("type") if "type" in cols else None
            # `dump custom ... element`: chemical symbols beat numeric
            # types for species identity
            el_i = cols.index("element") if "element" in cols else None
            pos = np.empty((n_atoms, 3), dtype=np.float64)
            ids = np.arange(n_atoms)
            typ = np.ones(n_atoms, dtype=np.int32)
            for i in range(n_atoms):
                parts = f.readline().split()
                pos[i] = [float(parts[c]) for c in cidx]
                if id_i is not None:
                    ids[i] = int(parts[id_i])
                if el_i is not None:
                    # dump_modify can set arbitrary labels — unknown ones
                    # fall back to the numeric type column
                    s = parts[el_i]
                    if s.isdigit():
                        typ[i] = int(s)
                    else:
                        try:
                            typ[i] = symbol_to_number(s.capitalize())
                        except ValueError:
                            typ[i] = (int(parts[ty_i])
                                      if ty_i is not None else 1)
                elif ty_i is not None:
                    typ[i] = int(parts[ty_i])
            order = np.argsort(ids, kind="stable")
            pos, typ = pos[order], typ[order]
            if variable_cell == "rescale":
                # fractional coords in THIS frame's box -> reference box
                frac = (pos if scaled
                        else (pos - origin) @ np.linalg.inv(this_cell))
                pos = frac @ cell + ref_origin
            elif scaled:
                pos = pos @ cell + origin
            if species is None:
                species = typ
            if structure is None:
                structure = Structure(pos, species, cell)
            yield structure, pos


def read_lammps_dump(path, variable_cell="error"):
    """Eager LAMMPS dump read: ``(Structure, traj (F, A, 3) cartesian)``.
    See :func:`iread_lammps_dump` for the streaming variant."""
    structure = None
    frames = []
    for structure, pos in iread_lammps_dump(
            path, variable_cell=variable_cell):
        frames.append(pos)
    if structure is None:
        raise ValueError(f"no frames found in {path}")
    return structure, np.stack(frames)


def sniff_format(path):
    """Classify a trajectory file: 'xdatcar' | 'lammps' | 'xyz' | 'npy' |
    'npz' | 'h5' | 'zarr' (a store directory) | None — the single
    dispatch table shared by
    :func:`open_trajectory` and :func:`convert_to_npy`.  Filename
    conventions first; unrecognized names fall back to content sniffing
    (so ``traj.txt``-style names still open)."""
    p = str(path)
    import os
    if os.path.isdir(p):
        from sitator_tpu_torch.io.tensorstore_io import is_zarr_store
        return "zarr" if is_zarr_store(p) else None
    name = p.rsplit("/", 1)[-1].upper()
    if name.startswith("XDATCAR") or p.endswith(".xdatcar"):
        return "xdatcar"
    if p.endswith((".lammpstrj", ".dump")):
        return "lammps"
    if p.endswith((".xyz", ".extxyz")):
        return "xyz"
    if p.endswith(".npy"):
        return "npy"
    if p.endswith(".npz"):
        return "npz"
    if p.endswith((".h5", ".hdf5")):
        return "h5"
    return _sniff_content(p)


def _sniff_content(path):
    """Content-based format detection for unconventionally-named files."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
        if head.startswith(b"\x93NUMPY"):
            return "npy"
        if head.startswith(b"PK\x03\x04"):
            return "npz"
        if head.startswith(b"\x89HDF"):
            return "h5"
        with open(path) as f:
            # capped reads: never materialize a huge single-line file
            lines = [f.readline(4096) for _ in range(8)]
    except (OSError, UnicodeDecodeError):
        return None
    # LAMMPS dumps may lead with ITEM: TIME / ITEM: UNITS before TIMESTEP
    if any(ln.startswith("ITEM: ") for ln in lines):
        return "lammps"

    def _is_xyz():
        # natoms int, then a comment, then atom lines of
        # <species> <x> <y> <z> [...] — check the shape of the first one
        try:
            int(lines[0].strip())
        except ValueError:
            return False
        try:
            sp_f, pos_f = _parse_properties(lines[1])
        except ValueError:
            return False
        parts = lines[2].split()
        if len(parts) < pos_f + 3:
            return False
        try:
            [float(x) for x in parts[pos_f:pos_f + 3]]
        except ValueError:
            return False
        return True

    if _is_xyz():
        return "xyz"
    try:                                   # xdatcar: comment, scale, 3x3
        float(lines[1].split()[0])
        for k in (2, 3, 4):
            row = [float(x) for x in lines[k].split()]
            if len(row) != 3:
                return None
        return "xdatcar"
    except (ValueError, IndexError):
        return None


def iter_text_frames(path, fmt, variable_cell="error"):
    """Stream ``(structure, frame)`` pairs from a text trajectory with O(1)
    memory — the single fmt→iterator dispatch shared by
    :func:`convert_to_npy` and
    :func:`sitator_tpu_torch.io.tensorstore_io.convert_to_zarr`."""
    it = {"xdatcar": iread_xdatcar, "lammps": iread_lammps_dump,
          "xyz": _iread_xyz_fixedcell}[fmt]
    yield from it(path, variable_cell=variable_cell)


def structure_sidecar_path(npy_path):
    """Path of the ``.structure.xyz`` sidecar next to a ``.npy``
    trajectory.  ``.npy`` files carry bare positions; the sidecar (one
    extxyz frame: species + cell) makes them self-describing, the same
    role ``structure.npz`` plays inside zarr stores."""
    return str(npy_path) + ".structure.xyz"


def convert_to_npy(src, out_path, dtype=np.float32, verbose=False,
                   variable_cell="error", structure_sidecar=True):
    """Convert any trajectory source to a memmapped ``.npy`` — the
    preferred format for the streaming engine (zero-copy random block
    reads).  ``src``: a path (extxyz / XDATCAR / LAMMPS dump, streamed
    with O(1) memory in two passes) or any ``TrajectoryReader``.
    ``variable_cell='rescale'`` bakes the NPT → fixed-cell affine bridge
    into the converted file, so the streaming engine never sees per-frame
    cells.  When the source structure is known and ``structure_sidecar``
    is true (default), a one-frame ``OUT.npy.structure.xyz`` sidecar is
    written so ``NpyTrajectory``/``open_trajectory`` can recover species
    and cell without a separate ``--structure`` file.
    Returns ``(Structure or None, out_path)``.
    """

    def _finish(structure, out_path):
        sidecar = structure_sidecar_path(out_path)
        if structure_sidecar and structure is not None:
            write_xyz(sidecar, structure)
        elif os.path.exists(sidecar):
            # overwriting the .npy without writing a sidecar: a stale
            # one from a previous conversion would silently describe
            # the wrong system
            os.remove(sidecar)
        return structure, out_path

    def frame_iter():
        p = str(src)
        fmt = sniff_format(p)
        if fmt not in ("xdatcar", "lammps", "xyz"):
            raise ValueError(
                f"convert_to_npy streams text formats only, got {p}; "
                "open binary formats with open_trajectory instead")
        yield from iter_text_frames(p, fmt, variable_cell)

    if isinstance(src, (str,)) or hasattr(src, "__fspath__"):
        p = str(src)
        fmt = sniff_format(p)
        if variable_cell == "error" and fmt in ("xyz", "lammps",
                                                "xdatcar"):
            # fast path: the native multithreaded decoder already indexes
            # the file — blockwise copy beats the two-pass Python parse by
            # an order of magnitude on multi-GB files, same O(block) memory
            reader = _try_native_reader(p, fmt)
            if reader is not None:
                structure = reader.structure
                out = np.lib.format.open_memmap(
                    out_path, mode="w+", dtype=dtype,
                    shape=(len(reader), reader.n_atoms, 3))
                B = 1024
                for lo in range(0, len(reader), B):
                    out[lo:lo + B] = reader[lo:min(lo + B, len(reader))]
                out.flush()
                if verbose:
                    print(f"wrote {len(reader)} frames x "
                          f"{reader.n_atoms} atoms to {out_path} "
                          "(native decoder)")
                return _finish(structure, out_path)
        # pass 1: count frames + shapes; pass 2: fill the memmap
        n_frames = 0
        structure = None
        for structure, _ in frame_iter():
            n_frames += 1
        if n_frames == 0:
            raise ValueError(f"no frames found in {src}")
        out = np.lib.format.open_memmap(
            out_path, mode="w+", dtype=dtype,
            shape=(n_frames, structure.n_atoms, 3))
        for i, (_, pos) in enumerate(frame_iter()):
            out[i] = pos
        out.flush()
        if verbose:
            print(f"wrote {n_frames} frames x {structure.n_atoms} atoms "
                  f"to {out_path}")
        return _finish(structure, out_path)
    # a TrajectoryReader: length known, stream blockwise
    reader = src
    n_frames = len(reader)
    n_atoms = reader.n_atoms
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=dtype,
                                    shape=(n_frames, n_atoms, 3))
    B = 1024
    for lo in range(0, n_frames, B):
        out[lo:lo + B] = reader[lo:min(lo + B, n_frames)]
    out.flush()
    return _finish(getattr(reader, "structure", None), out_path)


# ---------------------------------------------------------------- readers --
class TrajectoryReader:
    """Protocol: ``len(r)`` frames; ``r[lo:hi] -> (n, A, 3) float32``;
    optional ``r.structure``."""

    structure = None

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, key):
        raise NotImplementedError

    @property
    def n_atoms(self):
        return self[0:1].shape[1]


class ArrayTrajectory(TrajectoryReader):
    def __init__(self, array, structure=None):
        self._a = np.asarray(array)
        self.structure = structure

    def __len__(self):
        return self._a.shape[0]

    def __getitem__(self, key):
        return np.asarray(self._a[key], dtype=np.float32)


class NpyTrajectory(ArrayTrajectory):
    """Memory-mapped ``.npy`` of shape (F, A, 3) — zero-copy block reads,
    the preferred large-trajectory format.  If a ``PATH.structure.xyz``
    sidecar exists (written by :func:`convert_to_npy`), it is loaded
    automatically so ``.structure`` carries species and cell."""

    def __init__(self, path, structure=None):
        arr = np.load(path, mmap_mode="r")
        if structure is None:
            sidecar = structure_sidecar_path(path)
            if os.path.exists(sidecar):
                structure = read_xyz(sidecar)
                if arr.ndim >= 2 and structure.n_atoms != arr.shape[1]:
                    logger.warning(
                        "ignoring stale sidecar %s: %d atoms vs %d in "
                        "the trajectory (rewrite it or re-convert)",
                        sidecar, structure.n_atoms, arr.shape[1])
                    structure = None
        super().__init__(arr, structure)


class NpzTrajectory(ArrayTrajectory):
    def __init__(self, path, key="positions", structure=None):
        with np.load(path) as d:
            arr = d[key]
        super().__init__(arr, structure)


class H5Trajectory(TrajectoryReader):
    """An HDF5 dataset of frames, read as float32 with h5py's indexing.

    ``key`` is a path through groups and links, as H5MD's
    ``particles/all/position/value``; errors keep h5py's types.  The port's
    own reader (:mod:`sitator_tpu_torch.io.h5_store`) serves every layout
    h5py writes but the szip, n-bit and plugin filters; ``h5py`` is opened
    only where that reader raises ``UnsupportedLayout`` and h5py imports,
    and without h5py the ``UnsupportedLayout`` names what is missing.
    ``_h5py`` is the h5py file of that route, None where the port's reader
    serves."""

    def __init__(self, path, key="positions", structure=None):
        from sitator_tpu_torch.io.h5_store import H5Dataset, UnsupportedLayout
        self._h5py = self._ds = None
        try:
            self._ds = H5Dataset(path, key)
        except UnsupportedLayout as e:
            try:
                import h5py
            except ImportError:
                raise UnsupportedLayout(
                    f"{e}; h5py, which would read it, is not installed") \
                    from None
            self._h5py = h5py.File(path, "r")
            self._ds = self._h5py[key]
        self.structure = structure

    def __len__(self):
        return self._ds.shape[0]

    def __getitem__(self, key):
        if self._h5py is not None:
            return np.asarray(self._ds[key], dtype=np.float32)
        return self._ds.take(key, np.float32)

    def close(self):
        (self._h5py or self._ds).close()


class XYZTrajectory(ArrayTrajectory):
    def __init__(self, path, variable_cell="error"):
        structure, traj = read_xyz(path, index="all",
                                   variable_cell=variable_cell)
        super().__init__(traj, structure)


class XDATCARTrajectory(ArrayTrajectory):
    def __init__(self, path, variable_cell="error"):
        structure, traj = read_xdatcar(path, variable_cell=variable_cell)
        super().__init__(traj, structure)


class LammpsDumpTrajectory(ArrayTrajectory):
    def __init__(self, path, variable_cell="error"):
        structure, traj = read_lammps_dump(path,
                                           variable_cell=variable_cell)
        super().__init__(traj, structure)


def _try_native_reader(p, fmt, **kwargs):
    """Attempt the native multithreaded decoder for a text format; None
    when the library is unavailable or the file fails its prechecks
    (variable cell, non-standard layout, scaled coords, ...) — callers
    fall back to the Python parsers' clearer errors/handling."""
    try:
        from sitator_tpu_torch.io import native
        if native.get_lib() is None:
            return None
        cls = {"xyz": native.FastXYZTrajectory,
               "lammps": native.FastLammpsTrajectory,
               "xdatcar": native.FastXDATCARTrajectory}[fmt]
        return cls(p, **kwargs)
    except Exception:
        return None


def open_trajectory(path, **kwargs):
    """Open any supported trajectory behind the ``TrajectoryReader``
    protocol, preferring the native multithreaded decoders for text
    formats.  ``variable_cell='rescale'`` (text formats only) routes NPT
    files through the Python readers' affine cell bridge — the native
    decoders are fixed-cell by design.  NOTE: the rescale route is an
    EAGER whole-file load (random access over rescaled text needs the
    materialized array); for large NPT files use
    ``convert_to_npy(path, out, variable_cell='rescale')`` once — O(1)
    memory — and stream the resulting ``.npy``."""
    p = str(path)
    fmt = sniff_format(p)
    if fmt == "zarr":
        from sitator_tpu_torch.io.tensorstore_io import TensorstoreTrajectory
        kwargs.pop("variable_cell", None)  # fixed-cell store, as npy/h5
        return TensorstoreTrajectory(p, **kwargs)
    if fmt in ("npy", "npz", "h5"):
        # Binary formats carry no per-frame cells, so no rescale can be
        # applied here; accept-and-drop the kwarg so one call site can
        # open mixed sources with a uniform variable_cell= policy — but
        # say so, in case the file holds RAW NPT positions that were
        # never converted (convert_to_npy/_zarr bake the rescale in).
        vc = kwargs.pop("variable_cell", None)
        if vc not in (None, "error"):
            logger.warning(
                "variable_cell=%r ignored for binary trajectory %s: "
                "binary formats are fixed-cell (if this file holds raw "
                "NPT positions, convert it with convert_to_npy/"
                "convert_to_zarr variable_cell='rescale' first)", vc, p)
    if fmt == "npy":
        return NpyTrajectory(p, **kwargs)
    if fmt == "npz":
        return NpzTrajectory(p, **kwargs)
    if fmt == "h5":
        return H5Trajectory(p, **kwargs)
    if fmt in ("xdatcar", "lammps", "xyz"):
        vc = kwargs.pop("variable_cell", "error")
        if vc == "error":
            r = _try_native_reader(p, fmt, **kwargs)
            if r is not None:
                return r
        python_cls = {"xdatcar": XDATCARTrajectory,
                      "lammps": LammpsDumpTrajectory,
                      "xyz": XYZTrajectory}[fmt]
        return python_cls(p, variable_cell=vc)
    raise ValueError(f"unknown trajectory format: {p}")


# ----------------------------------------------------------------- feeder --
class ChunkedFeeder:
    """Background prefetcher: reads fixed-size frame blocks from a
    ``TrajectoryReader`` on worker thread(s) so host IO overlaps device
    compute (SURVEY.md §6.7 — the streaming half of the "context
    parallelism" analogue).  Iterate to get ``(lo, block)`` pairs in order.
    """

    def __init__(self, reader, block_frames, start=0, stop=None, depth=2):
        self.reader = reader
        self.block = int(block_frames)
        self.start = int(start)
        self.stop = len(reader) if stop is None else int(stop)
        self.depth = int(depth)

    def __iter__(self):
        q = _queue.Queue(maxsize=self.depth)
        stop_flag = threading.Event()

        def worker():
            try:
                for lo in range(self.start, self.stop, self.block):
                    if stop_flag.is_set():
                        return
                    hi = min(lo + self.block, self.stop)
                    q.put((lo, self.reader[lo:hi]))
                q.put(None)
            except BaseException as e:  # surface reader errors to consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop_flag.set()
