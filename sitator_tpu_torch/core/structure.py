"""Minimal periodic-structure container (copy of
``sitator_tpu.core.structure``, so the port imports nothing of the JAX
package).

The reference leans on ASE ``Atoms`` (SURVEY.md §3.9 item 5) for its host
structure; ASE is not a dependency here, so ``Structure`` is a
small internal equivalent: a triclinic cell (rows = lattice vectors), atomic
species, and cartesian positions.  It is a plain host-side object — device
code receives its arrays, never the object.
"""
from __future__ import annotations

import numpy as np

# Minimal symbol table (extendable); index = atomic number.
_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu",
]
_NUMBERS = {s: i for i, s in enumerate(_SYMBOLS)}


def symbol_to_number(sym: str) -> int:
    try:
        return _NUMBERS[sym]
    except KeyError:
        raise ValueError(f"unknown chemical symbol {sym!r}") from None


def number_to_symbol(z: int) -> str:
    return _SYMBOLS[int(z)]


def cell_to_parameters(cell):
    """Cell matrix → ``(a, b, c, alpha, beta, gamma)`` lengths (rows) and
    angles in degrees — the lengths+angles convention shared by CIF and
    CSSR writers.  Orientation and handedness are not representable in
    this form (reconstruction is canonical: a along x, b in the
    xy-plane)."""
    cell = np.asarray(cell, np.float64)
    lengths = np.linalg.norm(cell, axis=1)

    def _ang(u, v):
        return float(np.degrees(np.arccos(np.clip(
            np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)),
            -1.0, 1.0))))

    return (float(lengths[0]), float(lengths[1]), float(lengths[2]),
            _ang(cell[1], cell[2]), _ang(cell[0], cell[2]),
            _ang(cell[0], cell[1]))


class Structure:
    """Periodic atomic structure: cell, species, cartesian positions.

    Parameters
    ----------
    positions : (n_atoms, 3) cartesian coordinates.
    species : (n_atoms,) atomic numbers (ints) or chemical symbols (strs).
    cell : (3, 3) matrix, rows are lattice vectors (cartesian = frac @ cell).
    pbc : bool or (3,) bools; default fully periodic.
    """

    def __init__(self, positions, species, cell, pbc=True):
        self.positions = np.ascontiguousarray(positions, dtype=np.float64)
        if self.positions.ndim != 2 or self.positions.shape[1] != 3:
            raise ValueError("positions must be (n_atoms, 3)")
        species = np.asarray(species)
        if species.dtype.kind in "US":
            species = np.array([symbol_to_number(s) for s in species],
                               dtype=np.int32)
        self.species = np.ascontiguousarray(species, dtype=np.int32)
        if self.species.shape != (len(self.positions),):
            raise ValueError("species must be (n_atoms,)")
        self.cell = np.ascontiguousarray(cell, dtype=np.float64)
        if self.cell.shape != (3, 3):
            raise ValueError("cell must be (3, 3)")
        self.pbc = np.broadcast_to(np.asarray(pbc, dtype=bool), (3,)).copy()

    # -- basic protocol ----------------------------------------------------
    def __len__(self):
        return len(self.positions)

    @property
    def n_atoms(self) -> int:
        return len(self.positions)

    @property
    def symbols(self):
        return [number_to_symbol(z) for z in self.species]

    @property
    def cell_inv(self):
        return np.linalg.inv(self.cell)

    @property
    def frac_positions(self):
        return self.positions @ self.cell_inv

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))

    def wrapped(self) -> "Structure":
        """Copy with positions wrapped into the home cell."""
        f = self.frac_positions
        f -= np.floor(f)
        return Structure(f @ self.cell, self.species, self.cell, self.pbc)

    def copy(self) -> "Structure":
        return Structure(self.positions.copy(), self.species.copy(),
                         self.cell.copy(), self.pbc.copy())

    def repeat(self, reps) -> "Structure":
        """``(nx, ny, nz)`` (or a scalar) supercell: lattice vectors
        scale, atoms tile image-major (all atoms of image 0 — the
        original order — then image 1, ...).  Unit-cell structures from
        the reference package's ``read_cif`` / ``read_poscar`` are
        usually too small for the landmark cutoffs — tile them past
        ~2× the cutoff first (see the small-cell caveat in
        ``voronoi/generator.py``)."""
        raw = np.broadcast_to(np.asarray(reps), (3,))
        if not np.all(np.equal(np.mod(raw, 1), 0)):
            raise ValueError(
                f"repeat counts must be integers, got {raw}")
        reps = raw.astype(np.int64)
        if (reps < 1).any():
            raise ValueError(f"repeat counts must be >= 1, got {reps}")
        shifts = np.stack(np.meshgrid(*[np.arange(r) for r in reps],
                                      indexing="ij"),
                          axis=-1).reshape(-1, 3).astype(np.float64)
        offs = shifts @ self.cell                      # (P, 3)
        pos = (self.positions[None, :, :]
               + offs[:, None, :]).reshape(-1, 3)
        species = np.tile(self.species, len(offs))
        return Structure(pos, species, self.cell * reps[:, None],
                         self.pbc)

    def __mul__(self, reps) -> "Structure":
        return self.repeat(reps)

    def __getitem__(self, idx) -> "Structure":
        """Sub-structure by index array / boolean mask / slice."""
        return Structure(self.positions[idx], self.species[idx], self.cell,
                         self.pbc)

    def with_positions(self, positions) -> "Structure":
        return Structure(positions, self.species.copy(), self.cell.copy(),
                         self.pbc.copy())

    def __eq__(self, other):
        if not isinstance(other, Structure):
            return NotImplemented
        return (
            np.array_equal(self.species, other.species)
            and np.allclose(self.positions, other.positions)
            and np.allclose(self.cell, other.cell)
            and np.array_equal(self.pbc, other.pbc)
        )

    def __repr__(self):
        from collections import Counter
        c = Counter(self.symbols)
        formula = "".join(f"{s}{n if n > 1 else ''}" for s, n in sorted(c.items()))
        return f"Structure({formula}, n_atoms={self.n_atoms})"

    # -- serialization -----------------------------------------------------
    def to_dict(self, prefix=""):
        return {
            prefix + "positions": self.positions,
            prefix + "species": self.species,
            prefix + "cell": self.cell,
            prefix + "pbc": self.pbc,
        }

    @classmethod
    def from_dict(cls, d, prefix=""):
        return cls(d[prefix + "positions"], d[prefix + "species"],
                   d[prefix + "cell"], d[prefix + "pbc"])
