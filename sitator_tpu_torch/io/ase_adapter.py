"""Optional ASE interoperability (counterpart of
``sitator_tpu.io.ase_adapter``).

The package owns its own :class:`~sitator_tpu_torch.core.structure.Structure`
because ASE is not a dependency.  When ASE *is* installed, these converters
bridge the two worlds so existing ASE workflows (trajectory objects,
``ase.io.read``) drop straight in.  Importing this module never requires
ase; each function raises a clear ImportError at call time instead.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.core.structure import Structure

__all__ = ["from_ase", "to_ase", "trajectory_from_ase"]


def _require_ase():
    try:
        import ase  # noqa: F401
        return ase
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "ASE is not installed; sitator_tpu_torch does not require it "
            "— use sitator_tpu_torch.core.Structure and the "
            "sitator_tpu_torch.io readers, or install ase for this "
            "adapter") from e


def from_ase(atoms) -> Structure:
    """ASE ``Atoms`` → :class:`Structure` (positions, numbers, cell)."""
    _require_ase()
    cell = np.asarray(atoms.get_cell())
    if not cell.any():
        # non-periodic Atoms: bounding box with margin, like iread_xyz
        pos = atoms.get_positions()
        cell = np.diag(pos.max(0) - pos.min(0) + 10.0)
    return Structure(atoms.get_positions(), atoms.get_atomic_numbers(),
                     cell)


def to_ase(structure: Structure):
    """:class:`Structure` → ASE ``Atoms`` (periodic)."""
    ase = _require_ase()
    from ase import Atoms
    return Atoms(numbers=np.asarray(structure.species),
                 positions=np.asarray(structure.positions),
                 cell=np.asarray(structure.cell), pbc=True)


def trajectory_from_ase(images):
    """A sequence of ASE ``Atoms`` (e.g. ``ase.io.read(..., index=':')`` or
    an ASE trajectory object) → ``(Structure, traj (F, A, 3))`` ready for
    any sitator_tpu_torch engine."""
    _require_ase()
    images = list(images)
    if not images:
        raise ValueError("empty ASE trajectory")
    structure = from_ase(images[0])
    traj = np.stack([im.get_positions() for im in images])
    return structure, traj
