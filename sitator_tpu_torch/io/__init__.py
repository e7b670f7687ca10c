"""Trajectory and structure IO (counterpart of ``sitator_tpu.io``): the
text and binary formats with their readers and writers, the native
multithreaded text decoders (:mod:`sitator_tpu_torch.io.native`), zarr
v2/v3/n5 stores read and written by the port itself
(:mod:`sitator_tpu_torch.io.zarr_store`: every layout ``tensorstore``
writes on a local directory; ``tensorstore`` only for a store on another
kvstore than ``file``, or where a codec's library does not load), the
background block prefetcher, and
the synthetic-MD generators with known ground truth.

NumPy copies of the reference's modules, so the port imports nothing of
the JAX package.  ``__all__`` is the reference's, in its order, then the
port's own ``TrajectoryReader``.  The streaming engine takes any object
with ``len()`` and ``reader[lo:hi] -> (n, A, 3)``, either package's readers
included."""
from sitator_tpu_torch.io.synthetic import (SyntheticMD,
                                            make_fcc_hopping_trajectory,
                                            make_hopping_trajectory,
                                            make_langevin_trajectory)
from sitator_tpu_torch.io.formats import (
    ArrayTrajectory,
    ChunkedFeeder,
    H5Trajectory,
    NpyTrajectory,
    NpzTrajectory,
    TrajectoryReader,
    XDATCARTrajectory,
    LammpsDumpTrajectory,
    XYZTrajectory,
    convert_to_npy,
    iread_lammps_dump,
    iread_xdatcar,
    iread_xyz,
    read_lammps_dump,
    read_xdatcar,
    open_trajectory,
    read_xyz,
    read_poscar,
    read_cif,
    read_structure,
    write_poscar,
    write_cif,
    write_structure,
    write_xyz,
    write_xdatcar,
    write_lammps_dump,
)
from sitator_tpu_torch.io.tensorstore_io import (
    TensorstoreTrajectory,
    convert_to_zarr,
)

__all__ = [
    "SyntheticMD", "make_hopping_trajectory", "make_fcc_hopping_trajectory",
    "make_langevin_trajectory",
    "read_xyz", "write_xyz", "iread_xyz", "open_trajectory",
    "read_poscar", "read_cif", "read_structure", "write_poscar",
    "write_cif", "write_structure",
    "ArrayTrajectory", "NpyTrajectory", "NpzTrajectory", "H5Trajectory",
    "XYZTrajectory", "XDATCARTrajectory", "LammpsDumpTrajectory",
    "read_xdatcar", "read_lammps_dump", "iread_xdatcar",
    "write_xdatcar", "write_lammps_dump",
    "iread_lammps_dump", "convert_to_npy", "ChunkedFeeder",
    "TensorstoreTrajectory", "convert_to_zarr",
    "TrajectoryReader",
]
