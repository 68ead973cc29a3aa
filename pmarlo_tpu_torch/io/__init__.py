"""Host-side I/O: PDB structures, trajectory stores, shard datasets.

The framework's own trajectory format is npz (time-major coordinate
tensors + JSON metadata) rather than DCD — device-friendly, seekable, and
self-describing. PDB support covers the prep path (reference:
src/pmarlo/io/trajectory_reader.py, trajectory_writer.py).

Host copy of ``pmarlo_tpu/io/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from .pdb import PDBStructure, read_pdb, write_pdb
from .cif import read_cif, read_structure
from .trajectory import TrajectoryWriter, TrajectoryReader, iterload
from .shards import write_shard, read_shard, select_shard_paths, shard_id

__all__ = [
    "PDBStructure",
    "read_pdb",
    "read_cif",
    "read_structure",
    "write_pdb",
    "TrajectoryWriter",
    "TrajectoryReader",
    "iterload",
    "write_shard",
    "read_shard",
    "select_shard_paths",
    "shard_id",
]


def __getattr__(name):
    # format codecs resolve lazily so importing pmarlo_tpu.io never compiles
    if name in {"write_xtc", "read_xtc", "probe_xtc"}:
        from . import xtc

        return getattr(xtc, name)
    if name in {"write_trr", "read_trr", "probe_trr"}:
        from . import trr

        return getattr(trr, name)
    if name in {"write_dcd", "read_dcd", "read_dcd_box", "probe_dcd"}:
        from . import dcd

        return getattr(dcd, name)
    if name in {"write_netcdf", "read_netcdf", "probe_netcdf"}:
        from . import netcdf

        return getattr(netcdf, name)
    raise AttributeError(name)
