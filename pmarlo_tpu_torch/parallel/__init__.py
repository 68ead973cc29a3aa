"""Multi-rank parallelism: replica sharding and collective reductions.

Port of ``pmarlo_tpu/parallel``. The caller starts the ranks (``torchrun``,
or ``torch.multiprocessing`` with a ``FileStore``) and the process group;
a mesh is a 1-D ``DeviceMesh`` over that group (``mesh.py``). Each rank
computes its block and ``all_reduce`` joins the blocks:

- ``replica_mesh`` builds the mesh ``ReplicaExchange(mesh=)`` shards its
  rungs over (and ``build_cell_force_fn(mesh=)`` its cell x-slabs over);
- ``make_data_parallel_step`` / ``train_deeptica_data_parallel`` run the
  DeepTICA VAMP-2 step over the batch axis with the serial gradient;
- ``sharded_*`` reductions: transition counts, TICA covariance moments and
  histograms, one ``all_reduce`` each.
"""

from .mesh import data_mesh, replica_mesh, shard_replicas
from .reductions import (
    sharded_covariance_moments,
    sharded_histogram,
    sharded_transition_counts,
)
from .train import make_data_parallel_step, train_deeptica_data_parallel

__all__ = [
    "replica_mesh",
    "shard_replicas",
    "data_mesh",
    "sharded_transition_counts",
    "sharded_covariance_moments",
    "sharded_histogram",
    "make_data_parallel_step",
    "train_deeptica_data_parallel",
]
