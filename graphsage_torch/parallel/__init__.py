"""Distribution on ``torch.distributed``: the process group
(``multihost``), the collectives (``comm``), the ``data`` x ``model`` mesh
and the tensor-parallel placement (``mesh``), the halo exchange (``halo``)
and the locality reorder (``partition``).  Port of
``graphsage_tpu/parallel/``."""

from graphsage_torch.parallel.halo import (halo_gather_local,
                                           make_halo_gather, plan_halo,
                                           shard_features)
from graphsage_torch.parallel.mesh import (Mesh, batch_rows, gather_params,
                                           make_mesh, shard_params)
from graphsage_torch.parallel.multihost import initialize, local_batch_rows
from graphsage_torch.parallel.partition import bfs_reorder, relabel_dataset

__all__ = [
    "Mesh",
    "batch_rows",
    "bfs_reorder",
    "gather_params",
    "halo_gather_local",
    "initialize",
    "local_batch_rows",
    "make_halo_gather",
    "make_mesh",
    "plan_halo",
    "relabel_dataset",
    "shard_features",
    "shard_params",
]
