"""Distribution on ``torch.distributed``: the process group
(``multihost``), the collectives (``comm``), the halo exchange (``halo``)
and the locality reorder (``partition``).  Port of
``graphsage_tpu/parallel/`` without ``mesh.py``'s tensor-parallel
``model`` axis."""

from graphsage_torch.parallel.halo import (halo_gather_local,
                                           make_halo_gather, plan_halo,
                                           shard_features)
from graphsage_torch.parallel.multihost import initialize, local_batch_rows
from graphsage_torch.parallel.partition import bfs_reorder, relabel_dataset

__all__ = [
    "bfs_reorder",
    "halo_gather_local",
    "initialize",
    "local_batch_rows",
    "make_halo_gather",
    "plan_halo",
    "relabel_dataset",
    "shard_features",
]
