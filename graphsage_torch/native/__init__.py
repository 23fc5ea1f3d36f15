from graphsage_torch.native.engine import (
    bfs_closure_native,
    build_compact_batch_native,
    far_lists_native,
    sample_fanout_native,
    uniform_negatives_native,
)

__all__ = [
    "bfs_closure_native",
    "build_compact_batch_native",
    "far_lists_native",
    "sample_fanout_native",
    "uniform_negatives_native",
]
