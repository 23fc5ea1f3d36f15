"""The yardstick's arithmetic: peaks, and the operations and bytes a cell's
algorithm needs, from its shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 989
TFLOP/s dense bfloat16 on the tensor cores, 67 TFLOP/s float32 outside them
(the float32 configurations keep TF32 off), 3.35 TB/s of HBM.

The counts are the algorithm's, never the implementation's: a training node
costs its own K + 1 layer-1 rows whichever rows the program chooses to
transform, and an aggregation reads each distinct row it references once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def sampled_edges_per_node(fanout: int, num_layers: int) -> int:
    """Edges of one node's sampled computation tree: K at the top layer,
    K (K + 1) below it, and so on (``edges_per_batch(B, L, K) / B``)."""
    return sum(fanout * (fanout + 1) ** i for i in range(num_layers))


def train_flops_per_node(feat_dim: int, hidden: int, classes: int,
                         fanout: int) -> int:
    """Matmul FLOPs of one supervised training node in a two-layer model:
    layer 1 over the node's K + 1 rows, forward and dW (its inputs carry
    no gradient); layer 2 and the classifier forward, dW and dx."""
    layer1 = 2 * (fanout + 1) * (2 * feat_dim) * hidden * 2
    layer2 = 2 * (2 * hidden) * hidden * 3
    clf = 2 * hidden * classes * 3
    return layer1 + layer2 + clf


def embed_flops_per_pass(num_nodes: int, feat_dim: int, hidden: int,
                         num_layers: int) -> int:
    """Matmul FLOPs of a full-graph pass: every node through every layer's
    [self || aggregate] x W^T."""
    flops = 0
    for layer in range(num_layers):
        width = feat_dim if layer == 0 else hidden
        flops += num_nodes * 2 * (2 * width) * hidden
    return flops


def aggregate_bytes(distinct_rows: int, row_bytes: int, num_rows: int,
                    slots: int, out_row_bytes: int) -> int:
    """Least bytes of one aggregation over a [num_rows, slots] table: each
    distinct referenced row read once, the int32 index and each row's int32
    degree read once, the output written once."""
    return (distinct_rows * row_bytes + num_rows * slots * 4 + num_rows * 4
            + num_rows * out_row_bytes)


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
