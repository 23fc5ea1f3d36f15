from graphsage_torch.ops.aggregate import (
    LAUNCHES,
    max_aggregate,
    max_aggregate_plain,
    mean_aggregate,
    mean_aggregate_plain,
    reset_launches,
    sum_aggregate_plain,
)
from graphsage_torch.ops.gather import gather_rows, gather_rows_plain

__all__ = [
    "LAUNCHES",
    "gather_rows",
    "gather_rows_plain",
    "max_aggregate",
    "max_aggregate_plain",
    "mean_aggregate",
    "mean_aggregate_plain",
    "reset_launches",
    "sum_aggregate_plain",
]
