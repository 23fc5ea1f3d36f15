from graphsage_torch.data.graph import CSRGraph, PaddedAdjacency
from graphsage_torch.data.loaders import (
    Dataset,
    load_cora,
    load_pubmed,
    load_dataset,
    synthetic_power_law,
    split_nodes,
)

__all__ = [
    "CSRGraph",
    "PaddedAdjacency",
    "Dataset",
    "load_cora",
    "load_pubmed",
    "load_dataset",
    "synthetic_power_law",
    "split_nodes",
]
