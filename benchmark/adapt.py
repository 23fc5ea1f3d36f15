"""The program's types, built from the benchmark's inputs: the only place
besides the traffic kinds that imports the port."""

from __future__ import annotations

import numpy as np

from benchmark.graphgen import Data
from graphsage_torch.data.graph import CSRGraph
from graphsage_torch.data.loaders import Dataset
from graphsage_torch.models.graphsage import GraphSageConfig


def model_config(cfg: dict) -> GraphSageConfig:
    m, g = cfg["model"], cfg["graph"]
    return GraphSageConfig(num_layers=m["num_layers"],
                           input_size=g["num_feats"], out_size=m["hidden"],
                           gcn=False, agg_func=m["agg_func"],
                           compute_dtype=m["compute_dtype"])


def dataset(data: Data, cfg: dict) -> Dataset:
    """The trainers' host ``Dataset``: numpy copies of the graph, the
    features, the labels and the split."""
    g = data.graph

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    csr = CSRGraph(g.num_nodes, host(g.indptr, np.int32),
                   host(g.indices, np.int32))
    return Dataset(cfg["name"], csr, data.features.cpu().numpy(),
                   host(data.labels, np.int32), cfg["graph"]["num_classes"],
                   host(data.train, np.int32), host(data.val, np.int32),
                   host(data.test, np.int32), synthetic_features=True)
