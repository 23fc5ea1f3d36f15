"""The benchmark's inputs, made from the seed on the run's device.

Everything a cell feeds the program comes from here: the graph, the node
features and labels, the train / val / test split, the initial parameters
and, for the serving cells, the fixed-width neighbour table.  Each is drawn
from a ``torch.Generator`` of its own, seeded from ``--seed`` through
``numpy.random.SeedSequence``, so one seed gives the same inputs on every
run, and any whole number is a valid seed.  The graph's shape is the
configuration's (its ``topology_seed``, like a deployment's data set): the
run's seed numbers its nodes anew, so every seed gives the same degrees,
and so the same work, in another order.

The configuration's ``graph.generator`` names the module
``benchmark/graphs/<generator>.py`` whose ``topology(gcfg, device)`` makes
that fixed graph; an unknown name raises.  The split is ``split_nodes``': a
permutation, test the first N // 3, val the next N // 6, train the rest.
It is a copy, not an import: the program may change, the yardstick may not.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

# the named streams a seed is split into (one generator each)
_STREAMS = ("graph", "features", "split", "params", "table", "program")


def sub_seeds(seed: int) -> dict[str, int]:
    """A 31-bit seed for each named stream, from any whole number."""
    words = np.random.SeedSequence(seed & (2**64 - 1)).generate_state(
        len(_STREAMS))
    return {name: int(w) & 0x7FFFFFFF for name, w in zip(_STREAMS, words)}


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@dataclasses.dataclass
class Graph:
    """CSR adjacency on the device: ``indptr`` [N + 1] and ``indices`` [E]
    int64, each row's neighbours sorted ascending, no self-loops."""
    num_nodes: int
    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def rows(self) -> torch.Tensor:
        """The source node of every edge slot [E]."""
        return torch.repeat_interleave(
            torch.arange(self.num_nodes, device=self.indptr.device),
            self.degrees)

    def edge_keys(self) -> torch.Tensor:
        """source * N + destination of every slot, sorted ascending."""
        return self.rows() * self.num_nodes + self.indices


def csr(num_nodes: int, key: torch.Tensor) -> Graph:
    """The graph of sorted, distinct edge keys source * N + destination."""
    s, d = key // num_nodes, key % num_nodes
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=num_nodes), 0)
    return Graph(num_nodes, indptr, d)


def relabel(graph: Graph, gen: torch.Generator) -> Graph:
    """The same graph with its nodes numbered by a random permutation."""
    n = graph.num_nodes
    perm = torch.randperm(n, generator=gen, device=graph.indptr.device)
    key = perm[graph.rows()] * n + perm[graph.indices]
    return csr(n, torch.sort(key).values)


@dataclasses.dataclass
class Data:
    graph: Graph
    features: torch.Tensor   # [N, D] float32 holding values of feature_dtype
    labels: torch.Tensor     # [N] int64
    train: torch.Tensor      # int64 node ids
    val: torch.Tensor
    test: torch.Tensor


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def features(gcfg: dict, n: int, feature_dtype: str, seed: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(features [N, D] float32, labels [N]): a class basis row plus
    Gaussian noise, rounded to ``feature_dtype`` (the type the program
    keeps its table in), held as float32."""
    gen = generator(seed, device)
    c, d = gcfg["num_classes"], gcfg["num_feats"]
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    basis = torch.randn((c, d), generator=gen, device=device)
    x = torch.randn((n, d), generator=gen, device=device)
    x.mul_(gcfg["feature_noise"]).add_(basis[labels])
    return x.to(dtype(feature_dtype)).float(), labels


def topology(gcfg: dict, device: torch.device) -> Graph:
    """The configuration's graph before the seed renumbers it, from the
    module its ``generator`` names."""
    name = gcfg["generator"]
    module = f"benchmark.graphs.{name}"
    try:
        make = importlib.import_module(module).topology
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no graph generator {name!r} "
                         f"(benchmark/graphs/{name}.py)") from None
    graph = make(gcfg, device)
    if graph.num_nodes != gcfg["num_nodes"]:
        raise ValueError(f"generator {name!r} made {graph.num_nodes} nodes, "
                         f"the configuration states {gcfg['num_nodes']}")
    return graph


def make_data(cfg: dict, seed: int, device: torch.device) -> Data:
    gcfg = cfg["graph"]
    seeds = sub_seeds(seed)
    n = gcfg["num_nodes"]
    graph = relabel(topology(gcfg, device), generator(seeds["graph"], device))
    feats, labels = features(gcfg, n, cfg["model"]["feature_dtype"],
                             seeds["features"], device)
    perm = torch.randperm(n, generator=generator(seeds["split"], device),
                          device=device)
    n_test, n_val = n // 3, n // 6
    return Data(graph, feats, labels, train=perm[n_test + n_val:],
                val=perm[n_test:n_test + n_val], test=perm[:n_test])


def init_params(cfg: dict, seed: int, device: torch.device) -> dict:
    """Initial float32 parameters in the program's layout, one call a leaf:
    xavier-uniform layer weights [H, 2 * in] (no bias), a classifier
    weight [C, H] (xavier) and bias U(+-1 / sqrt(H))."""
    m, g = cfg["model"], cfg["graph"]
    gen = generator(seed, device)

    def uniform(shape, a):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * a

    def xavier(shape):
        return uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])))

    h = m["hidden"]
    layers = [{"weight": xavier((h, 2 * (g["num_feats"] if i == 0 else h)))}
              for i in range(m["num_layers"])]
    return {"sage": {"layers": layers},
            "clf": {"weight": xavier((g["num_classes"], h)),
                    "bias": uniform((g["num_classes"],),
                                    1.0 / math.sqrt(h))}}


def neighbour_table(graph: Graph, width: int,
                    seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(neighbors [N, width] int32, degrees [N] int32): a uniform
    ``width``-subset of each row (the whole row below it), zero-padded."""
    dev = graph.indptr.device
    gen = generator(seed, dev)
    rows = graph.rows()
    e = rows.shape[0]
    order = torch.argsort(torch.rand(e, generator=gen, device=dev))
    order = order[torch.argsort(rows[order], stable=True)]
    pos = torch.arange(e, device=dev) - graph.indptr[rows]
    keep = pos < width
    table = torch.zeros((graph.num_nodes, width), dtype=torch.int32,
                        device=dev)
    table[rows[keep], pos[keep]] = graph.indices[order][keep].to(
        torch.int32)
    return table, graph.degrees.clamp(max=width).to(torch.int32)
