"""The yardstick's arithmetic against the numbers worked out by hand, and
the generator's invariants."""

import pytest
import torch

from benchmark import counts, graphgen
from benchmark.reference import precision, sage


def test_sampled_edges_per_node():
    assert counts.sampled_edges_per_node(10, 2) == 120


def test_train_flops_config5():
    per_node = counts.train_flops_per_node(602, 128, 16, 10)
    assert per_node == 6_989_824
    # an epoch of config 5's 500,001 train nodes
    assert abs(per_node * 500_001 - 3.49e12) < 0.01e12


def test_embed_flops():
    assert counts.embed_flops_per_pass(1_000_000, 602, 128, 2) == \
        373_760_000_000
    assert counts.embed_flops_per_pass(19_717, 500, 128, 2) == \
        6_339_725_312


def test_aggregate_bytes_and_bound():
    # [1M, 16] slots over 1M distinct 256-byte rows, bfloat16 out: rows,
    # int32 index, int32 degrees, output
    nbytes = counts.aggregate_bytes(1_000_000, 256, 1_000_000, 16, 256)
    assert nbytes == 580_000_000
    assert abs(counts.bound_s(nbytes) * 1e3 - 0.173134) < 1e-6


def test_peaks():
    assert counts.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12


def _cfg(n=500, e=2000):
    return {"graph": {"generator": "power_law",
                      "num_nodes": n, "num_edges": e, "alpha": 0.8,
                      "topology_seed": 19,
                      "num_feats": 8, "num_classes": 3,
                      "feature_noise": 0.5},
            "model": {"feature_dtype": "bfloat16", "num_layers": 2,
                      "hidden": 16}}


def test_generator_is_seeded_and_sound():
    cpu = torch.device("cpu")
    a = graphgen.make_data(_cfg(), 2**31 + 5, cpu)
    b = graphgen.make_data(_cfg(), 2**31 + 5, cpu)
    c = graphgen.make_data(_cfg(), 7, cpu)
    assert torch.equal(a.graph.indices, b.graph.indices)
    assert torch.equal(a.features, b.features)
    assert not torch.equal(a.graph.indptr, c.graph.indptr)
    # one shape in another numbering: the same degrees
    assert torch.equal(a.graph.degrees.sort().values,
                       c.graph.degrees.sort().values)
    g = a.graph
    keys = g.edge_keys()
    assert torch.equal(keys, torch.unique(keys))           # sorted, no dups
    rows = g.rows()
    assert not (rows == g.indices).any()                   # no self-loops
    back = g.indices * g.num_nodes + rows
    assert torch.equal(torch.sort(back).values, keys)      # undirected
    n = g.num_nodes
    assert (a.test.numel(), a.val.numel()) == (n // 3, n // 6)
    assert torch.equal(torch.sort(torch.cat([a.train, a.val, a.test]))
                       .values, torch.arange(n))
    # features hold bfloat16 values
    assert torch.equal(a.features, a.features.bfloat16().float())


def test_graph_generator_found_by_name():
    cfg = _cfg()
    cfg["graph"]["generator"] = "no_such_graph"
    with pytest.raises(ValueError, match="no_such_graph"):
        graphgen.make_data(cfg, 1, torch.device("cpu"))


def test_neighbour_table_is_a_subset():
    g = graphgen.make_data(_cfg(), 3, torch.device("cpu")).graph
    table, deg = graphgen.neighbour_table(g, 4, 11)
    assert torch.equal(deg.long(), g.degrees.clamp(max=4))
    keys = g.edge_keys()
    for v in range(g.num_nodes):
        picked = table[v, :deg[v]].long()
        assert picked.unique().numel() == picked.numel()
        assert torch.isin(v * g.num_nodes + picked, keys).all()


def test_reference_aggregates():
    x = torch.tensor([[1.0, -2.0], [3.0, 4.0], [5.0, 0.0]])
    idx = torch.tensor([[1, 2], [0, 0]])
    valid = torch.tensor([[True, True], [False, False]])
    assert torch.equal(sage.aggregate(x, idx, valid, "MEAN"),
                       torch.tensor([[4.0, 2.0], [0.0, 0.0]]))
    assert torch.equal(sage.aggregate(x, idx, valid, "MAX"),
                       torch.tensor([[5.0, 4.0], [0.0, 0.0]]))


def test_precisions_round():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert torch.equal(precision.round_tf32(x),
                       torch.tensor([1.0, 1.0 + 2**-9, -1.0]))
    y = torch.linspace(-3, 3, 101)
    q = precision.round_fp8(y)
    assert (q - y).abs().max() <= 3 / 448 * 32    # e4m3: 3 mantissa bits
    assert q.unique().numel() < y.numel()
