"""The port's locality reorder (graphsage_torch.parallel.partition) against
the JAX package's (graphsage_tpu.parallel.partition), on the CPU: the same
permutations, relabelled graphs and datasets, and locality, bit for bit
(numpy on both sides)."""

import numpy as np
import pytest

from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.parallel import partition as jp
from graphsage_torch.data import CSRGraph, synthetic_power_law
from graphsage_torch.parallel import partition


@pytest.fixture(scope="module", params=[(300, 1500, 4), (257, 700, 7)],
                ids=["n300", "n257_seed7"])
def datasets(request):
    n, e, seed = request.param
    return (synthetic_power_law(n, e, num_feats=8, num_classes=3, seed=seed),
            jax_power_law(n, e, num_feats=8, num_classes=3, seed=seed))


def test_bfs_reorder_equals_jax(datasets):
    ds, jds = datasets
    perm = partition.bfs_reorder(ds.graph)
    np.testing.assert_array_equal(perm, jp.bfs_reorder(jds.graph))
    assert np.array_equal(np.sort(perm), np.arange(ds.num_nodes))


def test_relabel_graph_and_dataset_equal_jax(datasets):
    ds, jds = datasets
    perm = partition.bfs_reorder(ds.graph)
    g, jg = (partition.relabel_graph(ds.graph, perm),
             jp.relabel_graph(jds.graph, perm))
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    rds, jrds = (partition.relabel_dataset(ds, perm),
                 jp.relabel_dataset(jds, perm))
    for name in ("features", "labels", "train_nodes", "val_nodes",
                 "test_nodes"):
        got, want = getattr(rds, name), getattr(jrds, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(rds.graph.indices, jrds.graph.indices)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_partition_locality_equals_jax_and_reorder_improves_it(datasets,
                                                               parts):
    ds, jds = datasets
    before = partition.partition_locality(ds.graph, parts)
    assert before == jp.partition_locality(jds.graph, parts)
    rg = partition.relabel_graph(ds.graph, partition.bfs_reorder(ds.graph))
    after = partition.partition_locality(rg, parts)
    assert after == jp.partition_locality(
        jp.relabel_graph(jds.graph, jp.bfs_reorder(jds.graph)), parts)
    assert after > before, (before, after)


def test_bfs_reorder_visits_every_component():
    """Isolated nodes and separate components all get ids."""
    g = CSRGraph.from_edges(9, np.array([0, 1, 5]), np.array([1, 2, 6]))
    perm = partition.bfs_reorder(g)
    assert sorted(perm.tolist()) == list(range(9))
