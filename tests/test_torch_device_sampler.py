"""The port's device sampler (graphsage_torch.sampler.device): uniform
without replacement, self-loops masked, take-all as a random permutation
(modelled on tests/test_sampler_distribution.py), and the dense frontier
layout against the JAX package's on the same draws.

Frequency bounds: 4 binomial sigmas (plus 1) per neighbour, as the JAX
package's tests use; the layout comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphsage_tpu.data import CSRGraph
from graphsage_tpu.sampler.device import _sample_one_hop as jax_one_hop
from graphsage_tpu.sampler.device import (
    sample_frontiers_dense as jax_frontiers_dense)
from graphsage_torch.sampler.device import (HopSampler, _sample_one_hop,
                                            sample_frontiers_dense)


def _star(center_deg=20):
    """node 0 joined to 1..center_deg."""
    src = np.zeros(center_deg, dtype=np.int64)
    dst = np.arange(1, center_deg + 1)
    return CSRGraph.from_edges(center_deg + 1, src, dst)


def _tables(pad):
    return torch.from_numpy(pad.neighbors), torch.from_numpy(pad.degrees)


def test_uniform_without_replacement():
    deg, fanout, trials = 20, 10, 400
    neighbors, degrees = _tables(_star(deg).to_padded())
    gen = torch.Generator().manual_seed(0)
    samples, valid = _sample_one_hop(gen, neighbors, degrees,
                                     torch.zeros(trials, dtype=torch.int32),
                                     fanout)
    assert samples.dtype == torch.int32 and samples.shape == (trials, fanout)
    assert valid.all()                    # degree >= fanout
    samples = samples.numpy()
    for row in samples:
        assert len(set(row.tolist())) == fanout
    counts = np.bincount(samples.reshape(-1), minlength=deg + 1)[1:]
    p = fanout / deg
    sigma = np.sqrt(trials * p * (1 - p))
    assert np.all(np.abs(counts - trials * p) < 4 * sigma + 1), counts


def test_take_all_is_a_random_permutation():
    """A row narrower than the fanout comes back whole, valid slots first,
    padded with invalid slots, in a fresh random order per draw."""
    neighbors = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    degrees = torch.tensor([6], dtype=torch.int32)
    hop = HopSampler(neighbors, degrees, torch.Generator().manual_seed(1))
    trials = 600
    counts = np.zeros((6, 6), np.int64)          # counts[slot, neighbour-1]
    orders = set()
    for _ in range(trials):
        s, v = hop(torch.zeros(1, dtype=torch.int32), 10)
        s = s[0].numpy()
        assert v[0, :6].all() and not v[0, 6:].any()
        assert sorted(s[:6].tolist()) == [1, 2, 3, 4, 5, 6]
        orders.add(tuple(s[:6].tolist()))
        counts[np.arange(6), s[:6] - 1] += 1
    assert len(orders) > 100
    sigma = np.sqrt(trials * (1 / 6) * (5 / 6))
    assert np.all(np.abs(counts - trials / 6) < 4 * sigma + 1), counts


def test_valid_counts_min_of_degree_and_fanout():
    """Mixed degrees in one table: valid = slot < min(degree, fanout), the
    valid samples are distinct neighbours of their row."""
    rng = np.random.RandomState(0)
    n, width = 30, 12
    neighbors = rng.randint(0, 1000, (n, width)).astype(np.int32)
    degrees = rng.randint(0, width + 1, n).astype(np.int32)
    gen = torch.Generator().manual_seed(2)
    nodes = torch.from_numpy(rng.randint(0, n, 50).astype(np.int32))
    s, v = _sample_one_hop(gen, torch.from_numpy(neighbors),
                           torch.from_numpy(degrees), nodes, 5)
    for node, row, ok in zip(nodes.numpy(), s.numpy(), v.numpy()):
        k = min(degrees[node], 5)
        assert ok.tolist() == [True] * k + [False] * (5 - k)
        picked = row[:k].tolist()
        real = neighbors[node, :degrees[node]].tolist()
        assert all(picked.count(x) <= real.count(x) for x in picked)


def test_same_seed_same_draws():
    neighbors, degrees = _tables(_star(20).to_padded())
    nodes = torch.zeros(8, dtype=torch.int32)
    a = _sample_one_hop(torch.Generator().manual_seed(5), neighbors, degrees,
                        nodes, 4)
    b = _sample_one_hop(torch.Generator().manual_seed(5), neighbors, degrees,
                        nodes, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _self_loop_graph():
    rng = np.random.RandomState(3)
    n = 25
    src = np.concatenate([np.arange(n), rng.randint(0, n, 60), [4, 9]])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.randint(0, n, 60),
                          [4, 9]])                       # two self loops
    return CSRGraph.from_edges(n, src, dst).to_padded()


def test_frontier_layout_matches_jax_on_the_same_draws():
    """sample_frontiers_dense with the JAX package's hops replayed gives the
    JAX package's x0 ids, index tables, masks and self rows, for gcn on and
    off, over a graph with self loops."""
    pad = _self_loop_graph()
    nb, dg = jnp.asarray(pad.neighbors), jnp.asarray(pad.degrees)
    batch = np.array([4, 9, 0, 17, 4], np.int32)
    key = jax.random.PRNGKey(11)
    for gcn in (False, True):
        want_ids, want = jax_frontiers_dense(key, nb, dg, jnp.asarray(batch),
                                             num_layers=2, fanout=3, gcn=gcn)
        keys = list(jax.random.split(key, 2))

        def hop(nodes, fanout):
            s, v = jax_one_hop(keys.pop(0), nb, dg,
                               jnp.asarray(nodes.numpy()), fanout)
            return torch.from_numpy(np.array(s)), torch.from_numpy(
                np.array(v))

        ids, got = sample_frontiers_dense(hop, torch.from_numpy(batch),
                                          num_layers=2, fanout=3, gcn=gcn)
        assert not keys
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        for f, w in zip(got, want):
            np.testing.assert_array_equal(f.idx.numpy(), np.asarray(w.idx))
            np.testing.assert_array_equal(f.mask.numpy(), np.asarray(w.mask))
            np.testing.assert_array_equal(f.self_idx.numpy(),
                                          np.asarray(w.self_idx))


def test_self_loops_are_masked():
    """A sampled id equal to its parent never aggregates: its slot's mask is
    0; slot 0 (self) is 1 under gcn and 0 otherwise."""
    pad = _self_loop_graph()
    hop = HopSampler(*_tables(pad), torch.Generator().manual_seed(4))
    batch = torch.tensor([4, 9] * 50, dtype=torch.int32)
    for gcn in (False, True):
        ids, (frontier,) = sample_frontiers_dense(hop, batch, num_layers=1,
                                                  fanout=4, gcn=gcn)
        children = ids.reshape(len(batch), 5)
        assert (children[:, 0] == batch).all()
        is_self = children[:, 1:] == batch[:, None]
        assert is_self.any()
        assert not frontier.mask[:, 1:][is_self].any()
        assert (frontier.mask[:, 0] == float(gcn)).all()
