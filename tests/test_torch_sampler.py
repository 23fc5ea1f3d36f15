"""The port's host samplers (graphsage_torch.sampler, .native, .utils)
against the JAX package's, on the CPU: for one RandomState seed both give
bit-identical frontiers, pair batches, native-engine outputs and prefetched
epochs.  The port builds the native engine (csrc/gs_native.cpp) under
build/graphsage_torch/ and never writes inside graphsage_tpu/."""

import os

import numpy as np
import pytest

from graphsage_tpu import native as jax_native
from graphsage_tpu.data import synthetic_power_law as jax_power_law
from graphsage_tpu.sampler import PairSampler as JaxPairSampler
from graphsage_tpu.sampler import build_compact_batch as jax_build
from graphsage_tpu.utils.prefetch import prefetch as jax_prefetch
from graphsage_torch import native
from graphsage_torch.data import synthetic_power_law
from graphsage_torch.native import build as native_build
from graphsage_torch.sampler import PairSampler, build_compact_batch
from graphsage_torch.utils import prefetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graphs():
    """The same power-law dataset from both packages' loaders."""
    return (synthetic_power_law(600, 3000, num_feats=8, seed=2),
            jax_power_law(600, 3000, num_feats=8, seed=2))


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.x0_ids, b.x0_ids)
    assert (a.batch_size, a.out_rows) == (b.batch_size, b.out_rows)
    assert len(a.frontiers) == len(b.frontiers)
    for fa, fb in zip(a.frontiers, b.frontiers):
        for name in ("idx", "mask", "self_idx"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("native_mode", ["auto", "never"])
@pytest.mark.parametrize("gcn", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_compact_batch_is_bit_identical(graphs, seed, gcn, native_mode):
    ds, jds = graphs
    batch = np.random.RandomState(seed + 1).choice(600, 20, replace=False)
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):           # the second batch follows the RNG stream
        got = build_compact_batch(ds.graph, batch, rng, num_layers=2,
                                  fanout=5, gcn=gcn, native=native_mode)
        want = jax_build(jds.graph, batch, jrng, num_layers=2, fanout=5,
                         gcn=gcn, native=native_mode)
        _assert_batches_equal(got, want)
    assert rng.randint(2**31) == jrng.randint(2**31)


@pytest.mark.parametrize("native_mode", ["auto", "never"])
@pytest.mark.parametrize("gcn", [False, True])
def test_slot_shuffle_is_bit_identical(graphs, gcn, native_mode):
    """shuffle_slots (the LSTM aggregator's slot order) draws after the
    sampling from the same RandomState, so the shuffled frontiers equal the
    JAX package's bit for bit; each row holds the unshuffled row's slots in
    another order."""
    ds, jds = graphs
    batch = np.random.RandomState(4).choice(600, 20, replace=False)
    rng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        state = rng.get_state()
        got = build_compact_batch(ds.graph, batch, rng, num_layers=2,
                                  fanout=5, gcn=gcn, shuffle_slots=True,
                                  native=native_mode)
        want = jax_build(jds.graph, batch, jrng, num_layers=2, fanout=5,
                         gcn=gcn, shuffle_slots=True, native=native_mode)
        _assert_batches_equal(got, want)
        plain = build_compact_batch(ds.graph, batch, _rng_at(state),
                                    num_layers=2, fanout=5, gcn=gcn,
                                    native=native_mode)
        moved = False
        for fs, fp in zip(got.frontiers, plain.frontiers):
            np.testing.assert_array_equal(fs.self_idx, fp.self_idx)
            np.testing.assert_array_equal(np.sort(fs.idx * fs.mask, axis=1),
                                          np.sort(fp.idx * fp.mask, axis=1))
            np.testing.assert_array_equal(fs.mask.sum(1), fp.mask.sum(1))
            moved |= not np.array_equal(fs.mask, fp.mask)
        assert moved
    assert rng.randint(2**31) == jrng.randint(2**31)


def _rng_at(state) -> np.random.RandomState:
    rng = np.random.RandomState()
    rng.set_state(state)
    return rng


def test_replay_hook_uses_the_given_sample_sets(graphs):
    ds, jds = graphs
    batch = np.array([3, 9, 27])
    sets = [[{3, 4, 5}, {9}, {27, 3}]]
    sets.append([{v} for v in sorted({3, 4, 5, 9, 27})])
    got = build_compact_batch(ds.graph, batch, np.random.RandomState(0),
                              num_layers=2, sample_sets=sets)
    want = jax_build(jds.graph, batch, np.random.RandomState(0),
                     num_layers=2, sample_sets=sets)
    _assert_batches_equal(got, want)
    np.testing.assert_array_equal(got.frontiers[1].mask.sum(1)[:3],
                                  [2, 0, 1])


@pytest.mark.parametrize("num_neg", [6, 100])
@pytest.mark.parametrize("mode", ["exact", "uniform"])
def test_pair_batches_are_bit_identical(graphs, mode, num_neg):
    ds, jds = graphs
    train = ds.train_nodes
    ps = PairSampler(ds.graph, train, negative_mode=mode)
    jps = JaxPairSampler(jds.graph, jds.train_nodes, negative_mode=mode)
    rng, jrng = np.random.RandomState(4), np.random.RandomState(4)
    order = np.random.RandomState(5).permutation(train)
    for lo in (0, 20, 40):
        got = ps.sample_batch(order[lo:lo + 20], num_neg, rng)
        want = jps.sample_batch(order[lo:lo + 20], num_neg, jrng)
        for name in ("unique_nodes", "target_rows", "pos_q", "pos_mask",
                     "neg_q", "neg_mask", "node_valid"):
            x, y = getattr(got, name), getattr(want, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert got.num_unique == want.num_unique
    assert rng.randint(2**31) == jrng.randint(2**31)


def test_auto_negative_mode_follows_the_budget(graphs, monkeypatch):
    ds, _ = graphs
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "0")
    assert PairSampler(ds.graph, ds.train_nodes).negative_mode == "uniform"
    monkeypatch.setenv("GS_EXACT_NEG_BUDGET_S", "1e9")
    assert PairSampler(ds.graph, ds.train_nodes).negative_mode == "exact"


def test_prewarm_fills_the_same_far_lists(graphs):
    ds, _ = graphs
    warm = PairSampler(ds.graph, ds.train_nodes, negative_mode="exact")
    warm.prewarm_async(ds.train_nodes, chunk=50)
    warm._prewarm_thread.join(timeout=60)
    assert not warm._prewarm_thread.is_alive()
    warm.close()
    cold = PairSampler(ds.graph, ds.train_nodes, negative_mode="exact")
    for v in ds.train_nodes[:30]:
        np.testing.assert_array_equal(warm._far_cache[int(v)],
                                      cold._far_nodes(int(v)))


def test_native_entry_points_match_jax(graphs):
    ds, _ = graphs
    g = ds.graph
    train = ds.train_nodes
    roots = train[:7].astype(np.int32)
    np.testing.assert_array_equal(
        native.bfs_closure_native(g.indptr, g.indices, g.num_nodes, 11, 2),
        jax_native.bfs_closure_native(g.indptr, g.indices, g.num_nodes, 11,
                                      2))
    for x, y in zip(native.far_lists_native(g.indptr, g.indices, g.num_nodes,
                                            roots, 2, train),
                    jax_native.far_lists_native(g.indptr, g.indices,
                                                g.num_nodes, roots, 2,
                                                train)):
        np.testing.assert_array_equal(x, y)
    for got, want in (
            (native.uniform_negatives_native(g.indptr, g.indices,
                                             g.num_nodes, train, roots, 9,
                                             seed=3),
             jax_native.uniform_negatives_native(g.indptr, g.indices,
                                                 g.num_nodes, train, roots,
                                                 9, seed=3)),
            (native.sample_fanout_native(g.indptr, g.indices, g.num_nodes,
                                         roots, 4, seed=5),
             jax_native.sample_fanout_native(g.indptr, g.indices,
                                             g.num_nodes, roots, 4,
                                             seed=5))):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def _tree(path):
    # the JAX package's own library may be (re)built by its tests running
    # beside this one; what the port writes is checked by its g++ command
    return {name: os.stat(os.path.join(path, name)).st_mtime_ns
            for name in sorted(os.listdir(path))
            if not name.startswith("_gs_native")}


def test_engine_builds_under_build_and_leaves_the_jax_package_alone(
        tmp_path, monkeypatch):
    jax_native_dir = os.path.join(REPO, "graphsage_tpu", "native")
    before = _tree(jax_native_dir)
    assert native_build.library_path().parent.parts[-2:] == (
        "build", "graphsage_torch")
    monkeypatch.setattr(native_build, "BUILD_DIR",
                        tmp_path / "build" / "graphsage_torch")
    commands = []
    run = native_build.subprocess.run
    monkeypatch.setattr(native_build.subprocess, "run",
                        lambda cmd, **kw: commands.append(cmd) or run(cmd,
                                                                      **kw))
    path = native_build.build()
    assert path.parent == tmp_path / "build" / "graphsage_torch"
    assert path.name.startswith("libgs_native-") and path.exists()
    assert native_build.build() == path            # a current build is reused
    assert len(commands) == 1
    out = commands[0][commands[0].index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path / "build" / "graphsage_torch")
    assert _tree(jax_native_dir) == before


def test_failed_engine_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "GXX_FLAGS",
                        ("--no-such-flag", "-shared"))
    with pytest.raises(RuntimeError, match="native engine build failed"):
        native_build.build()


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetched_epochs_match_serial_and_jax(depth):
    def producer_for(rng):
        def producer():
            for _ in range(12):
                yield rng.randint(0, 1000, size=5)
        return producer

    serial = list(prefetch(producer_for(np.random.RandomState(8)),
                           enabled=False))
    ahead = list(prefetch(producer_for(np.random.RandomState(8)),
                          depth=depth))
    jax_side = list(jax_prefetch(producer_for(np.random.RandomState(8)),
                                 depth=depth))
    for a, b, c in zip(serial, ahead, jax_side):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(serial) == len(ahead) == 12


def test_producer_errors_reach_the_consumer():
    def producer():
        yield 1
        raise KeyError("boom")

    stream = prefetch(producer, depth=2)
    assert next(stream) == 1
    with pytest.raises(KeyError, match="boom"):
        next(stream)
