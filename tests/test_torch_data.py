"""The port's own copy of the data layer (graphsage_torch.data) gives
bit-identical outputs to the JAX package's (graphsage_tpu.data) for the same
inputs and seeds: graph compilation, padding, splits, synthetic graphs and
the file loaders, including their synthetic-content fallback."""

import dataclasses

import numpy as np
import pytest

from graphsage_tpu import data as jax_data
from graphsage_torch import data as port_data


def _assert_same(a, b):
    """Dataclasses and arrays equal field by field, dtypes included."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _edges(seed=0, n=60, e=200):
    rng = np.random.RandomState(seed)
    return n, rng.randint(0, n, e), rng.randint(0, n, e)


@pytest.mark.parametrize("undirected", [True, False])
def test_csr_from_edges_is_identical(undirected):
    n, src, dst = _edges()
    _assert_same(port_data.CSRGraph.from_edges(n, src, dst, undirected),
                 jax_data.CSRGraph.from_edges(n, src, dst, undirected))


@pytest.mark.parametrize("cap", [None, 3])
def test_to_padded_is_identical(cap):
    n, src, dst = _edges(1)
    _assert_same(port_data.CSRGraph.from_edges(n, src, dst).to_padded(cap),
                 jax_data.CSRGraph.from_edges(n, src, dst).to_padded(cap))


def test_to_padded_sampled_and_subsample_are_identical():
    n, src, dst = _edges(2, n=80, e=600)
    port = port_data.CSRGraph.from_edges(n, src, dst).to_padded_sampled(
        6, np.random.RandomState(99))
    ref = jax_data.CSRGraph.from_edges(n, src, dst).to_padded_sampled(
        6, np.random.RandomState(99))
    _assert_same(port, ref)
    _assert_same(port.subsample(3, np.random.RandomState(5)),
                 ref.subsample(3, np.random.RandomState(5)))


def test_split_nodes_is_identical():
    for a, b in zip(port_data.split_nodes(1001, 824),
                    jax_data.split_nodes(1001, 824)):
        _assert_same(a, b)


def test_synthetic_power_law_is_identical():
    kw = dict(num_feats=24, num_classes=5, seed=3)
    _assert_same(port_data.synthetic_power_law(500, 2500, **kw),
                 jax_data.synthetic_power_law(500, 2500, **kw))
    _assert_same(port_data.load_dataset("powerlaw:400:1600", seed=2,
                                        root="ignored"),
                 jax_data.load_dataset("powerlaw:400:1600", seed=2,
                                       root="ignored"))


CORA_CONTENT = """\
31336\t0\t1\t0\t0\t1\tNeural_Networks
1061127\t1\t0\t0\t0\t0\tRule_Learning
1106406\t0\t0\t1\t1\t0\tNeural_Networks
13195\t0\t1\t1\t0\t0\tReinforcement_Learning
37879\t1\t1\t0\t1\t1\tRule_Learning
1126012\t0\t0\t0\t0\t1\tNeural_Networks
"""

CORA_CITES = """\
31336\t1061127
31336\t1106406
1061127\t13195
13195\t37879
37879\t1126012
1126012\t31336
"""

PUBMED_CONTENT = (
    "PUBMED_FIXTURE\tNODE\tpaper\n"
    "cat=label:label\tnumeric:w-alpha:0.0\tnumeric:w-beta:0.0"
    "\tnumeric:w-gamma:0.0\tstring:summary:summary\n"
    "19127292\tlabel=2\tw-alpha=0.4\tw-gamma=0.125\tsummary=lorem ipsum\n"
    "17363749\tlabel=1\tw-beta=0.75\tsummary=foo\n"
    "19668377\tlabel=3\tw-alpha=0.2\tw-beta=0.3\tw-gamma=0.5\tsummary=bar\n"
    "17293876\tlabel=1\tsummary=no words at all\n"
)

PUBMED_CITES = (
    "DIRECTED\tcites\n"
    "NO_FEATURES\n"
    "33824\tpaper:19127292\t|\tpaper:17363749\n"
    "37511\tpaper:19668377\t|\tpaper:17293876\n"
    "40000\tpaper:17363749\t|\tpaper:19668377\n"
    "40001\tpaper:19127292\t|\tpaper:17293876\n"
)


@pytest.mark.parametrize("with_content", [True, False],
                         ids=["real-content", "synthetic-content"])
@pytest.mark.parametrize("name", ["cora", "pubmed"])
def test_file_loaders_are_identical(tmp_path, name, with_content):
    """Fixture files in the documented formats; without the content file
    both loaders synthesize the same content over the real edges."""
    if name == "cora":
        files = {"cora.cites": CORA_CITES, "cora.content": CORA_CONTENT}
        content = "cora.content"
    else:
        files = {"Pubmed-Diabetes.DIRECTED.cites.tab": PUBMED_CITES,
                 "Pubmed-Diabetes.NODE.paper.tab": PUBMED_CONTENT}
        content = "Pubmed-Diabetes.NODE.paper.tab"
    for fname, text in files.items():
        if with_content or fname != content:
            (tmp_path / fname).write_text(text)
    port = port_data.load_dataset(name, seed=7, root=str(tmp_path))
    ref = jax_data.load_dataset(name, seed=7, root=str(tmp_path))
    assert port.synthetic_features == (not with_content)
    _assert_same(port, ref)
