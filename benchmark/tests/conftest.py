"""Tests of the port's benchmark.  On the CPU they drive every cell at a
small size through the same entry point, with the look for a card
skipped; the ``card`` tests need a CUDA card and skip without one (run
them on the card: ``python -m pytest benchmark/tests -m card``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cell at a size a CPU test holds: widths cut too, which the cells
# on the card never are
TINY = {
    "train_sup_pl1m_b65536": {
        "config": {"graph": {"num_nodes": 8000, "num_edges": 40000,
                             "num_feats": 64}},
        "mix": {"b_sz": 1024, "trace_ticks": 2}},
    "embed_pl1m_cap16": {
        "config": {"graph": {"num_nodes": 3000, "num_edges": 15000,
                             "num_feats": 64}},
        "mix": {"trace_ticks": 3}},
    "train_plus_unsup_pubmed_b20": {
        "config": {"graph": {"num_nodes": 600, "num_edges": 1500,
                             "num_feats": 32}},
        "mix": {"trace_ticks": 5}},
    "embed_pubmed_cap32": {
        "config": {"graph": {"num_nodes": 600, "num_edges": 1500,
                             "num_feats": 32}},
        "mix": {"trace_ticks": 3}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
