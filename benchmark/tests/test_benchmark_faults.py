"""``correct`` must come out false for the control and for a program broken
underneath: a step that leaves its state unchanged, half of each batch
left out (the mean taken over the rest), an answer altered where it is
produced, and draws that break the sampler's rules.  Small sizes on the
CPU; the same readings at the cells' own sizes on the card are in PERF.md
(``python -m benchmark.calibrate``)."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import calibrate, compare, harness

from conftest import TINY
from test_benchmark_cells import run_cell

TRAIN = ["train_sup_pl1m_b65536", "train_plus_unsup_pubmed_b20"]
EMBED = ["embed_pl1m_cap16", "embed_pubmed_cap32"]


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert calibrate.main(["--workload", cell, "--seeds", "2",
                               "--seconds", "0.2"], device="cpu",
                              overrides=TINY[cell]) == 0
    rec = last_line(out.getvalue())
    limits = harness.load_cell(cell).limits
    assert rec["correct"], rec["readings"]
    assert not all(c.ok for c in compare.checks(rec["control"], limits))
    if cell in TRAIN:
        assert not all(c.ok for c in compare.checks(rec["half_batch"],
                                                    limits))


def assert_refused(cell):
    rc, out, err = run_cell(cell, 0)
    assert rc == 0, err[-3000:]
    assert not last_line(out)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_step_leaving_state_unchanged(cell, monkeypatch):
    from graphsage_torch.train import optim
    monkeypatch.setattr(optim, "sgd_update", lambda params, grads, lr: None)
    assert_refused(cell)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from graphsage_torch import losses
    from graphsage_torch.train import cached, trainer
    nll = losses.supervised_nll

    def half(logp, labels, row_mask):
        real = torch.nonzero(row_mask > 0)[:, 0]
        mask = row_mask.clone()
        mask[real[real.numel() // 2:]] = 0
        return nll(logp, labels, mask)

    monkeypatch.setattr(cached, "supervised_nll", half)
    monkeypatch.setattr(trainer, "supervised_nll", half)
    assert_refused(cell)


@pytest.mark.parametrize("cell", EMBED)
def test_answer_altered_where_produced(cell, monkeypatch):
    from graphsage_torch import infer
    full = infer._full_embed

    def altered(*args, **kw):
        out = full(*args, **kw).clone()
        out[7] = out[7] * 2 + 1
        return out

    monkeypatch.setattr(infer, "_full_embed", altered)
    assert_refused(cell)


def test_neighbour_draw_off_the_graph(monkeypatch):
    from graphsage_torch.sampler import device
    draw = device._sample_one_hop

    def shifted(generator, neighbors, degrees, nodes, fanout):
        samples, valid = draw(generator, neighbors, degrees, nodes, fanout)
        return (samples + 1) % neighbors.shape[0], valid

    monkeypatch.setattr(device, "_sample_one_hop", shifted)
    assert_refused("train_sup_pl1m_b65536")


def test_negatives_inside_the_neighbourhood(monkeypatch):
    from graphsage_torch.sampler.pairs import PairSampler

    def near(self, node, num_neg, rng):
        nbrs = self.graph.neighbors(node)
        return nbrs[[int(v) in self.train_set for v in nbrs]][:num_neg]

    monkeypatch.setattr(PairSampler, "negatives", near)
    assert_refused("train_plus_unsup_pubmed_b20")
