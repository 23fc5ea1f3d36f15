"""On a card, each cell at its own size and for one seed, through
``calibrate``: the run comes out correct, and the control (the reference in
the precision below the configuration's) does not, nor, in a training
cell, half of each batch left out.  Skips without a card."""

import contextlib
import io
import json

import pytest

from benchmark import calibrate, compare, harness

CELLS = ["train_sup_pl1m_b65536", "embed_pl1m_cap16",
         "train_plus_unsup_pubmed_b20", "embed_pubmed_cap32"]
SEED = 2**31 + 1917


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_and_control_not(cell, card):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert calibrate.main(["--workload", cell, "--seeds", str(SEED),
                               "--seconds", "1"], device=str(card)) == 0
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    limits = harness.load_cell(cell).limits
    assert rec["correct"], rec["readings"]
    assert not all(c.ok for c in compare.checks(rec["control"], limits))
    if "half_batch" in rec:
        assert not all(c.ok for c in compare.checks(rec["half_batch"],
                                                    limits))
