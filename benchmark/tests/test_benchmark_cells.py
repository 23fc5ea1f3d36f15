"""Every cell end to end at a small size on the CPU, through the same
entry point as on the card (the look for a card skipped): the last line's
keys, its metrics, and a correct check."""

import contextlib
import io
import json

import pytest

from benchmark import harness, run

from conftest import TINY

CELLS = sorted(TINY)


def run_cell(cell: str, trace: int, seed: int = 2**31 + 17,
             seconds: float = 0.3):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", overrides=TINY[cell])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell, trace):
    rc, out, err = run_cell(cell, trace)
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = harness.load_cell(cell)
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        # the CPU profile holds no device operation: nothing to read
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(spec.limits)
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    assert line["correct"], line["checks"]


def test_cells_match_benchmark_json():
    assert sorted(w for w in TINY) == sorted(
        w["name"] for w in json.loads(
            (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])
