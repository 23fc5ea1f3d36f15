"""The GraphSAGE-pool serving cell: its small size for the CPU runs of
``test_benchmark_cells.py``, its arithmetic against numbers worked out by
hand, and its readers on a trace that holds nothing to read."""

import json

import pytest
import torch

from benchmark import harness, pool
from benchmark.trace import TraceResult

from conftest import TINY

# the cell's size on the CPU, joined to the table every cell's CPU run
# reads (this module is collected before test_benchmark_cells.py)
TINY.update({
    "embed_reddit_pool_cap25": {
        "config": {"graph": {"num_nodes": 3000, "num_edges": 15000,
                             "num_feats": 64},
                   "model": {"hidden": 32, "pool_size": 48}},
        "mix": {"trace_ticks": 3}},
})


def _pool_cfg():
    return json.loads((harness.BENCH / "configs" / "sage_pool_reddit.json")
                      .read_text())


def test_pool_config_holds_the_published_widths():
    m, g = _pool_cfg()["model"], _pool_cfg()["graph"]
    assert (m["pool_size"], m["hidden"], m["num_layers"], m["fanout"]) == (
        512, 256, 2, 25)
    assert (g["num_nodes"], g["num_feats"], g["num_classes"]) == (
        232_965, 602, 41)
    assert m["agg_func"] == "POOL" and m["compute_dtype"] == "bfloat16"


def test_pool_pass_counts_by_hand():
    """Three nodes, two slots: node 0 reads 1 and 2, node 1 reads 0 (its
    second slot past its degree), node 2 reads nothing but itself."""
    cfg = {"model": {"hidden": 4, "pool_size": 8, "num_layers": 2,
                     "compute_dtype": "bfloat16"},
           "graph": {"num_feats": 6}}
    table = torch.tensor([[1, 2], [0, 1], [2, 0]], dtype=torch.int32)
    degrees = torch.tensor([2, 1, 1], dtype=torch.int32)
    c = pool.pass_counts(cfg, table, degrees, 2)
    # layer 1: pool 2*3*6*8, sage 2*3*(6+8)*4; layer 2: 2*3*4*8, 2*3*12*4
    assert c["flops_per_pass"] == 288 + 336 + 192 + 288
    # each layer: distinct rows {0, 1, 2} of 16 bytes, the int32 index and
    # degrees, the [3, 8] bfloat16 output
    agg = (3 * 16 + 3 * 2 * 4 + 3 * 4 + 3 * 16) / 3.35e12
    assert c["agg_bound_s_per_pass"] == pytest.approx(2 * agg)
    # bytes bound the pool transforms at this size: table, weight, bias,
    # output
    pool_bytes = ((3 * 6 * 2 + 8 * 6 * 4 + 8 * 4 + 3 * 8 * 2)
                  + (3 * 4 * 2 + 8 * 4 * 4 + 8 * 4 + 3 * 8 * 2))
    assert c["pool_bound_s_per_pass"] == pytest.approx(pool_bytes / 3.35e12)


def test_pool_pass_counts_at_the_cell():
    """The cell's pool transforms: layer 1 bound by its bytes (0.155 ms),
    layer 2 too (0.107 ms): 0.262 ms; about 0.43 TFLOP of products a pass."""
    cfg = _pool_cfg()
    n = cfg["graph"]["num_nodes"]
    table = torch.zeros((n, 1), dtype=torch.int32)
    c = pool.pass_counts(cfg, table, torch.zeros(n, dtype=torch.int32), 2)
    assert c["flops_per_pass"] / 1e12 == pytest.approx(0.4291, abs=1e-4)
    assert c["pool_bound_s_per_pass"] * 1e3 == pytest.approx(0.2623,
                                                             abs=1e-4)


def test_pool_params_have_the_program_layout():
    cfg = _pool_cfg()
    p = pool.init_params(cfg, 7, torch.device("cpu"))
    assert [tuple(lyr["weight"].shape) for lyr in p["sage"]["layers"]] == [
        (256, 602 + 512), (256, 256 + 512)]
    assert [tuple(q["weight"].shape) for q in p["sage"]["pool"]] == [
        (512, 602), (512, 256)]
    assert all(float(q["bias"].abs().max()) > 0 for q in p["sage"]["pool"])
    again = pool.init_params(cfg, 7, torch.device("cpu"))
    assert torch.equal(p["sage"]["pool"][1]["bias"],
                       again["sage"]["pool"][1]["bias"])


@pytest.mark.parametrize("metric", ["pool_ms.embed", "pool_roofline.embed"])
def test_pool_readers_find_nothing_in_an_empty_trace(metric):
    cell = harness.load_cell("embed_reddit_pool_cap25")
    empty = TraceResult(ticks=1, window_s=1.0, busy_s=0.0, kernels=0,
                        device_ops={}, idle_gaps=[], spans_ms={})
    ctx = harness.Ctx(cell, empty, {"passes": 1},
                      {"pool_bound_s_per_pass": 1e-3})
    assert harness.reader(metric)(ctx) is None


def test_pool_roofline_reads_the_pretransform_kernels():
    cell = harness.load_cell("embed_reddit_pool_cap25")
    trace = TraceResult(
        ticks=10, window_s=1.0, busy_s=0.5, kernels=3,
        device_ops={"pretransform_bias_relu_kernel<256, 4>": 0.03,
                    "pretransform_bias_relu_kernel<256, 16>": 0.01,
                    "pack_kernel": 0.002, "gather_reduce_kernel": 0.2},
        idle_gaps=[], spans_ms={})
    ctx = harness.Ctx(cell, trace, {"passes": 1},
                      {"pool_bound_s_per_pass": 1e-3})
    assert harness.reader("pool_roofline.embed")(ctx) == pytest.approx(25.0)


def _span(name, device_ms, layer):
    return {"name": name, "thread": "MainThread", "parent": None,
            "start_ns": 0, "end_ns": 100_000, "host_ms": 0.1,
            "device_ms": device_ms, "counts": {"layer": layer}}


@pytest.mark.parametrize("metric,want", [("pool_ms.embed", 1.5 + 0.75),
                                         ("transform_ms.embed", 4.0 + 2.5)])
def test_pool_cell_span_readers_sum_the_layers(metric, want, monkeypatch):
    """POOL's device-timed spans, one a layer a pass: the serving pass's
    pool MLPs (``serve.pool``) and its sage layers after the max
    (``serve.transform``), each a layer's mean over passes, summed."""
    from graphsage_torch.utils import obs
    store = {"spans": [_span("serve.pool", 1.0, 0),
                       _span("serve.pool", 2.0, 0),
                       _span("serve.pool", 0.75, 1),
                       _span("serve.transform", 4.0, 0),
                       _span("serve.transform", 2.5, 1),
                       _span("serve.aggregate", None, 0)],
             "counts": {}}
    monkeypatch.setattr(obs, "records", lambda clear=False: store)
    cell = harness.load_cell("embed_reddit_pool_cap25")
    assert metric in {m["name"] for m in cell.per_layer}
    trace = TraceResult(ticks=1, window_s=1.0, busy_s=0.5, kernels=0,
                        device_ops={}, idle_gaps=[], spans_ms={})
    ctx = harness.Ctx(cell, trace, {"passes": 1},
                      {"pool_bound_s_per_pass": 1e-3})
    assert harness.reader(metric)(ctx) == pytest.approx(want)
