"""Traffic kind ``embed``: full-graph serving passes of the port's
``infer.full_graph_embeddings``.

One caller asks for the [N, H] embedding table of the whole graph and waits
until it is complete on the card, then asks again: a closed loop.  The
passes run over a width-``table_width`` neighbour table that the benchmark
draws (a uniform subset of each node's neighbours), features in the
configuration's compute dtype, and float32 parameters, all on the card
before the window.  A pass's latency is read on the device's clock: a pair
of CUDA events around it in the stream, from its first launch to the end of
its last kernel.

The check compares the window's last table with the reference's full-graph
pass over the same table, and the first with the last (a pass is
deterministic).

Mix keys: ``table_width``, ``trace_ticks`` (passes a traced slice
covers).
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark import adapt, compare, counts, graphgen
from benchmark.reference import sage
from benchmark.reference.precision import CONTROL, EXACT
from graphsage_torch.data.graph import PaddedAdjacency
from graphsage_torch.infer import full_graph_embeddings

WARM_PASSES = 3     # passes before the window: every shape built and cached


class Driver:
    ticks_steps = False

    def __init__(self, cell, seed, device, tracer):
        cfg, mix = cell.config, cell.mix
        self.cfg, self.tracer, self.device = cfg, tracer, device
        self.seeds = graphgen.sub_seeds(seed)
        m, g = cfg["model"], cfg["graph"]
        data = graphgen.make_data(cfg, seed, device)
        self.table, self.degrees = graphgen.neighbour_table(
            data.graph, mix["table_width"], self.seeds["table"])
        self.params0 = graphgen.init_params(cfg, self.seeds["params"], device)
        feats = data.features.to(graphgen.dtype(m["compute_dtype"]))
        del data
        n, width = self.table.shape
        self.counts = {
            "flops_per_pass": counts.embed_flops_per_pass(
                n, g["num_feats"], m["hidden"], m["num_layers"]),
            "agg_bound_s_per_pass": self._agg_bound_s(feats.element_size())}
        self.per_tick = {"passes": 1}
        self.mcfg = adapt.model_config(cfg)
        self.program = {"feats": feats, "pad": PaddedAdjacency(
            neighbors=self.table, degrees=self.degrees, true_degrees=None,
            truncated=True)}
        self.cuda = device.type == "cuda"
        self.latencies, self.events = [], []
        self.first = self.last = None
        for _ in range(WARM_PASSES):
            self._pass()
        self._sync()

    def _agg_bound_s(self, itemsize: int) -> float:
        """Least seconds of a pass's aggregations: each distinct row the
        valid slots reference, read once, per layer (MEAN reads the
        transformed table's H-wide rows, MAX the layer's input rows)."""
        n, width = self.table.shape
        slot = torch.arange(width, device=self.table.device)
        valid = ((slot[None, :] < self.degrees[:, None])
                 & (self.table != torch.arange(n, device=slot.device)[:, None]))
        distinct = int(torch.unique(self.table[valid]).numel())
        m, g = self.cfg["model"], self.cfg["graph"]
        total = 0.0
        for layer in range(m["num_layers"]):
            width_in = g["num_feats"] if layer == 0 else m["hidden"]
            row = (m["hidden"] if m["agg_func"] == "MEAN" else width_in)
            total += counts.bound_s(counts.aggregate_bytes(
                distinct, row * itemsize, n, width, row * itemsize))
        return total

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _pass(self) -> torch.Tensor:
        return full_graph_embeddings(
            self.params0["sage"], self.mcfg, self.program["feats"],
            self.program["pad"], fetch=False, device=self.device)

    # ------------------------------------------------------------ window
    def iteration(self) -> None:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with self.tracer.span("pass"):
                out = self._pass()
            end.record()
            with self.tracer.span("wait"):
                end.synchronize()
            self.events.append((start, end))
        else:
            t0 = time.perf_counter()
            out = self._pass()
            self.latencies.append((time.perf_counter() - t0) * 1e3)
        if self.first is None:
            self.first = out
        self.last = out

    def attempted(self, units: int) -> int:
        return units

    def end_to_end(self, units: int, window_s: float) -> dict:
        lat = self.latencies + [s.elapsed_time(e) for s, e in self.events]
        p95 = (statistics.quantiles(lat, n=100, method="inclusive")[94]
               if len(lat) > 1 else lat[0])
        return {"embed_all_ms": window_s * 1e3 / units,
                "embed_all_p95_ms": p95}

    def release(self) -> None:
        self.program = None

    # ------------------------------------------------------------- check
    def readings(self, controls: bool):
        cfg = self.cfg
        m = cfg["model"]
        x, _ = graphgen.features(cfg["graph"], self.table.shape[0],
                                 m["feature_dtype"], self.seeds["features"],
                                 self.device)

        def full(p):
            return sage.full_graph(self.params0, x, self.table, self.degrees,
                                   m["agg_func"], p)

        ref = full(EXACT)
        out = {"emb_gap": compare.row_gap(self.last, ref),
               "pass_mismatch": int((self.first != self.last).sum())}
        if not controls:
            return out, None
        low = CONTROL[m["compute_dtype"]]
        return out, {"control": {"emb_gap": compare.row_gap(full(low), ref)}}
