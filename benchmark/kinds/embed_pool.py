"""Traffic kind ``embed_pool``: full-graph serving passes of the port's
``infer.full_graph_embeddings`` with a GraphSAGE-pool model.

The load is the ``embed`` kind's: one caller asks for the [N, H] embedding
table of the whole graph, waits until it is complete on the card, then asks
again (a closed loop), over a width-``table_width`` neighbour table that the
benchmark draws (a uniform subset of each node's neighbours) and that serves
every layer; features in the configuration's compute dtype and float32
parameters on the card before the window; a pass's latency is a pair of
CUDA events around it.  What differs is the model: each layer puts every
row through its pool MLP (``benchmark.pool`` draws its weights and bias from
the seed's ``params`` stream), takes the max over the slots of the pooled
rows, then the sage layer.

The check compares the window's last table with the plain reference's
full-graph pass (``reference.sage_pool``) over the same table, and the
first with the last (a pass is deterministic).

Mix keys: ``table_width``, ``trace_ticks`` (passes a traced slice
covers).
"""

from __future__ import annotations

import torch

from benchmark import compare, graphgen, pool
from benchmark.kinds import embed
from benchmark.reference import sage_pool
from benchmark.reference.precision import CONTROL, EXACT
from graphsage_torch.data.graph import PaddedAdjacency


class Driver(embed.Driver):

    def __init__(self, cell, seed, device, tracer):
        cfg, mix = cell.config, cell.mix
        self.cfg, self.tracer, self.device = cfg, tracer, device
        self.seeds = graphgen.sub_seeds(seed)
        m = cfg["model"]
        data = graphgen.make_data(cfg, seed, device)
        self.table, self.degrees = graphgen.neighbour_table(
            data.graph, mix["table_width"], self.seeds["table"])
        self.params0 = pool.init_params(cfg, self.seeds["params"], device)
        feats = data.features.to(graphgen.dtype(m["compute_dtype"]))
        del data
        self.counts = pool.pass_counts(cfg, self.table, self.degrees,
                                       feats.element_size())
        self.per_tick = {"passes": 1}
        self.mcfg = pool.model_config(cfg)
        self.program = {"feats": feats, "pad": PaddedAdjacency(
            neighbors=self.table, degrees=self.degrees, true_degrees=None,
            truncated=True)}
        self.cuda = device.type == "cuda"
        self.latencies, self.events = [], []
        self.first = self.last = None
        for _ in range(embed.WARM_PASSES):
            self._pass()
        self._sync()

    def readings(self, controls: bool):
        cfg = self.cfg
        m = cfg["model"]
        x, _ = graphgen.features(cfg["graph"], self.table.shape[0],
                                 m["feature_dtype"], self.seeds["features"],
                                 self.device)

        def full(p):
            return sage_pool.full_graph(self.params0, x, self.table,
                                        self.degrees, p)

        ref = full(EXACT)
        out = {"emb_gap": compare.row_gap(self.last, ref),
               "pass_mismatch": int((self.first != self.last).sum())}
        if not controls:
            return out, None
        low = CONTROL[m["compute_dtype"]]
        return out, {"control": {"emb_gap": compare.row_gap(full(low), ref)}}
