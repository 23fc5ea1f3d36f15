"""Traffic kind ``train_cached``: epochs of the port's ``CachedTrainer``.

The window calls ``CachedTrainer.train_epoch`` back to back, one caller
waiting for each (an epoch ends in the fetch of its losses): a leaf-cache
refresh over all N nodes, then ceil(train / B) steps of fixed-size batches.

Set-up builds the trainer from the benchmark's graph, features and initial
parameters and runs its first epoch through the same call, recording what
the check needs: the refresh's neighbour draw and a sample of the cache it
produced, the first steps' batches and draws, the parameters after each of
them, and every batch of the epoch.  The check (``benchmark.training``)
runs the reference over those steps from the same initial parameters, with
its own leaf cache from the recorded draw, and checks the draws
themselves.

The protocol is fixed: supervised, plain batches of train nodes (no pair
extension).  Mix keys: ``b_sz``, ``lr``, ``clip``, ``table_cap``,
``refresh_every``, ``trace_ticks`` (epochs a traced slice covers).
"""

from __future__ import annotations

import math

import torch

from benchmark import adapt, compare, counts, graphgen, training
from benchmark.reference import draws, sage
from benchmark.reference.precision import CONTROL, EXACT
from graphsage_torch.train import CachedTrainer, TrainConfig

CACHE_ROWS = 65536     # cache rows compared, drawn from the seed


class Driver(training.EpochDriver):

    def __init__(self, cell, seed, device, tracer):
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.tracer, self.device = cfg, mix, tracer, device
        self.seeds = graphgen.sub_seeds(seed)
        m = cfg["model"]
        self.fanout = m["fanout"]
        data = graphgen.make_data(cfg, seed, device)
        self.graph, self.labels, self.train = data.graph, data.labels, data.train
        self.params0 = graphgen.init_params(cfg, self.seeds["params"], device)
        tcfg = TrainConfig(learn_method="sup", b_sz=mix["b_sz"], lr=mix["lr"],
                           clip_norm=mix["clip"], fanout=self.fanout,
                           seed=self.seeds["program"], epochs=1,
                           refresh_every=mix["refresh_every"], verbose=False)
        ds = adapt.dataset(data, cfg)
        del data
        self.program = CachedTrainer(
            ds, adapt.model_config(cfg), tcfg, table_cap=mix["table_cap"],
            extend_batches=False, params=self.params0, device=device)
        del ds
        self.n_train = self.train.numel()
        self.steps = math.ceil(self.n_train / mix["b_sz"])
        self.per_tick = {"steps": self.steps, "nodes": self.n_train}
        g = cfg["graph"]
        self.counts = {"flops_per_node": counts.train_flops_per_node(
            g["num_feats"], m["hidden"], g["num_classes"], self.fanout)}
        self._warm_up()
        if tracer.enabled:
            self._spans()

    # ------------------------------------------------------------ set-up
    def _warm_up(self) -> None:
        tr = self.program
        hop, step, refresh = tr.hop, tr._step, tr._refresh
        self.hops, self.batches, self.after = [], [], []
        n = self.graph.num_nodes
        gen = graphgen.generator(self.seeds["table"], self.device)
        self.cache_rows = torch.randperm(n, generator=gen,
                                         device=self.device)[:CACHE_ROWS]

        def record_hop(nodes, fanout):
            out = hop(nodes, fanout)
            if len(self.hops) <= training.STEPS:
                self.hops.append((nodes.clone(), out[0].clone(),
                                  out[1].clone()))
            return out

        def record_refresh():
            out = refresh()
            if not hasattr(self, "prog_cache"):
                self.prog_cache = out[0][self.cache_rows].float().cpu()
            return out

        def record_step(params, feats, cache, count, hop_, batch, labels,
                        row_mask=None, pairs=None):
            loss = step(params, feats, cache, count, hop_, batch, labels,
                        row_mask, pairs)
            self.batches.append((batch, labels, row_mask))
            if len(self.batches) <= training.STEPS:
                self.after.append(training.snapshot(params))
            return loss

        tr.hop, tr._step, tr._refresh = record_hop, record_step, record_refresh
        try:
            tr.train_epoch()
        finally:
            tr.hop, tr._step = hop, step
            del tr._refresh
        self.prog_losses = tr.step_losses[:training.STEPS]
        tr.epoch += 1

    def _spans(self) -> None:
        tr, tracer = self.program, self.tracer
        step, refresh = tr._step, tr._refresh

        def timed_refresh():
            with tracer.timed("refresh"):
                return refresh()

        def spanned_step(*args, **kw):
            with tracer.span("step"):
                return step(*args, **kw)

        tr._refresh, tr._step = timed_refresh, spanned_step

    def release(self) -> None:
        self.program = None

    # ------------------------------------------------------------- check
    def _row_mask(self, t: int) -> torch.Tensor:
        b = self.mix["b_sz"]
        pos = torch.arange(t * b, (t + 1) * b, device=self.device)
        return (pos < self.n_train).float()

    def _draw_faults(self) -> int:
        n, k = self.graph.num_nodes, self.fanout
        keys, deg = self.graph.edge_keys(), self.graph.degrees
        faults = sum(draws.hop_faults(keys, n, deg, *h, k) for h in self.hops)
        faults += sum(int(not torch.equal(h[0].long(), b[0].long()))
                      for h, b in zip(self.hops[1:], self.batches))
        real = []
        for t, (batch, labels, row_mask) in enumerate(self.batches):
            keep = row_mask > 0
            faults += int(not torch.equal(keep.float(), self._row_mask(t)))
            faults += int(not torch.equal(labels[keep].long(),
                                          self.labels[batch[keep].long()]))
            real.append(batch[keep].long())
        real = torch.cat(real).sort().values
        faults += int(not torch.equal(real, self.train.sort().values))
        return faults

    def readings(self, controls: bool):
        cfg, mix = self.cfg, self.mix
        m = cfg["model"]
        x, _ = graphgen.features(cfg["graph"], self.graph.num_nodes,
                                 m["feature_dtype"], self.seeds["features"],
                                 self.device)
        _, samples, valid = self.hops[0]
        steps = [{"batch": self.batches[t][0], "samples": self.hops[t + 1][1],
                  "valid": self.hops[t + 1][2],
                  "labels": self.labels[self.batches[t][0].long()],
                  "row_mask": self._row_mask(t)}
                 for t in range(len(self.after))]
        low = CONTROL[m["compute_dtype"]]
        caches = {p.name: sage.leaf_cache(x, samples, valid, m["agg_func"], p)
                  for p in ((EXACT, low) if controls else (EXACT,))}

        def loss(params, step, p):
            return sage.cached_sup_loss(params, x, caches[p.name], step, p)

        def halve(steps):
            out = []
            for s in steps:
                mask = s["row_mask"].clone()
                mask[mask.numel() // 2:] = 0
                out.append(dict(s, row_mask=mask))
            return out

        rows, ref_cache = self.cache_rows, caches[EXACT.name]
        found, extra = training.readings(
            self.params0, steps, loss, mix["lr"], mix["clip"],
            self.prog_losses, self.after, low, halve, controls, split=True)
        out = {"cache_gap": compare.row_gap(self.prog_cache.to(self.device),
                                            ref_cache[rows]),
               **found, "draw_faults": self._draw_faults()}
        if controls:
            extra["control"]["cache_gap"] = compare.row_gap(
                caches[low.name][rows], ref_cache[rows])
        return out, extra
