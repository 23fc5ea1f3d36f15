"""Traffic kind ``train_compact``: epochs of the port's compact ``Trainer``,
the reference implementation's own protocol.

The window calls ``Trainer.train_epoch`` back to back: per step of b_sz
train nodes the host extends the batch with walk positives and negatives
(``PairSampler``), builds the compact frontiers (the C++ engine) on the
prefetch thread, and the card runs the encoder, the losses, the backward,
the clip and SGD.

Set-up builds the trainer from the benchmark's inputs, waits for the pair
sampler's background build of the negatives' far lists, and runs the first
epoch through the same call, recording the first steps' host batches and
the parameters after each of them.  The check (``benchmark.training``)
runs the reference over those batches from the same initial parameters,
and checks the batches themselves against the benchmark's graph.

Mix keys: ``learn_method``, ``unsup_loss`` ("margin") and its ``margin``
(the reference's MARGIN, which the program's pair sampler fixes),
``num_neg`` and ``walk_depth`` (the reference's negatives a target and the
hops of the neighbourhood they lie outside), ``b_sz``, ``lr``, ``clip``,
``trace_ticks`` (steps a traced slice covers).  The trainer builds its host
batches ahead on its prefetch thread at its own default depth.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark import adapt, graphgen, training
from benchmark.reference import draws, sage
from benchmark.reference.precision import CONTROL
from graphsage_torch.train import Trainer, TrainConfig

PREWARM_WAIT_S = 600.0   # the far lists' background build


class Driver(training.EpochDriver):
    ticks_steps = True

    def __init__(self, cell, seed, device, tracer):
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.tracer, self.device = cfg, mix, tracer, device
        self.seeds = graphgen.sub_seeds(seed)
        self.fanout = cfg["model"]["fanout"]
        data = graphgen.make_data(cfg, seed, device)
        self.graph, self.labels, self.train = data.graph, data.labels, data.train
        self.params0 = graphgen.init_params(cfg, self.seeds["params"], device)
        tcfg = TrainConfig(learn_method=mix["learn_method"],
                           unsup_loss=mix["unsup_loss"], b_sz=mix["b_sz"],
                           lr=mix["lr"], clip_norm=mix["clip"],
                           fanout=self.fanout, seed=self.seeds["program"],
                           epochs=1, verbose=False)
        ds = adapt.dataset(data, cfg)
        del data
        self.program = Trainer(ds, adapt.model_config(cfg), tcfg,
                               params=self.params0, device=device)
        del ds
        sampler = self.program.pair_sampler
        self.negative_mode = sampler.negative_mode
        prewarm = getattr(sampler, "_prewarm_thread", None)
        if prewarm is not None:
            prewarm.join(PREWARM_WAIT_S)
            if prewarm.is_alive():
                raise RuntimeError("the far lists' build outlasted "
                                   f"{PREWARM_WAIT_S} s")
        print(f"pair sampler negatives: {self.negative_mode}",
              file=sys.stderr)
        self.n_train = self.train.numel()
        self.steps = math.ceil(self.n_train / mix["b_sz"])
        self.per_tick = {"steps": 1}
        self.counts = {}
        self._warm_up()
        if tracer.enabled:
            self._spans()

    # ------------------------------------------------------------ set-up
    def _warm_up(self) -> None:
        tr = self.program
        step = tr._step
        self.batches, self.after = [], []

        def record_step(pb, cb, labels, row_mask):
            loss = step(pb, cb, labels, row_mask)
            if len(self.batches) < training.STEPS:
                self.batches.append((pb, cb, labels.copy(), row_mask.copy()))
                self.after.append(training.snapshot(tr.params))
            return loss

        tr._step = record_step
        try:
            tr.train_epoch()
        finally:
            del tr._step
        self.prog_losses = tr.step_losses[:training.STEPS]
        tr.epoch += 1

    def _spans(self) -> None:
        tr, tracer = self.program, self.tracer
        step, build = tr._step, tr._build_train_batch

        def spanned_step(*args):
            with tracer.span("step"):
                loss = step(*args)
            tracer.tick()
            return loss

        def spanned_build(nodes):
            with tracer.span("host_batch"):
                return build(nodes)

        tr._step, tr._build_train_batch = spanned_step, spanned_build

    def release(self) -> None:
        self.program.pair_sampler.close()
        self.program = None

    # ------------------------------------------------------------- check
    def _step_inputs(self, pb, cb) -> dict:
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        nu = int(pb.num_unique)
        top = t(pb.unique_nodes).long()
        rows = cb.frontiers[-1].idx.shape[0]
        labels = torch.zeros(rows, dtype=torch.long, device=dev)
        labels[:nu] = self.labels[top[:nu]]
        return {"x0_ids": t(cb.x0_ids),
                "frontiers": [(t(f.idx), t(f.mask), t(f.self_idx))
                              for f in cb.frontiers],
                "labels": labels,
                "row_mask": (torch.arange(rows, device=dev) < nu).float(),
                "pairs": {f: t(getattr(pb, f)) for f in (
                    "target_rows", "pos_q", "pos_mask", "neg_q", "neg_mask",
                    "node_valid")}}

    def _draw_faults(self, steps: list[dict]) -> int:
        g = self.graph
        keys, deg = g.edge_keys(), g.degrees
        indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
        train = np.zeros(g.num_nodes, bool)
        train[self.train.cpu().numpy()] = True
        faults, targets = 0, []
        for (pb, cb, labels, row_mask), s in zip(self.batches, steps):
            nu = int(pb.num_unique)
            top = s["x0_ids"].new_tensor(np.asarray(pb.unique_nodes[:nu]))
            faults += draws.compact_faults(keys, g.num_nodes, deg,
                                           s["x0_ids"], s["frontiers"], top,
                                           self.fanout)
            faults += draws.pair_faults(indptr, indices, train, pb,
                                        self.mix["num_neg"],
                                        self.mix["walk_depth"],
                                        self.negative_mode)
            faults += int(not np.array_equal(labels[:nu],
                                             s["labels"][:nu].cpu().numpy()))
            faults += int(not np.array_equal(row_mask,
                                             s["row_mask"].cpu().numpy()))
            targets.append(np.asarray(pb.unique_nodes)[
                np.asarray(pb.target_rows)])
        targets = np.concatenate(targets)
        faults += int(np.unique(targets).size != targets.size
                      or not train[targets].all())
        return faults

    def readings(self, controls: bool):
        cfg, mix = self.cfg, self.mix
        m = cfg["model"]
        x, _ = graphgen.features(cfg["graph"], self.graph.num_nodes,
                                 m["feature_dtype"], self.seeds["features"],
                                 self.device)
        steps = [self._step_inputs(pb, cb) for pb, cb, _, _ in self.batches]

        def loss(params, step, p):
            return sage.compact_loss(params, x, step, m["agg_func"],
                                     mix["learn_method"], mix["margin"], p)

        def halve(steps):
            out = []
            for s in steps:
                mask = s["row_mask"].clone()
                mask[int(mask.sum()) // 2:] = 0
                valid = s["pairs"]["node_valid"].clone()
                valid[valid.numel() // 2:] = 0
                out.append(dict(s, row_mask=mask,
                                pairs=dict(s["pairs"], node_valid=valid)))
            return out

        found, extra = training.readings(
            self.params0, steps, loss, mix["lr"], mix["clip"],
            self.prog_losses, self.after, CONTROL[m["compute_dtype"]], halve,
            controls)
        return {**found, "draw_faults": self._draw_faults(steps)}, extra
