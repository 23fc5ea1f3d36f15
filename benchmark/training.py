"""The check of a training cell: the reference follows the program's first
steps from the same initial parameters, on the batches and draws the
program recorded (see the traffic kinds).

Each step's loss is compared with the reference's loss of that batch at
the program's own parameters before the step (so a loss reads the forward
of that step, not the divergence of two trajectories), the first update's
gradient and the parameters' change after the third step with the
reference's own steps; where the kind gives them, the first gradient's
error is also projected onto the differences of the first batch's halves'
gradients (``compare.split_share``).  With ``controls``, the same numbers of the control
(the reference in the precision below the configuration's, put in the
program's place) and of a planted fault (half of each batch left out),
with the parts they are the worst of.
"""

from __future__ import annotations

import functools
import math

import torch

from benchmark import compare, counts
from benchmark.reference import sage
from benchmark.reference.precision import EXACT

STEPS = 8      # steps the reference follows, each step's loss compared
UPDATE = 3     # the parameters' change is compared after this many


def snapshot(params: dict) -> list[torch.Tensor]:
    """Copies of the leaves of ``params`` in the reference's order."""
    return [t.detach().clone() for t in sage.flat(params)]


class EpochDriver:
    """The window of the training kinds: ``program.train_epoch`` back to
    back, the rate over every epoch's train nodes.  A subclass sets
    ``program``, ``tracer``, ``cfg``, ``n_train`` and ``steps``."""
    ticks_steps = False

    def iteration(self) -> None:
        with self.tracer.span("epoch"):
            self.program.train_epoch()
        self.program.epoch += 1

    def attempted(self, units: int) -> int:
        return units * self.steps

    def end_to_end(self, units: int, window_s: float) -> dict:
        edges = counts.sampled_edges_per_node(
            self.cfg["model"]["fanout"], self.cfg["model"]["num_layers"])
        return {"train_edges_per_s": units * self.n_train * edges / window_s}


def split_differences(params0: dict, step: dict, loss,
                      clip: float) -> list[list[torch.Tensor]]:
    """For two ways of halving ``step``'s real rows (the first and second
    half of them; those at even and at odd places), the difference of the
    two halves' exact gradients, each model's leaves scaled by the clip of
    the whole batch's gradient.  The batch's quarters (half by place) are
    differentiated once each."""
    mask = step["row_mask"]
    real = torch.nonzero(mask > 0)[:, 0]
    first = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    first[real[:real.numel() // 2]] = True
    even = torch.zeros_like(first)
    even[real[0::2]] = True
    quarter = {}
    for a in (True, False):
        for b in (True, False):
            q = mask * ((first == a) & (even == b)).to(mask.dtype)
            fn = functools.partial(loss, step=dict(step, row_mask=q), p=EXACT)
            quarter[a, b] = (float(q.sum()),
                             sage.sgd(params0, [fn], 0.0, math.inf)["grad1"])

    def mean(keys):
        total = sum(quarter[k][0] for k in keys)
        return [sum(quarter[k][0] * quarter[k][1][i] for k in keys) / total
                for i in range(len(quarter[keys[0]][1]))]

    whole = mean(list(quarter))
    scale, at = [], 0
    for group in sage.leaves(params0).values():
        part = whole[at:at + len(group)]
        at += len(group)
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in part))
        scale += [min(1.0, clip / (norm + 1e-6))] * len(group)
    out = []
    for x, y in (([(True, True), (True, False)], [(False, True), (False, False)]),
                 ([(True, True), (False, True)], [(True, False), (False, False)])):
        out.append([c * (u - v) for c, u, v in zip(scale, mean(x), mean(y))])
    return out


def readings(params0: dict, steps: list, loss, lr: float, clip: float,
             prog_losses: list[float], prog_after: list, low,
             halve, controls: bool, split: bool = False):
    """``loss(params, step, p)`` is the reference's loss of one recorded
    step in precision ``p``; ``prog_after`` the program's flattened
    parameters after each of the first steps; ``halve(steps)`` the steps
    with half of each batch left out; ``split`` adds ``grad1_split``."""
    p0 = snapshot(params0)
    diffs = (split_differences(params0, steps[0], loss, clip) if split
             else None)

    def follow(p, steps_):
        return sage.sgd(params0, [functools.partial(loss, step=s, p=p)
                                  for s in steps_], lr, clip)

    exact = [functools.partial(loss, step=s, p=EXACT) for s in steps]

    def at(after):
        return sage.losses_at([p0] + after[:-1], exact)

    ref = follow(EXACT, steps)
    prog = {"losses": prog_losses, "params": prog_after,
            "grad1": [(a - b) / lr for a, b in zip(p0, prog_after[0])]}
    sides = {"program": (prog, at(prog_after))}
    out = compare.train_readings(prog, ref, p0, sides["program"][1], UPDATE,
                                 diffs)
    if not controls:
        return out, None
    for name, side in (("control", follow(low, steps)),
                       ("half_batch", follow(EXACT, halve(steps)))):
        sides[name] = (side, at(side["params"]))
    extra = {name: compare.train_readings(side, ref, p0, ref_at, UPDATE,
                                          diffs)
             for name, (side, ref_at) in sides.items() if name != "program"}
    extra["details"] = {name: compare.train_details(side, ref, p0, ref_at,
                                                    UPDATE)
                        for name, (side, ref_at) in sides.items()}
    return out, extra
