"""The numbers that decide ``correct``, each the gap between what the program
produced and what the reference gives, and the check of each against its
limit.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``leaf_gap``: by the worst leaf, |norm of the program's tensor - norm of
  the reference's| over the larger of the reference leaf's norm and the
  median leaf's (some gradients are all but zero).
- ``leaf_diff``: by the worst leaf, the norm of the difference of the two
  tensors, on the same scale: first-order in an error, where a norm's gap
  is second-order in one that is orthogonal to the tensor.
- ``split_share``: over ways of halving a batch, the largest share of the
  difference of its two halves' gradients that the program's error in the
  first gradient carries: 1 where one half was left out, near 0 for
  rounding, which is all but orthogonal to that difference.
- ``row_gap``: by the worst row, ||program row - reference row|| over the
  larger of the reference row's norm and the median row's.
- counts of broken draws or mismatches, whose limit is 0.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def norms(tensors) -> list[float]:
    return [float(t.double().norm()) for t in tensors]


def leaf_gap(prog: list[float], ref: list[float],
             keep: list[bool] | None = None) -> float:
    med = statistics.median(ref)
    keep = keep or [True] * len(ref)
    return max(abs(p - r) / max(r, med, 1e-30)
               for p, r, k in zip(prog, ref, keep) if k)


def leaf_diff(prog: list, ref: list) -> float:
    """By the worst leaf, ||program tensor - reference tensor|| over the
    larger of the reference leaf's norm and the median leaf's."""
    ref_norms = norms(ref)
    med = statistics.median(ref_norms)
    return max(d / max(r, med, 1e-30) for d, r in
               zip(norms([a - b for a, b in zip(prog, ref)]), ref_norms))


def split_share(prog: list, ref: list, diffs: list[list]) -> float:
    """max over ``diffs`` d of |<prog - ref, d>| / (||d||^2 / 2), summed over
    the leaves: d the difference of two halves' gradients, which a step
    over one half alone moves the gradient by half of."""
    err = [a.double() - b.double() for a, b in zip(prog, ref)]
    worst = 0.0
    for d in diffs:
        dot = sum(float((e * x.double()).sum()) for e, x in zip(err, d))
        half = sum(float(x.double().square().sum()) for x in d) / 2
        worst = max(worst, abs(dot) / max(half, 1e-300))
    return worst


def moving_leaves(grad_norms: list[float]) -> list[bool]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move by round-off alone and are left out of
    the parameters' change."""
    med = statistics.median(grad_norms)
    return [g >= 1e-3 * med for g in grad_norms]


def row_gap(prog: torch.Tensor, ref: torch.Tensor,
            block: int = 65536) -> float:
    n = ref.shape[0]
    ref_norm = torch.cat([ref[lo:lo + block].float().norm(dim=1)
                          for lo in range(0, n, block)])
    floor = max(float(ref_norm.median()), 1e-30)
    worst = 0.0
    for lo in range(0, n, block):
        diff = (prog[lo:lo + block].float()
                - ref[lo:lo + block].float()).norm(dim=1)
        rel = diff / ref_norm[lo:lo + block].clamp_min(floor)
        worst = max(worst, float(rel.max()))
    return worst


def train_details(side: dict, ref: dict, params0: list,
                  ref_at_side: list[float], update: int) -> dict:
    """The parts the training numbers are the worst of: each step's loss
    gap, each leaf's first-gradient and change gaps, the reference's
    norms."""
    ref_grad = norms(ref["grad1"])

    def change(after):
        return norms([b - a for a, b in zip(params0, after)])

    ref_change = change(ref["params"][update - 1])

    def gaps(side_norms, ref_norms):
        med = statistics.median(ref_norms)
        return [abs(p - r) / max(r, med, 1e-30)
                for p, r in zip(side_norms, ref_norms)]

    return {"loss": [abs(p - r) / max(abs(r), 1e-12)
                     for p, r in zip(side["losses"], ref_at_side)],
            "grad1": gaps(norms(side["grad1"]), ref_grad),
            "change": gaps(change(side["params"][update - 1]), ref_change),
            "ref_grad1": ref_grad, "ref_change": ref_change}


def train_readings(side: dict, ref: dict, params0: list,
                   ref_at_side: list[float], update: int,
                   diffs: list[list] | None = None) -> dict:
    """The training numbers of one side (the program, or the control or a
    fault put in its place) over the first steps.  ``side`` and ``ref``
    hold "losses", "grad1" (the first update's gradient as the optimizer
    takes it) and "params" (the leaves after each step); each step's loss
    is compared with the reference's loss of the same batch at the side's
    own parameters before that step (``ref_at_side``), the gradient and
    the parameters' change after ``update`` steps with the reference's own
    steps; with ``diffs`` (the first batch's halves' gradient differences)
    also ``grad1_split``."""
    ref_grad = norms(ref["grad1"])

    def change(after):
        return norms([b - a for a, b in zip(params0, after)])

    out = {"loss_gap": loss_gap(side["losses"], ref_at_side),
           "grad1_gap": leaf_gap(norms(side["grad1"]), ref_grad),
           "grad1_diff": leaf_diff(side["grad1"], ref["grad1"]),
           "update_gap": leaf_gap(change(side["params"][update - 1]),
                                  change(ref["params"][update - 1]),
                                  moving_leaves(ref_grad))}
    if diffs is not None:
        out["grad1_split"] = split_share(side["grad1"], ref["grad1"], diffs)
    return out


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(readings: dict[str, float], limits: dict[str, float]) -> list[Check]:
    """Each reading beside its limit; a reading with no limit yet (a cell
    being calibrated) is held to 0 and so reads as failed."""
    return [Check(name, float(value), float(limits.get(name, 0.0)))
            for name, value in readings.items()]
