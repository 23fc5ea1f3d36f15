"""SGD with per-model global-norm gradient clipping.

Port of ``graphsage_tpu/train/optim.py``.  Reference: plain
``torch.optim.SGD`` (lr 0.7 joint / 0.5 classifier-only, src/utils.py:136,
82) after ``clip_grad_norm_(model.parameters(), 5)`` applied **per model**
(src/utils.py:185-186, 106).  Parameters are pytrees (nested dicts and
lists) of leaf tensors; the scale stays on the device (no host sync).
"""

from __future__ import annotations

import torch

from graphsage_torch.parallel.comm import mean_over_ranks


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics: every gradient times
    min(1, max_norm / (norm + 1e-6))."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-6), max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


def apply_gradients(params: dict, loss: torch.Tensor, models, lr: float,
                    clip_norm: float, reduce=None) -> None:
    """Backward of ``loss``, then per-model clip (reference
    src/utils.py:185-186) and SGD, in place.  ``params`` maps each name in
    ``models`` to a pytree of leaf tensors; a model the loss does not reach
    gets a zero gradient (its params stay).  ``reduce`` maps the list of
    gradients before the clip (the distributed steps' mean over ranks)."""
    leaves = {k: tree_leaves(params[k]) for k in models}
    flat = [p for k in models for p in leaves[k]]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    if reduce is not None:
        grads = reduce(grads)
    at = 0
    for k in models:
        n = len(leaves[k])
        sgd_update(leaves[k], clip_by_global_norm(grads[at:at + n],
                                                  clip_norm), lr)
        at += n


def apply_gradients_mean(params: dict, loss: torch.Tensor, lr: float,
                         clip_norm: float, group=None) -> torch.Tensor:
    """The distributed steps' update (JAX's ``pmean`` of the loss inside the
    differentiated function): the local backward of this rank's ``loss``,
    the mean over ranks of the float32 gradients, then the per-model clip
    and SGD of :func:`apply_gradients` on the replicated params.  Returns
    the mean of the ranks' losses (a device scalar), which the same
    all-reduce carries."""
    out = {}

    def reduce(grads):
        *grads, out["loss"] = mean_over_ranks(grads + [loss.detach()], group)
        return grads

    apply_gradients(params, loss, ("sage", "clf"), lr, clip_norm,
                    reduce=reduce)
    return out["loss"]


@torch.no_grad()
def sgd_update(params: list[torch.Tensor], grads: list[torch.Tensor],
               lr: float) -> None:
    """p <- p - lr * g, in place (the product rounded first, as the JAX
    package's ``p - lr * g``)."""
    for p, g in zip(params, grads):
        p.sub_(lr * g)
