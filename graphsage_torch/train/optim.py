"""SGD with per-model global-norm gradient clipping.

Port of ``graphsage_tpu/train/optim.py``.  Reference: plain
``torch.optim.SGD`` (lr 0.7 joint / 0.5 classifier-only, src/utils.py:136,
82) after ``clip_grad_norm_(model.parameters(), 5)`` applied **per model**
(src/utils.py:185-186, 106).  Parameters are pytrees (nested dicts and
lists) of leaf tensors; the scale stays on the device (no host sync).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from graphsage_torch.parallel.comm import mean_over_ranks, sum_over_ranks
from graphsage_torch.parallel.mesh import Mesh, map_with_paths, sharded_dim
from graphsage_torch.utils.obs import span


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> list[torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics: every gradient times
    min(1, max_norm / (norm + 1e-6)); ``norm`` defaults to
    ``global_norm(grads)``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


def apply_gradients(params: dict, loss: torch.Tensor, models, lr: float,
                    clip_norm: float, reduce=None, norms=None) -> None:
    """Backward of ``loss``, then per-model clip (reference
    src/utils.py:185-186) and SGD, in place.  ``params`` maps each name in
    ``models`` to a pytree of leaf tensors; a model the loss does not reach
    gets a zero gradient (its params stay).  ``reduce`` maps the list of
    gradients before the clip (the distributed steps' mean over ranks);
    ``norms`` maps {model: its gradients} to {model: the norm its clip
    uses} (by default each model's :func:`global_norm`).  The backward and
    the clip with SGD are the spans ``step.backward`` and
    ``step.optimizer`` (``utils/obs.py``)."""
    leaves = {k: tree_leaves(params[k]) for k in models}
    flat = [p for k in models for p in leaves[k]]
    with span("step.backward"):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
    if reduce is not None:
        grads = reduce(grads)
    with span("step.optimizer"):
        split, at = {}, 0
        for k in models:
            split[k] = grads[at:at + len(leaves[k])]
            at += len(leaves[k])
        norm = {} if norms is None else norms(split)
        for k in models:
            sgd_update(leaves[k], clip_by_global_norm(split[k], clip_norm,
                                                      norm.get(k)), lr)


def apply_gradients_mean(params: dict, loss: torch.Tensor, lr: float,
                         clip_norm: float, group=None, norms=None,
                         then=None) -> torch.Tensor:
    """The distributed steps' update (JAX's ``pmean`` of the loss inside the
    differentiated function): the local backward of this rank's ``loss``,
    the mean over ranks of the float32 gradients, then the per-model clip
    and SGD of :func:`apply_gradients` on the replicated params (``norms``
    as there; ``then`` maps the list of averaged gradients before the
    clip).  Returns the mean of the ranks' losses (a device scalar), which
    the same all-reduce carries."""
    out = {}

    def reduce(grads):
        *grads, out["loss"] = mean_over_ranks(grads + [loss.detach()], group)
        return grads if then is None else then(grads)

    apply_gradients(params, loss, ("sage", "clf"), lr, clip_norm,
                    reduce=reduce, norms=norms)
    return out["loss"]


def apply_gradients_sharded(params: dict, loss: torch.Tensor, lr: float,
                            clip_norm: float, mesh: Mesh) -> torch.Tensor:
    """The tensor-parallel step's update (JAX's step under GSPMD, with
    ``parallel.mesh.shard_params``' placement): :func:`apply_gradients_mean`
    over the data group, whose per-model clip takes the global norm over
    the model group: the squares of every sharded leaf summed there (one
    all-reduce for both models), each replicated leaf counted once.
    Returns the mean of the data ranks' losses (a device scalar).

    A replicated leaf's gradient must be whole on every model rank before
    the clip.  The classifier bias's is (it is taken after the partial
    logits are summed).  A replicated SageLayer leaf (an LSTM cell under
    ``params["sage"]["agg"]``) feeds every model rank's slice of its
    layer, so each rank's gradient holds its slice's share: those are
    summed over the model group (one all-reduce of their concatenation,
    after the mean over the data group), as GSPMD sums them for JAX."""
    models = ("sage", "clf")
    placed = {k: tree_leaves(map_with_paths(
        lambda path, leaf: sharded_dim(path, leaf) is not None, params[k],
        (k,))) for k in models}
    # the gradients' order is apply_gradients': sage's leaves, then clf's
    shares = [not s for s in placed["sage"]] + [False] * len(placed["clf"])

    def sum_shares(grads):
        picked = [g for g, share in zip(grads, shares) if share]
        if not picked:
            return grads
        summed = iter(sum_over_ranks(picked, mesh.model_group))
        return [next(summed) if share else g
                for g, share in zip(grads, shares)]

    def norms(split):
        # the sharded leaves' squares first, summed over the model group,
        # then the replicated ones': the order of global_norm's sum where
        # the sharded leaves come first (at n_model 1 the same bits)
        squares = torch.stack([
            sum(g.float().square().sum()
                for g, s in zip(split[k], placed[k]) if s)
            + torch.zeros((), device=loss.device) for k in models])
        dist.all_reduce(squares, op=dist.ReduceOp.SUM,
                        group=mesh.model_group)
        return {k: torch.sqrt(squares[i] + sum(
            g.float().square().sum() for g, s in zip(split[k], placed[k])
            if not s)) for i, k in enumerate(models)}

    return apply_gradients_mean(params, loss, lr, clip_norm, mesh.data_group,
                                norms=norms, then=sum_shares)


@torch.no_grad()
def sgd_update(params: list[torch.Tensor], grads: list[torch.Tensor],
               lr: float) -> None:
    """p <- p - lr * g, in place (the product rounded first, as the JAX
    package's ``p - lr * g``)."""
    for p, g in zip(params, grads):
        p.sub_(lr * g)
