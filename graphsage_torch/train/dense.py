"""The dense training pipeline: sampling, encode, loss, backward, clip and
SGD for a batch of node ids, all on the device.

Port of ``graphsage_tpu/train/dense.py``.  Per step the batch is expanded
into dense per-occurrence frontiers ([B] -> [B·(K+1)] -> ...) by the device
sampler (``sampler/device.py``), encoded from the full feature table with
``graphsage_apply_gathered`` (layer 1 transforms the table once when it has
no more than twice the frontier's rows, then every MEAN aggregate is the
``gather_mean`` kernel with its scatter-add backward), and trained with the
per-model clip and SGD of the other pipelines.  Parameters are leaf tensors
updated in place (the JAX package returns new pytrees).

Sampling goes through a hop sampler, as in the cached pipeline: on the card
``HopSampler`` draws from a ``torch.Generator``; the tests hand in a hop
that replays the JAX package's draws.  The JAX package's ``lax.scan`` epoch
is a Python loop of steps here (``make_dense_sup_epoch``) that keeps the
losses on the device: no host synchronisation inside.

Mixed precision (``compute_dtype="bfloat16"``): ``cast_compute`` rounds the
float32 master params and the feature table to bfloat16 inside the
differentiated function, so every product takes bfloat16 operands with
float32 accumulation and the gradients come back through the cast as
float32 (the contract of every bfloat16 training path in the port).

Tensor parallelism (``make_dense_sup_step(mesh=...)``): the JAX package
runs this step under GSPMD with ``parallel/mesh.py``'s placement (its
``dryrun_multichip``); the port runs it a process a rank over
``graphsage_torch.parallel.mesh``.  Every rank draws the global batch's
hops, so the step sees the single-device step's samples, keeps its data
rank's block, computes its model rank's column slice of each layer
(``comm.all_gather_cols`` joins the slices before the next layer) and its
partial logits (``comm.sum_partials`` sums them over the model group
before the bias), and updates its slices
(``optim.apply_gradients_sharded``).

The JAX package's dense pipeline is a library API: its CLI has no
``--pipeline dense``, and neither has the port's.
"""

from __future__ import annotations

import functools

import torch

from graphsage_torch.convert import _tree_map
from graphsage_torch.losses import supervised_nll, unsup_loss_from_pairbatch
from graphsage_torch.models.graphsage import (Frontier, GraphSageConfig,
                                              compute_dtype,
                                              graphsage_apply_gathered,
                                              refuse_pool)
from graphsage_torch.models.layers import classifier_apply
from graphsage_torch.parallel import comm
from graphsage_torch.parallel.mesh import Mesh, batch_rows
from graphsage_torch.sampler.device import sample_frontiers_dense
from graphsage_torch.train.optim import apply_gradients, apply_gradients_sharded


def cast_compute(tree, mcfg: GraphSageConfig):
    """Round the float32 leaves of ``tree`` (a tensor or a pytree of them)
    to the config's compute dtype; other leaves, and everything under
    float32 compute, pass unchanged (``graphsage_tpu/train/dense.py:34``).
    The cast is differentiable, so applied inside the loss the master
    params keep float32 gradients."""
    dtype = compute_dtype(mcfg)
    if dtype == torch.float32:
        return tree
    return _tree_map(
        lambda x: x.to(dtype) if x.dtype == torch.float32 else x, tree)


def dense_forward(params: dict, mcfg: GraphSageConfig, feats: torch.Tensor,
                  hop, batch: torch.Tensor, fanout: int = 10,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """Sampling and encode for a batch of node ids: [B] -> [B, out_size] in
    the compute dtype.  ``hop`` draws one hop a layer, top-down.

    With ``mesh`` (the tensor-parallel step) the hops are the global
    batch's, the encode runs on this data rank's block of them and yields
    this model rank's [B / n_data, out_size / n_model] column slice, the
    layers' slices joined by ``comm.all_gather_cols``."""
    x0_ids, frontiers = sample_frontiers_dense(
        hop, batch, num_layers=mcfg.num_layers, fanout=fanout, gcn=mcfg.gcn)
    join = u0 = None
    if mesh is not None:
        u0 = x0_ids.shape[0]
        x0_ids, frontiers = _block_of(x0_ids, frontiers, mesh)
        join = functools.partial(comm.all_gather_cols,
                                 group=mesh.model_group)
    params = cast_compute(params, mcfg)
    feats = cast_compute(feats, mcfg)
    return graphsage_apply_gathered(params["sage"], mcfg, feats, x0_ids,
                                    frontiers, join=join, u0=u0)


def make_dense_sup_step(mcfg: GraphSageConfig, fanout: int = 10,
                        lr: float = 0.7, clip: float = 5.0,
                        mesh: Mesh | None = None):
    """Supervised step: ``step(params, feats, hop, batch, labels) -> loss``
    (a float32 device scalar, not synchronised), the params updated in
    place.

    With ``mesh`` it is one rank's step of the data- and tensor-parallel
    step: ``params`` are the rank's ``parallel.mesh.shard_params``,
    ``batch`` and ``labels`` the global batch (the same on every rank, its
    size a multiple of n_data), ``hop`` seeded alike on every rank; the
    loss returned is the mean over the data ranks, the global batch's
    mean NLL.  The replicated LSTM cells' gradient shares are summed over
    the model group (``optim.apply_gradients_sharded``)."""
    refuse_pool(mcfg, "the dense pipeline")
    partial_sum = None
    if mesh is not None:
        partial_sum = functools.partial(comm.sum_partials,
                                        group=mesh.model_group)

    def step(params, feats, hop, batch, labels):
        if mesh is not None:
            labels = batch_rows(labels, mesh)
        embs = dense_forward(params, mcfg, feats, hop, batch, fanout, mesh)
        logp = classifier_apply(cast_compute(params["clf"], mcfg), embs,
                                partial_sum)
        mask = torch.ones(labels.shape[0], device=embs.device)
        loss = supervised_nll(logp, labels, mask)
        if mesh is not None:
            return apply_gradients_sharded(params, loss, lr, clip, mesh)
        apply_gradients(params, loss, ("sage", "clf"), lr, clip)
        return loss.detach()

    return step


def _block_of(x0_ids: torch.Tensor, frontiers: list, mesh: Mesh):
    """This data rank's block of the global batch's dense frontiers: the
    same rows of every depth (``mesh.batch_rows``), each frontier's slot
    and self indices re-based onto the block's first row."""
    out = []
    for f in frontiers:
        base = batch_rows(f.self_idx, mesh)
        out.append(Frontier(idx=batch_rows(f.idx, mesh) - base[:1],
                            mask=batch_rows(f.mask, mesh),
                            self_idx=base - base[:1]))
    return batch_rows(x0_ids, mesh), out


def make_dense_unsup_step(mcfg: GraphSageConfig, unsup_loss: str = "normal",
                          fanout: int = 10, lr: float = 0.7,
                          clip: float = 5.0, learn_method: str = "unsup",
                          q: float = 10.0, margin: float = 3.0):
    """Unsupervised / plus_unsup step: ``step(params, feats, hop, batch,
    labels, pairs, row_mask=None) -> loss``, the params updated in place.

    ``batch`` is the extended batch (the pair endpoints' union, reference
    src/models.py:135-148) and ``pairs`` the PairBatch tensors indexing
    into it.  ``row_mask`` marks the real rows of a bucket-padded batch
    (``PairBatch.unique_nodes`` pads with node 0), so that plus_unsup's NLL
    leaves the padding out; pass ``arange(U_pad) < pb.num_unique``, as the
    trainers do."""
    refuse_pool(mcfg, "the dense pipeline")
    def step(params, feats, hop, batch, labels, pairs, row_mask=None):
        embs = dense_forward(params, mcfg, feats, hop, batch, fanout)
        loss = unsup_loss_from_pairbatch(embs, pairs, unsup_loss, q=q,
                                         margin=margin)
        if learn_method == "plus_unsup":
            logp = classifier_apply(cast_compute(params["clf"], mcfg), embs)
            mask = (torch.ones(batch.shape[0], device=embs.device)
                    if row_mask is None else row_mask)
            loss = loss + supervised_nll(logp, labels, mask)
        apply_gradients(params, loss, ("sage", "clf"), lr, clip)
        return loss.detach()

    return step


def make_dense_sup_epoch(mcfg: GraphSageConfig, fanout: int = 10,
                         lr: float = 0.7, clip: float = 5.0):
    """The multi-step loop: ``epoch(params, feats, hop, batches [T, B],
    labels [T, B]) -> losses [T]`` on the device, one supervised step a row
    and no host synchronisation inside.  Each step draws its own hops from
    ``hop``, as JAX's scan takes a fresh subkey a step."""
    step = make_dense_sup_step(mcfg, fanout=fanout, lr=lr, clip=clip)

    def epoch(params, feats, hop, batches, labels):
        return torch.stack([step(params, feats, hop, batches[t], labels[t])
                            for t in range(batches.shape[0])])

    return epoch


def edges_per_batch(batch_size: int, num_layers: int, fanout: int) -> int:
    """Aggregation edges of one dense batch: a frontier node at depth d
    aggregates at most ``fanout`` neighbours and the frontier at depth d has
    B·(fanout+1)^d nodes.  The full-degree count, the unit of the edges/s
    rate."""
    total = 0
    width = batch_size
    for _ in range(num_layers):
        total += width * fanout
        width *= fanout + 1
    return total
