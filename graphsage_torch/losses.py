"""Training objectives, port of ``graphsage_tpu/losses.py``.

Reference semantics:
- supervised: hand-picked NLL over log_softmax outputs,
  ``-sum logp[range, labels] / len(batch)`` (src/utils.py:161-163);
- unsup "normal": per target node, mean over its positive pairs of
  -log sigmoid(cos) plus -Q * mean over its negative pairs of
  log sigmoid(-cos), averaged over nodes with both kinds of pairs
  (src/models.py:65-98);
- unsup "margin": per node, relu(max_neg - min_pos + MARGIN) on
  log sigmoid(cos) scores (src/models.py:100-132);
- plus_unsup: supervised + unsup summed (src/utils.py:165-175).

Variable-size pair sets are masked fixed-shape tensors (``PairBatch``);
means, mins and maxes run under the masks, and nodes lacking a positive or
a negative pair are left out as the reference's ``continue`` does.
Reductions run in float32 whatever the embedding dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphsage_torch.ops.aggregate import pair_cosine
from graphsage_torch.ops.sddmm import pair_loss_scores


def supervised_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                   row_mask: torch.Tensor) -> torch.Tensor:
    """-mean over valid rows of log_probs[i, labels[i]]; the divisor is the
    number of real batch rows.  log_probs [U, C], labels [U] int, row_mask
    [U] float.  A one-hot pick, as the JAX package takes it."""
    onehot = (labels[:, None].long()
              == torch.arange(log_probs.shape[1], device=labels.device))
    picked = torch.where(onehot, log_probs,
                         torch.zeros((), dtype=log_probs.dtype,
                                     device=log_probs.device))
    picked = picked.sum(dim=1).float()
    row_mask = row_mask.float()
    total = -(picked * row_mask).sum()
    return total / row_mask.sum().clamp_min(1.0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int):
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim).clamp_min(1.0)


def _unsup_loss_from_cosines(pos_cos, pos_mask, neg_cos, neg_mask,
                             node_valid, kind: str, q: float,
                             margin: float) -> torch.Tensor:
    """Per-node reductions over pair cosine scores, averaged over the nodes
    with at least one valid positive and one valid negative pair."""
    pos_cos = pos_cos.float()
    neg_cos = neg_cos.float()
    pos_mask = pos_mask.float()
    neg_mask = neg_mask.float()
    node_valid = node_valid.float()
    if kind == "normal":
        pos_term = _masked_mean(-F.logsigmoid(pos_cos), pos_mask, 1)
        neg_term = q * _masked_mean(F.logsigmoid(-neg_cos), neg_mask, 1)
        per_node = pos_term - neg_term
    elif kind == "margin":
        # Python scalars: a tensor made from one on the card would be a
        # host-to-device copy, which waits for the device
        pos_s = F.logsigmoid(pos_cos)
        neg_s = F.logsigmoid(neg_cos)
        pos_min = torch.where(pos_mask > 0, pos_s, 1e30).amin(dim=1)
        neg_max = torch.where(neg_mask > 0, neg_s, -1e30).amax(dim=1)
        per_node = torch.relu(neg_max - pos_min + margin)
    else:
        raise ValueError("unsup_loss can be only 'margin' or 'normal'.")
    return (per_node * node_valid).sum() / node_valid.sum().clamp_min(1.0)


def unsup_loss_normal(embeddings, pos_p, pos_q, pos_mask, neg_p, neg_q,
                      neg_mask, node_valid, q: float = 10.0) -> torch.Tensor:
    """Negative-sampling objective (reference src/models.py:65-98)."""
    pos_cos = pair_cosine(embeddings, pos_p, pos_q)
    neg_cos = pair_cosine(embeddings, neg_p, neg_q)
    return _unsup_loss_from_cosines(pos_cos, pos_mask, neg_cos, neg_mask,
                                    node_valid, "normal", q, 0.0)


def unsup_loss_margin(embeddings, pos_p, pos_q, pos_mask, neg_p, neg_q,
                      neg_mask, node_valid,
                      margin: float = 3.0) -> torch.Tensor:
    """Hinge objective (reference src/models.py:100-132)."""
    pos_cos = pair_cosine(embeddings, pos_p, pos_q)
    neg_cos = pair_cosine(embeddings, neg_p, neg_q)
    return _unsup_loss_from_cosines(pos_cos, pos_mask, neg_cos, neg_mask,
                                    node_valid, "margin", 0.0, margin)


def unsup_loss_from_pairbatch(embeddings: torch.Tensor, pb_tensors: dict,
                              kind: str, q: float = 10.0,
                              margin: float = 3.0) -> torch.Tensor:
    """Dispatch over a PairBatch's fields as tensors (reference dispatch
    src/utils.py:177-181).  With ``target_rows`` present the pair scores
    come from ``ops.sddmm.pair_loss_scores`` (the score block, or the
    gathered form for large batches); without it, from explicit
    ``pos_p``/``neg_p`` index tensors."""
    target_rows = pb_tensors.get("target_rows")
    if target_rows is not None:
        pos_cos, neg_cos = pair_loss_scores(
            embeddings, target_rows, pb_tensors["pos_q"],
            pb_tensors["neg_q"])
        return _unsup_loss_from_cosines(
            pos_cos, pb_tensors["pos_mask"], neg_cos,
            pb_tensors["neg_mask"], pb_tensors["node_valid"], kind, q,
            margin)

    args = (embeddings, pb_tensors["pos_p"], pb_tensors["pos_q"],
            pb_tensors["pos_mask"], pb_tensors["neg_p"], pb_tensors["neg_q"],
            pb_tensors["neg_mask"], pb_tensors["node_valid"])
    if kind == "normal":
        return unsup_loss_normal(*args, q=q)
    if kind == "margin":
        return unsup_loss_margin(*args, margin=margin)
    raise ValueError("unsup_loss can be only 'margin' or 'normal'.")
