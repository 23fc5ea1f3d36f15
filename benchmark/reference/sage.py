"""Plain PyTorch GraphSAGE: the reference every cell's output is held to.

Written from the model's description (Hamilton et al. 2017; the reference
implementation's ``src/models.py`` and ``src/utils.py``), with no code of
the program: a layer is relu([self || aggregate] x W^T) with no bias, MEAN
averages the valid neighbours (0 where there is none), MAX takes their
elementwise maximum (0 where there is none) and splits a gradient equally
among tied maxima (``torch.amax``); the classifier is log_softmax of a
biased linear map; the supervised loss is the mean negative log-likelihood
over the batch's real rows; the margin loss of a target is relu(max over its
negatives of log sigmoid(cos) - min over its positives of the same + margin),
averaged over the targets that have both; plus_unsup adds the two; the
update clips each model's gradient (encoder, classifier) to global norm
``clip`` and takes an SGD step.

Everything runs in float32 (TF32 off) unless a :class:`Precision` of
``reference.precision`` says otherwise, and in row blocks where a table is
large.  Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Precision

_EPS = 1e-8


def aggregate(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
              agg: str) -> torch.Tensor:
    """Rows of ``x`` at ``idx`` [U, S] reduced over the slots where
    ``valid`` [U, S] holds: the mean, or the elementwise maximum."""
    g = x[idx.long()]
    if agg == "MEAN":
        w = valid.to(g.dtype)[..., None]
        return (g * w).sum(1) / w.sum(1).clamp_min(1.0)
    if agg == "MAX":
        g = g.masked_fill(~valid[..., None], float("-inf")).amax(1)
        return torch.where(valid.any(1, keepdim=True), g,
                           torch.zeros((), device=g.device))
    raise ValueError(agg)


def layer(w: torch.Tensor, self_h: torch.Tensor, agg_h: torch.Tensor,
          p: Precision) -> torch.Tensor:
    return torch.relu(p.mm(torch.cat([self_h, agg_h], -1), w.T))


def log_probs(clf: dict, emb: torch.Tensor, p: Precision) -> torch.Tensor:
    return torch.log_softmax(p.mm(emb, clf["weight"].T) + clf["bias"], -1)


def nll(logp: torch.Tensor, labels: torch.Tensor,
        row_mask: torch.Tensor) -> torch.Tensor:
    picked = logp.gather(1, labels.long()[:, None])[:, 0]
    return -(picked * row_mask).sum() / row_mask.sum().clamp_min(1.0)


def _cos(emb: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ea, eb = emb[a.long()], emb[b.long()]
    na = ea.norm(dim=-1).clamp_min(_EPS)
    nb = eb.norm(dim=-1).clamp_min(_EPS)
    return (ea * eb).sum(-1) / (na * nb)


def margin_loss(emb: torch.Tensor, pairs: dict, margin: float) -> torch.Tensor:
    """``pairs``: target_rows [B], pos_q / neg_q [B, P] rows of ``emb``,
    pos_mask / neg_mask [B, P] and node_valid [B] weights."""
    t = pairs["target_rows"][:, None]
    pos = F.logsigmoid(_cos(emb, t.expand_as(pairs["pos_q"]),
                            pairs["pos_q"]))
    neg = F.logsigmoid(_cos(emb, t.expand_as(pairs["neg_q"]),
                            pairs["neg_q"]))
    pos_min = pos.masked_fill(pairs["pos_mask"] <= 0, float("inf")).amin(1)
    neg_max = neg.masked_fill(pairs["neg_mask"] <= 0, float("-inf")).amax(1)
    valid = pairs["node_valid"] > 0
    per_node = torch.relu(torch.where(valid, neg_max - pos_min + margin,
                                      torch.zeros_like(pos_min)))
    return per_node.sum() / valid.sum().clamp_min(1)


# ------------------------------------------------------------------ tables
def leaf_cache(x: torch.Tensor, samples: torch.Tensor, valid: torch.Tensor,
               agg: str, p: Precision = EXACT,
               block: int = 32768) -> torch.Tensor:
    """The leaf cache of every node: its features aggregated over one draw
    of neighbours (``samples`` [N, K], ``valid`` [N, K]), self draws left
    out, stored in ``p``'s table precision."""
    x = p.table(x)
    n = samples.shape[0]
    out = []
    for lo in range(0, n, block):
        rows = torch.arange(lo, min(lo + block, n), device=x.device)
        s = samples[lo:lo + block].long()
        keep = valid[lo:lo + block] & (s != rows[:, None])
        out.append(aggregate(x, s, keep, agg))
    return p.table(torch.cat(out))


def full_graph(params: dict, x: torch.Tensor, neighbors: torch.Tensor,
               degrees: torch.Tensor, agg: str, p: Precision = EXACT,
               block: int = 16384) -> torch.Tensor:
    """Every node through every layer over the whole (width-capped)
    neighbour table, no sampling: [N, H]."""
    n, width = neighbors.shape
    slot = torch.arange(width, device=neighbors.device)
    h = p.table(x)
    for w in (lyr["weight"] for lyr in params["sage"]["layers"]):
        out = []
        for lo in range(0, n, block):
            rows = torch.arange(lo, min(lo + block, n), device=x.device)
            nb = neighbors[lo:lo + block].long()
            keep = ((slot[None, :] < degrees[lo:lo + block, None])
                    & (nb != rows[:, None]))
            out.append(p.table(layer(w, h[lo:lo + block],
                                     aggregate(h, nb, keep, agg), p)))
        h = torch.cat(out)
    return h


# ------------------------------------------------------------------- steps
def cached_sup_loss(params: dict, x: torch.Tensor, cache: torch.Tensor,
                    step: dict, p: Precision) -> torch.Tensor:
    """The supervised loss of a batch whose layer-1 rows take the leaf
    cache: ``step`` holds batch [B], samples / valid [B, K] (the batch's
    one-hop draw), labels [B] and row_mask [B]."""
    sage, batch = params["sage"]["layers"], step["batch"].long()
    samples = step["samples"].long()
    ids = torch.cat([batch[:, None], samples], 1)            # [B, K + 1]
    b, k1 = ids.shape
    xs, cs = p.table(x)[ids], cache[ids]
    h1 = p.table(layer(sage[0]["weight"], xs.reshape(b * k1, -1),
                       cs.reshape(b * k1, -1), p)).reshape(b, k1, -1)
    keep = step["valid"] & (samples != batch[:, None])
    w = keep.to(h1.dtype)[..., None]
    agg = (h1[:, 1:] * w).sum(1) / w.sum(1).clamp_min(1.0)
    h2 = p.table(layer(sage[1]["weight"], h1[:, 0], agg, p))
    return nll(log_probs(params["clf"], h2, p), step["labels"],
               step["row_mask"])


def compact_loss(params: dict, x: torch.Tensor, step: dict, agg: str,
                 learn_method: str, margin: float,
                 p: Precision) -> torch.Tensor:
    """The loss of one compact batch: ``step`` holds x0_ids, the bottom-up
    frontiers [(idx, mask, self_idx)], labels and row_mask over the top
    rows, and the pair tables."""
    h = p.table(x)[step["x0_ids"].long()]
    for w, (idx, mask, self_idx) in zip(
            (lyr["weight"] for lyr in params["sage"]["layers"]),
            step["frontiers"]):
        h = p.table(layer(w, h[self_idx.long()],
                          aggregate(h, idx, mask > 0, agg), p))
    loss = torch.zeros((), device=h.device)
    if learn_method != "unsup":
        loss = loss + nll(log_probs(params["clf"], h, p), step["labels"],
                          step["row_mask"])
    if learn_method != "sup":
        loss = loss + margin_loss(h, step["pairs"], margin)
    return loss


def leaves(params: dict) -> dict[str, list[torch.Tensor]]:
    """Each model's leaves in a fixed order: the encoder's layer weights,
    then the classifier's weight and bias."""
    return {"sage": [lyr["weight"] for lyr in params["sage"]["layers"]],
            "clf": [params["clf"]["weight"], params["clf"]["bias"]]}


def flat(params: dict) -> list[torch.Tensor]:
    return [t for g in leaves(params).values() for t in g]


def unflat(tensors: list[torch.Tensor]) -> dict:
    """The params of :func:`flat`'s list: L layer weights, then the
    classifier's weight and bias."""
    return {"sage": {"layers": [{"weight": w} for w in tensors[:-2]]},
            "clf": {"weight": tensors[-2], "bias": tensors[-1]}}


@torch.no_grad()
def losses_at(states: list[list[torch.Tensor]], losses) -> list[float]:
    """Each loss function of ``losses`` at the params of the matching
    flattened state."""
    return [float(fn(unflat(s))) for s, fn in zip(states, losses)]


def sgd(params: dict, losses, lr: float, clip: float) -> dict:
    """Drive ``params`` (not changed) through one update per loss function
    of ``losses`` (each maps params to a scalar): per-model clip, SGD.
    Returns {"losses", "grad1" (the first update's clipped gradients),
    "params" [after each step]} with leaves flattened as :func:`leaves`."""
    cur = unflat([t.detach().clone() for t in flat(params)])
    out = {"losses": [], "grad1": None, "params": []}
    for fn in losses:
        groups = leaves(cur)
        for leaf in (t for g in groups.values() for t in g):
            leaf.requires_grad_(True)
        loss = fn(cur)
        tensors = [t for g in groups.values() for t in g]
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(tensors, grads)]
        clipped, at = [], 0
        for g in groups.values():
            part = grads[at:at + len(g)]
            at += len(g)
            norm = torch.sqrt(sum(v.square().sum() for v in part))
            scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
            clipped += [v * scale for v in part]
        with torch.no_grad():
            for t, g in zip(tensors, clipped):
                t.requires_grad_(False)
                t.sub_(lr * g)
        out["losses"].append(float(loss.detach()))
        if out["grad1"] is None:
            out["grad1"] = [g.detach() for g in clipped]
        out["params"].append([t.detach().clone() for t in tensors])
    return out
