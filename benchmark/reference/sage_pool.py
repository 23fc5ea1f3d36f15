"""Plain PyTorch GraphSAGE-pool: the reference the pool cells and the port's
POOL tests are held to.

Written from the model's description (Hamilton et al. 2017, section 3.3,
Eq. 3; the authors' ``graphsage/aggregators.py`` ``MaxPoolingAggregator``),
with no code of the program.  Layer ``l`` of a node ``v`` with neighbours
N(v):

    z_u  = relu(W_pool,l h_u + b_l)               for every neighbour u
    a_v  = elementwise max over u in N(v) of z_u  (0 where N(v) is empty)
    h'_v = relu(W_l [h_v || a_v])                 (no bias)

computed plainly: the MLP over every row of the previous layer's matrix (a
neighbour's z is the same in every slot that holds it), a gather of all S
slots of z, then ``torch.amax``, whose gradient splits a tie equally among
the tied slots.  The sage layer, the classifier, the losses and the
per-model clip and SGD are those of ``reference.sage``.

Everything runs in float32 (TF32 off) unless a :class:`Precision` of
``reference.precision`` says otherwise, and in row blocks where a table is
large.  Parameters: ``{"sage": {"layers": [{"weight": [H, D + P]}], "pool":
[{"weight": [P, D], "bias": [P]}]}, "clf": {"weight", "bias"}}``.  Nothing
here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import sage
from benchmark.reference.precision import EXACT, Precision


def pool_rows(pool: dict, h: torch.Tensor, p: Precision,
              block: int = 65536) -> torch.Tensor:
    """z [M, P]: the pool MLP relu(h W_pool^T + b) of every row of ``h``,
    in row blocks, stored in ``p``'s table precision."""
    z = torch.cat([torch.relu(p.mm(h[lo:lo + block], pool["weight"].T)
                              + pool["bias"])
                   for lo in range(0, h.shape[0], block)])
    return p.table(z)


def slot_max(z: torch.Tensor, idx: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """a [U, P]: the rows of ``z`` at every slot of ``idx`` [U, S], their
    elementwise max over the slots where ``valid`` holds (0 for a row with
    none)."""
    g = z[idx.long()]                                        # [U, S, P]
    g = g.masked_fill(~valid[..., None], float("-inf")).amax(1)
    return torch.where(valid.any(1, keepdim=True), g,
                       torch.zeros((), device=g.device))


def full_graph(params: dict, x: torch.Tensor, neighbors: torch.Tensor,
               degrees: torch.Tensor, p: Precision = EXACT,
               block: int = 8192) -> torch.Tensor:
    """Every node through every layer over the whole (width-capped)
    neighbour table, no sampling: [N, H].  A node never aggregates itself
    (self-loop slots are left out)."""
    n, width = neighbors.shape
    slot = torch.arange(width, device=neighbors.device)
    h = p.table(x)
    sage_p = params["sage"]
    for lyr, pool in zip(sage_p["layers"], sage_p["pool"]):
        z = pool_rows(pool, h, p)
        out = []
        for lo in range(0, n, block):
            rows = torch.arange(lo, min(lo + block, n), device=x.device)
            nb = neighbors[lo:lo + block]
            keep = ((slot[None, :] < degrees[lo:lo + block, None])
                    & (nb.long() != rows[:, None]))
            out.append(p.table(sage.layer(lyr["weight"], h[lo:lo + block],
                                          slot_max(z, nb, keep), p)))
        del z
        h = torch.cat(out)
    return h


def encode(sage_p: dict, h: torch.Tensor, frontiers,
           p: Precision = EXACT) -> torch.Tensor:
    """The encoder over bottom-up frontiers [(idx, mask, self_idx)]: ``h``
    the rows of the deepest level, the top level's rows returned."""
    for lyr, pool, (idx, mask, self_idx) in zip(
            sage_p["layers"], sage_p["pool"], frontiers):
        agg = slot_max(pool_rows(pool, h, p), idx, mask > 0)
        h = p.table(sage.layer(lyr["weight"], h[self_idx.long()], agg, p))
    return h


def compact_loss(params: dict, x: torch.Tensor, step: dict,
                 learn_method: str, margin: float,
                 p: Precision) -> torch.Tensor:
    """The loss of one compact batch: ``step`` holds x0_ids, the bottom-up
    frontiers [(idx, mask, self_idx)], labels and row_mask over the top
    rows, and the pair tables (``reference.sage.compact_loss``'s)."""
    h = encode(params["sage"], p.table(x)[step["x0_ids"].long()],
               step["frontiers"], p)
    loss = torch.zeros((), device=h.device)
    if learn_method != "unsup":
        loss = loss + sage.nll(sage.log_probs(params["clf"], h, p),
                               step["labels"], step["row_mask"])
    if learn_method != "sup":
        loss = loss + sage.margin_loss(h, step["pairs"], margin)
    return loss


def leaves(params: dict) -> dict[str, list[torch.Tensor]]:
    """Each model's leaves in a fixed order: the encoder's layer weights,
    then each layer's pool weight and bias; the classifier's weight and
    bias."""
    sage_p = params["sage"]
    pool = [t for q in sage_p["pool"] for t in (q["weight"], q["bias"])]
    return {"sage": [lyr["weight"] for lyr in sage_p["layers"]] + pool,
            "clf": [params["clf"]["weight"], params["clf"]["bias"]]}


def flat(params: dict) -> list[torch.Tensor]:
    return [t for g in leaves(params).values() for t in g]


def unflat(tensors: list[torch.Tensor]) -> dict:
    """The params of :func:`flat`'s list: L layer weights, L (pool weight,
    pool bias) pairs, then the classifier's weight and bias."""
    n = (len(tensors) - 2) // 3
    pool = tensors[n:3 * n]
    return {"sage": {"layers": [{"weight": w} for w in tensors[:n]],
                     "pool": [{"weight": pool[2 * i], "bias": pool[2 * i + 1]}
                              for i in range(n)]},
            "clf": {"weight": tensors[-2], "bias": tensors[-1]}}


@torch.no_grad()
def losses_at(states: list[list[torch.Tensor]], losses) -> list[float]:
    """Each loss function of ``losses`` at the params of the matching
    flattened state."""
    return [float(fn(unflat(s))) for s, fn in zip(states, losses)]


def sgd(params: dict, losses, lr: float, clip: float) -> dict:
    """``reference.sage.sgd`` over this layout: one update per loss
    function of ``losses``, each model's gradient clipped to global norm
    ``clip``, then SGD; ``params`` are not changed.  Returns {"losses",
    "grad1" (the first update's clipped gradients), "params" [after each
    step]}, leaves flattened as :func:`leaves`."""
    cur = unflat([t.detach().clone() for t in flat(params)])
    out = {"losses": [], "grad1": None, "params": []}
    for fn in losses:
        groups = leaves(cur)
        tensors = [t for g in groups.values() for t in g]
        for t in tensors:
            t.requires_grad_(True)
        loss = fn(cur)
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
