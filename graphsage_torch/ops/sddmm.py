"""Pairwise cosine scores for the unsupervised losses.

Port of ``graphsage_tpu/ops/sddmm.py``.  Every pair's left side is one of
the B batch targets, so the scores come as a dense block

    scores[b, u] = cos(emb[target_rows[b]], emb[u])      # [B, U]

from which the losses sample their pairs (``sample_scores``), or, where the
block would be mostly waste, per pair (``gathered_pair_cosines``);
``pair_loss_scores`` chooses by the JAX package's byte model.

- ``dense_pair_scores``: the plain PyTorch block, on any device; the CPU
  path and the reference the kernel is held against on the card.
- ``pair_scores_kernel``: the hand-written CUDA kernel
  (``graphsage_torch/csrc/sddmm.cu``), a CUDA tensor only; its launch plan
  (tiles, copy unit, stage and store width) is ``scores_plan``'s.
- ``PairScores``: the block with the analytic backward of the JAX package's
  ``_pallas_scores_bwd`` (``sddmm.py:63-75``).  Its forward is the kernel on
  a CUDA tensor and the plain version on a CPU tensor.
- ``pair_scores``: the dispatcher (``sddmm.py:81-92``): ``PairScores`` on
  the card, where the JAX package takes its Pallas kernel on the TPU; the
  plain version, differentiated by autograd, elsewhere.

Norms and products run in float32, each norm clamped at ``eps``; the block
comes back in the emb dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from graphsage_torch.ops import build
from graphsage_torch.ops.aggregate import (_DTYPE_CODES, _INT_MAX, LAUNCHES,
                                           widest_unit)

_EPS = 1e-8
_MAX_B = 65535 * 64          # the kernel's grid: 65535 tiles of 64 targets

SMEM_BUDGET = 113 * 1024     # shared memory a block, so that two fit an SM
MAX_STAGE = 256              # widest stage of a row split into stages


class ScoresPlan(NamedTuple):
    """Launch plan of ``pair_scores_kernel``."""
    tb: int       # targets a tile
    tu: int       # table rows a tile
    unit: int     # bytes of one copy into shared memory (16, 8, 4, 2)
    hs: int       # columns a stage (all H in one stage where it fits)
    vec: int      # elements a store (4 where U is a multiple of 4, else 1)


def scores_smem(tb: int, tu: int, elt: int, h: int, hs: int) -> int:
    """Dynamic shared memory of a block (``sddmm.cu::smem_bytes``): the
    float32 stage buffers, two where the row takes several stages (bfloat16:
    one float32 buffer and the raw stage buffers), rows padded to an odd
    number of 16-byte chunks; or the [tb, tu + 4] output tile if larger."""
    rows = tb + tu
    nbuf = 2 if h > hs else 1
    fbuf = rows * (((hs + 3) // 4) | 1) * 16
    stage = nbuf * fbuf if elt == 4 else fbuf + nbuf * rows * hs * 2
    return max(stage, tb * (tu + 4) * 4)


@functools.lru_cache(maxsize=256)
def scores_plan(b: int, u: int, h: int, elt: int, stride_bytes: int,
                base_align: int) -> ScoresPlan:
    """The tile, copy unit, stage width and store width for a [B, U] block
    over rows of h elements of ``elt`` bytes, ``stride_bytes`` apart, the
    table's address ``base_align`` mod 16.

    B <= 32 takes tiles of 8 targets x 8 table rows (the 20 x 1024 step:
    384 blocks), B > 32 tiles of 64 x 64 (512 x 2048: 256 blocks), the two
    tiles ``sddmm.cu::by_tile`` launches.  The
    unit is the widest that divides the address, the row stride and the
    row width.  A row of at most 256 columns takes one stage where that
    fits in ``SMEM_BUDGET``; a wider one stages of the most columns (a
    multiple of 32, at most 256) whose two buffers fit."""
    tb = tu = 8 if b <= 32 else 64
    unit = widest_unit(elt, base_align, stride_bytes, h * elt)
    hs = -(-h // 8) * 8
    if hs > MAX_STAGE or scores_smem(tb, tu, elt, h, hs) > SMEM_BUDGET:
        hs = MAX_STAGE
        while hs > 32 and scores_smem(tb, tu, elt, h, hs) > SMEM_BUDGET:
            hs -= 32
    return ScoresPlan(tb, tu, unit, hs, 4 if u % 4 == 0 else 1)


def _unit_rows(emb: torch.Tensor, eps: float):
    """(unit, norms): emb's rows in float32 divided by max(|row|, eps)."""
    emb32 = emb.float()
    norms = torch.linalg.vector_norm(emb32, dim=-1,
                                     keepdim=True).clamp_min(eps)
    return emb32 / norms, norms


def dense_pair_scores(emb: torch.Tensor, target_rows: torch.Tensor,
                      eps: float = _EPS) -> torch.Tensor:
    """[U, H] x [B] -> [B, U] cosine scores, in emb's dtype (plain)."""
    unit, _ = _unit_rows(emb, eps)
    targets = unit[target_rows.long()]                        # [B, H]
    return torch.matmul(targets, unit.T).to(emb.dtype)


def _check_kernel_args(emb: torch.Tensor, target_rows: torch.Tensor) -> None:
    """What the kernel takes: emb [U, H] float32/bfloat16 with unit column
    stride (any row stride), target_rows [B] int32 contiguous, both on one
    CUDA device."""
    if emb.dim() != 2 or target_rows.dim() != 1:
        raise ValueError(f"expected emb [U, H] and target_rows [B]; got "
                         f"{tuple(emb.shape)}, {tuple(target_rows.shape)}")
    if emb.dtype not in _DTYPE_CODES:
        raise TypeError(f"emb must be float32 or bfloat16, not {emb.dtype}")
    if target_rows.dtype != torch.int32:
        raise TypeError(f"target_rows must be int32, not "
                        f"{target_rows.dtype}")
    if emb.shape[1] > 1 and emb.stride(1) != 1:
        raise ValueError(f"emb needs unit column stride, has strides "
                         f"{emb.stride()}")
    if not target_rows.is_contiguous():
        raise ValueError("target_rows must be contiguous")
    if max(*emb.shape, emb.stride(0)) > _INT_MAX:
        raise ValueError("U and H must each fit in 32 bits")
    if target_rows.shape[0] > _MAX_B:
        raise ValueError(f"at most {_MAX_B} targets per call")
    if not (emb.is_cuda and target_rows.device == emb.device):
        raise ValueError(f"emb and target_rows must lie on one CUDA device; "
                         f"got {emb.device}, {target_rows.device}")


def pair_scores_kernel(emb: torch.Tensor, target_rows: torch.Tensor,
                       eps: float = _EPS) -> torch.Tensor:
    """Launch the ``pair_scores`` CUDA kernel: [U, H] x [B] -> [B, U] in
    emb's dtype.  Forward only; ``PairScores`` gives it a gradient."""
    _check_kernel_args(emb, target_rows)
    u, h = emb.shape
    b = target_rows.shape[0]
    if h == 0:                  # no columns: every score is 0
        return torch.zeros((b, u), dtype=emb.dtype, device=emb.device)
    out = torch.empty((b, u), dtype=emb.dtype, device=emb.device)
    if b == 0 or u == 0:
        return out
    lib = build.load_library("sddmm")
    elt = emb.element_size()
    ptr = emb.data_ptr()
    plan = scores_plan(b, u, h, elt, emb.stride(0) * elt, ptr % 16)
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = lib.gs_pair_scores(_DTYPE_CODES[emb.dtype], emb.device.index, ptr,
                            emb.stride(0), target_rows.data_ptr(),
                            out.data_ptr(), b, u, h, eps, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"pair_scores launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")
    LAUNCHES["pair_scores"] += 1
    return out


def pair_scores_backward(g: torch.Tensor, emb: torch.Tensor,
                         target_rows: torch.Tensor,
                         eps: float = _EPS) -> torch.Tensor:
    """d(emb) of the score block (``_pallas_scores_bwd``): with
    S = unit[t] @ unit.T, d_unit = g.T @ unit[t] plus g @ unit added into
    the target rows, then through the row normalisation
    d_emb = (d_unit - unit * <d_unit, unit>) / norms.  In float32; returned
    in emb's dtype."""
    unit, norms = _unit_rows(emb, eps)
    t = target_rows.long()
    g = g.float()
    d_unit = torch.matmul(g.T, unit[t])                      # [U, H]
    d_unit.index_add_(0, t, torch.matmul(g, unit))           # [B, H]
    proj = (d_unit * unit).sum(dim=-1, keepdim=True)
    return ((d_unit - unit * proj) / norms).to(emb.dtype)


class PairScores(torch.autograd.Function):
    """The score block with the analytic backward; the gradient flows to
    ``emb`` only."""

    @staticmethod
    def forward(ctx, emb, target_rows, eps=_EPS):
        ctx.save_for_backward(emb, target_rows)
        ctx.eps = eps
        if not emb.is_cuda:
            return dense_pair_scores(emb, target_rows, eps)
        return pair_scores_kernel(emb, target_rows, eps)

    @staticmethod
    def backward(ctx, g):
        emb, target_rows = ctx.saved_tensors
        return (pair_scores_backward(g, emb, target_rows, ctx.eps), None,
                None)


def pair_scores(emb: torch.Tensor, target_rows: torch.Tensor,
                eps: float = _EPS) -> torch.Tensor:
    """The [B, U] score block: the kernel with the analytic backward on the
    card, the plain version elsewhere."""
    if emb.is_cuda:
        return PairScores.apply(emb, target_rows, eps)
    return dense_pair_scores(emb, target_rows, eps)


def sample_scores(scores: torch.Tensor, q_idx: torch.Tensor) -> torch.Tensor:
    """Per-pair scalars out of the block: [B, U] x [B, P] -> [B, P]."""
    return torch.gather(scores, 1, q_idx.long())


def gathered_pair_cosines(emb: torch.Tensor, target_rows: torch.Tensor,
                          pos_q: torch.Tensor, neg_q: torch.Tensor,
                          eps: float = _EPS):
    """Per-pair cosines without the [B, U] block: normalise once, gather the
    pair rows, batched dot.  [U, H] x [B] x [B, P] x [B, M] ->
    ([B, P], [B, M]) in emb's dtype."""
    unit, _ = _unit_rows(emb, eps)
    t = unit[target_rows.long()]                               # [B, H]
    pos = unit[pos_q.long()]                                   # [B, P, H]
    neg = unit[neg_q.long()]                                   # [B, M, H]
    pos_cos = torch.einsum("bh,bph->bp", t, pos)
    neg_cos = torch.einsum("bh,bmh->bm", t, neg)
    return pos_cos.to(emb.dtype), neg_cos.to(emb.dtype)


def dense_block_pays(b: int, u: int, n_pairs: int, h: int) -> bool:
    """Whether ``pair_loss_scores`` takes the dense [B, U] block: the JAX
    package's byte model (``sddmm.py:149``), kept as it is for parity,
    block traffic 3*B*U against 3*pairs*H + U*H."""
    return 3 * b * u <= 3 * n_pairs * h + u * h


def pair_loss_scores(emb: torch.Tensor, target_rows: torch.Tensor,
                     pos_q: torch.Tensor, neg_q: torch.Tensor,
                     eps: float = _EPS):
    """Per-pair cosines for the losses: the dense block when it is cheap
    (small B * U, the compact pipeline's batches), the gathered form when
    the block would be mostly waste (``dense_block_pays``)."""
    b = target_rows.shape[0]
    u, h = emb.shape
    n_pairs = pos_q.shape[0] * pos_q.shape[1] + neg_q.shape[0] * neg_q.shape[1]
    if dense_block_pays(b, u, n_pairs, h):
        scores = pair_scores(emb, target_rows, eps=eps)
        return sample_scores(scores, pos_q), sample_scores(scores, neg_q)
    return gathered_pair_cosines(emb, target_rows, pos_q, neg_q, eps=eps)
