"""Neighbourhood aggregation: plain PyTorch versions and the CUDA kernels.

Port of ``graphsage_tpu/ops/aggregate.py`` (the XLA ops) and
``graphsage_tpu/ops/pallas_aggregate.py`` (the Pallas TPU kernels) in one
module.  Aggregation is a padded fixed-fanout segment reduce: every output
row owns ``S`` index slots into the previous layer's embedding table, with a
weight mask.

- ``*_aggregate_plain``: straightforward PyTorch, on any device.  They are
  the CPU path and the reference the kernels are held against on the card.
- ``mean_aggregate`` / ``max_aggregate``: the public ops.  A CPU tensor takes
  the plain version; a CUDA tensor launches the hand-written kernel
  (``graphsage_torch/csrc/aggregate.cu``) or raises — there is no fallback.

Semantics (``graphsage_tpu/ops/aggregate.py:52-71``): sums accumulate in
float32 and the result is returned in the embed dtype, rounded once; the
mask weights are taken in float32.  MEAN divides by ``max(sum(mask), 1)``, so
a row with no valid slot gives 0.  MAX takes the elementwise max over the
slots with ``mask > 0`` and gives 0 for a row with no such slot.

Both have a gradient on both devices: ``mean_aggregate`` and
``max_aggregate`` are ``torch.autograd.Function``s whose forward is the
plain version on a CPU tensor and the kernel on a CUDA tensor, and whose
backward is the JAX package's custom VJP (``_pallas_mean_bwd`` and
``_pallas_max_bwd``, ``graphsage_tpu/ops/pallas_aggregate.py:147-184``, XLA
scatters there, ``ops.scatter.scatter_rows`` here: JAX's order of the
bfloat16 adds, the ``scatter_rows`` kernel on the card).  MAX routes each
output element's gradient to the slots that hold the maximum and splits it
equally among tied slots, as ``jax.grad`` of ``jnp.max`` does: its tie
split (``max_tie_split_plain`` on the CPU) is the ``gather_max_bwd``
kernel on the card, one launch before the scatter.  The CPU takes the
same Functions with the plain versions, so the CPU tests exercise the
backwards the card runs.

``pair_cosine`` is the per-pair cosine score of the unsupervised losses
(``graphsage_tpu/ops/aggregate.py:74-87``), plain PyTorch.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import build

# Launches of each CUDA kernel (``pair_scores`` is ops/sddmm.py's,
# ``gather_rows`` ops/gather.py's, ``scatter_rows`` ops/scatter.py's,
# ``pretransform`` ops/pretransform.py's).  A wrapper adds one where it
# launches its kernel and nowhere else; runs that must show they went
# through the kernels set these to 0 before and read them after.
LAUNCHES = {"gather_mean": 0, "gather_max": 0, "gather_max_bwd": 0,
            "pair_scores": 0, "gather_rows": 0, "scatter_rows": 0,
            "pretransform": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _weighted_sum(embed: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """sum_s weights[:, s] * embed[idx[:, s]] in float32, slot by slot (never
    builds the [U, S, D] gather)."""
    acc = torch.zeros((idx.shape[0], embed.shape[1]), dtype=torch.float32,
                      device=embed.device)
    idx = idx.long()
    for s in range(idx.shape[1]):
        acc = acc + embed[idx[:, s]].float() * weights[:, s, None]
    return acc


def sum_aggregate_plain(embed: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked sum: embed [M, D], idx [U, S] int, mask [U, S] -> [U, D]."""
    return _weighted_sum(embed, idx, mask.float()).to(embed.dtype)


def mean_aggregate_plain(embed: torch.Tensor, idx: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Masked mean (reference MEAN aggregator, src/models.py:311-314)."""
    weights = mask.float()
    total = _weighted_sum(embed, idx, weights)
    count = weights.sum(dim=1, keepdim=True)
    return (total / count.clamp_min(1.0)).to(embed.dtype)


def max_aggregate_plain(embed: torch.Tensor, idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked max (reference MAX aggregator, src/models.py:316-326), as
    ``graphsage_tpu/ops/aggregate.py:63-71`` computes it: ``amax`` over the
    [U, S, D] gather with masked slots at -inf, in the embed dtype (a max
    is exact in any dtype).  Autograd through it splits the gradient
    equally among tied maxima, as ``jax.grad`` of ``jnp.max`` does, so it
    is also the plain reference of the backward."""
    valid = mask > 0
    gathered = embed[idx.long()]                                 # [U, S, D]
    neg_inf = torch.tensor(float("-inf"), dtype=embed.dtype,
                           device=embed.device)
    out = torch.amax(torch.where(valid[..., None], gathered, neg_inf), dim=1)
    any_valid = valid.any(dim=1, keepdim=True)
    return torch.where(any_valid, out, torch.zeros_like(out))


def _check_kernel_args(embed: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor) -> None:
    """What the kernels take: embed [M, D] float32/bfloat16 with unit column
    stride (any row stride), idx [U, S] int32 and mask [U, S] float32, both
    contiguous, all on one CUDA device."""
    if embed.dim() != 2 or idx.dim() != 2 or mask.shape != idx.shape:
        raise ValueError(
            f"expected embed [M, D], idx [U, S], mask [U, S]; got "
            f"{tuple(embed.shape)}, {tuple(idx.shape)}, {tuple(mask.shape)}")
    if embed.dtype not in _DTYPE_CODES:
        raise TypeError(f"embed must be float32 or bfloat16, not "
                        f"{embed.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, not {mask.dtype}")
    if embed.shape[1] > 1 and embed.stride(1) != 1:
        raise ValueError(f"embed needs unit column stride, has strides "
                         f"{embed.stride()}")
    if not (idx.is_contiguous() and mask.is_contiguous()):
        raise ValueError("idx and mask must be contiguous")
    if max(*idx.shape, embed.shape[1], embed.stride(0)) > _INT_MAX:
        raise ValueError("U, S and D must each fit in 32 bits")
    if not (embed.is_cuda and idx.device == embed.device
            and mask.device == embed.device):
        raise ValueError(f"embed, idx and mask must lie on one CUDA device; "
                         f"got {embed.device}, {idx.device}, {mask.device}")


def widest_unit(elt: int, *byte_counts: int) -> int:
    """The widest access of 16, 8, 4 or 2 bytes, no narrower than an element
    of ``elt`` bytes, that divides every address, stride and width in
    ``byte_counts``."""
    n = 0
    for count in byte_counts:
        n |= count
    low = n & -n  # the largest power of two dividing all of them
    return max(elt, 16 if n == 0 or low >= 16 else low)


def aggregate_plan(elt: int, embed_mod16: int, stride_bytes: int,
                   row_bytes: int, out_mod16: int) -> tuple[int, int, int]:
    """Launch plan of ``gather_reduce_kernel``: (unit bytes a lane loads,
    lanes a row, units a lane a pass).

    The unit is the widest that divides the embed table's address (mod 16),
    its row stride, the row width in bytes and the output's address.  A row
    of at most 16 units takes 16 lanes (two rows a warp), a wider row 32,
    with 1, 2 or 4 units a lane a pass (rows wider than 128 units take
    several passes)."""
    unit = widest_unit(elt, embed_mod16, stride_bytes, row_bytes, out_mod16)
    units = row_bytes // unit
    if units <= 16:
        return unit, 16, 1
    return unit, 32, 1 if units <= 32 else 2 if units <= 64 else 4


def _launch(name: str, symbol: str, embed: torch.Tensor, idx: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    _check_kernel_args(embed, idx, mask)
    u, s = idx.shape
    d = embed.shape[1]
    out = torch.empty((u, d), dtype=embed.dtype, device=embed.device)
    if u == 0 or d == 0:
        return out
    lib = build.load_library("aggregate")
    elt = embed.element_size()
    unit, lanes, kc = aggregate_plan(elt, embed.data_ptr() % 16,
                                     embed.stride(0) * elt, d * elt,
                                     out.data_ptr() % 16)
    stream = torch.cuda.current_stream(embed.device).cuda_stream
    rc = getattr(lib, symbol)(
        _DTYPE_CODES[embed.dtype], embed.device.index, embed.data_ptr(),
        embed.stride(0), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
        u, s, d, unit, lanes, kc, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return out


class _GatherMean(torch.autograd.Function):
    """Masked mean with the scatter-add backward of ``_pallas_mean_bwd``.
    Gradients flow to ``embed`` only (idx and mask are sampling output)."""

    @staticmethod
    def forward(ctx, embed, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.embed_shape = embed.shape
        ctx.embed_dtype = embed.dtype
        if not embed.is_cuda:
            return mean_aggregate_plain(embed, idx, mask)
        return _launch("gather_mean", "gs_gather_mean", embed, idx, mask)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return mean_aggregate_backward(g, idx, mask, ctx.embed_shape,
                                       ctx.embed_dtype), None, None


def mean_aggregate_backward(g: torch.Tensor, idx: torch.Tensor,
                            mask: torch.Tensor, embed_shape,
                            embed_dtype: torch.dtype) -> torch.Tensor:
    """d(embed) of the masked mean: each slot's row receives
    ``g[u] * mask[u, s] / max(sum_s mask[u, s], 1)``, accumulated into a
    zero [M, D] in the embed dtype by ``ops.scatter.scatter_rows``."""
    # imported here: ops.scatter imports this module
    from graphsage_torch.ops.scatter import scatter_rows

    cnt = mask.float().sum(dim=1, keepdim=True).clamp_min(1.0)
    w = (mask.float() / cnt).to(g.dtype)                         # [U, S]
    contrib = (g[:, None, :] * w[:, :, None]).to(embed_dtype)    # [U, S, D]
    return scatter_rows(contrib.reshape(-1, embed_shape[1]), idx,
                        embed_shape[0])


def mean_aggregate(embed: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked mean, differentiable in ``embed``.  CPU tensors take
    :func:`mean_aggregate_plain`; CUDA tensors launch the ``gather_mean``
    kernel (see :func:`_check_kernel_args` for what it takes).  The
    backward is :func:`mean_aggregate_backward` on both."""
    return _GatherMean.apply(embed, idx, mask)


class _GatherMax(torch.autograd.Function):
    """Masked max with the tie-splitting backward of ``_pallas_max_bwd``.
    Gradients flow to ``embed`` only.  Saves ``embed`` (no copy), ``idx``,
    ``mask`` and the output, from which the backward finds the tied
    slots."""

    @staticmethod
    def forward(ctx, embed, idx, mask):
        if not embed.is_cuda:
            out = max_aggregate_plain(embed, idx, mask)
        else:
            out = _launch("gather_max", "gs_gather_max", embed, idx, mask)
        ctx.save_for_backward(embed, idx, mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        embed, idx, mask, out = ctx.saved_tensors
        return max_aggregate_backward(g, embed, idx, mask, out), None, None


def max_tie_split_plain(g: torch.Tensor, embed: torch.Tensor,
                        idx: torch.Tensor, mask: torch.Tensor,
                        out: torch.Tensor) -> torch.Tensor:
    """The tie split of the masked max's backward (``_pallas_max_bwd`` up to
    its scatter), plain: gather the slot rows, mark the valid slots equal
    to the output (the forward returns exact slot values, so the test is
    exact in bfloat16 too), divide ``g`` by the number of tied slots in
    g's dtype, and round each slot's share to the embed dtype:
    contrib [U*S, D], one row a slot, masked slots included."""
    # imported here: ops.gather imports this module
    from graphsage_torch.ops.gather import gather_rows_plain

    u, s = idx.shape
    d = embed.shape[1]
    gathered = gather_rows_plain(embed, idx.reshape(-1)).view(u, s, d)
    is_max = ((gathered == out[:, None, :])
              & (mask[..., None] > 0)).to(g.dtype)
    denom = is_max.sum(dim=1, keepdim=True).clamp_min(1.0)
    contrib = (g[:, None, :] * is_max / denom).to(embed.dtype)   # [U, S, D]
    return contrib.reshape(-1, d)


def gather_max_bwd_kernel(g: torch.Tensor, embed: torch.Tensor,
                          idx: torch.Tensor, mask: torch.Tensor,
                          out: torch.Tensor) -> torch.Tensor:
    """Launch the ``gather_max_bwd`` CUDA kernel: :func:`max_tie_split_plain`
    in one launch, equal to it bit for bit.  Takes what
    :func:`_check_kernel_args` allows, with g and out [U, D] contiguous in
    the embed dtype on the same device."""
    want = (idx.shape[0], embed.shape[-1])
    for name, t in (("g", g), ("out", out)):
        if tuple(t.shape) != want:
            raise ValueError(f"expected {name} {list(want)}; got "
                             f"{list(t.shape)}")
        if t.dtype != embed.dtype:
            raise TypeError(f"{name} must be {embed.dtype}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != embed.device:
            raise ValueError(f"{name} lies on {t.device}, embed on "
                             f"{embed.device}")
    _check_kernel_args(embed, idx, mask)
    u, s = idx.shape
    d = embed.shape[1]
    contrib = torch.empty((u * s, d), dtype=embed.dtype, device=embed.device)
    if contrib.numel() == 0:
        return contrib
    lib = build.load_library("aggregate")
    elt = embed.element_size()
    unit, lanes, kc = aggregate_plan(
        elt, embed.data_ptr() % 16, embed.stride(0) * elt, d * elt,
        (out.data_ptr() | g.data_ptr() | contrib.data_ptr()) % 16)
    stream = torch.cuda.current_stream(embed.device).cuda_stream
    rc = lib.gs_gather_max_bwd(
        _DTYPE_CODES[embed.dtype], embed.device.index, embed.data_ptr(),
        embed.stride(0), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
        g.data_ptr(), contrib.data_ptr(), u, s, d, unit, lanes, kc, stream)
    if rc != 0:
        raise RuntimeError(f"gather_max_bwd launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")
    LAUNCHES["gather_max_bwd"] += 1
    return contrib


def max_aggregate_backward(g: torch.Tensor, embed: torch.Tensor,
                           idx: torch.Tensor, mask: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """d(embed) of the masked max (``_pallas_max_bwd``): the tie split
    (the ``gather_max_bwd`` kernel on a CUDA tensor,
    :func:`max_tie_split_plain` on a CPU one), then each slot's share added
    into a zero [M, D] in the embed dtype by ``ops.scatter.scatter_rows``."""
    # imported here: ops.scatter imports this module
    from graphsage_torch.ops.scatter import scatter_rows

    if embed.is_cuda:
        contrib = gather_max_bwd_kernel(g.contiguous(), embed, idx, mask,
                                        out)
    else:
        contrib = max_tie_split_plain(g, embed, idx, mask, out)
    return scatter_rows(contrib, idx.reshape(-1), embed.shape[0])


def max_aggregate(embed: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked max, differentiable in ``embed``.  CPU tensors take
    :func:`max_aggregate_plain`; CUDA tensors launch the ``gather_max``
    kernel.  The backward is :func:`max_aggregate_backward` on both."""
    return _GatherMax.apply(embed, idx, mask)


def pair_cosine(embed: torch.Tensor, p_idx: torch.Tensor,
                q_idx: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity of embedding pairs, in float32, with each norm
    clamped at ``eps`` (``F.cosine_similarity`` semantics, reference
    src/models.py:82,90).  p_idx/q_idx: int index tensors of one shape into
    embed's rows; returns that shape."""
    from graphsage_torch.ops.scatter import take_rows

    a = take_rows(embed, p_idx).float()
    b = take_rows(embed, q_idx).float()
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return (a * b).sum(dim=-1) / (na * nb)
