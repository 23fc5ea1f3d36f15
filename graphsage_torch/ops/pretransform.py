"""MEAN's pretransform of a bfloat16 table: ``z = h @ w.T`` with the float32
weight split exactly into three bfloat16 pieces, and GraphSAGE-pool's pool
transform, ``z = relu(h @ w.T + b)``: the same product with a float32 bias
and a relu applied to the float32 sums before the one rounding.  Plain
PyTorch and the CUDA kernel.

The table ``h`` [N, K] is bfloat16, so each of its elements is exact in
bfloat16.  The float32 weight ``w`` [P, K] is the exact sum of three
bfloat16 pieces (:func:`split_weight`): ``hi = bf16(w)``, ``mid = bf16(w -
hi)``, ``lo = bf16(w - hi - mid)``, 8 of its 24 significant bits each.  A
product of two bfloat16 numbers is exact in float32, so ``h @ (hi + mid +
lo).T`` summed in float32 is the float32 product ``h.float() @ w.T`` with
the sums in another order, rounded once to bfloat16, as the JAX package's
``jnp.dot(bf16, f32, preferred_element_type=f32)`` computes it
(``graphsage_tpu/models/layers.py:40-59``).

- ``pretransform_plain``: the three pieces' products summed into one float32
  accumulator by ``torch.matmul``, on any device: the CPU path and the
  reference the kernel is held against on the card.
- ``pretransform_kernel``: the hand-written tensor-core kernel
  (``graphsage_torch/csrc/pretransform.cu``), a CUDA tensor only, after
  one launch of its ``pack_kernel``, which splits the weight into the
  kernel's layout (:func:`pack_pieces` of :func:`split_weight`).
- ``pretransform``: splits the weight and takes the plain version for a CPU
  table; a CUDA table launches the kernel or raises, with no fallback.
  Forward only: ``models.layers.mean_pretransform`` and
  ``models.layers.pool_transform`` call it where autograd would not record
  the call.  Given a ``bias``, the kernel's epilogue adds it and takes the
  relu (``gs_pretransform_bias_relu``); without one it launches MEAN's
  kernel, which has no epilogue.
"""

from __future__ import annotations

import torch

from graphsage_torch.ops import build
from graphsage_torch.ops.aggregate import _INT_MAX, LAUNCHES, widest_unit
from graphsage_torch.utils import obs

PIECES = 3
SLICE = 64          # K a slice of the kernel's loop (128 bytes of bfloat16)


def split_weight(w: torch.Tensor) -> torch.Tensor:
    """[3, P, K] bfloat16 pieces of the float32 ``w`` [P, K] (any float
    dtype is taken in float32) whose float32 sum, ``(hi + mid) + lo``, is
    ``w`` bit for bit: each piece is the remainder rounded to bfloat16.  A
    zero remainder takes ``w``'s sign, so that -0 sums back to -0.  Exact
    for finite ``|w|`` from 2^-110 (below, the last piece loses bits under
    bfloat16's smallest subnormal) up to bfloat16's largest finite value,
    3.39e38 (above, ``hi`` rounds to infinity), and for 0."""
    w = w.float()
    signed_zero = w * 0
    rest, pieces = w, []
    for _ in range(PIECES):
        piece = rest.to(torch.bfloat16)
        pieces.append(piece)
        rest = rest - piece.float()
        rest = torch.where(rest == 0, signed_zero, rest)
    return torch.stack(pieces)


def pretransform_plain(h: torch.Tensor, pieces: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """h [N, K] bfloat16 x pieces [3, P, K] bfloat16 -> [N, P] bfloat16: the
    three pieces' products added into one float32 accumulator, rounded
    once (plain).  With ``bias`` [P] (taken in float32), relu(sums + bias)
    is rounded instead."""
    h32 = h.float()
    z = torch.matmul(h32, pieces[0].float().T)
    for piece in pieces[1:]:
        z.addmm_(h32, piece.float().T)
    if bias is not None:
        z = torch.relu(z + bias.float())
    return z.to(torch.bfloat16)


def pretransform_plan(h_mod16: int, stride_bytes: int, row_bytes: int,
                      p: int) -> tuple[int, int]:
    """Launch plan of the kernel: (unit bytes of a copy of h, columns of z a
    tile).  The unit is the widest of 16, 8, 4 or 2 bytes that divides h's
    address (mod 16), its row stride and its row width; a tile is 64, 128 or
    256 columns, the narrowest that holds P (wider z takes several)."""
    unit = widest_unit(2, h_mod16, stride_bytes, row_bytes)
    bn = 64 if p <= 64 else 128 if p <= 128 else 256
    return unit, bn


def pack_pieces(pieces: torch.Tensor, bn: int) -> torch.Tensor:
    """The kernel's layout of the pieces (plain; the card's ``pack_kernel``
    writes it from the weight): [ceil(K / 64), ceil(P / bn), 3, bn, 64]
    contiguous, zero past K and past P, so that each slice of K of each
    column tile is one contiguous run, with each 128-byte row's 16-byte
    chunk c at chunk c ^ (row % 8), the swizzle of the kernel's shared
    memory."""
    q, p, k = pieces.shape
    kt, ct = -(-k // SLICE), -(-p // bn)
    buf = pieces.new_zeros((q, ct * bn, kt * SLICE))
    buf[:, :p, :k] = pieces
    packed = buf.view(q, ct, bn, kt, SLICE).permute(3, 1, 0, 2, 4)
    rows = torch.arange(bn, device=pieces.device)[:, None]
    chunk = (torch.arange(SLICE // 8, device=pieces.device)[None, :]
             ^ (rows % 8))                                   # [bn, 8]
    chunks = packed.reshape(kt, ct, q, bn, SLICE // 8, 8)
    return torch.gather(chunks, 4, chunk[:, :, None].expand(
        chunks.shape)).reshape(kt, ct, q, bn, SLICE).contiguous()


def _check_kernel_args(h: torch.Tensor, w: torch.Tensor,
                       bias: torch.Tensor | None = None) -> None:
    """What the kernel takes: h [N, K] bfloat16 and w [P, K] float32, each
    with unit column stride (any row stride), and the epilogue's bias, a
    contiguous float32 [P] or None, on one CUDA device."""
    if h.dim() != 2 or w.dim() != 2 or w.shape[1] != h.shape[1]:
        raise ValueError(f"expected h [N, K] and w [P, K]; got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"h must be bfloat16 and w float32, not {h.dtype}, "
                        f"{w.dtype}")
    for name, t in (("h", h), ("w", w)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs unit column stride, has strides "
                             f"{t.stride()}")
    if max(*h.shape, w.shape[0], h.stride(0), w.stride(0)) > _INT_MAX:
        raise ValueError("N, K, P and the row strides must each fit in 32 "
                         "bits")
    if bias is not None:
        if bias.shape != (w.shape[0],) or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 [{w.shape[0]}]; got "
                             f"{bias.dtype} {tuple(bias.shape)}")
        if bias.stride(0) != 1 or bias.device != h.device:
            raise ValueError("bias must be contiguous, on h's device")
    if not (h.is_cuda and w.device == h.device):
        raise ValueError(f"h and w must lie on one CUDA device; got "
                         f"{h.device}, {w.device}")


def _raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gs_error_string(rc).decode()})")


def pretransform_kernel(h: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the ``pretransform`` CUDA kernel, after its ``pack_kernel``:
    [N, K] x [P, K] -> [N, P] bfloat16, :func:`pretransform_plain`'s sums
    of :func:`split_weight`'s pieces in the kernel's order; with ``bias``
    the epilogue's relu(sums + bias).  Takes what
    :func:`_check_kernel_args` allows; an empty table or weight launches
    nothing (with a bias and K = 0, z is relu(bias) on every row)."""
    _check_kernel_args(h, w, bias)
    n, k = h.shape
    p = w.shape[0]
    if n == 0 or p == 0 or k == 0:
        z = torch.zeros((n, p), dtype=torch.float32, device=h.device)
        if bias is not None:
            z = torch.relu(z + bias)
        return z.to(torch.bfloat16)
    unit, bn = pretransform_plan(h.data_ptr() % 16, h.stride(0) * 2, k * 2, p)
    lib = build.load_library("pretransform")
    stream = torch.cuda.current_stream(h.device).cuda_stream
    packed = torch.empty(-(-k // SLICE) * -(-p // bn) * PIECES * bn * SLICE,
                         dtype=torch.bfloat16, device=h.device)
    _raise_for(lib, lib.gs_pretransform_pack(
        h.device.index, w.data_ptr(), w.stride(0), packed.data_ptr(), p, k,
        bn, stream), "pretransform's pack")
    z = torch.empty((n, p), dtype=torch.bfloat16, device=h.device)
    if bias is None:
        _raise_for(lib, lib.gs_pretransform(
            h.device.index, h.data_ptr(), h.stride(0), packed.data_ptr(),
            z.data_ptr(), n, k, p, bn, unit, stream), "pretransform")
    else:
        _raise_for(lib, lib.gs_pretransform_bias_relu(
            h.device.index, h.data_ptr(), h.stride(0), packed.data_ptr(),
            z.data_ptr(), n, k, p, bn, unit, bias.data_ptr(), stream),
            "pretransform")
    LAUNCHES["pretransform"] += 1
    obs.count("serve.pretransform_kernel", n)
    return z


def pretransform(h: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """``h @ w.T`` for a bfloat16 table ``h`` [N, K] and a float32 weight
    ``w`` [P, K] (any float dtype is taken in float32), rounded once to
    bfloat16; with ``bias`` [P] (taken in float32), ``relu(h @ w.T +
    bias)`` rounded once.  CPU tensors take :func:`pretransform_plain`;
    CUDA tensors launch the ``pretransform`` kernel.  No gradient."""
    w = w.to(h.device, torch.float32)
    if bias is not None:
        bias = bias.to(h.device, torch.float32).contiguous()
    if not h.is_cuda:
        return pretransform_plain(h, split_weight(w), bias)
    return pretransform_kernel(h, w, bias)
