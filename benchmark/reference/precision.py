"""The precisions the reference computes in.

``EXACT`` is the reference itself: float32 with TF32 off.  The others are the
controls of ``correct``, the step below the precision a configuration
states, which a cell's limits must reject:

- ``FP8``, below bfloat16: every stored table, activation and matmul operand
  rounded to float8 e4m3 with one scale a tensor (its largest magnitude to
  448, as fp8 GEMMs are fed), sums in float32;
- ``TF32``, below float32 with TF32 off: every matmul operand rounded to
  TF32's 10-bit mantissa (to nearest, ties to even), as the tensor cores
  take them, sums in float32.

Rounding is forward only: the gradient passes through it unchanged, and the
backward products take the rounded operands autograd saved.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach() if x.requires_grad else rounded


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return _straight_through(x, q)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return _straight_through(x, bits.view(torch.float32))


def _same(x: torch.Tensor) -> torch.Tensor:
    return x.float()


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    table: Callable[[torch.Tensor], torch.Tensor]    # stored tables
    operand: Callable[[torch.Tensor], torch.Tensor]  # matmul operands

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))


EXACT = Precision("float32", _same, _same)
FP8 = Precision("fp8_e4m3", round_fp8, round_fp8)
TF32 = Precision("tf32", _same, round_tf32)

# the control of each configured compute dtype
CONTROL = {"bfloat16": FP8, "float32": TF32}
