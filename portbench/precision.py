"""The precisions the comparison uses: fp32 as the configurations state
it, and TF32, the step below it that would tempt a later change, for the
control.

``tf32`` rounds an fp32 tensor to TF32's 10 explicit mantissa bits (to
nearest, ties to even), as the tensor cores round a product's operands; a
product of two rounded operands accumulated in fp32 is a TF32 product,
whatever kernel the library picks for it.
"""

from __future__ import annotations

import torch


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b))


def fp32_only() -> None:
    """Keep every fp32 product in IEEE fp32 (TF32 off), as the
    configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
