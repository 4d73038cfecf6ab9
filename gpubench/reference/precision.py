"""The lower precision the control computes in: TF32, float32 with its
mantissa rounded to 10 bits (round to nearest, ties away from zero, as the
card's ``cvt.rna.tf32.f32`` does)."""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32, returned as float32 (inf and nan pass)."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    finite = torch.isfinite(x)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # a magnitude's bits grow with it, so adding half an ulp of TF32 to the
    # magnitude rounds ties away from zero for either sign
    return torch.where(finite, rounded, x)
