"""Rounding to a lower precision, for the control that the check must fail."""

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits, to nearest, ties to
    even): what a TF32 product reads of its operands."""
    t = t.contiguous().to(torch.float32)
    i = t.view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    r = torch.bitwise_and(i + 0x0FFF + lsb, ~0x1FFF)
    return r.view(torch.float32)
