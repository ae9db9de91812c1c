"""Lower-precision controls: the reference computed with its operands
rounded to a narrower type, to show that the comparison fails them."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0  # the largest finite float8_e4m3fn
E5M2_MAX = 57344.0  # the largest finite float8_e5m2


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one per-tensor scale (its largest
    magnitude at the type's largest finite value), back in its dtype."""
    amax = t.abs().amax()
    if float(amax) == 0.0:
        return t
    scale = amax / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Float8(torch.autograd.Function):
    """float8 training's rounding: e4m3 on the way forward, e5m2 for the
    gradient on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` as an operand of a float8 product: rounded to e4m3, its
    gradient rounded to e5m2."""
    return _Float8.apply(t)
