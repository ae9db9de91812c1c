"""Named model variants and the double-output heads.

Counterpart of ``ctunet_tpu/models/variants.py`` (reference
``ctunet/pytorch/models.py:272-387``): zero-argument classes selected from
configs by name through the model registry. The variants subclass
:class:`UNet` directly, so their state_dict keys are the reference's. The
4-block family runs at ``i_size`` 7, the 5-block family (``UNet5b2i3o``,
``UNetSPSmall``, for 512-wide volumes) at ``i_size`` 4.
"""

from __future__ import annotations

import torch

from ..registry import register_model
from .unet import UNet

# the two 3x2 channel maps of the double-output head (``variants.py:77-95``):
#   full = out @ M_FULL;  flap = out @ M_FLAP + B_FLAP
M_FULL = ((1.0, 0.0), (0.0, 1.0), (0.0, 1.0))
M_FLAP = ((0.0, 0.0), (-1.0, 1.0), (0.0, 0.0))
B_FLAP = (1.0, 0.0)


def double_out_head(backg_flap_fullsk: torch.Tensor):
    """(..., 3) sigmoid output -> (full skull, flap), each (..., 2)."""
    t = backg_flap_fullsk
    m_full = torch.tensor(M_FULL, dtype=t.dtype, device=t.device)
    m_flap = torch.tensor(M_FLAP, dtype=t.dtype, device=t.device)
    b_flap = torch.tensor(B_FLAP, dtype=t.dtype, device=t.device)
    return t @ m_full, t @ m_flap + b_flap


@register_model("UNet4b2i3o")
class UNet4b2i3o(UNet):
    """Three-channel output with shape prior (``models.py:272-278``)."""

    def __init__(self):
        super().__init__(input_channels=2, out_channels=3, i_size=7)


@register_model("UNet5b2i3o")
class UNet5b2i3o(UNet):
    """5-block small variant (``models.py:281-287``): i_size 4."""

    def __init__(self):
        super().__init__(input_channels=2, out_channels=3, n_blocks=5,
                         i_size=4)


@register_model("UNet4b1i3o")
class UNet4b1i3o(UNet):
    """Single-input variant without shape prior (``models.py:290-296``)."""

    def __init__(self):
        super().__init__(input_channels=1, out_channels=3, i_size=7)


@register_model("UNetSP")
class UNetSP(UNet):
    """U-Net with shape prior, double output (``models.py:299-330``):
    (B, D, H, W, 2) broken skull + atlas in, (full skull, flap) out."""

    def __init__(self):
        super().__init__(input_channels=2, out_channels=3, i_size=7)

    def forward(self, x):
        return double_out_head(super().forward(x))


@register_model("UNetSPSmall")
class UNetSPSmall(UNet):
    """Small 5-block double-output variant for 512-wide volumes
    (``models.py:333-365``); unlike UNetSP it softmaxes both heads, in the
    compute dtype."""

    def __init__(self):
        super().__init__(input_channels=2, out_channels=3, n_blocks=5,
                         i_size=4)

    def forward(self, x):
        full, flap = double_out_head(super().forward(x))
        return torch.softmax(full, -1), torch.softmax(flap, -1)


@register_model("UNetDO")
class UNetDO(UNet):
    """Double output without shape prior (``models.py:368-387``)."""

    def __init__(self):
        super().__init__(input_channels=1, out_channels=3, i_size=7)

    def forward(self, x):
        return double_out_head(super().forward(x))
