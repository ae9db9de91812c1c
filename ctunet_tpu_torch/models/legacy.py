"""Legacy fixed 4-level U-Net (the AutoImplant 2020 challenge models) as
PyTorch ``nn.Module``s, eval and train mode.

Counterpart of ``ctunet_tpu/models/legacy.py``: ``recAE_v2_fixed``
(reference ``ctunet/pytorch/models.py:441-538``) and ``UNet4_2IC``
(``models.py:541-557``). Unlike the generic family (``models/unet.py``):

- kernel 5, padding 2, and every conv has a bias (``legacy.py:28-52``);
- the center block is in the data path (quirk Q1 does not apply);
- each decoder block upsamples its whole input with a ConvTranspose(k2, s2)
  of the same width, then two conv units, and its output is concatenated
  with the encoder skip (``legacy.py:55-92,135-145``);
- the head is a 1x1 ``last_conv`` and a softmax.

Submodules carry the reference's state_dict names, so a reference ``.pt``
loads with ``load_state_dict``: ``dblock{1..4}`` and ``cblock_center`` are
``(conv, bn, relu) x 2`` at ``0..5``; ``ublock{1..4}`` are the ConvT at
``0`` then ``(conv, bn, relu) x 2`` at ``1..6``; ``last_conv``
(``ctunet_tpu/models/torch_port.py:242-265``). Like ``models/unet.py`` the
modules run channels-last, ``(B, D, H, W, C)``. :meth:`RecAEv2Fixed.configure`
sets the compute dtype, as the JAX legacy models' ``dtype=`` does
(``ctunet_tpu/models/legacy.py:36-37,65-66``): parameters stay f32 and are
cast per call, each conv adds its bias in the compute dtype, and the head
and softmax run in it; f32 by default. It also sets how the k=5 convs run,
through ``models/unet.py::Conv3d`` (``PackedConv``,
``ctunet_tpu/models/unet.py:108-136``):

=========================  ==============================================
``pallas``                 K5 forward and dgrad, k^3 tap-shifted ``bmm``
                           wgrad (``ops/chain_conv_train.py``)
``plain``                  the same on the kernel's plain version
``xla``, ``xla_dw``,       ``F.conv3d`` (cuDNN on the card); ``chain`` as
``chain``                  the JAX package's ``chain``, which takes the
                           XLA conv at k=5 (``chain_conv_train.py:72-73``)
=========================  ==============================================

The BatchNorm is the port's own (``models/unet.py::BatchNorm``, flax's
statistics) and trains the same way. There is no dropout: the JAX
``build_model`` passes no ``dropout_p``, so it is 0. The JAX models' remat
(``use_checkpoint``) is a TPU memory choice with the same values, and the
port does not recompute.
"""

from __future__ import annotations

import torch
from torch import nn

from ..registry import register_model
from .unet import CONV_IMPLS, BatchNorm, Conv3d, ConvTranspose2x, maxpool2


def _conv_unit(cin: int, cout: int):
    """Conv3d(k5, p2, bias) + BatchNorm + ReLU (``down_block_cr``)."""
    return [Conv3d(cin, cout, 5, padding=2),
            BatchNorm(cout, eps=1e-5, momentum=0.1), nn.ReLU()]


def down_block(cin: int, cout: int) -> nn.Sequential:
    """``down_block_cr`` (``models.py:393-411``): two conv units."""
    return nn.Sequential(*_conv_unit(cin, cout), *_conv_unit(cout, cout))


def up_block(cin: int, cout: int) -> nn.Sequential:
    """``up_block_cr`` (``models.py:414-438``): ConvT(k2, s2) of the same
    width, then two conv units."""
    return nn.Sequential(ConvTranspose2x(cin, cin, 2, stride=2),
                         *_conv_unit(cin, cout), *_conv_unit(cout, cout))


@register_model("recAE_v2_fixed")
class RecAEv2Fixed(nn.Module):
    """Hand-unrolled 4-level U-Net with a live center block and a softmax
    head. Spatial extents must divide by 16."""

    input_channels = 1
    i_size = 8
    n_blocks = 4  # pool levels

    def __init__(self):
        super().__init__()
        fms = [self.i_size * 2 ** n for n in range(5)]
        cin = self.input_channels
        for i in range(4):
            setattr(self, f"dblock{i + 1}", down_block(cin, fms[i]))
            cin = fms[i]
        self.cblock_center = down_block(fms[3], fms[4])
        cin = fms[4]
        for i in range(4):
            setattr(self, f"ublock{i + 1}", up_block(cin, fms[3 - i]))
            cin = 2 * fms[3 - i]
        self.last_conv = nn.Conv3d(cin, 2, 1)
        self.compute_dtype = torch.float32

    def configure(self, conv_impl: str = "xla",
                  compute_dtype: torch.dtype = torch.float32
                  ) -> "RecAEv2Fixed":
        """Select the conv implementation and the compute dtype of every
        layer (``UNet.configure``'s signature; the table above)."""
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r}: one of {CONV_IMPLS}")
        self.compute_dtype = compute_dtype
        for m in self.modules():
            if isinstance(m, Conv3d):
                m.conv_impl, m.compute_dtype = conv_impl, compute_dtype
            elif isinstance(m, ConvTranspose2x):
                m.compute_dtype = compute_dtype
        return self

    def forward_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> pre-softmax (B, D, H, W, 2)."""
        dt = self.compute_dtype
        skips = []
        h = x.to(dt)
        for i in range(4):
            h = getattr(self, f"dblock{i + 1}")(h)
            skips.append(h)
            h = maxpool2(h)
        h = self.cblock_center(h)
        for i in range(4):
            h = torch.cat([getattr(self, f"ublock{i + 1}")(h), skips[3 - i]],
                          -1)
        k = self.last_conv.weight[:, :, 0, 0, 0].t().to(dt)  # (C, 2)
        return h @ k + self.last_conv.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> (B, D, H, W, 2) softmax probabilities."""
        return torch.softmax(self.forward_logits(x), -1)


@register_model("UNet4_2IC")
class UNet4_2IC(RecAEv2Fixed):
    """2 input channels (broken skull + atlas), i_size 7."""

    input_channels = 2
    i_size = 7
