"""Generic 3D U-Net family as PyTorch ``nn.Module``s (plain f32 forward).

Counterpart of ``ctunet_tpu/models/unet.py`` and the numerical reference of
the port: the bf16 engine (``ctunet_tpu_torch/engine.py``) is held against
this forward. It reproduces the effective graph of the reference model zoo
(``ctunet/pytorch/models.py:158-261``):

- quirk Q1: with ``fc_layer=None`` (every shipped variant) the reference
  computes the center block and then discards it (``models.py:241``), so the
  decoder consumes the last pooled feature map directly. No center block is
  built here; the dead ``cblock.*`` keys of a reference checkpoint are
  dropped on load (``checkpoint.py``);
- decoder widths follow ``unet.py:599-634``: block ``u{idx}`` upsamples its
  whole input with a ConvTranspose(k2, s2) of the same width, then two conv
  units to ``i_size * 2**i`` channels; its output is concatenated with the
  encoder skip ``d[i]`` for the next block;
- the final skip concat is never built: ``last_conv`` is one
  ``Conv3d(2*i_size, out, 1)`` in the reference, applied here weight-split
  over the pair (``unet.py:619-639``).

Submodule names are the reference's state_dict keys (``d_blocks.{i}.block``,
``u_blocks.{j}.block``, ``last_conv``), so a reference ``.pt`` loads with
``load_state_dict``. The public layout is channels-last, ``(B, D, H, W, C)``
in and out, like ``ctunet_tpu``; the modules run NCDHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv_unit(cin: int, cout: int):
    """Conv3d(k3, SAME, no bias) + BatchNorm3d + ReLU (``models.py:9-49``)."""
    return [nn.Conv3d(cin, cout, 3, padding=1, bias=False),
            nn.BatchNorm3d(cout, eps=1e-5), nn.ReLU()]


class UNetBlock(nn.Module):
    """Two conv units; an up block prepends ConvTranspose3d(k2, s2, bias).

    ``block`` indices match the reference: down ``0,1,2,3,4,5`` =
    (conv, bn, relu) x 2; up ``0`` = convT, then (conv, bn, relu) x 2 at
    ``1..6``.
    """

    def __init__(self, cin: int, cout: int, up_block: bool = False):
        super().__init__()
        layers = _conv_unit(cin, cout) + _conv_unit(cout, cout)
        if up_block:
            layers.insert(0, nn.ConvTranspose3d(cin, cin, 2, stride=2))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class UNet(nn.Module):
    """Generic U-Net (``models.py:158-261``), concat skips, sigmoid head."""

    def __init__(self, input_channels: int = 1, out_channels: int = 2,
                 n_blocks: int = 4, i_size: int = 8):
        super().__init__()
        self.n_blocks = n_blocks
        widths = [i_size * 2 ** i for i in range(n_blocks)]
        self.d_blocks = nn.ModuleList()
        cin = input_channels
        for w in widths:
            self.d_blocks.append(UNetBlock(cin, w))
            cin = w
        self.u_blocks = nn.ModuleList()
        for idx in range(n_blocks):
            i = n_blocks - 1 - idx
            self.u_blocks.append(UNetBlock(cin, widths[i], up_block=True))
            cin = 2 * widths[i]
        self.last_conv = nn.Conv3d(cin, out_channels, 1)

    def forward_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> pre-sigmoid (B, D, H, W, out_channels)."""
        h = x.permute(0, 4, 1, 2, 3)
        skips = []
        for blk in self.d_blocks:
            h = blk(h)
            skips.append(h)
            h = F.max_pool3d(h, 2)
        for idx, blk in enumerate(self.u_blocks):
            u = blk(h)
            skip = skips[self.n_blocks - 1 - idx]
            h = torch.cat([u, skip], 1) if idx < self.n_blocks - 1 else None
        # weight-split 1x1 head over (last decoder output, first skip)
        ca = u.shape[1]
        w = self.last_conv.weight
        out = (F.conv3d(u, w[:, :ca]) + F.conv3d(skip, w[:, ca:])
               + self.last_conv.bias[None, :, None, None, None])
        return out.permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.forward_logits(x))
