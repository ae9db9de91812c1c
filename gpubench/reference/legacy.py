"""Plain PyTorch float32 reference of the legacy k=5 U-Net family that the
benchmark serves (``UNet4_2IC``; ``recAE_v2_fixed`` has the same layers at
other widths).

It follows the published model, ``ctunet/pytorch/models.py:441-557``
(``recAE_v2_fixed`` and ``UNet4_2IC`` on top of it), on weights named as
that model's ``state_dict``: ``dblock{1..4}`` and ``cblock_center`` are
``(conv, bn, relu) x 2`` at ``0..5``, ``ublock{1..4}`` the ConvTranspose at
``0`` then ``(conv, bn, relu) x 2`` at ``1..6``, and ``last_conv``; conv
weights ``(O, I, 5, 5, 5)``, ConvTranspose weights ``(I, O, 2, 2, 2)``.
Tensors are channels-last, ``(B, D, H, W, C)``.

- conv unit: conv k5 with padding 2 and its bias, BatchNorm on the
  running statistics (eps 1e-5), ReLU;
- encoder level i: two conv units, the skip, a 2x2x2 max pool;
- the centre block: two conv units, in the data path;
- decoder block j: ConvTranspose(k2, s2, bias) of its whole input, two
  conv units, then ``cat([block output, skip], -1)``;
- head: the 1x1 ``last_conv`` with its bias, a softmax over the 2 classes.

Departures from the published model, none of which changes a value it
defines: inference only (BatchNorm on its running statistics); the head's
softmax in f32, where the model softmaxes in its compute dtype; the 1x1
head as a matmul over the channel axis. Run it under
``systems.reference_precision()`` (TF32 off).

``q``, where given, rounds each operand of every conv, ConvTranspose and
head product before it is used (a lower-precision control). Nothing here
imports a kernel, JAX or the package under test.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

BN_EPS = 1e-5
N_LEVELS = 4


def _same(t: Tensor) -> Tensor:
    return t


def conv5(x: Tensor, weight: Tensor, bias: Tensor,
          q: Callable = _same) -> Tensor:
    """SAME 5x5x5 convolution of ``x`` with a torch ``(O, I, 5, 5, 5)``
    weight and its bias."""
    y = F.conv3d(q(x).permute(0, 4, 1, 2, 3), q(weight), bias, padding=2)
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose2(x: Tensor, weight: Tensor, bias: Tensor,
                    q: Callable = _same) -> Tensor:
    """ConvTranspose(k2, s2) with a torch ``(I, O, 2, 2, 2)`` weight:
    ``out[2z+a, 2y+b, 2x+c, o] = sum_i x[z, y, x, i] * weight[i, o, a, b,
    c] + bias[o]``."""
    y = torch.einsum("nzyxi,ioabc->nzaybxco", q(x), q(weight))
    n, d, _, h, _, w, _, co = y.shape
    return y.reshape(n, 2 * d, 2 * h, 2 * w, co) + bias


def max_pool2(x: Tensor) -> Tensor:
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).amax((2, 4, 6))


def conv_unit(x: Tensor, sd: Dict[str, Tensor], prefix: str, conv: int,
              q: Callable = _same) -> Tensor:
    """Conv ``{prefix}.{conv}``, BatchNorm ``{prefix}.{conv + 1}``, ReLU."""
    y = conv5(x, sd[f"{prefix}.{conv}.weight"], sd[f"{prefix}.{conv}.bias"],
              q)
    bn = f"{prefix}.{conv + 1}"
    y = ((y - sd[f"{bn}.running_mean"])
         * torch.rsqrt(sd[f"{bn}.running_var"] + BN_EPS)
         * sd[f"{bn}.weight"] + sd[f"{bn}.bias"])
    return torch.relu(y)


def forward(sd: Dict[str, Tensor], x: Tensor, q: Callable = _same) -> Tensor:
    """Softmax probabilities ``(B, D, H, W, 2)`` of the model on ``x``
    ``(B, D, H, W, C)``, every spatial extent a multiple of 16."""
    h = x
    skips = []
    for i in range(N_LEVELS):
        h = conv_unit(h, sd, f"dblock{i + 1}", 0, q)
        h = conv_unit(h, sd, f"dblock{i + 1}", 3, q)
        skips.append(h)
        h = max_pool2(h)
    h = conv_unit(h, sd, "cblock_center", 0, q)
    h = conv_unit(h, sd, "cblock_center", 3, q)
    for j in range(N_LEVELS):
        name = f"ublock{j + 1}"
        u = conv_transpose2(h, sd[f"{name}.0.weight"], sd[f"{name}.0.bias"],
                            q)
        u = conv_unit(u, sd, name, 1, q)
        u = conv_unit(u, sd, name, 4, q)
        h = torch.cat([u, skips[N_LEVELS - 1 - j]], -1)
    k = sd["last_conv.weight"][:, :, 0, 0, 0].t()  # (C, 2)
    return torch.softmax(q(h) @ q(k) + sd["last_conv.bias"], -1)


def load(path: str, device) -> Dict[str, Tensor]:
    """A ``torch.save`` state_dict file as f32 tensors on ``device`` (read
    with ``weights_only``: tensors and containers only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device, torch.float32) for k, v in sd.items()}
