"""Plain PyTorch float32 reference of the generic U-Net family that the
benchmark serves and trains (UNetSP, UNetSPSmall).

It follows the published model (the ``ctunet`` model zoo's ``UNet`` with
concatenated skips and no live center block) on weights in the flax
layout of the committed ``.npz`` exports: flat names without the
``params/unet/`` or ``batch_stats/unet/`` root, such as
``d0/unit0/conv/kernel`` (``(3, 3, 3, I, O)``), ``u1/upconv/kernel``
(``(2, 2, 2, O, I)``), ``last_conv/kernel`` (``(1, 1, 1, I, O)``) and
``d0/unit0/bn/mean``. Tensors are channels-last, ``(B, D, H, W, C)``.

- encoder level i: two conv units (conv k3 SAME without bias, BatchNorm,
  ReLU), the skip, a 2x2x2 max pool;
- decoder block j: ConvTranspose(k2, s2, bias) of its whole input, two
  conv units, then the output joined with the skip of its level (the last
  block's join feeds the 1x1 head);
- head: the 1x1 conv to 3 channels, a sigmoid, then the double-output
  head's two 3x2 maps (``double``), softmaxed for ``double_softmax``.

``q``, where given, rounds each operand of every conv, ConvTranspose and
head product before it is used (a lower-precision control); the gradient
passes through the rounding unchanged. Nothing here imports a kernel,
JAX or the package under test.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# the double-output head: full = out @ M_FULL; flap = out @ M_FLAP + B_FLAP
M_FULL = ((1.0, 0.0), (0.0, 1.0), (0.0, 1.0))
M_FLAP = ((0.0, 0.0), (-1.0, 1.0), (0.0, 0.0))
B_FLAP = (1.0, 0.0)
BN_EPS = 1e-5


def _same(t: Tensor) -> Tensor:
    return t


def conv3(x: Tensor, kernel: Tensor, q: Callable = _same) -> Tensor:
    """SAME 3x3x3 convolution of ``x`` with a ``(3, 3, 3, I, O)`` kernel."""
    w = q(kernel).permute(4, 3, 0, 1, 2)
    y = F.conv3d(q(x).permute(0, 4, 1, 2, 3), w, padding=1)
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose2(x: Tensor, kernel: Tensor, bias: Tensor,
                    q: Callable = _same) -> Tensor:
    """ConvTranspose(k2, s2): ``out[2z+a, 2y+b, 2x+c, o] = sum_i x[z, y,
    x, i] * kernel[a, b, c, o, i] + bias[o]``."""
    y = torch.einsum("nzyxi,abcoi->nzaybxco", q(x), q(kernel))
    n, d, _, h, _, w, _, co = y.shape
    return y.reshape(n, 2 * d, 2 * h, 2 * w, co) + bias


def batch_norm(x: Tensor, scale: Tensor, bias: Tensor,
               mean: Optional[Tensor], var: Optional[Tensor],
               seen: Optional[list] = None) -> Tensor:
    """BatchNorm over the channel axis: the batch's biased statistics
    when ``mean`` is None (training; appended to ``seen`` where given),
    else the running ones."""
    if mean is None:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = ((x - mean) ** 2).mean(axes)
        if seen is not None:
            seen.append((mean.detach(), var.detach()))
    return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias


def max_pool2(x: Tensor) -> Tensor:
    """2x2x2 max pool; ``amax`` splits the gradient evenly among ties."""
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).amax((2, 4, 6))


def conv_unit(x: Tensor, p: Dict[str, Tensor], s: Optional[Dict[str, Tensor]],
              name: str, q: Callable = _same,
              seen: Optional[Dict[str, tuple]] = None) -> Tensor:
    y = conv3(x, p[f"{name}/conv/kernel"], q)
    mean = None if s is None else s[f"{name}/bn/mean"]
    var = None if s is None else s[f"{name}/bn/var"]
    got = [] if seen is not None else None
    y = batch_norm(y, p[f"{name}/bn/scale"], p[f"{name}/bn/bias"], mean, var,
                   got)
    if got:
        seen[name] = got[0]
    return torch.relu(y)


def forward(p: Dict[str, Tensor], s: Optional[Dict[str, Tensor]], x: Tensor,
            n_blocks: int, head: str, q: Callable = _same,
            seen: Optional[Dict[str, tuple]] = None
            ) -> Tuple[Tensor, Tensor]:
    """``(full, flap)`` head outputs, each ``(B, D, H, W, 2)``, of the
    U-Net on ``x`` ``(B, D, H, W, C)``. ``s`` None: training mode (the
    batch's statistics, each unit's ``(mean, var)`` put in ``seen`` by
    its name where given), else the running statistics."""
    h = x
    skips = []
    for i in range(n_blocks):
        h = conv_unit(h, p, s, f"d{i}/unit0", q, seen)
        h = conv_unit(h, p, s, f"d{i}/unit1", q, seen)
        skips.append(h)
        h = max_pool2(h)
    for j in range(n_blocks):
        u = conv_transpose2(h, p[f"u{j}/upconv/kernel"],
                            p[f"u{j}/upconv/bias"], q)
        u = conv_unit(u, p, s, f"u{j}/unit0", q, seen)
        u = conv_unit(u, p, s, f"u{j}/unit1", q, seen)
        h = torch.cat([u, skips[n_blocks - 1 - j]], -1)
    k = p["last_conv/kernel"][0, 0, 0]  # (I, 3)
    out = torch.sigmoid(q(h) @ q(k) + p["last_conv/bias"])
    dev = out.device
    full = out @ torch.tensor(M_FULL, device=dev)
    flap = out @ torch.tensor(M_FLAP, device=dev) + torch.tensor(B_FLAP,
                                                                  device=dev)
    if head == "double_softmax":
        return torch.softmax(full, -1), torch.softmax(flap, -1)
    if head != "double":
        raise ValueError(f"head {head!r}: double or double_softmax")
    return full, flap


def split_weights(flat: Dict[str, Tensor]):
    """``(params, stats)`` of a flat flax-layout weight dict (the keys of
    an ``.npz`` export), without their ``params/unet/`` and
    ``batch_stats/unet/`` roots."""
    p, s = {}, {}
    for k, v in flat.items():
        root, _, rest = k.partition("/")
        rest = rest[len("unet/"):] if rest.startswith("unet/") else rest
        (p if root == "params" else s)[rest] = v
    return p, s
