"""Binary morphology on the device: 6-neighbourhood erosion and dilation.

Counterpart of ``ctunet_tpu/ops/preprocess.py:106-148`` (reference
``ctunet/pytorch/transforms.py:97-127,356-377``, the SimpleITK
``{Erode,Dilate}ObjectMorphology`` default of a radius-1 cross): each pass
takes the minimum (erosion) or maximum (dilation) of a voxel and its six
face neighbours. A neighbour outside the volume reads ``pad_value``: 1.0
for erosion and 0.0 for dilation, so the border neither erodes nor grows
by itself.

:func:`erode_dilate` draws its coin and its choice from a
``torch.Generator``; :func:`erode_dilate_core` takes them as values (the
split of ``ops/synthesis.py``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cross_reduce(x: Tensor, op, pad_value: float) -> Tensor:
    """``op`` of every voxel with its two neighbours along each axis, the
    neighbours taken from ``x`` itself (``preprocess.py:106-120``)."""
    out = x
    for axis in range(x.ndim):
        n = x.shape[axis]
        edge = torch.full_like(x.narrow(axis, 0, 1), pad_value)
        lo = torch.cat([edge, x.narrow(axis, 0, n - 1)], axis)
        hi = torch.cat([x.narrow(axis, 1, n - 1), edge], axis)
        out = op(op(out, lo), hi)
    return out


def dilate(volume: Tensor, times: int = 1) -> Tensor:
    """Binary dilation, 6-neighbourhood (``preprocess.py:123-129``)."""
    v = (volume > 0).float()
    for _ in range(times):
        v = _cross_reduce(v, torch.maximum, 0.0)
    return v


def erode(volume: Tensor, times: int = 1) -> Tensor:
    """Binary erosion, 6-neighbourhood (``preprocess.py:132-138``)."""
    v = (volume > 0).float()
    for _ in range(times):
        v = _cross_reduce(v, torch.minimum, 1.0)
    return v


def erode_dilate_core(volume: Tensor, choice, apply) -> Tensor:
    """Erode (``choice`` 0) or dilate (1) the binarized volume once when
    ``apply``; else the binarized volume. ``choice`` and ``apply`` may be
    device tensors: both branches are computed, nothing waits for the
    host."""
    v = (volume > 0).float()
    dev = v.device
    out = torch.where(torch.as_tensor(choice, device=dev) == 0, erode(v),
                      dilate(v))
    return torch.where(torch.as_tensor(apply, device=dev), out, v)


def erode_dilate(gen: torch.Generator, volume: Tensor,
                 p: float = 1.0) -> Tensor:
    """With probability ``p``, erode or dilate once, each with probability
    1/2 (``preprocess.py:141-148``)."""
    dev = volume.device
    choice = torch.randint(0, 2, (), generator=gen, device=dev)
    coin = torch.rand((), generator=gen, device=dev)
    return erode_dilate_core(volume, choice, coin <= p)
