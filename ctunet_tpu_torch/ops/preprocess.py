"""CT ingest on the device: HU windowing, resampling, padding, and binary
morphology (6-neighbourhood erosion and dilation).

Counterpart of ``ctunet_tpu/ops/preprocess.py``, whose functions are XLA
there; here they are plain PyTorch on the tensor's device.

- :func:`hu_window` clips to an HU window and thresholds to bone, or
  rescales the window to [0, 1] (``preprocess.py:25-40``).
- :func:`resample_to_shape` is ``jax.image.resize(..., "trilinear")``,
  which is not ``F.interpolate``: it antialiases when it downsamples,
  widening the triangle kernel by the inverse scale, and normalizes each
  output sample's weights (``jax/_src/image/scale.py``
  ``compute_weight_mat``). The same per-axis weight matrices are built here
  in f32 and applied as one contraction per resized axis; an axis whose
  size does not change is left alone, as JAX skips it.
- :func:`resample_to_spacing`, :func:`fixed_pad`, :func:`unpad` and
  :func:`pad_to_multiple` as ``preprocess.py:50-103`` (reference
  ``transforms.py:303-335``).
- The morphology (``preprocess.py:106-148``, reference
  ``transforms.py:97-127,356-377``, the SimpleITK
  ``{Erode,Dilate}ObjectMorphology`` default of a radius-1 cross): each
  pass takes the minimum (erosion) or maximum (dilation) of a voxel and its
  six face neighbours. A neighbour outside the volume reads ``pad_value``:
  1.0 for erosion and 0.0 for dilation, so the border neither erodes nor
  grows by itself. :func:`erode_dilate` draws its coin and its choice from
  a ``torch.Generator``; :func:`erode_dilate_core` takes them as values
  (the split of ``ops/synthesis.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def hu_window(volume: Tensor, lo: float = -100.0, hi: float = 1500.0,
              threshold: float = 150.0, binarize: bool = True) -> Tensor:
    """Clip a CT volume to ``[lo, hi]`` HU, then either threshold it to
    binary bone (``>= threshold``) or rescale the window to [0, 1]; f32."""
    v = torch.clamp(volume.float(), lo, hi)
    if binarize:
        return (v >= threshold).float()
    # times the f32 reciprocal of the width, as XLA compiles the division
    return (v - lo) * (1.0 / (hi - lo))


def _resize_weights(n_in: int, n_out: int, device) -> Tensor:
    """``(n_in, n_out)`` f32 weights of one axis of
    ``jax.image.resize(method="trilinear", antialias=True)``: the triangle
    kernel at the output samples' positions in the input, widened by
    ``n_in / n_out`` when that exceeds 1, each column normalized to sum 1,
    and zero for a sample outside the input."""
    inv = 1.0 / (n_out / n_in)
    kscale = max(inv, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv - 0.0 - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resample_to_shape(volume: Tensor, target_shape: Sequence[int]) -> Tensor:
    """Trilinear resample of a ``(D, H, W)`` volume (any rank) to
    ``target_shape``, in f32, as ``jax.image.resize`` computes it
    (antialiased when downsampling; see the module docstring)."""
    out = volume.float()
    for axis, n_out in enumerate(int(t) for t in target_shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = _resize_weights(n_in, n_out, out.device)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out.contiguous()


def resample_to_spacing(volume: Tensor, spacing: Sequence[float],
                        target_spacing: Sequence[float] = (1.0, 1.0, 1.0)
                        ) -> Tensor:
    """Resample to ``target_spacing``: each axis to
    ``max(1, round(size * spacing / target))`` voxels (Python's rounding,
    half to even, as the JAX function computes the shape on the host)."""
    shape = tuple(max(1, int(round(s * sp / tsp)))
                  for s, sp, tsp in zip(volume.shape, spacing,
                                        target_spacing))
    return resample_to_shape(volume, shape)


def fixed_pad(v: Tensor, final_img_size: Sequence[int],
              constant_value: float = 0.0):
    """Pad the trailing edge of each axis up to ``final_img_size``
    (reference ``transforms.py:311-335``): ``(padded, padding)`` with
    ``padding`` the ``(before, after)`` pairs :func:`unpad` takes. Raises
    ``ValueError`` when the input exceeds the target."""
    padding = tuple((0, int(t) - int(s))
                    for s, t in zip(v.shape, final_img_size))
    if any(int(s) > int(t) for s, t in zip(v.shape, final_img_size)):
        raise ValueError(f"input size {tuple(v.shape)} exceeds target "
                         f"{tuple(final_img_size)}")
    flat = [p for pair in reversed(padding) for p in pair]
    return F.pad(v, flat, value=constant_value), padding


def unpad(x: Tensor, pad_width) -> Tensor:
    """Inverse of :func:`fixed_pad` (reference ``transforms.py:303-308``)."""
    return x[tuple(slice(b, None if a == 0 else -a) for b, a in pad_width)]


def pad_to_multiple(v: Tensor, multiple: int = 16,
                    constant_value: float = 0.0):
    """Pad each axis up to the next multiple of ``multiple`` (the U-Net's
    pools need sizes divisible by ``2 ** n_blocks``): ``(padded,
    padding)``."""
    target = tuple(math.ceil(s / multiple) * multiple for s in v.shape)
    return fixed_pad(v, target, constant_value)


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
