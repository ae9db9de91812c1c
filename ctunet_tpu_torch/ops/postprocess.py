"""Prediction postprocessing: thresholding and the largest connected
component, on the host and on the device.

Counterpart of ``ctunet_tpu/ops/postprocess.py``:

- :func:`threshold` binarizes a probability map;
- :func:`largest_cc` labels on the host with scipy (one pass), the
  postprocessor the serving loop installs for ``b_largest_cc``;
- :func:`largest_cc_device` floods voxel ids on the tensor's device until
  nothing changes, the JAX function's fix-point (``postprocess.py:57-82``).
"""

from __future__ import annotations

import numpy as np
import torch

from .preprocess import _cross_reduce


def threshold(volume: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Binarize a probability map: 1.0 where ``volume >= thr`` (f32)."""
    return (volume >= thr).float()


def largest_cc(mask: np.ndarray) -> np.ndarray:
    """Keep the largest 6-connected foreground component (float32 0/1)."""
    from scipy import ndimage

    mask = np.asarray(mask) > 0
    labels, n = ndimage.label(
        mask, structure=ndimage.generate_binary_structure(3, 1)
    )
    if n <= 1:
        return mask.astype(np.float32)
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return (labels == counts.argmax()).astype(np.float32)


def largest_cc_device(mask: torch.Tensor) -> torch.Tensor:
    """Keep the largest 6-connected component of a ``(D, H, W)`` mask on
    its device (f32 0/1).

    Each foreground voxel starts with its own id, ``z*H*W + y*W + x + 1``
    in int32 (f32 ids would collide above 2**24 voxels, merging
    components); the ids flood to the 6-neighbourhood maximum, confined to
    the foreground, until a sweep changes nothing. Each component then
    holds its largest id, and the id with the most voxels wins; on a tie in
    size the smaller id, as ``torch.argmax`` and ``jnp.argmax`` both take
    the first maximum. That is the component whose last voxel in raster
    order comes first, where :func:`largest_cc` takes the one whose first
    voxel comes first: the two agree unless two components tie in size
    and their orders differ.

    Costs one sweep of six shifted maxima per voxel of the longest path
    inside a component, and one host sync per sweep, to test for the
    fix-point (``lax.while_loop`` tests it on the TPU).
    """
    if mask.numel() >= 2 ** 31:
        raise ValueError("volume too large for int32 voxel ids")
    m = (mask > 0).to(torch.int32)
    d, h, w = mask.shape
    ids = (torch.arange(1, mask.numel() + 1, dtype=torch.int32,
                        device=mask.device).reshape(d, h, w)) * m
    cur = _cross_reduce(ids, torch.maximum, 0) * m
    prev = ids
    while not torch.equal(prev, cur):
        prev, cur = cur, _cross_reduce(cur, torch.maximum, 0) * m
    counts = torch.bincount(cur.reshape(-1), minlength=mask.numel() + 2)
    counts[0] = 0  # background
    biggest = torch.argmax(counts).to(torch.int32)
    return ((cur == biggest) & (m > 0)).float()
