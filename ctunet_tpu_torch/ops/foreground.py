"""Volume-level foreground cropping for serving and training.

The port's own copy of ``ctunet_tpu/ops/foreground.py`` (numpy, same
outputs). A skull fills a fraction of the preprocessed canvas, and the
kernels' cost is proportional to the voxels they see, so serving runs the
engine on the foreground bounding box plus a margin and pastes the mask
back into the full canvas on the host.

Outside the crop the input is exactly zero, so the crop's SAME-padding
zeros match the true data for every first-layer voxel. Deeper layers see
zero padding where the whole-volume run carries constant bias/BN fields,
so predictions can differ in a receptive-field band at the crop border;
the margin pushes that band into empty space, and offsets snap to the
pooling multiple so every pool grid stays aligned with the whole-volume
run. An all-zero input gives a spatially constant prediction, so the
full-canvas mask is the crop's mask pasted into one constant class
(:func:`background_class` measures it on an empty volume).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Slices = Tuple[slice, ...]


def plan_crop(
    vol: np.ndarray,
    margin: int = 16,
    multiple: int = 16,
    min_size: Optional[Sequence[int]] = None,
) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Foreground crop plan ``(offsets, sizes)`` for one ``(D, H, W)``
    volume (``foreground.py:38-76``): offsets snapped DOWN to ``multiple``,
    sizes the bounding box plus ``margin`` on each side snapped UP to
    ``multiple``, at least ``min_size``, clamped to the canvas. ``None``
    when the volume is empty or no axis would shrink."""
    vol = np.asarray(vol)
    assert vol.ndim == 3, vol.shape
    offs, sizes = [], []
    any_gain = False
    for ax in range(3):
        other = tuple(i for i in range(3) if i != ax)
        nz = np.flatnonzero(np.any(vol != 0, axis=other))
        if nz.size == 0:
            return None
        lo = max(0, int(nz[0]) - margin)
        hi = min(vol.shape[ax], int(nz[-1]) + 1 + margin)
        lo = (lo // multiple) * multiple
        size = -(-(hi - lo) // multiple) * multiple
        if min_size is not None:
            size = max(size, int(min_size[ax]))
        size = min(size, vol.shape[ax])
        lo = min(lo, vol.shape[ax] - size)
        offs.append(lo)
        sizes.append(size)
        any_gain |= size < vol.shape[ax]
    if not any_gain:
        return None
    return tuple(offs), tuple(sizes)


def crop_slices(offsets: Sequence[int], sizes: Sequence[int]) -> Slices:
    return tuple(slice(o, o + s) for o, s in zip(offsets, sizes))


def paste_full(
    crop_mask: np.ndarray,
    offsets: Sequence[int],
    full_shape: Sequence[int],
    background: int = 0,
) -> np.ndarray:
    """Paste a cropped ``(..., d, h, w)`` mask into a ``background``-filled
    full-canvas array, leading batch dimensions kept."""
    crop_mask = np.asarray(crop_mask)
    out = np.full(crop_mask.shape[:-3] + tuple(full_shape), background,
                  crop_mask.dtype)
    out[(Ellipsis,) + crop_slices(offsets, crop_mask.shape[-3:])] = crop_mask
    return out


def background_class(predict, input_shape, device, dtype=None) -> list:
    """Argmax class of the model on an EMPTY volume, per output head
    (``foreground.py:99-115``): the prediction there is spatially constant,
    so the centre voxel's class is the one to fill outside a crop.
    ``predict`` takes ``(1, *input_shape)`` tensors on ``device``;
    ``input_shape`` is unbatched, e.g. ``(32, 32, 32, 2)``."""
    import torch

    x = torch.zeros((1, *input_shape), dtype=dtype or torch.float32,
                    device=device)
    with torch.inference_mode():
        out = predict(x)
    classes = []
    for o in out if isinstance(out, (tuple, list)) else (out,):
        a = o[0].float().cpu().numpy()
        center = tuple(s // 2 for s in a.shape[:-1])
        classes.append(int(np.argmax(a[center])))
    return classes
