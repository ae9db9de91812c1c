"""Spatial augmentation on the device: affine warps, elastic deformation,
the S-axis flip and the cranioplasty chain that composes them.

Counterpart of ``ctunet_tpu/ops/warp.py`` (reference
``ctunet/pytorch/transforms.py:173-228``, torchio's ``RandomFlip(('S',))``,
``RandomElasticDeformation(7, locked_borders=2)`` and ``RandomAffine(scales
=(0.9, 1.1), translation=(10, 10, 15), degrees=15)``, all nearest): a
coordinate-grid gather for the affine, and a coarse control-point
displacement field upsampled trilinearly for the elastic warp.

Sampling is ``jax.scipy.ndimage.map_coordinates`` with ``mode="constant"``
and ``cval=0`` at ``order=0``: nearest rounds half away from zero, as JAX
does (``torch.round`` and ``grid_sample`` round half to even), and a
coordinate outside ``[0, size)`` reads 0. ``jax.image.resize(...,
"trilinear")`` of the coarse field is ``F.interpolate(mode="trilinear",
align_corners=False)`` when it upsamples.

As in ``ops/synthesis.py`` each random transform is a **draw** (the
functions that take a ``torch.Generator``, ``draw_*``) and a **core**
(``*_core``), a deterministic function of the volume and the drawn values
that the tests hold against JAX. Drawn values stay tensors on the volume's
device, and a coin picks between the warped and the unwarped volume with
``torch.where``, so no draw waits for the host. Single volumes
``(D, H, W)``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .preprocess import erode_dilate
from .synthesis import salt_and_pepper, skull_random_hole

Tensor = torch.Tensor


def _identity_grid(shape, device) -> Tensor:
    """(3, D, H, W) f32 voxel-coordinate grid."""
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def _round_half_away(c: Tensor) -> Tensor:
    """Round to the nearest integer, halves away from zero (``lax.round``),
    exactly: ``c - trunc(c)`` is exact in f32."""
    t = torch.trunc(c)
    f = c - t
    return t + (f >= 0.5).float() - (f <= -0.5).float()


def _gather(volume: Tensor, idx) -> Tensor:
    """``volume[iz, iy, ix]`` for integer index tensors, 0 where an index
    lies outside the volume."""
    valid = None
    flat = None
    for i, n in zip(idx, volume.shape):
        ok = (i >= 0) & (i < n)
        valid = ok if valid is None else valid & ok
        i = i.clamp(0, n - 1)
        flat = i if flat is None else flat * n + i
    vals = volume.reshape(-1)[flat]
    return torch.where(valid, vals, torch.zeros_like(vals))


def _sample(volume: Tensor, coords: Tensor) -> Tensor:
    """Gather ``volume`` at ``(3, *out_shape)`` coordinates, nearest, 0
    outside (``warp.py:43-48`` at ``order=0``)."""
    return _gather(volume, [_round_half_away(c).long() for c in coords])


def affine_warp(volume: Tensor, matrix: Tensor,
                translation: Tensor) -> Tensor:
    """Warp by an output -> input affine around the volume's centre,
    nearest:
    ``in = M @ (out - c) + c - t`` (``warp.py:51-62``)."""
    shape, dev = volume.shape, volume.device
    grid = _identity_grid(shape, dev).reshape(3, -1)
    center = (torch.tensor(shape, dtype=torch.float32, device=dev)
              - 1.0)[:, None] / 2.0
    matrix = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=dev)
    src = matrix @ (grid - center) + center - translation[:, None]
    return _sample(volume, src.reshape(3, *shape))


def _rotation_matrix(angles: Tensor) -> Tensor:
    """Composite rotation ``rz @ ry @ rx`` from per-axis angles in radians
    (``warp.py:65-75``)."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rz = mat([[one, zero, zero], [zero, c[0], -s[0]], [zero, s[0], c[0]]])
    ry = mat([[c[1], zero, s[1]], [zero, one, zero], [-s[1], zero, c[1]]])
    rx = mat([[c[2], -s[2], zero], [s[2], c[2], zero], [zero, zero, one]])
    return rz @ ry @ rx


def _coin_where(apply, warped: Tensor, volume: Tensor) -> Tensor:
    return torch.where(torch.as_tensor(apply, device=volume.device), warped,
                       volume)


def random_affine_core(volume: Tensor, scale, translation, angles,
                       apply) -> Tensor:
    """The zoom/shift/rotation of the drawn ``scale``, ``translation`` and
    ``angles`` (each ``(3,)``), nearest, when ``apply``: the output ->
    input map is ``R(-angles) @ diag(1 / scale)`` (``warp.py:96-99``)."""
    dev = volume.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    angles = torch.as_tensor(angles, dtype=torch.float32, device=dev)
    matrix = _rotation_matrix(-angles) @ torch.diag(1.0 / scale)
    return _coin_where(apply, affine_warp(volume, matrix, translation),
                       volume)


def draw_affine(gen: torch.Generator, device,
                scales: Tuple[float, float] = (0.9, 1.1),
                translation: Tuple[float, float, float] = (10.0, 10.0, 15.0),
                degrees: float = 15.0, p: float = 0.5) -> Dict[str, Tensor]:
    """``scale`` ~ U(scales), ``translation`` ~ U(-1, 1) * ``translation``,
    ``angles`` ~ U(-degrees, degrees) in radians, and the coin
    (``warp.py:78-101``)."""
    u = torch.rand(10, generator=gen, device=device)
    t_max = torch.tensor(translation, dtype=torch.float32, device=device)
    rad = math.radians(degrees)
    return dict(scale=scales[0] + (scales[1] - scales[0]) * u[0:3],
                translation=(2.0 * u[3:6] - 1.0) * t_max,
                angles=(2.0 * u[6:9] - 1.0) * rad,
                apply=u[9] <= p)


def random_affine(gen: torch.Generator, volume: Tensor,
                  scales: Tuple[float, float] = (0.9, 1.1),
                  translation: Tuple[float, float, float] = (10.0, 10.0,
                                                             15.0),
                  degrees: float = 15.0, p: float = 0.5) -> Tensor:
    """Random zoom/shift/rotation with probability ``p`` (torchio
    ``RandomAffine`` as ``transforms.py:203-206`` uses it), nearest."""
    return random_affine_core(volume, **draw_affine(
        gen, volume.device, scales, translation, degrees, p))


def random_elastic_core(volume: Tensor, disp: Tensor, apply) -> Tensor:
    """Warp by the coarse displacement grid ``disp`` ``(3, n, n, n)``
    (voxels, borders already locked) upsampled trilinearly to the volume,
    nearest, when ``apply`` (``warp.py:104-133``)."""
    disp = torch.as_tensor(disp, dtype=torch.float32, device=volume.device)
    field = F.interpolate(disp[None], size=tuple(volume.shape),
                          mode="trilinear", align_corners=False)[0]
    coords = _identity_grid(volume.shape, volume.device) + field
    return _coin_where(apply, _sample(volume, coords), volume)


def draw_elastic(gen: torch.Generator, device, num_control_points: int = 7,
                 max_displacement: float = 7.5, locked_borders: int = 2,
                 p: float = 0.5) -> Dict[str, Tensor]:
    """Displacements ~ U(-max, max) on an ``n^3`` grid per axis, zero within
    ``locked_borders`` of its faces, and the coin."""
    n = num_control_points
    u = torch.rand(3 * n ** 3 + 1, generator=gen, device=device)
    disp = ((2.0 * u[:-1] - 1.0) * max_displacement).reshape(3, n, n, n)
    if locked_borders > 0:
        lb = locked_borders
        mask = torch.zeros((n, n, n), device=device)
        mask[lb:-lb, lb:-lb, lb:-lb] = 1.0
        disp = disp * mask
    return dict(disp=disp, apply=u[-1] <= p)


def random_elastic(gen: torch.Generator, volume: Tensor,
                   num_control_points: int = 7,
                   max_displacement: float = 7.5, locked_borders: int = 2,
                   p: float = 0.5) -> Tensor:
    """Random elastic deformation with probability ``p`` (torchio
    ``RandomElasticDeformation`` as ``transforms.py:198-200`` uses it)."""
    return random_elastic_core(volume, **draw_elastic(
        gen, volume.device, num_control_points, max_displacement,
        locked_borders, p))


def random_flip_s(gen: torch.Generator, volume: Tensor,
                  p: float = 0.5) -> Tensor:
    """Flip along the S (first, z) axis with probability ``p``
    (``tio.RandomFlip(('S',), .5)``, ``warp.py:136-141``)."""
    coin = torch.rand((), generator=gen, device=volume.device)
    return _coin_where(coin <= p, volume.flip(0), volume)


def cranioplasty_transform(gen: torch.Generator, volume: Tensor):
    """The augmentation chain of the single-output shape-prior problem
    (``warp.py:144-165``): erode/dilate (p .3) -> S-flip (.5) -> elastic
    (.5) -> affine (.5) -> threshold at 0.5 -> hole (.9) -> salt and pepper
    (1, density .05), drawn in that order.

    Returns ``(noisy broken skull, (full skull, flap))``, f32 volumes.
    """
    full = (volume > 0).float()
    full = erode_dilate(gen, full, p=0.3)
    full = random_flip_s(gen, full, p=0.5)
    full = random_elastic(gen, full, p=0.5)
    full = random_affine(gen, full, p=0.5)
    full = (full > 0.5).float()
    broken, flap = skull_random_hole(gen, full, p=0.9)
    broken = salt_and_pepper(gen, broken, p=1.0, noise_density=0.05)
    return broken, (full, flap)
