"""On-device self-supervised target synthesis (virtual craniectomy).

Counterpart of ``ctunet_tpu/ops/synthesis.py`` (reference
``ctunet/pytorch/transforms.py`` + ``ctunet/utilities.py:127-178``): pick a
random nonzero voxel of a binary skull, rasterize a sphere, a box or a
"flap" (cube + 2 cylinders) around it and mask it out, which gives a
(broken skull, extracted flap) training pair; then add salt-and-pepper
noise.

Each transform is split in two. The **core** (``*_core``, the keep masks)
is a deterministic function of the volume and of the drawn values (centre,
size, type, ``c_diam``, density, coin, the per-voxel random numbers); it is
what the tests hold against the JAX functions, value for value. The
**drawing layer** (the functions that take a ``torch.Generator``) draws
those values and calls the core: a JAX threefry stream and a torch Philox
stream cannot give the same numbers, so the two packages agree in
distribution only. Every drawn value stays a tensor on the generator's
device, so a synthesis step never waits for the host.

Single volumes ``(D, H, W)``; the train step loops over the batch.
Quirk Q3 (``synthesis.py:22-27``) is kept as the JAX package has it: the
noise density is drawn per call, U(0, max density).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def _coords(shape, device):
    """Broadcastable (z, y, x) f32 index grids of a volume shape."""
    d, h, w = shape
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device)  # noqa: E731
    return ar(d)[:, None, None], ar(h)[None, :, None], ar(w)[None, None, :]


def _f32(v, device) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def sphere_keep_mask(shape, center, size, device=None) -> Tensor:
    """1 outside the sphere, 0 inside (L2 distance <= size)."""
    center, size = _f32(center, device), _f32(size, device)
    zz, yy, xx = _coords(shape, center.device)
    d2 = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2
          + (xx - center[2]) ** 2)
    return (d2 > size * size).float()


def box_keep_mask(shape, center, size, device=None) -> Tensor:
    """1 outside the box, 0 inside (Chebyshev distance <= size)."""
    center, size = _f32(center, device), _f32(size, device)
    zz, yy, xx = _coords(shape, center.device)
    cheb = torch.maximum(
        torch.maximum((zz - center[0]).abs(), (yy - center[1]).abs()),
        (xx - center[2]).abs())
    return (cheb > size).float()


def flap_keep_mask(shape, center, size, c_diam, device=None) -> Tensor:
    """1 outside the "flap", 0 inside: a cube of side ``size`` at
    ``center`` joined with two cylinders (axis z, height ``size``, radius
    ``c_diam``) at the cube's two x-extremes, offset ``-size/2`` in y, with
    the relative-coordinate round trip of ``synthesis.py:69-98``."""
    center, size = _f32(center, device), _f32(size, device)
    c_diam = _f32(c_diam, center.device)
    zz, yy, xx = _coords(shape, center.device)
    dims = _f32(shape, center.device)
    scale = (dims - 1.0) / dims
    cz, cy, cx = (center[i] * scale[i] for i in range(3))
    half = size / 2.0
    in_z = (zz - cz).abs() <= half
    cube = in_z & ((yy - cy).abs() <= half) & ((xx - cx).abs() <= half)
    ey = (center[1] - half) * scale[1]
    ex1 = (center[2] - half) * scale[2]
    ex2 = (center[2] + half) * scale[2]
    r2 = c_diam * c_diam
    cyl1 = in_z & ((yy - ey) ** 2 + (xx - ex1) ** 2 <= r2)
    cyl2 = in_z & ((yy - ey) ** 2 + (xx - ex2) ** 2 <= r2)
    return 1.0 - (cube | cyl1 | cyl2).float()


PATCH_TYPES = ("sphere", "box", "flap")


def nonzero_voxel_core(volume: Tensor, scores: Tensor):
    """The nonzero voxel with the largest score: ``((z, y, x) f32,
    any_nonzero)``. ``scores`` are integers of the volume's shape
    (``random_nonzero_voxel``, ``synthesis.py:101-126``: the first maximum
    in row-major order)."""
    nz = volume > 0
    flat = torch.where(nz, scores, torch.zeros_like(scores)).reshape(-1)
    idx = torch.argmax(flat)
    _, h, w = volume.shape
    center = torch.stack([idx // (h * w), (idx // w) % h, idx % w]).float()
    return center, nz.any()


def random_nonzero_voxel(gen: torch.Generator, volume: Tensor):
    """A uniformly drawn nonzero voxel of ``volume``: ``((z, y, x) f32,
    any_nonzero)`` (``synthesis.py:101-126``): one 32-bit score per voxel,
    the nonzero voxel with the largest wins (:func:`nonzero_voxel_core`).
    For an empty volume the centre is voxel 0 and ``any_nonzero`` False."""
    scores = torch.randint(0, 2 ** 32, tuple(volume.shape), generator=gen,
                           device=volume.device, dtype=torch.int64)
    return nonzero_voxel_core(volume, scores)


def radius_bounds(shape) -> Tuple[int, int]:
    """Bounds of the patch size (``transforms.py:265-268``)."""
    min_radius = (min(shape) // 5) - 1
    max_radius = int(max(min_radius, max(shape) // 3.5))
    return min_radius, max(max_radius, min_radius + 1)


def blank_patch_core(image: Tensor, center, size, p_type, c_diam,
                     apply) -> Tuple[Tensor, Tensor]:
    """Punch the drawn shape out of a binary volume: ``(masked_out,
    extracted)`` f32. ``p_type`` is a name of ``PATCH_TYPES`` or an integer
    (tensor) index into it; ``apply`` False returns the image unchanged and
    an empty flap."""
    shape, dev = tuple(image.shape), image.device
    masks = (lambda: sphere_keep_mask(shape, center, size, dev),
             lambda: box_keep_mask(shape, center, size, dev),
             lambda: flap_keep_mask(shape, center, size, c_diam, dev))
    if isinstance(p_type, str):
        keep = masks[PATCH_TYPES.index(p_type)]()
    else:
        t = torch.as_tensor(p_type, device=dev)
        keep = torch.where(t == 0, masks[0](),
                           torch.where(t == 1, masks[1](), masks[2]()))
    apply = torch.as_tensor(apply, device=dev)
    keep = torch.where(apply, keep, torch.ones_like(keep))
    img = (image > 0).float()
    return img * keep, img * (1.0 - keep)


def draw_blank_patch(gen: torch.Generator, image: Tensor,
                     prob: float = 1.0) -> Dict[str, Tensor]:
    """The values ``random_blank_patch`` draws (``synthesis.py:136-179``):
    a uniformly chosen nonzero voxel, size ~ U{min_r..max_r-1}, type ~
    U{0,1,2}, ``c_diam`` ~ U(0.25, 1) * size / 4, and the coin."""
    dev = image.device
    center, any_nz = random_nonzero_voxel(gen, image)
    min_r, max_r = radius_bounds(image.shape)
    size = torch.randint(min_r, max_r, (), generator=gen, device=dev).float()
    u = torch.rand(3, generator=gen, device=dev)
    return dict(center=center, size=size,
                p_type=torch.clamp((u[0] * 3).long(), max=2),
                c_diam=(0.25 + 0.75 * u[1]) * size / 4.0,
                apply=(u[2] <= prob) & any_nz)


def random_blank_patch(gen: torch.Generator, image: Tensor, prob: float = 1.0,
                       p_type: str = "random") -> Tuple[Tensor, Tensor]:
    """Punch a random hole in a binary volume: ``(masked_out, extracted)``.
    With probability ``1 - prob``, or for an empty volume, the image comes
    back unchanged with an all-zero flap."""
    drawn = draw_blank_patch(gen, image, prob)
    if p_type in PATCH_TYPES:
        drawn["p_type"] = p_type
    return blank_patch_core(image, **drawn)


def skull_random_hole(gen: torch.Generator, image: Tensor,
                      p: float = 1.0) -> Tuple[Tensor, Tensor]:
    """Virtual craniectomy on one volume -> (broken skull, flap)
    (``SkullRandomHole``, ``transforms.py:52-94``)."""
    return random_blank_patch(gen, image, prob=p)


def salt_and_pepper_core(img: Tensor, density, u_black: Tensor,
                         u_white: Tensor, apply,
                         salt_ratio: float = 0.1) -> Tensor:
    """Binary salt-and-pepper noise from the drawn ``density``, the two
    per-voxel uniforms and the coin (``synthesis.py:182-206``): pepper
    clears voxels, salt sets them."""
    density = _f32(density, img.device)
    black = (u_black > density * (1.0 - salt_ratio)).float()
    white = 1.0 - (u_white > density * salt_ratio).float()
    noisy = torch.maximum((img > 0).float() * black, white)
    apply = torch.as_tensor(apply, device=img.device)
    return torch.where(apply, noisy, img.float())


def draw_salt_and_pepper(gen: torch.Generator, img: Tensor, p: float = 1.0,
                         noise_density: float = 0.2) -> Dict[str, Tensor]:
    """density ~ U(0, noise_density), two independent 16-bit uniforms per
    voxel (the low and high halves of one 32-bit draw), and the coin."""
    dev = img.device
    u = torch.rand(2, generator=gen, device=dev)
    bits = torch.randint(0, 2 ** 32, tuple(img.shape), generator=gen,
                         device=dev, dtype=torch.int64)
    return dict(density=u[0] * noise_density,
                u_black=(bits & 0xFFFF).float() * (1.0 / 65536.0),
                u_white=(bits >> 16).float() * (1.0 / 65536.0),
                apply=u[1] <= p)


def salt_and_pepper(gen: torch.Generator, img: Tensor, p: float = 1.0,
                    noise_density: float = 0.2,
                    salt_ratio: float = 0.1) -> Tensor:
    """Binary salt-and-pepper noise, applied with probability ``p``
    (``transforms.py:13-49``)."""
    return salt_and_pepper_core(
        img, salt_ratio=salt_ratio,
        **draw_salt_and_pepper(gen, img, p, noise_density))


def flap_rec_transform(gen: torch.Generator, volume: Tensor,
                       noise_p: float = 0.5, noise_density: float = 0.05):
    """Training pair of the double-output flap problem from a complete
    binary skull: ``(broken_noisy, (full_skull, flap))``, all f32
    (``synthesis.py:219-240``)."""
    full = (volume > 0).float()
    broken, flap = skull_random_hole(gen, full, p=1.0)
    broken = salt_and_pepper(gen, broken, p=noise_p,
                             noise_density=noise_density)
    return broken, (full, flap)


def random_flip_core(img: Tensor, axis, apply) -> Tensor:
    """``img`` flipped along spatial ``axis`` (0, 1 or 2, possibly a
    tensor) when ``apply``."""
    axis = torch.as_tensor(axis, device=img.device)
    flipped = torch.where(axis == 0, img.flip(0),
                          torch.where(axis == 1, img.flip(1), img.flip(2)))
    return torch.where(torch.as_tensor(apply, device=img.device), flipped,
                       img)


def random_flip(gen: torch.Generator, img: Tensor,
                probability: float = 0.5) -> Tensor:
    """Flip one random spatial axis of a ``(D, H, W)`` volume with the
    given probability (``synthesis.py:243-258``; like the JAX function it
    needs a cubic volume, since every branch must keep the shape)."""
    u = torch.rand(2, generator=gen, device=img.device)
    return random_flip_core(img, torch.clamp((u[0] * 3).long(), max=2),
                            u[1] <= probability)
