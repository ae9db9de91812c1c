"""What a run hands to the system under test and to the reference alike,
made from ``--seed``: synthetic skulls, the atlas, and the initial weights
of a training run; and the committed weights of a serving run, read as
raw arrays.

Skulls are binary ellipsoid shells on the configuration's canvas, made on
the device in bulk and decoded into host memory as a loader hands them
over: ``(1, D, H, W)`` f32. A broken skull has a cap cut out of its upper
half (a virtual craniectomy). The atlas is the complete nominal shell and
does not depend on the seed. Every seed gives the same sizes: only where
the shells sit, their widths and the holes change.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import flops

# nominal semi-axes of a skull as shares of the canvas (z, y, x)
AXES = (0.40, 0.41, 0.36)
THICKNESS = 4.0  # voxels


def subseed(seed: int, k: int) -> int:
    """A 63-bit seed for stream ``k`` of the run's ``seed``."""
    state = np.random.SeedSequence([int(seed), int(k)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _shell(canvas, center, axes, thickness, device) -> torch.Tensor:
    zz, yy, xx = (torch.arange(s, dtype=torch.float32, device=device)
                  for s in canvas)
    rho = torch.sqrt(((zz[:, None, None] - center[0]) / axes[0]) ** 2
                     + ((yy[None, :, None] - center[1]) / axes[1]) ** 2
                     + ((xx[None, None, :] - center[2]) / axes[2]) ** 2)
    return (torch.abs(rho - 1.0) * (sum(axes) / 3.0)
            <= thickness / 2.0).float()


def atlas(canvas: Sequence[int], device) -> np.ndarray:
    """The complete nominal shell ``(D, H, W)`` f32 on the host."""
    center = [s / 2.0 for s in canvas]
    axes = [a * s for a, s in zip(AXES, canvas)]
    return _shell(canvas, center, axes, THICKNESS, device).cpu().numpy()


def skulls(canvas: Sequence[int], n: int, seed: int, device,
           broken: bool) -> List[np.ndarray]:
    """``n`` distinct skulls ``(1, D, H, W)`` f32 on the host, drawn from
    ``seed`` on ``device``; with ``broken`` each has a cap cut out."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 0))
    draws = torch.rand(n, 9, generator=gen, device=device).tolist()
    out = []
    for u in draws:
        center = [s * (0.5 + 0.06 * (v - 0.5)) for s, v in zip(canvas, u)]
        axes = [a * s * (0.92 + 0.1 * v)
                for a, s, v in zip(AXES, canvas, u[3:6])]
        vol = _shell(canvas, center, axes, THICKNESS + 3.0 * u[6], device)
        if broken:
            # the cap: around the shell point in a direction of the upper
            # half (z below the centre), of radius 0.25-0.4 of the mean axis
            az, pol = 2 * math.pi * u[7], 0.2 + 1.1 * u[8]
            d = (-math.cos(pol), math.sin(pol) * math.sin(az),
                 math.sin(pol) * math.cos(az))
            cap = [c + a * v for c, a, v in zip(center, axes, d)]
            r = (0.25 + 0.15 * u[7]) * sum(axes) / 3.0
            zz, yy, xx = (torch.arange(s, dtype=torch.float32,
                                       device=device) for s in canvas)
            hole = ((zz[:, None, None] - cap[0]) ** 2
                    + (yy[None, :, None] - cap[1]) ** 2
                    + (xx[None, None, :] - cap[2]) ** 2) <= r * r
            vol = torch.where(hole, torch.zeros_like(vol), vol)
        out.append(vol[None].cpu().numpy())
    return out


def init_weights(spec: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights of a training run in the flax layout of the
    ``.npz`` exports (``params/unet/...``, ``batch_stats/unet/...``), f32
    on ``device``, drawn by PyTorch's default initialisation law: every
    conv, ConvTranspose and head weight and bias uniform in
    ``+-1/sqrt(fan_in)``; BatchNorm scale 1, shift 0, statistics 0 and 1.
    One uniform draw on the device covers every drawn leaf."""
    n, ws = spec["n_blocks"], flops.widths(spec)
    shapes = {}  # name -> (shape, fan_in)
    cin = spec["input_channels"]

    def unit(name, ci, co):
        shapes[f"{name}/conv/kernel"] = ((3, 3, 3, ci, co), 27 * ci)

    for i, w in enumerate(ws):
        unit(f"d{i}/unit0", cin, w)
        unit(f"d{i}/unit1", w, w)
        cin = w
    for j in range(n):
        w = ws[n - 1 - j]
        # torch's ConvTranspose3d(cin, cin) takes its fan-in from the
        # weight's second axis, its output channels
        shapes[f"u{j}/upconv/kernel"] = ((2, 2, 2, cin, cin), 8 * cin)
        shapes[f"u{j}/upconv/bias"] = ((cin,), 8 * cin)
        unit(f"u{j}/unit0", cin, w)
        unit(f"u{j}/unit1", w, w)
        cin = 2 * w
    out_ch = spec["out_channels"]
    shapes["last_conv/kernel"] = ((1, 1, 1, cin, out_ch), cin)
    shapes["last_conv/bias"] = ((out_ch,), cin)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for (name, (shape, fan_in)), part in zip(shapes.items(),
                                             flat.split(sizes)):
        out[f"params/unet/{name}"] = (part / math.sqrt(fan_in)).reshape(shape)
    for name in [k[:-len("/conv/kernel")] for k in shapes
                 if k.endswith("/conv/kernel")]:
        co = shapes[f"{name}/conv/kernel"][0][-1]
        one = torch.ones(co, device=device)
        out[f"params/unet/{name}/bn/scale"] = one
        out[f"params/unet/{name}/bn/bias"] = torch.zeros_like(one)
        out[f"batch_stats/unet/{name}/bn/mean"] = torch.zeros_like(one)
        out[f"batch_stats/unet/{name}/bn/var"] = one.clone()
    return out


def read_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """A flat ``.npz`` export as f32 tensors on ``device``."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
                for k in z.files}
