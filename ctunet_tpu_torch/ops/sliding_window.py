"""Sliding-window patch inference with Gaussian overlap blending.

Counterpart of ``ctunet_tpu/ops/sliding_window.py:28-189``: tile a volume
into overlapping patches, run the network on each, and blend the overlaps
with a Gaussian importance window. The grid, the starts and the window
are the JAX package's, computed in numpy; the accumulation runs in f32 on
the device in scan order (patch by patch, ``acc += out * window`` and
``weight += window`` on the patch's box), then ``acc / weight``, so the
result equals the JAX scan's value for value. XLA contracts the update
``acc + out * window`` into a fused multiply-add, one rounding to f32; the
port rounds it once too: the product of two f32 values is exact in f64,
so ``float(double(acc) + double(out) * double(window))`` is that rounding
(short of a double rounding of the f64 sum, about 2^-29 of the cases).
``patch_batch`` K hands K patches to one forward call; the JAX scan pads
the grid to a multiple of K with zero-weight entries, which add nothing:
the last call here simply takes fewer patches, and the result is the same
for every K.

The per-patch forward is the caller's: the serving engine
(``engine.build_predict`` or ``engine_q.build_predict_q``), so each patch
runs the engine's kernels at the patch shape. There is no kernel here:
the JAX version is XLA (``dynamic_slice`` and ``dynamic_update_slice`` in
a ``lax.scan``), with no Pallas.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch


def patch_starts(size: int, patch: int, step: int) -> np.ndarray:
    """Start offsets covering ``[0, size - patch]`` inclusive with about
    ``step`` spacing (``sliding_window.py:28-33``)."""
    if size <= patch:
        return np.array([0], np.int32)
    n = int(np.ceil((size - patch) / step)) + 1
    return np.round(np.linspace(0, size - patch, n)).astype(np.int32)


def grid_starts(shape: Sequence[int], patch: Sequence[int],
                overlap: float) -> np.ndarray:
    """All ``(z, y, x)`` patch starts of a volume shape, in scan order
    (``sliding_window.py:36-45``)."""
    steps = [max(1, int(p * (1.0 - overlap))) for p in patch]
    axes = [patch_starts(s, p, st) for s, p, st in zip(shape, patch, steps)]
    return np.array(list(itertools.product(*axes)), np.int32).reshape(-1, 3)


SIGMA_SCALE = 0.125


def gaussian_window(patch: Sequence[int]) -> np.ndarray:
    """Separable 3D Gaussian importance window, centre-weighted, sigma
    ``SIGMA_SCALE`` of the patch, f32, floored at 1e-4
    (``sliding_window.py:48-58``)."""
    ws = []
    for p in patch:
        c = (p - 1) / 2.0
        sigma = max(p * SIGMA_SCALE, 1.0)
        x = np.arange(p, dtype=np.float64)
        ws.append(np.exp(-0.5 * ((x - c) / sigma) ** 2))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    w = w / w.max()
    return np.maximum(w, 1e-4).astype(np.float32)


def make_sliding_window_fn(apply_fn: Callable, patch_size=128,
                           overlap: float = 0.5, atlas=None,
                           compute_dtype=torch.bfloat16,
                           patch_batch: int = 1) -> Callable:
    """Build ``predict(images)`` running tiled inference
    (``make_sliding_window_fn``, ``sliding_window.py:61-189``).

    :param apply_fn: the per-patch forward, ``x`` ``(K, pz, py, px, C)``
        in ``compute_dtype`` -> an output or a tuple of outputs, each
        ``(K, pz, py, px, c)``.
    :param atlas: ``(D, H, W)`` constant stacked as the last channel of
        every patch (sliced at the patch's start), or None.
    :param patch_batch: patches per ``apply_fn`` call.
    :returns: ``predict(images)`` on ``(B, D, H, W)`` f32 volumes on the
        device, each extent at least the patch's: the model's output
        structure with whole-volume blended maps, channels-last f32.
    """
    if isinstance(patch_size, int):
        patch = (patch_size, patch_size, patch_size)
    else:
        patch = tuple(int(p) for p in patch_size)
    win_np = gaussian_window(patch)
    kb = max(1, int(patch_batch))
    cache = {}

    def on(device):
        """The window (f32 and f64) and the atlas on ``device``, uploaded
        once."""
        if device not in cache:
            win = torch.from_numpy(win_np).to(device)
            cache[device] = (
                win, win.double()[..., None],
                None if atlas is None else torch.as_tensor(
                    np.asarray(atlas, np.float32)).to(device))
        return cache[device]

    def run_one(vol: torch.Tensor):
        win, win64, atlas_c = on(vol.device)
        shape = tuple(vol.shape)
        if any(s < p for s, p in zip(shape, patch)):
            raise ValueError(f"volume {shape} is smaller than the patch "
                             f"{patch}: pad it first")
        starts = grid_starts(shape, patch, overlap).tolist()

        def box(st):
            return tuple(slice(s, s + p) for s, p in zip(st, patch))

        def slice_patch(st):
            chans = [vol[box(st)]]
            if atlas_c is not None:
                chans.append(atlas_c[box(st)])
            return torch.stack(chans, -1).to(compute_dtype)

        acc, single = None, False
        wacc = torch.zeros(shape, dtype=torch.float32, device=vol.device)
        for g in range(0, len(starts), kb):
            group = starts[g:g + kb]
            out = apply_fn(torch.stack([slice_patch(st) for st in group]))
            single = not isinstance(out, tuple)
            outs = [o.float() for o in ((out,) if single else out)]
            if acc is None:
                acc = [torch.zeros(shape + (o.shape[-1],),
                                   dtype=torch.float32, device=vol.device)
                       for o in outs]
            for j, st in enumerate(group):
                b = box(st)
                for a, o in zip(acc, outs):
                    a[b] = (a[b].double() + o[j].double() * win64).float()
                wacc[b] += win
        res = tuple(a / wacc[..., None] for a in acc)
        return res[0] if single else res

    def predict(images: torch.Tensor):
        outs = [run_one(images[i].float()) for i in range(images.shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    return predict
