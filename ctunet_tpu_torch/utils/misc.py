"""Small host-side helpers (paths, timing, model summary, volume view).

Counterpart of ``ctunet_tpu/utils/misc.py``: ``makedir`` (ref
``ctunet/utilities.py:22-32``), the ``tic``/``toc_eps`` epoch ETA
(``utilities.py:271-304``), ``model_summary`` (the ``show_model_summary``
key) and ``view`` (``utilities.py:314-315``).
"""

from __future__ import annotations

import os
import timeit
from typing import Optional


def makedir(path: Optional[str] = None) -> Optional[str]:
    """Create the folder at ``path`` if missing; return the path."""
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    return path


def tic() -> float:
    """Start a wall-clock timer."""
    return timeit.default_timer()


def toc_eps(ep_time: float, n_epoch: int, epochs: int,
            print_out: bool = True) -> float:
    """Stop the timer and print estimated remaining training time."""
    ep_time = timeit.default_timer() - ep_time
    remaining = int(ep_time * (epochs + 1 - n_epoch))
    hours = remaining // 3600
    minutes = (remaining - hours * 3600) // 60
    if print_out:
        print(
            "({}%) Remaining time (HH:MM): {}:{}\n".format(
                int(100 * n_epoch / float(epochs)), hours, minutes
            )
        )
    return ep_time


# the CPU probe whose forward FLOPs model_summary scales to the input
FLOP_PROBE = (32, 32, 32)


def model_summary(model, input_shape, *, print_out: bool = True) -> str:
    """Parameter table, total, BatchNorm statistics count and forward FLOPs
    of a port model (``misc.model_summary``): one line per state_dict
    parameter (name, shape, count); the running means and variances
    counted apart. The FLOPs are the function's: ``FlopCounterMode`` over
    one eval forward of a copy of the model in f32 on the CPU at a 32^3
    probe, scaled by voxels to ``input_shape`` ``(B, D, H, W, C)`` as the
    JAX summary scales its probe (the network is fully convolutional).
    The JAX summary prints XLA's ``cost_analysis`` of its W-packed convs
    (``PackedConv``), which counts the packing's work and reads about 4x
    higher (README, port section).
    """
    import copy

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    lines = []
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        lines.append(f"  {name:<60s} {str(tuple(p.shape)):>20s} {n:>12,d}")
    bn = sum(b.numel() for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var")))
    lines.append(f"  {'TOTAL trainable':<60s} {'':>20s} {total:>12,d}")
    if bn:
        lines.append(f"  {'batch-norm running stats':<60s} {'':>20s} "
                     f"{bn:>12,d}")
    probe = copy.deepcopy(model).cpu().float().eval()
    if hasattr(probe, "configure"):
        probe.configure("xla", torch.float32)
    x = torch.zeros((1, *FLOP_PROBE, input_shape[-1]))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        probe(x)
    scale = (float(np.prod(input_shape[:-1]))
             / float(np.prod((1, *FLOP_PROBE))))
    flops = counter.get_total_flops() * scale
    lines.append(f"  forward FLOPs (the function's) @ {tuple(input_shape)}: "
                 f"{flops / 1e9:.1f} G (scaled from a 32^3 probe)")
    out = "Model summary:\n" + "\n".join(lines)
    if print_out:
        print(out)
    return out


def view(tensor, save_path: Optional[str] = None) -> Optional[str]:
    """Mid-slice montage (axial, coronal, sagittal) of the first batch
    element and channel (``misc.view``; the reference calls ``sitk.Show``).
    Takes numpy arrays or torch tensors in ``(D, H, W)``, ``(D, H, W, C)``
    or ``(B, D, H, W, C)``; a CUDA tensor is copied to the host. Shows a
    window when a display is available, else writes a PNG (``save_path``,
    default ``view.png``) and returns its path."""
    import numpy as np

    if hasattr(tensor, "detach"):  # a torch tensor, wherever it lies
        tensor = tensor.detach().float().cpu().numpy()
    vol = np.asarray(tensor)
    if vol.ndim == 5:
        vol = vol[0]
    if vol.ndim == 4:
        vol = vol[..., 0]
    if vol.ndim != 3:
        raise ValueError(f"view expects a 3D volume, got shape {vol.shape}")
    import matplotlib

    if save_path is not None or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d, h, w = vol.shape
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (sl, title) in zip(axes, [(vol[d // 2], "axial"),
                                      (vol[:, h // 2], "coronal"),
                                      (vol[:, :, w // 2], "sagittal")]):
        ax.imshow(sl, cmap="gray", interpolation="nearest")
        ax.set_title(f"{title} (mid)")
        ax.axis("off")
    fig.tight_layout()
    if save_path is None and os.environ.get("DISPLAY"):
        plt.show()
        return None
    save_path = save_path or "view.png"
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    print(f"view: wrote {save_path}")
    return save_path
