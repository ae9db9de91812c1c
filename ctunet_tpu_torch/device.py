"""Device selection for the port's entry points.

The entry points (``Model``, ``engine.build_predict``, the CLI) run on the
card. The CPU is used only when the caller asks for it, and a missing card
is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# INI ``s_device`` values that name the accelerator: the reference's
# ``cuda``, ``ctunet_tpu``'s ``tpu`` (its headline INIs say ``tpu``), ``gpu``.
_ACCEL = {"cuda", "gpu", "tpu"}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``"cpu"`` -> CPU; None, ``cuda[:N]``, ``gpu`` or ``tpu`` -> CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (or implied) and no card
    is visible, and ``ValueError`` for any other name.
    """
    if isinstance(device, torch.device):
        name, index = device.type, device.index
    else:
        name = "cuda" if device is None else str(device).strip().lower()
        name, _, idx = name.partition(":")
        index = int(idx) if idx else None
    if name == "cpu":
        return torch.device("cpu")
    if name not in _ACCEL:
        raise ValueError(f"unknown device {device!r} (cpu, cuda, gpu, tpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA card and none is visible; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    return torch.device("cuda", 0 if index is None else index)
