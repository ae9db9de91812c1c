"""Argmax and one-hot codecs (channels-last).

Counterpart of ``ctunet_tpu/ops/codecs.py`` (reference
``hard_segm_from_tensor`` and ``one_hot_encoding``,
``ctunet/utilities.py:73-124``).
"""

from __future__ import annotations

import torch


def hard_segm(prob_map: torch.Tensor, keep_dims: bool = False) -> torch.Tensor:
    """Argmax over the trailing channel axis, as float32: (B, D, H, W, C) ->
    (B, D, H, W), or (D, H, W, C) -> (D, H, W); ``keep_dims`` re-appends a
    size-1 channel. Ties take the first channel, as numpy and JAX do."""
    seg = torch.argmax(prob_map, dim=-1).to(torch.float32)
    return seg[..., None] if keep_dims else seg


def one_hot(labels: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Integer-valued label map (any dtype) -> f32 one-hot with a trailing
    class axis (``codecs.py::one_hot``)."""
    return torch.nn.functional.one_hot(labels.long(), num_classes).float()
