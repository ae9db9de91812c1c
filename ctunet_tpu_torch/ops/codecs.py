"""Argmax codec (channels-last).

Counterpart of ``ctunet_tpu/ops/codecs.py::hard_segm`` (reference
``hard_segm_from_tensor``, ``ctunet/utilities.py:103-124``).
"""

from __future__ import annotations

import torch


def hard_segm(prob_map: torch.Tensor, keep_dims: bool = False) -> torch.Tensor:
    """Argmax over the trailing channel axis, as float32: (B, D, H, W, C) ->
    (B, D, H, W), or (D, H, W, C) -> (D, H, W); ``keep_dims`` re-appends a
    size-1 channel. Ties take the first channel, as numpy and JAX do."""
    seg = torch.argmax(prob_map, dim=-1).to(torch.float32)
    return seg[..., None] if keep_dims else seg
