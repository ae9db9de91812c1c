"""Losses and quality metrics (channels-last).

Counterpart of ``ctunet_tpu/ops/losses.py``, the reference's loss math:

- ``dice_loss``: squared-denominator global Dice over the flattened
  (classes x voxels) of each batch element, eps = 1e-7, background channel
  included (``ctunet/utilities.py:35-50``, quirk Q5);
- ``softmax_cross_entropy``: ``torch.nn.CrossEntropyLoss`` semantics, the
  mean over batch and voxels of ``-log_softmax(pred)[label]``;
- ``dice_coeff``: mean foreground Dice of one-hot(argmax(pred)) against the
  one-hot target, NaN when both sets are empty (monai ``compute_meandice``);
- ``hausdorff``: host-side Hausdorff distance by exact euclidean distance
  transforms of the class boundaries, NaN/inf replaced with max(shape)
  (``ctunet/utilities.py:62-70``).

All device functions take ``(B, D, H, W, C)`` tensors and compute in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-7


def dice_loss(probs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Squared-denominator Dice loss (``losses.py:32-44``)."""
    b = probs.shape[0]
    p = probs.float().reshape(b, -1)
    m = masks.float().reshape(b, -1)
    num = (p * m).sum(1)
    den1 = (p * p).sum(1)
    den2 = (m * m).sum(1)
    return 1.0 - 2.0 * ((num + _EPS) / (den1 + den2 + _EPS)).mean()


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of ``logits`` ``(B, ..., C)`` against
    integer ``labels`` ``(B, ...)`` (``losses.py:47-63``). Like the
    reference, training feeds post-sigmoid activations here (quirk Q4)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels[..., None].long())
    return -picked.mean()


def dice_coeff(pred_probs: torch.Tensor,
               target_onehot: torch.Tensor) -> torch.Tensor:
    """Mean foreground Dice of hard predictions (``losses.py:66-83``): per
    (batch, foreground class) ``2|X n Y| / (|X| + |Y|)``, NaN when both are
    empty, then the mean (NaN propagates like the reference)."""
    nc = target_onehot.shape[-1]
    hard = F.one_hot(torch.argmax(pred_probs, -1), nc).float()
    b = hard.shape[0]
    x = hard.reshape(b, -1, nc)[..., 1:]
    y = target_onehot.float().reshape(b, -1, nc)[..., 1:]
    inter = (x * y).sum(1)
    denom = x.sum(1) + y.sum(1)
    nan = torch.full_like(denom, float("nan"))
    return torch.where(denom > 0, 2.0 * inter / denom, nan).mean()


# --------------------------------------------------------------------------
# Hausdorff distance (host side; a display metric off the hot path)
# --------------------------------------------------------------------------


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels: the mask minus its 1-step erosion (6-connected)."""
    from scipy import ndimage

    eroded = ndimage.binary_erosion(
        mask, ndimage.generate_binary_structure(3, 1))
    return mask & ~eroded


def _directed_hd(a: np.ndarray, b: np.ndarray) -> float:
    """max over surface(a) of the distance to surface(b) (exact EDT)."""
    from scipy import ndimage

    sa, sb = _surface(a), _surface(b)
    if not sa.any() or not sb.any():
        return float("nan")
    return float(ndimage.distance_transform_edt(~sb)[sa].max())


def _hausdorff_labels(hard: np.ndarray, tgt: np.ndarray, num_classes: int,
                      inf_alt: float) -> float:
    vals = []
    for bi in range(tgt.shape[0]):
        for c in range(1, num_classes):  # background excluded
            x, y = hard[bi] == c, tgt[bi] == c
            hd = max(_directed_hd(x, y), _directed_hd(y, x))
            vals.append(hd if np.isfinite(hd) else inf_alt)
    return float(np.mean(vals)) if vals else inf_alt


def hausdorff(pred_probs, target_onehot) -> float:
    """Mean foreground Hausdorff distance of host arrays with one-hot
    targets (``losses.py:110-132``): NaN/inf are replaced with max(spatial
    shape) before averaging."""
    pred = np.asarray(pred_probs, dtype=np.float32)
    tgt = np.asarray(target_onehot, dtype=np.float32)
    return _hausdorff_labels(np.argmax(pred, -1), np.argmax(tgt, -1),
                             tgt.shape[-1], float(max(tgt.shape[1:-1])))


def hausdorff_device_argmax(pred_logits: torch.Tensor,
                            target_onehot: torch.Tensor) -> float:
    """:func:`hausdorff` with the argmax taken on the device, so that only
    uint8 label maps cross to the host (``losses.py:135-161``)."""
    nc = int(target_onehot.shape[-1])
    hard = torch.argmax(pred_logits, -1).to(torch.uint8).cpu().numpy()
    tgt = torch.argmax(target_onehot, -1).to(torch.uint8).cpu().numpy()
    return _hausdorff_labels(hard, tgt, nc,
                             float(max(target_onehot.shape[1:-1])))
