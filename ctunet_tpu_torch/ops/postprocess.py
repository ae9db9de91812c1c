"""Prediction postprocessing on the host: largest connected component.

Counterpart of ``ctunet_tpu/ops/postprocess.py::largest_cc`` (host, scipy),
the postprocessor the serving loop installs for ``b_largest_cc``.
"""

from __future__ import annotations

import numpy as np


def largest_cc(mask: np.ndarray) -> np.ndarray:
    """Keep the largest 6-connected foreground component (float32 0/1)."""
    from scipy import ndimage

    mask = np.asarray(mask) > 0
    labels, n = ndimage.label(
        mask, structure=ndimage.generate_binary_structure(3, 1)
    )
    if n <= 1:
        return mask.astype(np.float32)
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return (labels == counts.argmax()).astype(np.float32)
