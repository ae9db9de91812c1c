"""Synthetic binary "skull" volumes for tests and demos.

The reference has no tests or fixtures (SURVEY.md §4); its de-facto inputs
are preprocessed binary skull volumes. A thin spherical shell is a perfect
stand-in: nonzero voxels form a closed surface, so the virtual-craniectomy
transform behaves exactly as it does on a real skull. The PyTorch port's
own copy of ``ctunet_tpu/data/synthetic.py`` (numpy only, same outputs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def spherical_shell(
    shape: Tuple[int, int, int] = (32, 32, 32),
    thickness: float = 2.0,
    radius_frac: float = 0.38,
    center: Optional[Tuple[float, float, float]] = None,
    seed: Optional[int] = None,
) -> np.ndarray:
    """A hollow sphere (binary uint8, [z,y,x]); optional jittered center."""
    rng = np.random.default_rng(seed)
    if center is None:
        center = tuple(s / 2.0 for s in shape)
        if seed is not None:
            center = tuple(
                c + rng.uniform(-1.5, 1.5) for c in center
            )
    radius = radius_frac * min(shape)
    zz, yy, xx = np.meshgrid(
        *(np.arange(s, dtype=np.float32) for s in shape), indexing="ij"
    )
    dist = np.sqrt(
        (zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2
    )
    shell = (np.abs(dist - radius) <= thickness / 2.0 + 0.5).astype(np.uint8)
    return shell


def make_dataset(
    folder: str,
    n: int = 4,
    shape: Tuple[int, int, int] = (32, 32, 32),
    seed: int = 0,
) -> str:
    """Write ``n`` synthetic skull NIfTIs + a CSV listing; return CSV path."""
    import csv
    import os

    from ..utils import nifti

    os.makedirs(folder, exist_ok=True)
    rows = []
    for i in range(n):
        vol = spherical_shell(shape, seed=seed + i)
        path = os.path.join(folder, f"skull_{i:03d}.nii.gz")
        affine = np.diag([1.0, 1.0, 1.0, 1.0])
        nifti.write(path, nifti.NiftiImage(vol, affine))
        rows.append(path)
    csv_path = os.path.join(folder, "files.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "mask"])
        for r in rows:
            w.writerow([r, ""])
    return csv_path
