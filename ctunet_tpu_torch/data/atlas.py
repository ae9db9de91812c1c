"""Skull-atlas (shape prior) registry.

The reference hard-wires three atlas files by input size under
``~/headctools/assets/atlas/reg`` (``ctunet/pytorch/datasets.py:22-27``) and
concatenates the atlas as a second input channel per sample on the host
(``datasets.py:30-47``). Here the atlas is loaded once, cached, uploaded to
the device once and concatenated there per volume (it is a constant — no
reason to ship it with every batch). The directory is configurable
(``atlas_dir`` config key), sizes can be registered at runtime, and unknown
sizes raise the same style of error as the reference. The PyTorch port's
own copy of ``ctunet_tpu/data/atlas.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..utils import nifti

# size (D, H, W) -> filename, matching ``datasets.py:23-27``.
ATLAS_FILES: Dict[Tuple[int, int, int], str] = {
    (64, 128, 128): "atlas_128_64.nii.gz",
    (224, 304, 304): "atlas_304_224.nii.gz",
    (224, 512, 512): "atlas_skull_512_224.nii.gz",
}

_CACHE: Dict[Tuple[int, int, int], np.ndarray] = {}


def register_atlas(im_size, array_or_path) -> None:
    """Register an atlas for a volume size (array, or path to a NIfTI)."""
    key = tuple(int(s) for s in im_size)
    if isinstance(array_or_path, str):
        ATLAS_FILES[key] = array_or_path
        _CACHE.pop(key, None)
    else:
        _CACHE[key] = np.asarray(array_or_path, np.float32)


def load_atlas(im_size, atlas_dir: str) -> np.ndarray:
    """Load (and cache) the atlas for a volume size as float32 [z,y,x]."""
    key = tuple(int(s) for s in im_size)
    if key in _CACHE:
        return _CACHE[key]
    if key not in ATLAS_FILES:
        # Fallback: the reference's file naming convention,
        # atlas_<H>_<D>.nii.gz, discovered in atlas_dir (lets CLI users add
        # new sizes without code).
        guess = os.path.join(
            os.path.expanduser(atlas_dir), f"atlas_{key[1]}_{key[0]}.nii.gz"
        )
        if os.path.exists(guess):
            ATLAS_FILES[key] = guess
        else:
            avail = ", ".join(str(t) for t in ATLAS_FILES)
            raise FileNotFoundError(
                f"The input images have a size ({key}) different than the "
                f"available atlases sizes: {avail}."
            )
    fname = ATLAS_FILES[key]
    path = fname if os.path.isabs(fname) else os.path.join(
        os.path.expanduser(atlas_dir), fname
    )
    if not os.path.exists(path):
        raise FileNotFoundError(f"Atlas not found {path}.")
    arr = nifti.read(path).data.astype(np.float32)
    _CACHE[key] = arr
    return arr
