"""Test-time datasets: NIfTI listing + host decode.

Counterpart of the serving half of ``ctunet_tpu/data/datasets.py``
(reference ``ctunet/pytorch/datasets.py:50-133``). A dataset lists files
from a CSV (first column, header row skipped, as ``pandas.read_csv`` +
``iloc[idx, 0]`` read it) or one ``single_file``, and decodes a volume on
the host per item. The atlas channel is not concatenated here: the trainer
uploads the atlas once and stacks it on the device.

Samples: ``{'image': float32 [z,y,x], 'filepath': str}``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

from ..utils import nifti


class NiftiImageDataset:
    """CT volumes listed in a CSV (or one ``single_file``)."""

    def __init__(self, csv_file: Optional[str] = None,
                 single_file: Optional[str] = None):
        if single_file is not None:
            self.files = [single_file]
        else:
            with open(os.path.expanduser(csv_file), newline="") as f:
                rows = list(csv.reader(f))
            self.files = [r[0] for r in rows[1:] if r]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        path = self.files[idx]
        return {"image": nifti.read(path).data.astype(np.float32),
                "filepath": path}


# The atlas is stacked on the device, so the atlas dataset is an alias kept
# for API parity with ``NiftiImageWithAtlasDataset`` (``datasets.py:50-112``).
NiftiImageWithAtlasDataset = NiftiImageDataset
