"""Datasets: NIfTI listing + host decode (and nothing else).

Counterpart of ``ctunet_tpu/data/datasets.py`` (reference
``ctunet/pytorch/datasets.py:50-249``). A dataset lists files from a CSV
(header row skipped, column 0 the image and column 1 the optional mask, as
``pandas.read_csv`` + ``iloc`` read it) or one ``single_file``, and decodes
a volume on the host per item. Target synthesis runs on the device inside
the train step (``problem.py``), and the atlas channel is not concatenated
here: the trainer uploads the atlas once and stacks it on the device.

Samples: ``{'image': float32 [z,y,x], 'filepath': str}``, plus ``'flap'``
for a stored (broken, flap) pair of the train datasets.
"""

from __future__ import annotations

import collections
import csv
import os
import threading
from typing import Callable, Dict, Optional

import numpy as np

from ..utils import nifti


class _DecodeCache:
    """Bytes-bounded LRU cache of decoded volumes (thread-safe).

    Training samples with replacement (quirk Q4), so the same files are
    read again every epoch, and a gzipped full-size volume takes far longer
    to decode than a train step. The cache keys on (path, mtime), so an
    edited file is decoded again; the arrays it returns are read-only (they
    are shared across epochs).
    """

    def __init__(self, max_bytes: int = 8 << 30):
        self.max_bytes = max_bytes
        self._items: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def _evict(self) -> None:
        while self._bytes > self.max_bytes and self._items:
            _, old = self._items.popitem(last=False)
            self._bytes -= old.nbytes

    def get(self, path: str, loader: Callable[[], np.ndarray]) -> np.ndarray:
        try:
            key = (path, os.path.getmtime(path))
        except OSError:
            key = (path, None)
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return self._items[key]
        arr = loader()
        arr.flags.writeable = False
        if arr.nbytes <= self.max_bytes:
            with self._lock:
                if key not in self._items:
                    self._items[key] = arr
                    self._bytes += arr.nbytes
                    self._evict()
        return arr

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._bytes = 0


DECODE_CACHE = _DecodeCache(
    int(os.environ.get("CTUNET_TPU_DECODE_CACHE_MB", 8192)) << 20)


class NiftiImageDataset:
    """CT volumes listed in a CSV (or one ``single_file``)."""

    def __init__(self, csv_file: Optional[str] = None,
                 single_file: Optional[str] = None):
        if single_file is not None:
            self.rows = [[single_file, ""]]
        else:
            with open(os.path.expanduser(csv_file), newline="") as f:
                self.rows = [r for r in list(csv.reader(f))[1:] if r]
        self.files = [r[0] for r in self.rows]

    def __len__(self) -> int:
        return len(self.files)

    @staticmethod
    def _read(path: str) -> np.ndarray:
        return DECODE_CACHE.get(
            path, lambda: nifti.read(path).data.astype(np.float32))

    def __getitem__(self, idx: int) -> Dict:
        path = self.files[idx]
        return {"image": self._read(path), "filepath": path}


# The atlas is stacked on the device, so the atlas dataset is an alias kept
# for API parity with ``NiftiImageWithAtlasDataset`` (``datasets.py:50-112``).
NiftiImageWithAtlasDataset = NiftiImageDataset


class FlapRecWShapePrior2OTrainDataset(NiftiImageDataset):
    """Complete skulls (or stored pairs) for the double-output problems
    (``datasets.py:144-181``, ref ``datasets.py:152-235``).

    A row whose file name contains ``already_augmented_id`` is already
    broken: column 0 is the broken skull and column 1 the flap (an empty
    mask falls back to the ``_nfg_d`` -> ``_nfg_i`` file name convention).
    The sample then carries ``'flap'`` and the handler punches no hole.
    """

    def __init__(self, csv_file: Optional[str] = None,
                 single_file: Optional[str] = None,
                 already_augmented_id: str = "nfg"):
        super().__init__(csv_file, single_file)
        self.already_augmented_id = already_augmented_id

    def __getitem__(self, idx: int) -> Dict:
        path = self.files[idx]
        sample = {"image": self._read(path), "filepath": path}
        name = os.path.split(path)[1]
        if self.already_augmented_id and self.already_augmented_id in name:
            row = self.rows[idx]
            mask = row[1].strip() if len(row) > 1 else ""
            flap_path = (path.replace("_nfg_d", "_nfg_i")
                         if mask in ("", "nan") else mask)
            sample["flap"] = self._read(flap_path)
        return sample


class FlapRec2OTrainDataset(FlapRecWShapePrior2OTrainDataset):
    """Double output without shape prior (ref ``datasets.py:238-249``)."""


class FlapRecTrainDataset(NiftiImageDataset):
    """Complete skulls for the single-output ``FlapRec`` synthesis (ref
    ``datasets.py:136-149``)."""


class FlapRecWShapePriorTrainDataset(FlapRecWShapePrior2OTrainDataset):
    """Complete skulls (or stored pairs) for ``FlapRecWithShapePrior``
    (``datasets.py:188-191``, ref ``datasets.py:252-281``)."""


class BinaryDenoisingAEDataset(NiftiImageDataset):
    """Clean skulls for ``DenoisingAE``, which adds the noise on the device
    (ref ``datasets.py:284-294``)."""


BinaryDenoisingAEDatasetv2 = BinaryDenoisingAEDataset
