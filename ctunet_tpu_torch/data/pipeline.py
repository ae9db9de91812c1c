"""Host data pipeline: threaded decode prefetch + pinned uploads.

Counterpart of ``ctunet_tpu/data/pipeline.py``. A thread pool decodes the
next batches while the device works on the current one (the reference used
DataLoader worker processes and pinned memory, ``Model.py:179-186,198``);
:func:`upload` copies a decoded volume through pinned host memory with a
``non_blocking`` copy, so the transfer is queued on the current stream and
the host goes on decoding.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator, List

import numpy as np
import torch


class HostLoader:
    """Iterable over batches in dataset order: ``{'image': (B,D,H,W) f32,
    'filepath': [...]}`` (the test path; training's sampling with
    replacement is not ported yet)."""

    def __init__(self, dataset, batch_size: int = 1, n_workers: int = 2):
        self.dataset = dataset
        self.batch_size = max(1, int(batch_size))
        self.n_workers = max(1, int(n_workers or 1))

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    @staticmethod
    def _collate(samples: List[Dict]) -> Dict:
        batch: Dict = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            batch[key] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                          else vals)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        idxs = np.arange(len(self.dataset))
        batches = [idxs[i: i + self.batch_size]
                   for i in range(0, len(idxs), self.batch_size)]
        with cf.ThreadPoolExecutor(self.n_workers) as pool:
            pending: collections.deque = collections.deque()
            it = iter(batches)
            for b in it:
                pending.append(pool.map(self.dataset.__getitem__, b.tolist()))
                if len(pending) > self.n_workers:
                    break
            while pending:
                samples = list(pending.popleft())
                b = next(it, None)
                if b is not None:
                    pending.append(
                        pool.map(self.dataset.__getitem__, b.tolist()))
                yield self._collate(samples)


def upload(array: np.ndarray, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """Host array -> ``dtype`` tensor on ``device``.

    For a CUDA device the array is staged in pinned memory and copied with
    ``non_blocking=True`` on the current stream; the cast runs on the device
    afterwards. The pinned buffer stays referenced by the copy until the
    stream has consumed it (PyTorch's caching host allocator records the
    stream), so the caller may drop it at once.
    """
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True).to(dtype)
