"""Host data pipeline: threaded decode prefetch + pinned uploads.

Counterpart of ``ctunet_tpu/data/pipeline.py``. A thread pool decodes the
next batches while the device works on the current one (the reference used
DataLoader worker processes and pinned memory, ``Model.py:179-186,198``);
:func:`upload` copies a decoded volume through pinned host memory with a
``non_blocking`` copy, so the transfer is queued on the current stream and
the host goes on decoding; :func:`device_prefetch` keeps a few uploaded
batches ahead of the consumer.

Sampling parity: training draws with replacement, ``len(dataset)`` samples
per epoch (``Model.py:175-177``, quirk Q4).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator, List

import numpy as np
import torch


class HostLoader:
    """Iterable over batches ``{'image': (B,D,H,W) f32, ..., 'filepath':
    [...]}``: in dataset order by default (the test path), shuffled with or
    without replacement for training (``pipeline.py:24-123``).

    ``batch_size`` is the global batch. With ``num_processes > 1`` (the
    data ranks of a multi-process run, ``parallel/``) every rank draws the
    same epoch index stream (same ``seed``) and loads only its slice,
    ``batch_size // num_processes`` samples from ``process_id`` on, of each
    global batch; an uneven tail batch is skipped (``pipeline.py:27-45,
    92-101``). The batch must divide over the ranks."""

    def __init__(self, dataset, batch_size: int = 1, n_workers: int = 2,
                 shuffle: bool = False, replacement: bool = True,
                 seed: int = 0, drop_remainder: bool = False,
                 process_id: int = 0, num_processes: int = 1):
        self.dataset = dataset
        self.batch_size = max(1, int(batch_size))
        self.n_workers = max(1, int(n_workers or 1))
        self.shuffle = shuffle
        self.replacement = replacement
        self.drop_remainder = drop_remainder
        self.process_id = int(process_id)
        self.num_processes = max(1, int(num_processes))
        if self.batch_size % self.num_processes:
            raise ValueError(
                f"global batch {self.batch_size} must divide over "
                f"{self.num_processes} processes")
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder or self.num_processes > 1:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        if self.replacement:
            return self._rng.integers(0, n, size=n)
        return self._rng.permutation(n)

    @staticmethod
    def _collate(samples: List[Dict]) -> Dict:
        batch: Dict = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            batch[key] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                          else vals)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        idxs = self._epoch_indices()
        batches = [idxs[i: i + self.batch_size]
                   for i in range(0, len(idxs), self.batch_size)]
        if self.drop_remainder or self.num_processes > 1:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_processes > 1:  # this rank's slice of each batch
            per = self.batch_size // self.num_processes
            batches = [b[self.process_id * per:(self.process_id + 1) * per]
                       for b in batches]
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


def device_prefetch(iterator, device: torch.device, depth: int = 2,
                    dtype: torch.dtype = torch.float32):
    """Run :func:`upload` ``depth`` batches ahead of the consumer
    (``pipeline.py:183-250``): array entries become ``dtype`` tensors on
    ``device``, other entries (file paths) pass through. The packed-bits
    upload of the JAX package served a slow host link and is not carried
    over."""

    def put(batch):
        return {k: (upload(v, device, dtype) if isinstance(v, np.ndarray)
                    else v) for k, v in batch.items()}

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= max(1, depth):
            break
    while queue:
        nxt = queue.popleft()
        batch = next(it, None)
        if batch is not None:
            queue.append(put(batch))
        yield nxt
