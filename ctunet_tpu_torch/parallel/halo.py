"""Depth halo exchange for volumes whose depth is split over ranks.

Counterpart of ``chain_halo_exchange`` (``ctunet_tpu/parallel/halo.py:23-
39``). There the chained layout carries its halo planes inside the tensor
and ``lax.ppermute`` refreshes them, delivering zeros at the volume's
edges. Here a slab is a dense ``(Ds, H, W, C)`` tensor: the exchange
returns the left neighbour's last plane and the right neighbour's first
plane, and ``None`` where the slab is at the volume's edge, so that the
caller joins only real planes (``engine.build_sharded_predict``).

One ``all_gather`` of every rank's edge planes, as raw bytes, carries the
exchange: both backends take it on CUDA tensors (gloo's point-to-point
``send``/``recv`` may not), and any dtype travels unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Halo = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def halo_exchange_many(slabs: Sequence[torch.Tensor], group,
                       size: int, index: int) -> List[Halo]:
    """For each ``(Ds, ...)`` slab: ``(left, right)``, the last plane of
    the slab of rank ``index - 1`` of ``group`` and the first plane of rank
    ``index + 1``'s, each ``(1, ...)``; ``None`` past either end. Every
    rank of the ``size`` ranks of ``group`` passes slabs of the same shapes
    and dtypes, in the same order."""
    if size <= 1:
        return [(None, None) for _ in slabs]
    import torch.distributed as dist

    planes = [p for s in slabs for p in (s[:1], s[-1:])]
    nbytes = [p.numel() * p.element_size() for p in planes]
    mine = torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                      for p in planes])
    got = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(got, mine, group=group)

    def plane(buf, j):
        s = slabs[j // 2]
        off = sum(nbytes[:j])
        raw = buf[off:off + nbytes[j]]
        if off % s.element_size():  # a view of a wider dtype needs it
            raw = raw.clone()
        return raw.view(s.dtype).reshape((1,) + tuple(s.shape[1:]))

    out = []
    for i in range(len(slabs)):
        left = plane(got[index - 1], 2 * i + 1) if index > 0 else None
        right = plane(got[index + 1], 2 * i) if index < size - 1 else None
        out.append((left, right))
    return out


def join(halo: Halo, x: torch.Tensor) -> torch.Tensor:
    """``x`` with the neighbours' planes joined on along depth."""
    left, right = halo
    if left is None and right is None:
        return x
    return torch.cat([t for t in (left, x, right) if t is not None])


def crop(halo: Halo, y: torch.Tensor, scale: int = 1) -> torch.Tensor:
    """Drop the ``scale`` output planes of each joined plane of ``halo``
    (2 for a stride-2 upsampling), as a tensor aligned to 16 bytes (the
    kernels' requirement)."""
    lo = scale if halo[0] is not None else 0
    hi = scale if halo[1] is not None else 0
    if lo == hi == 0:
        return y
    y = y[lo:y.shape[0] - hi]
    return y.clone() if y.data_ptr() % 16 else y
