"""The (data, spatial) mesh of ranks.

Counterpart of ``ctunet_tpu/parallel/mesh.py:30-50``. The JAX mesh is a
grid of devices one SPMD program shards over; here it is a grid of ranks,
one per device (``parallel/distributed.py``), rank ``r`` at data row ``r //
spatial`` and spatial column ``r % spatial``:

- ``data``: each row of the grid takes a slice of every global batch;
  gradients and BatchNorm batch statistics are averaged over the ranks of a
  spatial column (the *data group*);
- ``spatial``: the ranks of a data row split one volume's depth
  (``engine.build_sharded_predict``), exchanging edge planes within the row
  (the *spatial group*, ``parallel/halo.py``).

Parameters are replicated: every rank holds them whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data x spatial`` grid of ranks and the
    process group of each axis through it (None for an axis of size 1,
    where nothing is exchanged)."""

    data: int
    spatial: int
    rank: int = 0
    data_group: Optional[Any] = None
    spatial_group: Optional[Any] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial}

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


def make_mesh(data: int = 0, spatial: int = 1) -> Mesh:
    """Build the ``(data, spatial)`` mesh over the live process group's
    ranks (one rank without one; ``data=0``: ``world // spatial``). Every
    rank calls it with the same shape: it creates each axis's process
    groups, which is a collective. Raises ``ValueError`` when ``data *
    spatial`` is not the world size."""
    from .distributed import rank_and_world

    rank, world = rank_and_world()
    spatial = max(1, int(spatial or 1))
    data = int(data or 0) or max(1, world // spatial)
    if data * spatial != world:
        raise ValueError(
            f"mesh {data}x{spatial} needs {data * spatial} ranks, the world "
            f"has {world} (one process per device: launch data x spatial "
            "processes)")
    groups = {}
    if world > 1:
        import torch.distributed as dist

        rows = [[d * spatial + s for s in range(spatial)]
                for d in range(data)]
        cols = [[d * spatial + s for d in range(data)]
                for s in range(spatial)]
        for axis, lines in ((SPATIAL_AXIS, rows), (DATA_AXIS, cols)):
            if len(lines[0]) == 1:
                continue
            for ranks in lines:  # every rank creates every group
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
                if rank in ranks:
                    groups[axis] = g
    return Mesh(data, spatial, rank, groups.get(DATA_AXIS),
                groups.get(SPATIAL_AXIS))
