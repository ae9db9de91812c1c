"""``ctunet_tpu_torch.parallel``: rank bring-up, the mesh, the depth halo,
and the rank slices of ``HostLoader``.

Counterparts of ``ctunet_tpu/parallel`` and ``tests/test_distributed.py``.
The ranks are gloo processes on the CPU (``parallel.spawn``, each group on
a free port).
"""

import numpy as np
import pytest
import torch

from ctunet_tpu_torch import parallel
from ctunet_tpu_torch.data.pipeline import HostLoader
from ctunet_tpu_torch.parallel import distributed


def test_initialize_is_a_noop_without_the_flag():
    assert parallel.initialize_from_params({"distributed": False}) == (0, 1)
    assert not parallel.is_initialized()


@pytest.mark.parametrize("missing", ["dist_coordinator",
                                     "dist_num_processes",
                                     "dist_process_id"])
def test_initialize_names_the_missing_key(monkeypatch, missing):
    for env in ("CTUNET_COORDINATOR", "CTUNET_NUM_PROCESSES",
                "CTUNET_PROCESS_ID"):
        monkeypatch.delenv(env, raising=False)
    params = dict(distributed=True, device="cpu",
                  dist_coordinator="localhost:1", dist_num_processes=2,
                  dist_process_id=0)
    params[missing] = {"dist_coordinator": "", "dist_num_processes": 0,
                       "dist_process_id": -1}[missing]
    with pytest.raises(ValueError, match=missing):
        parallel.initialize_from_params(params)
    assert not parallel.is_initialized()


def _env_rank(rank):
    # the keys name another world and rank: the environment wins
    got = parallel.initialize_from_params(dict(
        distributed=True, device="cpu", dist_coordinator="localhost:1",
        dist_num_processes=5, dist_process_id=4))
    again = parallel.initialize_from_params(dict(distributed=True))
    return got, again, torch.distributed.get_backend()


def test_environment_overrides_the_keys():
    got = parallel.spawn(_env_rank, 2)
    assert got == [((0, 2), (0, 2), "gloo"), ((1, 2), (1, 2), "gloo")]


def test_backend_follows_the_devices():
    assert distributed.choose_backend(False, 2, n_cards=8) == "gloo"
    assert distributed.choose_backend(True, 2, n_cards=1) == "gloo"
    assert distributed.choose_backend(True, 4, n_cards=4) == "nccl"
    assert distributed.local_batch_size(4, 2) == 2
    with pytest.raises(ValueError):
        distributed.local_batch_size(3, 2)


def test_one_rank_mesh_and_its_raise():
    m = parallel.make_mesh()
    assert (m.data, m.spatial, m.data_index, m.spatial_index) == (1, 1, 0, 0)
    assert m.data_group is None and m.spatial_group is None
    with pytest.raises(ValueError, match="one process per device"):
        parallel.make_mesh(2, 1)
    with pytest.raises(ValueError):
        parallel.make_mesh(0, 2)  # 0 x 2 of one rank: data rounds to 1


def _mesh_rank(rank):
    import torch.distributed as dist

    parallel.initialize_from_params(dict(distributed=True, device="cpu"))
    m = parallel.make_mesh(0, 2)  # 4 ranks: 2 x 2
    out = dict(shape=(m.data, m.spatial),
               coords=(m.data_index, m.spatial_index),
               sizes=(dist.get_world_size(m.data_group),
                      dist.get_world_size(m.spatial_group)))
    # the spatial group joins the ranks of one data row: each rank's slab
    # is (its data row, its column); the halo crosses columns only
    x = torch.full((3, 2, 2, 1), float(10 * m.data_index + m.spatial_index))
    left, right = parallel.halo_exchange_many(
        [x], m.spatial_group, m.spatial, m.spatial_index)[0]
    out["halo"] = (None if left is None else float(left.max()),
                   None if right is None else float(right.max()))
    # data-group sum: the ranks of one column
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=m.data_group)
    out["data_sum"] = float(t)
    return out


def test_mesh_of_four_ranks():
    got = parallel.spawn(_mesh_rank, 4)
    for r, g in enumerate(got):
        d, s = divmod(r, 2)
        assert g["shape"] == (2, 2) and g["coords"] == (d, s)
        assert g["sizes"] == (2, 2)
        other = 10 * d + 1 - s
        assert g["halo"] == ((None, other) if s == 0 else (other, None))
        assert g["data_sum"] == float(s + (2 + s))


def _halo_rank(rank, world):
    parallel.initialize_from_params(dict(distributed=True, device="cpu"))
    m = parallel.make_mesh(1, world)
    gen = torch.Generator().manual_seed(rank)
    slabs = [torch.rand((4, 3, 5, 2), generator=gen).to(torch.bfloat16),
             torch.randint(-128, 127, (2, 3, 5, 7), generator=gen,
                           dtype=torch.int8),
             torch.rand((3, 3, 5, 3), generator=gen)]
    got = parallel.halo_exchange_many(slabs, m.spatial_group, m.spatial,
                                      m.spatial_index)
    return slabs, got


@pytest.mark.parametrize("world", [2, 3])
def test_halo_exchange_gives_the_neighbours_edge_planes(world):
    ranks = parallel.spawn(_halo_rank, world, (world,))
    for r, (slabs, got) in enumerate(ranks):
        for i, (left, right) in enumerate(got):
            if r == 0:
                assert left is None
            else:
                want = ranks[r - 1][0][i][-1:]
                assert left.dtype == want.dtype and torch.equal(left, want)
            if r == world - 1:
                assert right is None
            else:
                want = ranks[r + 1][0][i][:1]
                assert right.dtype == want.dtype and torch.equal(right, want)


def test_join_and_crop():
    x = torch.arange(4.0).reshape(4, 1, 1, 1)
    lo, hi = torch.full((1, 1, 1, 1), -1.0), torch.full((1, 1, 1, 1), 9.0)
    assert parallel.join((lo, hi), x).flatten().tolist() == [-1, 0, 1, 2, 3,
                                                             9]
    assert parallel.join((None, hi), x).shape[0] == 5
    y = torch.arange(12.0).reshape(12, 1, 1, 1)
    assert parallel.crop((lo, hi), y, 2).flatten().tolist() == list(
        range(2, 10))
    assert parallel.crop((None, None), y) is y


class _IdxDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 2), i, np.float32), "filepath": str(i)}


@pytest.mark.parametrize("n_items,ranks", [(12, 2), (13, 2), (12, 4)])
def test_hostloader_rank_slices_reassemble_the_global_batch(n_items, ranks):
    """Every rank draws the same index stream; its slices, put together,
    are the single-process batches (``tests/test_distributed.py:37-54``);
    the uneven tail batch is skipped."""
    full = HostLoader(_IdxDataset(n_items), batch_size=4, seed=7,
                      n_workers=1, shuffle=True)
    parts = [HostLoader(_IdxDataset(n_items), batch_size=4, seed=7,
                        n_workers=1, shuffle=True, process_id=r,
                        num_processes=ranks) for r in range(ranks)]
    want = [b["image"][:, 0, 0] for b in full]
    got = [[b["image"][:, 0, 0] for b in p] for p in parts]
    assert all(len(g) == len(parts[0]) == n_items // 4 for g in got)
    for i in range(n_items // 4):
        np.testing.assert_array_equal(
            want[i], np.concatenate([g[i] for g in got]))


def test_hostloader_rejects_an_indivisible_batch():
    with pytest.raises(ValueError, match="divide"):
        HostLoader(_IdxDataset(4), batch_size=3, num_processes=2)


def test_package_exports_ops_and_parallel_lazily():
    """``import ctunet_tpu_torch`` imports no torch;
    ``ctunet_tpu_torch.ops`` and ``.parallel`` import on first use, as
    ``ctunet_tpu/__init__.py:10,19`` exports ``ops``."""
    import subprocess
    import sys

    code = ("import sys, ctunet_tpu_torch as c; "
            "assert 'torch' not in sys.modules; "
            "assert {'ops', 'parallel'} <= set(c.__all__); "
            "print(c.ops.threshold.__name__, c.parallel.make_mesh.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.split() == ["threshold", "make_mesh"]
