"""Multi-process bring-up: one process per device over ``torch.distributed``.

Counterpart of ``ctunet_tpu/parallel/distributed.py``. The JAX package runs
one process per host, each driving its local devices as one SPMD program;
this port runs one process (a *rank*) per device, PyTorch's idiom, and the
ranks talk through ``torch.distributed`` collectives.

Config keys (INI type-prefix convention, the JAX package's keys):
  ``b_distributed``          bring the process group up
  ``s_dist_coordinator``     ``host:port`` of rank 0
                             (env ``CTUNET_COORDINATOR``)
  ``i_dist_num_processes``   world size (env ``CTUNET_NUM_PROCESSES``)
  ``i_dist_process_id``      this process's rank (env ``CTUNET_PROCESS_ID``)

A set environment variable overrides its key, so one INI serves every rank
while a launcher sets each rank's id. ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``
(as ``torchrun`` sets them) say where a rank sits on its host; without them
every rank is taken to share one host. There is no automatic discovery (the
JAX package's TPU-pod / SLURM fallback): a missing coordinator, world size
or rank is an error.

Backend: ``gloo`` on the CPU; on the card ``nccl`` when every rank of a
host has a card of its own, and ``gloo`` when ranks share a card (NCCL
refuses two ranks on one device). The choice follows from the devices; a
rank never moves to the CPU.

The JAX helpers ``TcpBarrier``, ``sync_compiled``, ``globalize`` and
``put_global`` have no counterpart: they exist for XLA's
compile-then-collective timeout and for assembling global ``jax.Array``\\ s,
and an eager PyTorch rank has neither.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import torch

# how long a collective or a barrier waits for the slowest rank
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)

_ENV = {"dist_coordinator": "CTUNET_COORDINATOR",
        "dist_num_processes": "CTUNET_NUM_PROCESSES",
        "dist_process_id": "CTUNET_PROCESS_ID"}


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """``(rank, world size)`` of the live process group, ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if not is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _setting(params: Dict[str, Any], key: str) -> str:
    """The environment variable of ``key`` when set, else the key's
    value; an unset value is ``""``."""
    env = os.environ.get(_ENV[key], "").strip()
    if env:
        return env
    value = params.get(key)
    if value is None or (key != "dist_coordinator" and int(value) < 0) \
            or (key == "dist_num_processes" and int(value) == 0):
        return ""
    return str(value).strip()


def local_rank_and_world(rank: int, world: int) -> Tuple[int, int]:
    """This rank's index among the ranks of its host, and their number:
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` when set, else one host."""
    local = os.environ.get("LOCAL_RANK", "").strip()
    count = os.environ.get("LOCAL_WORLD_SIZE", "").strip()
    return (int(local) if local else rank), (int(count) if count else world)


def choose_backend(on_cuda: bool, local_world: int,
                   n_cards: Optional[int] = None) -> str:
    """``nccl`` when the ranks run on the card and each rank of a host has
    a card of its own, else ``gloo`` (the CPU, or ranks sharing a card)."""
    if not on_cuda:
        return "gloo"
    n_cards = torch.cuda.device_count() if n_cards is None else n_cards
    return "nccl" if n_cards >= local_world else "gloo"


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: the CPU stays the CPU; on the card, card
    ``LOCAL_RANK`` when each rank of the host has one, else the ranks share
    them round-robin (one card: all share card 0)."""
    if device.type != "cuda" or not is_initialized():
        return device
    rank, world = rank_and_world()
    local, local_world = local_rank_and_world(rank, world)
    n_cards = torch.cuda.device_count()
    if n_cards >= local_world:
        return torch.device("cuda", local)
    return torch.device("cuda", local % n_cards)


def initialize_from_params(params: Dict[str, Any]) -> Tuple[int, int]:
    """Bring the process group up when ``b_distributed`` is set.

    Returns ``(rank, world size)``, ``(0, 1)`` when distribution is off. A
    second call is a no-op that reports the live group. Raises
    ``ValueError`` naming the key when the coordinator, the world size or
    the rank is missing, or the rank is out of range.
    """
    import torch.distributed as dist

    if not params.get("distributed") or is_initialized():
        return rank_and_world()
    vals = {k: _setting(params, k) for k in _ENV}
    for key, val in vals.items():
        if not val:
            raise ValueError(
                f"b_distributed needs {key} (INI key "
                f"{'s' if key == 'dist_coordinator' else 'i'}_{key} or env "
                f"{_ENV[key]}): this port has no automatic discovery")
    coord = vals["dist_coordinator"]
    world, rank = int(vals["dist_num_processes"]), int(vals["dist_process_id"])
    if not 0 <= rank < world:
        raise ValueError(f"dist_process_id {rank} outside a world of {world}")
    if "://" not in coord:
        coord = "tcp://" + coord
    on_cuda = str(params.get("device") or "cuda").lower() != "cpu"
    local, local_world = local_rank_and_world(rank, world)
    backend = choose_backend(on_cuda, local_world)
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=coord, world_size=world,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    if rank == 0:
        where = ("on the CPU" if not on_cuda else
                 f"{torch.cuda.device_count()} card(s) for {local_world} "
                 "ranks a host")
        print(f"torch.distributed: {world} ranks, backend {backend} "
              f"({where})", flush=True)
    return rank, world


def local_batch_size(global_batch: int, n: Optional[int] = None) -> int:
    """This rank's share of ``global_batch`` over ``n`` ranks (default:
    the world)."""
    n = rank_and_world()[1] if n is None else int(n)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over "
                         f"{n} processes")
    return global_batch // n


def barrier_wait(tag: str) -> None:
    """Block until every rank reaches this point (``tag`` names it in a
    timeout's error). No-op without a process group."""
    import torch.distributed as dist

    if not is_initialized() or dist.get_world_size() == 1:
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=COLLECTIVE_TIMEOUT,
                                   wait_all_ranks=True)
        else:
            dist.barrier(device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r}: {e}") from e


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, forward and backward: the gradient of each
    rank's input is the sum over the ranks of the gradients of the output
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_mean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ``size`` ranks of ``group``."""
    return _AllReduceSum.apply(x, group) / size
