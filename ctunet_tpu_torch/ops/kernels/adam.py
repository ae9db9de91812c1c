"""The Adam / AdamW update of many f32 leaves as one multi-tensor kernel
(``csrc/adam_mt.cu``).

:func:`adam_mt` updates each leaf's parameter and its moments ``mu``,
``nu`` and ``nu_max`` in place with the arithmetic of
``steps.Optimizer._update`` (``adam`` or ``adamw``, f32): the constants
come from :func:`constants`, each rounded to f32 as ATen rounds a Python
scalar on the card, and the bias corrections go in as ATen's f32
reciprocals. :func:`pack` plans the launches as ATen's
``multi_tensor_apply`` does: a table of at most :data:`LEAVES` leaves (five
pointers and a size each) and a block map of at most :data:`BLOCKS` blocks,
block ``b`` updating chunk ``block_chunk[b]`` (:data:`CHUNK` elements) of
the table's leaf ``block_leaf[b]``; the table goes by value in the launch's
parameters, so a launch copies nothing to the device and never waits.

Its plain version is the per-leaf ``steps.Optimizer._update`` on the same
card, which it equals bit for bit; CPU tensors take that path (the
kernel refuses them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import build

# leaves in one launch's table, blocks in its map, elements a block updates
# (csrc/adam_mt.cu: MT_LEAVES, MT_BLOCKS, MT_CHUNK)
LEAVES = 48
BLOCKS = 320
CHUNK = 4096
# the table's bytes: five pointers and an int64 size a leaf, an int32 chunk
# and a uint8 leaf a block, rounded up to 8; with the constants it fits the
# 4 KB of a launch's parameters
TABLE_BYTES = (48 * LEAVES + 5 * BLOCKS + 7) // 8 * 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flags: the L2 decay on the gradient (adam), the decoupled decay (adamw),
# the plateau scale
L2, DECOUPLED, SCALED = 1, 2, 4


class Launch(NamedTuple):
    """One launch: the leaves of its table (indices into the caller's list,
    in order) and, for each block, its slot in that table and its chunk."""

    leaves: List[int]
    block_leaf: List[int]
    block_chunk: List[int]


class Constants(NamedTuple):
    """The update's constants as the kernel takes them: f32 values and the
    flags."""

    b1: float
    c1: float
    b2: float
    c2: float
    inv_bc1: float
    inv_bc2: float
    eps: float
    wd: float
    neg_lr: float
    scale: float
    flags: int


def _f32(v: float) -> float:
    return float(np.float32(v))


def constants(name: str, lr: float, b1: float, b2: float, eps: float,
              wd: float, bc1: float, bc2: float,
              scale: float) -> Constants:
    """The constants of one ``adam`` or ``adamw`` step: each Python float
    rounded to f32 (``1 - b`` taken in double first, as the per-leaf path
    writes it), the bias corrections ``bc1``, ``bc2`` as their f32
    reciprocals (ATen's division by a host scalar on the card)."""
    if name not in ("adam", "adamw"):
        raise ValueError(f"adam_mt: adam or adamw, got {name!r}")
    one = np.float32(1.0)
    flags = ((L2 if wd and name == "adam" else 0)
             | (DECOUPLED if name == "adamw" else 0)
             | (SCALED if scale != 1.0 else 0))
    return Constants(_f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
                     float(one / np.float32(bc1)),
                     float(one / np.float32(bc2)), _f32(eps), _f32(wd),
                     _f32(-lr), _f32(scale), flags)


def pack(numels: Sequence[int]) -> List[Launch]:
    """The launches that update leaves of ``numels`` elements: leaves in
    order, each leaf's chunks in order, a new launch when the table or the
    block map is full (a leaf cut there goes on in the next table). Empty
    leaves take no block."""
    launches: List[Launch] = []
    cur = Launch([], [], [])
    for i, n in enumerate(numels):
        for c in range(-(-int(n) // CHUNK)):
            if not cur.leaves or cur.leaves[-1] != i:
                if len(cur.leaves) == LEAVES:
                    launches.append(cur)
                    cur = Launch([], [], [])
                cur.leaves.append(i)
            cur.block_leaf.append(len(cur.leaves) - 1)
            cur.block_chunk.append(c)
            if len(cur.block_leaf) == BLOCKS:
                launches.append(cur)
                cur = Launch([], [], [])
    if cur.block_leaf:
        launches.append(cur)
    return launches


def table(launch: Launch, numels: Sequence[int]) -> np.ndarray:
    """The launch's table as the kernel reads it, its pointers left 0: the
    sizes of its leaves (``numels`` indexed as :func:`pack`'s leaves) and
    its block map."""
    buf = np.zeros(TABLE_BYTES, np.uint8)
    buf[40 * LEAVES:48 * LEAVES].view(np.int64)[:len(launch.leaves)] = [
        numels[i] for i in launch.leaves]
    nb = len(launch.block_leaf)
    at = 48 * LEAVES
    buf[at:at + 4 * BLOCKS].view(np.int32)[:nb] = launch.block_chunk
    buf[at + 4 * BLOCKS:at + 5 * BLOCKS][:nb] = launch.block_leaf
    return buf


@functools.lru_cache(maxsize=8)
def _plan(numels: Tuple[int, ...]):
    """``(leaves, table, blocks)`` of each launch of :func:`pack`, planned
    once for each tuple of leaf sizes (a model's leaves keep theirs)."""
    return tuple((np.asarray(t.leaves, np.intp), table(t, numels),
                  len(t.block_leaf)) for t in pack(numels))


def _require_cuda(t, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: CUDA tensors only (the per-leaf "
                         f"steps.Optimizer._update takes the rest), got "
                         f"{t.device}")


def _check(tensors) -> List[int]:
    """The leaves' sizes, after checking that every tensor is contiguous
    f32 on the first one's device with its leaf's size."""
    if len(tensors) != 5 or len({len(ts) for ts in tensors}) != 1:
        raise ValueError("adam_mt: five lists of as many leaves (params, "
                         "grads, mu, nu, nu_max)")
    numels = [p.numel() for p in tensors[0]]
    dev = tensors[0][0].get_device() if numels else -1
    f32 = torch.float32
    for ts in tensors:
        for t, n in zip(ts, numels):
            if t.dtype is not f32 or not t.is_contiguous():
                raise ValueError("adam_mt: every tensor contiguous f32")
            if t.numel() != n or t.get_device() != dev:
                raise ValueError("adam_mt: a leaf's tensors share its "
                                 "device and size")
    return numels


@build.traced
def adam_mt(params, grads, mus, nus, nu_maxs, k: Constants) -> None:
    """One ``adam`` / ``adamw`` step of the leaves ``params`` (f32,
    contiguous) from ``grads``, their moments updated in place; ``k`` from
    :func:`constants`.

    ``csrc/adam_mt.cu`` on the current stream, one launch per table of
    :func:`pack`, or an error; CUDA tensors only.
    """
    tensors = (list(params), list(grads), list(mus), list(nus),
               list(nu_maxs))
    numels = _check(tensors)
    if not numels:
        return
    _require_cuda(tensors[0][0], "adam_mt")
    fn = build.function("adam_mt", "ctunet_adam_mt",
                        [_P, _I] + [_F] * 10 + [_I, _I, _P])
    stream = build.stream_args(tensors[0][0])
    ptrs = np.array([[t.data_ptr() for t in ts] for ts in tensors],
                    np.uint64)
    for leaves, tab, blocks in _plan(tuple(numels)):
        buf = tab.copy()
        buf[:40 * LEAVES].view(np.uint64).reshape(5, LEAVES)[
            :, :len(leaves)] = ptrs[:, leaves]
        rc = fn(buf.ctypes.data, blocks, *k, *stream)
        build.check(rc, "adam_mt")
        adam_mt.launches += 1


adam_mt.launches = 0
