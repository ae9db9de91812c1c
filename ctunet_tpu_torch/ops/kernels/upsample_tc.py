"""``upconv_tc``: the stride-2 upsampling kernels K3 and K7a/K7b on the
tensor cores, one implicit GEMM from half-resolution operands
(``csrc/upconv_tc.cu``).

Output voxel ``2m+p`` (parity ``p`` in {0,1}^3) of half-resolution voxel
``m`` draws taps ``t`` from the neighbours ``m + off(p, t)`` of ``m``:

- K7 (``conv_transpose_k2s2(_dual)``): one tap, ``off = 0``, weights
  ``W[p]`` of the ConvT, plus bias;
- K3 (``upconv_fused_chain_split``, bf16): 8 taps ``t`` in {0,1}^3,
  ``off = p - 1 + t``, weights ``R[3 - p - 2t]`` of the composite response
  (:func:`~.upconv.composite_response`), plus the ones-channel term of the
  in-bounds taps, the folded bias and ReLU.

Host side: :func:`uptc_plan` picks the tiles per layer and shape,
:func:`pack_weights` lays the weights out as the kernel's stages read them
(:func:`slot_table` is the enumeration both share), :func:`uptc_packed`
keeps the packing on the weight tensor, and :func:`uptc_blocks` is the
kernel's grid arithmetic. :func:`upconv_tc` launches the kernel for bf16
CUDA tensors (or raises) and runs the plain version of K3 or K7 for a CPU
tensor; ``upconv_tc.launches`` counts kernel launches, and equals on every
bf16 path the launches of the K3, K7a and K7b wrappers, which call it.

In f32 the same function runs on :func:`upconv_tc_f32`
(``csrc/upconv_tc_f32.cu``): the same implicit GEMM on split tf32 products
(3xTF32 with the weights split exactly, f32-accurate), plan
:func:`uptcf_plan` (an :class:`UpPlan` whose ``cc`` is a multiple of 8;
K3 blocks take 2 or 4 parities of one ``pz``), slots :func:`uptcf_slots`,
weights :func:`pack_weights_f32` (three tf32 planes) kept by
:func:`uptcf_packed`. The wrappers ``upconv.upconv_f32`` (K3) and
``convt.convt_f32`` (K7a/K7b) call it, and ``upconv_tc_f32.launches``
equals the sum of theirs.

K3q, the int8 mode of K3, has a kernel of its own on the int8 tensor cores,
:func:`upconv_tc_q` (``csrc/upconv_tc_q.cu``), with the same tiles and slot
enumeration: :func:`uptcq_plan` adds the int8 channel groups (the ones
lane rides operand a's padding), :func:`pack_weights_q` the packing;
``upconv_tc_q.launches`` equals on every path the launches of
``upconv.upconv_q_requant``, which calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import build
from .conv3d import (SMEM_PER_BLOCK, _check, _require_cuda,
                     split_tf32_planes)

_P, _I = ctypes.c_void_p, ctypes.c_int

# SMs of an H100 SXM: the plan wants at least two blocks on each
UT_SMS = 132
# M tiles of 64 * mf half-resolution voxels of one z plane, as (mf, log2 TX)
UT_TILES = ((1, 3), (1, 4), (2, 3), (2, 4))
# bytes of one pipeline stage (slab + weights), a block holding two
UT_STAGE_BYTES = 32 * 1024
# accumulators a thread holds: np * mf * nf n8 tiles of 4 floats
UT_MAX_TILES = 16


class UpPlan(NamedTuple):
    """Launch parameters of ``csrc/upconv_tc.cu`` for one layer at one
    shape: ``k3`` (K3) or K7; ``np`` parities per block (2, 4 or 8; the
    grid walks ``8 // np`` parity groups); ``mf`` m16 fragments per warp
    (4 warps: ``64 * mf`` voxels a tile, ``1 << tx_log2`` along W); ``nf``
    n8 tiles per block (``8 * nf`` output channels); ``cc`` input channels
    per stage, ``chunks_a`` / ``chunks_b`` stages per plane of each
    operand."""

    k3: bool
    np: int
    mf: int
    nf: int
    tx_log2: int
    cc: int
    chunks_a: int
    chunks_b: int

    @property
    def tile(self):
        """(TY, TX): the half-resolution tile of one block in one plane."""
        tx = 1 << self.tx_log2
        return 64 * self.mf // tx, tx

    @property
    def n_pg(self) -> int:
        return 8 // self.np

    @property
    def n_dz(self) -> int:
        """Input planes a block reads: z-1..z+1 (K3, all 8 parities),
        z+pz-1..z+pz (K3, one z parity), z (K7)."""
        return (3 if self.np == 8 else 2) if self.k3 else 1

    @property
    def slots(self) -> int:
        """Weight matrices of the widest stage: 4 taps of each parity
        (K3 at the block's middle plane), one per parity (K7)."""
        return 4 * self.np if self.k3 else self.np

    @property
    def chunks(self) -> int:
        return self.chunks_a + self.chunks_b

    def n_tiles(self, co: int) -> int:
        return -(-co // (8 * self.nf))

    def dz_lo(self, pg: int) -> int:
        """The first input plane of parity group ``pg``, relative to z."""
        return ((pg * self.np) >> 2) - 1 if self.k3 else 0


def parity(p: int):
    """(pz, py, px) of parity index ``p = 4 pz + 2 py + px``."""
    return p >> 2, (p >> 1) & 1, p & 1


def reads(k3: bool, dz: int, o: int, p: int) -> Optional[int]:
    """The tap of parity ``p`` that reads slab offset ``o`` (``(dy, dx) =
    divmod(o, 3)`` minus 1 in K3) of plane ``dz``, as ``4 tz + 2 ty + tx``,
    or None (the kernel's ``reads``)."""
    if not k3:
        return 0
    pz, py, px = parity(p)
    tz, ty, tx = dz + 1 - pz, o // 3 - py, o % 3 - px
    if min(tz, ty, tx) < 0 or max(tz, ty, tx) > 1:
        return None
    return 4 * tz + 2 * ty + tx


def slot_table(plan: UpPlan, pg: int):
    """Per input plane ``dzi`` of parity group ``pg``, the stage's slots in
    order: ``(o, j, p, t)`` for slab offset ``o``, the block's parity ``j``
    (``p = pg * np + j``) and its tap ``t``, numbered over (offset,
    parity), as the kernel's slot table numbers them."""
    n_off = 9 if plan.k3 else 1
    table = []
    for dzi in range(plan.n_dz):
        dz = plan.dz_lo(pg) + dzi
        row = []
        for o in range(n_off):
            for j in range(plan.np):
                p = pg * plan.np + j
                t = reads(plan.k3, dz, o, p)
                if t is not None:
                    row.append((o, j, p, t))
        table.append(row)
    return table


def _stage_bytes(k3: bool, cc: int, np_: int, nf: int, slab_vox: int) -> int:
    slots = 4 * np_ if k3 else np_
    return 2 * slab_vox * (cc + 8) + 2 * slots * cc * 8 * nf


def uptc_channels(ca: int, cb: int, k3: bool, np_: int, nf: int):
    """``(cc, chunks_a, chunks_b)``: the fewest padded channels
    (``(chunks_a + chunks_b) * cc``), then the widest chunk whose stage fits
    ``UT_STAGE_BYTES`` at the largest slab of ``UT_TILES``."""
    h = 1 if k3 else 0
    slab = max((64 * mf // (1 << t) + 2 * h) * ((1 << t) + 2 * h)
               for mf, t in UT_TILES)
    best = None
    for cc in (16, 32, 64):
        if cc > 16 and _stage_bytes(k3, cc, np_, nf, slab) > UT_STAGE_BYTES:
            continue
        n_a, n_b = -(-ca // cc), -(-cb // cc)
        key = ((n_a + n_b) * cc, -cc)
        if best is None or key < best[0]:
            best = (key, cc, n_a, n_b)
    return best[1:]


def uptc_plan(shape2, ca: int, cb: int, co: int, k3: bool) -> UpPlan:
    """The tile plan of K3 (``k3``) or K7 from half-resolution operands of
    ``ca`` (and ``cb``) channels over ``shape2`` to ``co`` channels.
    ``nf`` covers ``co`` in one N tile up to 32 channels. Of the parity
    groupings and M tiles that keep ``np * mf * nf <= UT_MAX_TILES``, the
    one with the least estimated time: the shared-memory bytes the blocks
    read per k16 step (A once per slab offset a block reads, B once per
    (offset, parity) pair, in each of 4 warps), stretched when the grid has
    fewer than two blocks per SM."""
    d2, h2, w2 = shape2
    nf = 1 if co <= 8 else 2 if co <= 16 else 4
    n_tiles = -(-co // (8 * nf))
    best = None
    for np_ in (8, 4, 2):
        for mf, tx_log2 in UT_TILES:
            if np_ * mf * nf > UT_MAX_TILES:
                continue
            tx = 1 << tx_log2
            ty = 64 * mf // tx
            blocks = d2 * -(-h2 // ty) * -(-w2 // tx) * (8 // np_) * n_tiles
            offsets = {8: 27, 4: 18, 2: 12}[np_] if k3 else 1
            pairs = 8 * np_ if k3 else np_
            per_block = 4 * (offsets * mf * 512 + pairs * nf * 256)
            cost = blocks * per_block * max(1.0, 2 * UT_SMS / blocks)
            if best is None or cost < best[0]:
                best = (cost, np_, mf, tx_log2)
    _, np_, mf, tx_log2 = best
    cc, n_a, n_b = uptc_channels(ca, cb, k3, np_, nf)
    return UpPlan(bool(k3), np_, mf, nf, tx_log2, cc, n_a, n_b)


def uptc_blocks(shape2, co: int, plan: UpPlan):
    """The blocks of the kernel's grid, with its index arithmetic: each is
    ``(z, y0, x0, pg, n0, vy, vx, ncol)``: half-resolution rows
    ``y0..y0+vy`` and columns ``x0..x0+vx`` of plane ``z``, whose output
    voxels of parities ``pg * np ..`` and channels ``n0..n0+ncol`` it
    writes."""
    d2, h2, w2 = shape2
    ty, tx = plan.tile
    bn, n_tiles = 8 * plan.nf, plan.n_tiles(co)
    tiles_x, tiles_y = -(-w2 // tx), -(-h2 // ty)
    for z in range(d2):  # blockIdx.y
        for bx in range(tiles_y * tiles_x * plan.n_pg * n_tiles):
            rest, nt = divmod(bx, n_tiles)
            tile, pg = divmod(rest, plan.n_pg)
            ty_i, tx_i = divmod(tile, tiles_x)
            y0, x0, n0 = ty_i * ty, tx_i * tx, nt * bn
            yield (z, y0, x0, pg, n0, min(ty, h2 - y0), min(tx, w2 - x0),
                   min(bn, co - n0))


def _tap_weights(w: torch.Tensor, k3: bool) -> torch.Tensor:
    """``(8 * T, C, Co)``: the weights of (parity p, tap t) at ``p * T +
    t``; K3 reads ``R[3 - p - 2t]`` of ``(4, 4, 4, C, Co)`` (T = 8), K7
    ``W[p]`` of ``(2, 2, 2, C, Co)`` (T = 1)."""
    if not k3:
        return w.reshape(8, *w.shape[3:])
    idx = torch.tensor([[[3 - pd - 2 * td for pd, td in zip(parity(p),
                                                            parity(t))]
                         for t in range(8)] for p in range(8)])
    return w[idx[..., 0], idx[..., 1], idx[..., 2]].reshape(64, *w.shape[3:])


def _slot_weights(wa: torch.Tensor, wb: Optional[torch.Tensor],
                  plan: UpPlan, slots=slot_table) -> torch.Tensor:
    """``(n_pg, n_dz, slots, chunks * cc, n_tiles * 8 * nf)``: per parity
    group and input plane, the weights of the stage's slots in the order of
    ``slots(plan, pg)`` (:func:`slot_table`, or :func:`uptcf_slots`;
    operand a's channels padded to its chunks, then b's); zeros pad the
    channels, ``Co`` and the slots a plane does not use."""
    co = wa.shape[-1]
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    parts = []
    for w, n in ((wa, plan.chunks_a), (wb, plan.chunks_b)):
        if n:
            t = _tap_weights(w, plan.k3)
            parts.append(F.pad(t, (0, 0, 0, n * plan.cc - t.shape[1])))
    wt = F.pad(torch.cat(parts, 1), (0, nt * bn - co))
    n_mat = wt.shape[0]
    wz = torch.cat([wt, wt.new_zeros((1,) + wt.shape[1:])])
    idx = torch.full((plan.n_pg, plan.n_dz, plan.slots), n_mat)
    tpp = 8 if plan.k3 else 1
    for pg in range(plan.n_pg):
        for dzi, row in enumerate(slots(plan, pg)):
            for s, (_, _, p, t) in enumerate(row):
                idx[pg, dzi, s] = p * tpp + t
    return wz[idx]


def pack_weights(wa: torch.Tensor, wb: Optional[torch.Tensor],
                 plan: UpPlan) -> torch.Tensor:
    """The kernel's weight operand ``(n_pg, n_tiles, n_dz, chunks, slots,
    cc / 8, 8 * nf, 8)``: per parity group, N tile, input plane and channel
    chunk (operand a's chunks, then b's), the stage's slots of
    :func:`slot_table`, each ``[k-group][n][8]`` (:func:`_slot_weights`)."""
    g = _slot_weights(wa, wb, plan)
    g = g.reshape(plan.n_pg, plan.n_dz, plan.slots, plan.chunks,
                  plan.cc // 8, 8, -1, 8 * plan.nf)
    return g.permute(0, 6, 1, 3, 2, 4, 7, 5).contiguous()


def pack_wone(wone: torch.Tensor) -> torch.Tensor:
    """K3's ones-channel response ``(4, 4, 4, Co)`` -> f32 ``(8, 9, Co)``:
    per parity its 8 taps' rows, then their sum (taken in f64), the term of
    a voxel whose taps all lie inside."""
    t = _tap_weights(wone[..., None, :], True).reshape(8, 8, -1).double()
    return torch.cat([t, t.sum(1, keepdim=True)], 1).float().contiguous()


def _kept(attr: str, plan_key: tuple, wa: torch.Tensor,
          wb: Optional[torch.Tensor], wone: Optional[torch.Tensor], make):
    """``make()``, once per weight tensor: kept on ``wa`` under ``attr``
    and made again only when one of the weights was written in place since
    (version counters), another tensor comes with it, or the plan packs
    differently (``plan_key``)."""
    def ver(t):
        return None if t is None or t.is_inference() else (id(t), t._version)

    key = (plan_key, ver(wa), ver(wb), ver(wone), id(wb), id(wone))
    hit = getattr(wa, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, make())
        setattr(wa, attr, hit)
    return hit[1]


def uptc_packed(wa: torch.Tensor, wb: Optional[torch.Tensor],
                wone: Optional[torch.Tensor], plan: UpPlan):
    """``(pack_weights, pack_wone or None)``, once per weight tensor
    (:func:`_kept`)."""
    return _kept("_uptc_packed", (plan.k3, plan.np, plan.nf, plan.cc,
                                  plan.chunks_a, plan.chunks_b),
                 wa, wb, wone, lambda: (
                     pack_weights(wa, wb, plan),
                     None if wone is None else pack_wone(wone)))


def upconv_tc_plain(a, b, wa, wb, wone, bias, k3: bool) -> torch.Tensor:
    """The plain version: K3's (:func:`~.upconv.upconv_bn_relu_plain`) when
    ``k3``, else K7's (:func:`~.convt.convt_k2s2_plain`)."""
    from . import convt, upconv

    if k3:
        return upconv.upconv_bn_relu_plain(a, b, wa, wb, wone, bias)
    return convt.convt_k2s2_plain(a, b, wa, wb, bias)


def _up_checks(a, b, wa, wb, wone, bias, k3: bool, dtype, what: str):
    """Check the operands of K3 (``k3``) or K7 in ``dtype`` (f32 bias) for
    a launch and return ``(D2, H2, W2, Ca, Cb, Co)``."""
    _require_cuda(a, what)
    kw = 4 if k3 else 2
    d2, h2, w2, ca = a.shape
    co = wa.shape[-1]
    _check(a, "a", dtype)
    _check(wa, "wa", dtype, (kw, kw, kw, ca, co), a.device)
    _check(bias, "bias", torch.float32, (co,), a.device)
    if k3:
        _check(wone, "wone", dtype, (4, 4, 4, co), a.device)
    elif wone is not None:
        raise ValueError(f"{what}: K7 takes no ones-channel weights")
    cb = 0
    if b is not None:
        cb = b.shape[-1]
        _check(b, "b", dtype, (d2, h2, w2, cb), a.device)
        _check(wb, "wb", dtype, (kw, kw, kw, cb, co), a.device)
    if a.data_ptr() % 16 or (b is not None and b.data_ptr() % 16):
        raise ValueError(f"{what}: a and b must start on a 16-byte "
                         "boundary")
    return d2, h2, w2, ca, cb, co


@build.traced
def upconv_tc(a: torch.Tensor, b: Optional[torch.Tensor], wa: torch.Tensor,
              wb: Optional[torch.Tensor], wone: Optional[torch.Tensor],
              bias: torch.Tensor, k3: bool) -> torch.Tensor:
    """K3 (``k3``: ``wa``/``wb`` ``(4, 4, 4, C, Co)`` composite responses,
    ``wone`` ``(4, 4, 4, Co)``, ReLU) or K7 (``wa``/``wb`` ``(2, 2, 2, C,
    Co)``, ``wone`` None, no activation) of bf16 half-resolution ``a``
    ``(D2, H2, W2, Ca)`` and ``b`` ``(D2, H2, W2, Cb)`` or None, with f32
    ``bias`` ``(Co,)`` -> bf16 ``(2*D2, 2*H2, 2*W2, Co)``, accumulated in
    f32 and rounded once.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/upconv_tc.cu``
    kernel on the current stream with :func:`uptc_plan`'s tiles and
    :func:`uptc_packed` weights, or an error.
    """
    if a.device.type == "cpu":
        return upconv_tc_plain(a, b, wa, wb, wone, bias, k3)
    d2, h2, w2, ca, cb, co = _up_checks(a, b, wa, wb, wone, bias, k3,
                                        torch.bfloat16, "upconv_tc")
    out = torch.empty((2 * d2, 2 * h2, 2 * w2, co), dtype=torch.bfloat16,
                      device=a.device)
    if out.numel() == 0:
        return out
    plan = uptc_plan((d2, h2, w2), ca, cb, co, k3)
    wp, wo = uptc_packed(wa, wb, wone, plan)
    fn = build.function("upconv_tc", "ctunet_upconv_tc",
                        [_P] * 6 + [_I] * 16 + [_P])
    rc = fn(a.data_ptr(), None if b is None else b.data_ptr(), wp.data_ptr(),
            None if wo is None else wo.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d2, h2, w2, ca, cb, co, int(k3), int(k3),
            plan.np, plan.mf, plan.nf, plan.tx_log2, plan.cc, plan.chunks_a,
            plan.chunks_b, *build.stream_args(a))
    build.check(rc, "upconv_tc")
    upconv_tc.launches += 1
    return out


upconv_tc.launches = 0


def upconv_tc_work(shape2, ca: int, cb: int, co: int, k3: bool):
    """``(bytes, flops)`` the function needs at these shapes (each input
    read once, the output written once, the weights read once; the flops
    of the in-bounds taps): the terms of the card's bound."""
    v2 = math.prod(shape2)
    taps = math.prod(4 * n - 2 for n in shape2) if k3 else 8 * v2
    nbytes = (2 * v2 * (ca + cb) + 2 * 8 * v2 * co
              + 2 * (64 if k3 else 8) * (ca + cb + (1 if k3 else 0)) * co
              + 4 * co)
    return nbytes, 2 * (ca + cb) * co * taps


# --------------------------------------------------------------------------
# upconv_tc_f32: K3 and K7a/K7b in f32 on the tensor cores, split tf32
# --------------------------------------------------------------------------

# bytes of one f32 pipeline stage (slab + the three weight planes of its
# slots), a block holding two: f32 and the three planes make a stage up to
# 6x upconv_tc's at the same channel chunk, so UT_STAGE_BYTES does not
# carry over. A plan sweep on the H100 (every plan of every f32 path shape)
# found small stages, which keep more blocks on an SM, the fastest.
UTF_STAGE_BYTES = 24 * 1024
# accumulators a thread holds: np * mf * nf n8 tiles of 4 floats, and as
# many for the stage's corrections (the kernel's UF_MAX_TILES; the same
# sweep found 16 slower at every shape)
UTF_MAX_TILES = 8


def uptcf_slots(plan: UpPlan, pg: int):
    """``csrc/upconv_tc_f32.cu``'s stage slots, as :func:`slot_table` lists
    ``upconv_tc``'s: per input plane ``dzi`` of parity group ``pg``, ``(o,
    j, p, t)`` in slot order, parity by parity and (K3) tap ``(ty, tx)`` by
    tap, which the kernel's unrolled loop addresses as ``4 j + 2 ty + tx``
    (K3 takes 2 or 4 parities of one ``pz``: every parity reads both
    planes, through tap ``tz = dzi``)."""
    if not plan.k3:
        return [[(0, j, pg * plan.np + j, 0) for j in range(plan.np)]]
    if plan.np not in (2, 4):
        raise ValueError(f"upconv_tc_f32: K3 takes 2 or 4 parities a block, "
                         f"got {plan.np}")
    table = []
    for dzi in range(plan.n_dz):
        row = []
        for j in range(plan.np):
            p = pg * plan.np + j
            _, py, px = parity(p)
            for ty in (0, 1):
                for tx in (0, 1):
                    row.append(((ty + py) * 3 + tx + px, j, p,
                                4 * dzi + 2 * ty + tx))
        table.append(row)
    return table


def uptcf_stage_bytes(plan: UpPlan) -> int:
    """One f32 stage of ``plan``: the halo slab (``cc + 4`` floats a voxel,
    an odd number of 16-byte words) and the widest stage's slots, three
    tf32 planes each."""
    h = 1 if plan.k3 else 0
    ty, tx = plan.tile
    slab = (ty + 2 * h) * (tx + 2 * h) * (plan.cc + 4)
    return 4 * (slab + plan.slots * 3 * plan.cc * 8 * plan.nf)


def uptcf_smem(plan: UpPlan) -> int:
    """Shared memory of one block: the two-stage ring, which the staged f32
    output tile reuses."""
    tile = 4 * plan.np * 64 * plan.mf * 8 * plan.nf
    return max(2 * uptcf_stage_bytes(plan), tile)


def uptcf_channels(ca: int, cb: int, plan: UpPlan):
    """``(cc, chunks_a, chunks_b)`` of f32 operands for ``plan``'s tiles:
    ``cc`` a multiple of 8 (one k8 product takes two k-groups of 4) whose
    stage fits ``UTF_STAGE_BYTES`` and whose block fits the card: the
    fewest stages (``chunks_a + chunks_b``), then the fewest padded
    channels, then the widest chunk."""
    best = None
    for cc in range(8, -(-max(ca, cb) // 8) * 8 + 1, 8):
        wide = plan._replace(cc=cc)
        if cc > 8 and (uptcf_stage_bytes(wide) > UTF_STAGE_BYTES
                       or uptcf_smem(wide) > SMEM_PER_BLOCK):
            continue
        n_a, n_b = -(-ca // cc), -(-cb // cc)
        key = (n_a + n_b, (n_a + n_b) * cc, -cc)
        if best is None or key < best[0]:
            best = (key, cc, n_a, n_b)
    return best[1:]


@functools.lru_cache(maxsize=256)
def uptcf_plan(shape2, ca: int, cb: int, co: int, k3: bool) -> UpPlan:
    """The tile plan of ``csrc/upconv_tc_f32.cu`` for K3 (``k3``) or K7
    from f32 half-resolution operands of ``ca`` (and ``cb``) channels over
    ``shape2`` to ``co`` channels: :class:`UpPlan`'s fields, with ``cc`` a
    multiple of 8 (:func:`uptcf_channels`). ``nf`` covers ``co`` in one N
    tile up to 32 channels. Of the parity groupings (K3: 4 or 2 parities
    of one ``pz``, whose slots the kernel knows when it is compiled; K7: 8,
    4 or 2) and M tiles that keep ``np * mf * nf <= UTF_MAX_TILES``, the
    one with the least estimated time: the shared-memory bytes the blocks
    read per k8 step (A once per slab offset a block reads, the three B
    planes once per (offset, parity) pair, in each of 4 warps), stretched
    when the grid has fewer than two blocks per SM. Kept per shape: a
    launch pays for it once."""
    d2, h2, w2 = shape2
    nf = 1 if co <= 8 else 2 if co <= 16 else 4
    n_tiles = -(-co // (8 * nf))
    best = None
    for np_ in (4, 2) if k3 else (8, 4, 2):
        for mf, tx_log2 in UT_TILES:
            if np_ * mf * nf > UTF_MAX_TILES:
                continue
            tx = 1 << tx_log2
            ty = 64 * mf // tx
            blocks = d2 * -(-h2 // ty) * -(-w2 // tx) * (8 // np_) * n_tiles
            offsets = {4: 18, 2: 12}[np_] if k3 else 1
            pairs = 8 * np_ if k3 else np_
            per_block = 4 * (offsets * mf * 512 + pairs * 3 * nf * 256)
            cost = blocks * per_block * max(1.0, 2 * UT_SMS / blocks)
            if best is None or cost < best[0]:
                best = (cost, np_, mf, tx_log2)
    plan = UpPlan(bool(k3), best[1], best[2], nf, best[3], 8, 1, 0)
    cc, n_a, n_b = uptcf_channels(ca, cb, plan)
    return plan._replace(cc=cc, chunks_a=n_a, chunks_b=n_b)


def pack_weights_f32(wa: torch.Tensor, wb: Optional[torch.Tensor],
                     plan: UpPlan) -> torch.Tensor:
    """f32 weights -> ``csrc/upconv_tc_f32.cu``'s operand ``(n_pg,
    n_tiles, n_dz, chunks, slots, 3, cc / 4, 8 * nf, 4)``: per parity
    group, N tile, input plane and channel chunk, the stage's slots of
    :func:`uptcf_slots` (:func:`_slot_weights`), each the three tf32
    planes ``hi + mid + lo == w`` (:func:`~.conv3d.split_tf32_planes`) of
    ``[k-group][n][4]``."""
    g = split_tf32_planes(_slot_weights(
        wa.float(), None if wb is None else wb.float(), plan, uptcf_slots))
    g = g.reshape(3, plan.n_pg, plan.n_dz, plan.slots, plan.chunks,
                  plan.cc // 4, 4, -1, 8 * plan.nf)
    return g.permute(1, 7, 2, 4, 3, 0, 5, 8, 6).contiguous()


def uptcf_packed(wa: torch.Tensor, wb: Optional[torch.Tensor],
                 wone: Optional[torch.Tensor], plan: UpPlan):
    """``(pack_weights_f32, pack_wone or None)``, once per weight tensor
    (:func:`_kept`)."""
    return _kept("_uptcf_packed", (plan.k3, plan.np, plan.nf, plan.cc,
                                   plan.chunks_a, plan.chunks_b),
                 wa, wb, wone, lambda: (
                     pack_weights_f32(wa, wb, plan),
                     None if wone is None else pack_wone(wone)))


@build.traced
def upconv_tc_f32(a: torch.Tensor, b: Optional[torch.Tensor],
                  wa: torch.Tensor, wb: Optional[torch.Tensor],
                  wone: Optional[torch.Tensor], bias: torch.Tensor,
                  k3: bool) -> torch.Tensor:
    """K3 or K7 as :func:`upconv_tc` takes them, on f32 operands, weights
    and ``wone`` -> f32 ``(2*D2, 2*H2, 2*W2, Co)``, to f32 accuracy: the
    split-tf32 tensor-core kernel of K3 and K7a/K7b in f32.

    CPU tensor: the plain version. CUDA tensor: the
    ``csrc/upconv_tc_f32.cu`` kernel on the current stream with
    :func:`uptcf_plan`'s tiles and :func:`uptcf_packed` weights, or an
    error.
    """
    if a.device.type == "cpu":
        return upconv_tc_plain(a, b, wa, wb, wone, bias, k3)
    d2, h2, w2, ca, cb, co = _up_checks(a, b, wa, wb, wone, bias, k3,
                                        torch.float32, "upconv_tc_f32")
    out = torch.empty((2 * d2, 2 * h2, 2 * w2, co), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    plan = uptcf_plan((d2, h2, w2), ca, cb, co, k3)
    wp, wo = uptcf_packed(wa, wb, wone, plan)
    fn = build.function("upconv_tc_f32", "ctunet_upconv_tc_f32",
                        [_P] * 6 + [_I] * 16 + [_P])
    rc = fn(a.data_ptr(), None if b is None else b.data_ptr(), wp.data_ptr(),
            None if wo is None else wo.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d2, h2, w2, ca, cb, co, int(k3), int(k3),
            plan.np, plan.mf, plan.nf, plan.tx_log2, plan.cc, plan.chunks_a,
            plan.chunks_b, *build.stream_args(a))
    build.check(rc, "upconv_tc_f32")
    upconv_tc_f32.launches += 1
    return out


upconv_tc_f32.launches = 0


# --------------------------------------------------------------------------
# upconv_tc_q: K3q (int8 K3, requant) on the int8 tensor cores
# --------------------------------------------------------------------------


class UpqPlan(NamedTuple):
    """Launch parameters of ``csrc/upconv_tc_q.cu`` for one K3q layer at
    one shape: ``np``, ``mf``, ``nf``, ``tx_log2`` as :class:`UpPlan`'s
    (K3); the input lanes as 16-byte groups, ``ga`` of operand a with the
    ones lane (``ceil((Ca + 1) / 16)``) then ``gb`` of b, walked in
    ``chunks`` stages of ``cg`` groups (even: a k32 step takes two) per
    input plane."""

    np: int
    mf: int
    nf: int
    tx_log2: int
    cg: int
    chunks: int
    ga: int
    gb: int

    @property
    def geometry(self) -> UpPlan:
        """The K3 :class:`UpPlan` of the same tiles: its grid
        (:func:`uptc_blocks`), planes and slots (:func:`slot_table`) are
        this kernel's."""
        return UpPlan(True, self.np, self.mf, self.nf, self.tx_log2, 16, 1,
                      0)

    @property
    def tile(self):
        return self.geometry.tile

    def n_tiles(self, co: int) -> int:
        return -(-co // (8 * self.nf))


def uptcq_groups(ca: int, cb: int, np_: int, nf: int):
    """``(cg, chunks, ga, gb)``: the fewest padded groups (``chunks *
    cg``), then the widest even chunk whose stage (slab of ``16 * (cg + 1)``
    bytes a voxel, ``4 * np_`` weight slots) fits ``UT_STAGE_BYTES`` at the
    largest slab of ``UT_TILES``."""
    ga, gb = -(-(ca + 1) // 16), -(-cb // 16)
    gt = ga + gb
    slab = max((64 * mf // (1 << t) + 2) * ((1 << t) + 2)
               for mf, t in UT_TILES)
    best = None
    for cg in range(2, gt + gt % 2 + 1, 2):
        stage = slab * 16 * (cg + 1) + 4 * np_ * cg * 8 * nf * 16
        if cg > 2 and stage > UT_STAGE_BYTES:
            continue
        chunks = -(-gt // cg)
        key = (chunks * cg, -cg)
        if best is None or key < best[0]:
            best = (key, cg, chunks)
    return best[1], best[2], ga, gb


def uptcq_plan(shape2, ca: int, cb: int, co: int) -> UpqPlan:
    """The tile plan of K3q from half-resolution operands of ``ca`` (and
    ``cb``) int8 channels over ``shape2`` to ``co`` channels: the tiles
    :func:`uptc_plan` picks for K3 (its estimate counts bytes of shared
    memory per k step, the same in int8), the groups by
    :func:`uptcq_groups`."""
    bf = uptc_plan(shape2, ca, cb, co, True)
    return UpqPlan(bf.np, bf.mf, bf.nf, bf.tx_log2,
                   *uptcq_groups(ca, cb, bf.np, bf.nf))


def pack_weights_q(wa: torch.Tensor, wb: Optional[torch.Tensor],
                   wone: torch.Tensor, plan: UpqPlan) -> torch.Tensor:
    """K3q's int8 weights -> the kernel's operand ``(n_pg, n_tiles, n_dz,
    chunks, slots, cg, 8 * nf, 16)``: the composite's rows as the kernel's
    lanes, ``[wa | wone]`` padded to ``16 * ga`` then ``wb`` padded to ``16
    * gb``, per (parity, tap) ``R[3 - p - 2t]``, laid out per parity group,
    N tile, input plane and chunk as the stage's slots of
    :func:`slot_table`, each ``[group][n][16 bytes]``; zeros pad the lanes,
    ``Co`` and the slots a plane does not use."""
    co = wa.shape[-1]
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    geo = plan.geometry
    wa1 = torch.cat([wa, wone[..., None, :]], 3)
    parts = [F.pad(_tap_weights(wa1, True),
                   (0, 0, 0, 16 * plan.ga - wa1.shape[3]))]
    if plan.gb:
        parts.append(F.pad(_tap_weights(wb, True),
                           (0, 0, 0, 16 * plan.gb - wb.shape[3])))
    wt = torch.cat(parts, 1)
    wt = F.pad(wt, (0, nt * bn - co,
                    0, 16 * plan.chunks * plan.cg - wt.shape[1]))
    wz = torch.cat([wt, wt.new_zeros((1,) + wt.shape[1:])])
    idx = torch.full((geo.n_pg, geo.n_dz, geo.slots), wt.shape[0])
    for pg in range(geo.n_pg):
        for dzi, row in enumerate(slot_table(geo, pg)):
            for s, (_, _, p, t) in enumerate(row):
                idx[pg, dzi, s] = p * 8 + t
    g = wz[idx].reshape(geo.n_pg, geo.n_dz, geo.slots, plan.chunks, plan.cg,
                        16, nt, bn)
    return g.permute(0, 6, 1, 3, 2, 4, 7, 5).contiguous()


def uptcq_packed(wa: torch.Tensor, wb: Optional[torch.Tensor],
                 wone: torch.Tensor, plan: UpqPlan) -> torch.Tensor:
    """:func:`pack_weights_q`, once per weight tensor (:func:`_kept`)."""
    return _kept("_uptcq_packed", (plan.np, plan.nf, plan.cg, plan.chunks),
                 wa, wb, wone, lambda: pack_weights_q(wa, wb, wone, plan))


@build.traced
def upconv_tc_q(a: torch.Tensor, b: Optional[torch.Tensor],
                wa: torch.Tensor, wb: Optional[torch.Tensor],
                wone: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                zp: bool = True) -> torch.Tensor:
    """K3q's function (:func:`~.upconv.upconv_q_requant`, same arguments)
    on the int8 tensor cores.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/upconv_tc_q.cu``
    kernel on the current stream with :func:`uptcq_plan`'s tiles and
    :func:`uptcq_packed` weights, or an error.
    """
    from .upconv import upconv_q_checks, upconv_q_requant_plain

    if a.device.type == "cpu":
        return upconv_q_requant_plain(a, b, wa, wb, wone, scale, bias, zp)
    d2, h2, w2, ca, cb, co = upconv_q_checks(a, b, wa, wb, wone, scale,
                                             bias, "upconv_tc_q")
    if a.data_ptr() % 16 or (b is not None and b.data_ptr() % 16):
        raise ValueError("upconv_tc_q: a and b must start on a 16-byte "
                         "boundary")
    out = torch.empty((2 * d2, 2 * h2, 2 * w2, co), dtype=torch.int8,
                      device=a.device)
    if out.numel() == 0:
        return out
    plan = uptcq_plan((d2, h2, w2), ca, cb, co)
    wp = uptcq_packed(wa, wb, wone, plan)
    fn = build.function("upconv_tc_q", "ctunet_upconv_tc_q",
                        [_P] * 6 + [_I] * 14 + [_P])
    rc = fn(a.data_ptr(), None if b is None else b.data_ptr(), wp.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), d2, h2, w2,
            ca, cb, co, int(bool(zp)), plan.np, plan.mf, plan.nf,
            plan.tx_log2, plan.cg, plan.chunks, *build.stream_args(a))
    build.check(rc, "upconv_tc_q")
    upconv_tc_q.launches += 1
    return out


upconv_tc_q.launches = 0
