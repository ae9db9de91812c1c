"""K1 (Conv3D k3 + folded BN + ReLU) and K2 (2x2x2 max pool) for Hopper,
with their int8 modes K1q (requantizing int8 conv) and K2q (int8 pool), K6
(Conv3D k3 + bias + optional ReLU in bf16 or f32, the training conv) and
K5 (the same at k5, the legacy family's conv, served and trained).

Counterpart of ``ctunet_tpu/ops/pallas/conv3d.py``: ``conv3d_chain_split``
(bf16 and ``scale=``/``zp=`` int8 modes), ``conv3d_chain_q`` (the full-tap
int8 form, K4a), ``maxpool2_chain``, ``conv3d_chain`` (K6: forward and
input gradient of the training conv, ``ops/chain_conv_train.py``, and the
``sparse`` serving route) and ``conv3d_fused`` at k=5 (K5). The TPU chain
and W-packed layouts (W packed into lanes, halo rows, ones-channel) are
not carried over: every function takes and returns dense channels-last
volumes.

In bf16, K1, K6 and K5 are one kernel, :func:`conv3d_tc`
(``csrc/conv3d_tc.cu``): an implicit GEMM on the tensor cores whose tiles
:func:`tc_plan` chooses per layer and shape and whose weights
:func:`pack_tc_weights` lays out once per weight tensor. In f32 they are
another, :func:`conv3d_tc_f32` (``csrc/conv3d_tc_f32.cu``): the same
implicit GEMM on split tf32 operands (3xTF32 with the weights split
exactly: four tf32 products per f32 product, f32-accurate), plan
:func:`tcf_plan`, weights :func:`pack_tcf_weights` (three tf32 planes),
reached through :func:`conv3d_f32` (K1, K6) and :func:`conv3d5_f32`
(K5). The CUDA-core
kernels they replaced (``csrc/conv3d.cu``, ``csrc/conv3d_k5.cu``) are
kept, bf16 and f32, as ``*_direct`` functions for timing. K2 (bf16, and
f32 as :func:`maxpool2_f32`) and K2q run one row-streaming kernel,
:func:`maxpool2_rows` (``csrc/maxpool_rows.cu``, plan :func:`pool_plan`);
the kernel they launched before (``csrc/maxpool.cu``) stays reachable as
:func:`maxpool2_direct`, :func:`maxpool2_f32_direct` and
:func:`maxpool2_q_direct`. K1q runs
the int8 tensor-core kernel :func:`conv3d_tc_q` (``csrc/conv3d_tc_q.cu``,
plan :func:`tcq_plan`, weights :func:`pack_tcq_weights`); the CUDA-core
kernel ``csrc/conv3d_q.cu`` it launched before stays reachable as
:func:`conv3d_q_requant_direct`.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
its plain PyTorch version only for a tensor on the CPU. ``<wrapper>.launches``
counts kernel launches, so a run can show that its path went through the
kernels; a bf16 K1/K6/K5 call counts on its wrapper and on ``conv3d_tc``,
an f32 K1/K6 call on its wrapper, on ``conv3d_f32`` and on
``conv3d_tc_f32``, an f32 K5 call on its wrapper, on ``conv3d5_f32`` and on
``conv3d_tc_f32``, a K2 call on its wrapper and on ``maxpool2_rows`` (f32
on ``maxpool2_f32`` too), a K2q call on ``maxpool2_q`` and on
``maxpool2_rows``, a K1q call on its wrapper and on ``conv3d_tc_q``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def fold_bn(bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into a per-channel (scale, bias), in f32
    (``conv3d.py:97-103``)."""
    inv = bn_scale.float() / torch.sqrt(bn_var.float() + eps)
    return inv, bn_bias.float() - bn_mean.float() * inv


def fold_conv_unit(conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var,
                   dtype=torch.bfloat16):
    """Conv3d(k3 or k5) + BatchNorm3d weights -> the kernel's operands.

    ``conv_w`` is torch ``(O, I, k, k, k)``. Returns ``(w, bias)`` with
    ``w = conv_w * scale`` folded in f32 and then cast to ``dtype``, laid
    out tap-major ``(k, k, k, I, O)``, and ``bias`` f32 ``(O,)``:
    ``conv_b * scale + bn_shift`` — the rounding of the JAX engine
    (``engine.py:77-86``, ``conv3d.py:71-72,223,815-816,1124``: bf16
    weights, f32 bias added to the f32 accumulator).
    """
    inv, bn_bias = fold_bn(bn_w, bn_b, bn_mean, bn_var)
    w = conv_w.float().permute(2, 3, 4, 1, 0) * inv
    cb = (torch.zeros_like(inv) if conv_b is None else conv_b.float())
    return w.to(dtype).contiguous(), (cb * inv + bn_bias).contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on cpu or cuda, "
                         f"got {x.device}")


# --------------------------------------------------------------------------
# conv3d_tc: bf16 Conv3D(k3 or k5, SAME) + bias + optional ReLU on the
# tensor cores, the kernel of K1, K6 and K5 in bf16
# --------------------------------------------------------------------------

# SMs of an H100 SXM: the plan wants at least two blocks on each
TC_SMS = 132
# shared memory one block may hold on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
# output tiles of 64 * mf voxels of one z plane, as (mf, log2 TX): 16x16,
# 32x8, 8x16 and 16x8 (TY x TX)
TC_TILES = ((4, 4), (4, 3), (2, 4), (2, 3))
# bytes of one pipeline stage (slab + weights), a block holding two: small
# stages keep several blocks on an SM, which the k=5 layers need more than
# wide channel chunks (a plan sweep on the H100 chose it)
TC_STAGE_BYTES = 26 * 1024


class TcPlan(NamedTuple):
    """Launch parameters of ``csrc/conv3d_tc.cu`` for one layer at one
    shape: kernel size ``k``; ``mf`` m16 fragments per warp (4 warps, so
    64 * mf voxels a tile, ``1 << tx_log2`` of them along W); ``nf`` n8
    tiles per block (``8 * nf`` output channels); ``cc`` input channels per
    pipeline stage, ``chunks`` stages per input plane."""

    k: int
    mf: int
    nf: int
    tx_log2: int
    cc: int
    chunks: int

    @property
    def tile(self):
        """(TY, TX): the output tile of one block in one z plane."""
        tx = 1 << self.tx_log2
        return 64 * self.mf // tx, tx

    def n_tiles(self, co: int) -> int:
        return -(-co // (8 * self.nf))

    def groups(self) -> int:
        """k-groups of 8 input channels per stage, rounded up to even (one
        k16 product takes two)."""
        return (self.k * self.k * self.cc // 8 + 1) // 2 * 2


def _tc_stage_bytes(k: int, cc: int, nf: int, slab_voxels: int) -> int:
    cs = cc if (cc // 8) % 2 else cc + 8  # odd 16-byte words per voxel
    groups = (k * k * cc // 8 + 1) // 2 * 2
    return 2 * slab_voxels * cs + 16 * groups * 8 * nf


def tc_channels(ci: int, k: int, nf: int):
    """``(cc, chunks)``: the input-channel chunk of one stage and the
    chunks per plane. The fewest padded channels (``cc * chunks >= ci``),
    then the widest chunk, whose stage fits ``TC_STAGE_BYTES`` at the
    largest halo slab of ``TC_TILES``; depends on the layer alone, so one
    weight packing serves every shape."""
    slab = max((64 * mf // (1 << t) + k - 1) * ((1 << t) + k - 1)
               for mf, t in TC_TILES)
    best = None
    for cc in range(8, -(-ci // 8) * 8 + 1, 8):
        if cc > 8 and _tc_stage_bytes(k, cc, nf, slab) > TC_STAGE_BYTES:
            continue
        chunks = -(-ci // cc)
        key = (chunks * cc, -cc)
        if best is None or key < best[0]:
            best = (key, cc, chunks)
    return best[1], best[2]


def tc_plan(shape, ci: int, co: int, k: int) -> TcPlan:
    """The tile plan of a ``k`` conv ``ci -> co`` over a ``(D, H, W)``
    volume. ``nf`` covers ``co`` in one N tile up to 32 channels (wider
    layers take several, one block each). The M tile is the one of
    ``TC_TILES`` with the least estimated time: the voxels computed
    (ragged extents round up to whole tiles) times the shared-memory bytes
    per product (``512 / nf`` of A, ``128 / mf`` of B), stretched when the
    grid has fewer than two blocks per SM."""
    d, h, w = shape
    nf = 1 if co <= 8 else 2 if co <= 16 else 4
    n_tiles = -(-co // (8 * nf))
    cc, chunks = tc_channels(ci, k, nf)
    best = None
    for mf, tx_log2 in TC_TILES:
        tx = 1 << tx_log2
        ty = 64 * mf // tx
        nty, ntx = -(-h // ty), -(-w // tx)
        blocks = d * nty * ntx * n_tiles
        work = d * nty * ty * ntx * tx * n_tiles
        cost = work * (512 / nf + 128 / mf) * max(1.0, 2 * TC_SMS / blocks)
        if best is None or cost < best[0]:
            best = (cost, mf, tx_log2)
    return TcPlan(k, best[1], nf, best[2], cc, chunks)


def tc_blocks(shape, co: int, plan: TcPlan):
    """The blocks of the kernel's grid, with its index arithmetic: each is
    ``(z, y0, x0, n0, vy, vx, ncol)``, the output rows ``y0..y0+vy``,
    columns ``x0..x0+vx`` and channels ``n0..n0+ncol`` of plane ``z`` that
    it writes."""
    d, h, w = shape
    ty, tx = plan.tile
    bn, n_tiles = 8 * plan.nf, plan.n_tiles(co)
    tiles_x, tiles_y = -(-w // tx), -(-h // ty)
    for z in range(d):  # blockIdx.y
        for b in range(tiles_y * tiles_x * n_tiles):  # blockIdx.x
            tile, nt = divmod(b, n_tiles)
            ty_i, tx_i = divmod(tile, tiles_x)
            y0, x0, n0 = ty_i * ty, tx_i * tx, nt * bn
            yield (z, y0, x0, n0, min(ty, h - y0), min(tx, w - x0),
                   min(bn, co - n0))


def pack_tc_weights(w: torch.Tensor, plan: TcPlan) -> torch.Tensor:
    """``(k, k, k, Ci, Co)`` weights -> the kernel's B operand
    ``(n_tiles, k, chunks, groups, 8 * nf, 8)``: per N tile, input plane dz
    and channel chunk, one stage's k-groups (group ``(dy * k + dx) *
    cc / 8 + c8`` holds input channels ``chunk * cc + 8 * c8 + j``), each
    ``[n][j]``; zeros pad Ci, Co and an odd group count."""
    k, ci, co = w.shape[0], w.shape[3], w.shape[4]
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    c8 = plan.cc // 8
    wz = w.new_zeros((k, k, k, plan.cc * plan.chunks, bn * nt))
    wz[..., :ci, :co] = w
    t = wz.reshape(k, k * k, plan.chunks, c8, 8, nt, bn)
    t = t.permute(5, 0, 2, 1, 3, 6, 4).reshape(nt, k, plan.chunks,
                                               k * k * c8, bn, 8)
    return F.pad(t, (0, 0, 0, 0, 0, plan.groups() - k * k * c8)).contiguous()


def tc_packed(w: torch.Tensor, plan: TcPlan) -> torch.Tensor:
    """:func:`pack_tc_weights`, once per weight tensor: the packing is kept
    on ``w`` and made again only when ``w`` was written in place since (its
    version counter) or another packing is asked for."""
    key = (plan.cc, plan.chunks, plan.nf,
           None if w.is_inference() else w._version)
    hit = getattr(w, "_tc_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_tc_weights(w, plan))
        w._tc_packed = hit
    return hit[1]


def conv3d_tc_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of every conv of this module: ``F.conv3d``
    with SAME padding (``k // 2``) in f32 on the (already rounded) inputs,
    + bias, ReLU when ``relu``, cast back to ``x.dtype`` once.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(k, k, k, Ci, Co)``, k odd;
        ``bias``: ``(Co,)`` f32.
    """
    xf = x.float().permute(3, 0, 1, 2)[None]
    wf = w.float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=w.shape[0] // 2)[0].permute(1, 2, 3, 0)
    y = y + bias.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def _conv_checks(x, w, bias, k: int, what: str):
    """Check a conv's operands (``w`` of ``x``'s dtype, ``(k, k, k, Ci,
    Co)``) and return ``(D, H, W, Ci, Co)``."""
    _require_cuda(x, what)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    _check(x, "x", x.dtype)
    _check(w, "w", x.dtype, (k, k, k, ci, co), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    return d, h, wd, ci, co


@build.traced
def conv3d_tc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool = True) -> torch.Tensor:
    """The tensor-core conv on bf16 ``x`` ``(D, H, W, Ci)`` with bf16 ``w``
    ``(k, k, k, Ci, Co)``, k 3 or 5, and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv(x, w) + bias)`` accumulated in f32 and
    rounded once, ``act`` the ReLU when ``relu``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d_tc.cu``
    kernel on the current stream with :func:`tc_plan`'s tiles and
    :func:`tc_packed` weights, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_tc_plain(x, w, bias, relu)
    k = w.shape[0] if w.dim() == 5 else 0
    if k not in (3, 5):
        raise ValueError(f"conv3d_tc: k = 3 or 5, got w {tuple(w.shape)}")
    d, h, wd, ci, co = _conv_checks(x, w, bias, k, "conv3d_tc")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_tc: bfloat16 only, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("conv3d_tc: x must start on a 16-byte boundary")
    if d * h * wd * co == 0:
        return torch.empty((d, h, wd, co), dtype=torch.bfloat16,
                           device=x.device)
    plan = tc_plan((d, h, wd), ci, co, k)
    out = launch_tc(x, tc_packed(w, plan), bias, relu, plan)
    conv3d_tc.launches += 1
    return out


conv3d_tc.launches = 0


def launch_tc(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
              relu: bool, plan: TcPlan) -> torch.Tensor:
    """One launch of ``csrc/conv3d_tc.cu`` on checked operands with the
    weights ``wp`` packed for ``plan`` (:func:`conv3d_tc` picks both)."""
    d, h, wd, ci = x.shape
    co = bias.shape[0]
    out = torch.empty((d, h, wd, co), dtype=torch.bfloat16, device=x.device)
    fn = build.function("conv3d_tc", "ctunet_conv3d_tc",
                        [_P] * 4 + [_I] * 13 + [_P])
    rc = fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, plan.k, int(bool(relu)), plan.mf, plan.nf,
            plan.tx_log2, plan.cc, plan.chunks, *build.stream_args(x))
    build.check(rc, "conv3d_tc")
    return out


# --------------------------------------------------------------------------
# conv3d_tc_f32: f32 Conv3D(k3 or k5, SAME) + bias + optional ReLU on the
# tensor cores in split tf32 products, the kernel of K1, K6 and K5 in f32
# --------------------------------------------------------------------------

# bytes of one pipeline stage (slab + the three weight planes), a block
# holding two; f32 and the planes make conv3d_tc's stage up to 6x larger
# at the same channel chunk, so TC_STAGE_BYTES does not carry over. A
# plan sweep on the H100 (24-64 KB at every f32 conv shape of the paths,
# summed per path) chose 32 KB.
TCF_STAGE_BYTES = 32 * 1024
# the largest tile, in m16 x n8 fragments a warp (mf * nf): the same sweep
# found the 4 x 4 tile no faster than 2 x 4
TCF_MAX_FRAGS = 8


class TcfPlan(NamedTuple):
    """Launch parameters of ``csrc/conv3d_tc_f32.cu`` for one layer at one
    shape: kernel size ``k``; ``mf`` m16 fragments per warp (4 warps, so
    64 * mf voxels a tile, ``1 << tx_log2`` of them along W); ``nf`` n8
    tiles per block (``8 * nf`` output channels); ``cc`` input channels per
    pipeline stage (a multiple of 4), ``chunks`` stages per input
    plane."""

    k: int
    mf: int
    nf: int
    tx_log2: int
    cc: int
    chunks: int

    @property
    def tile(self):
        """(TY, TX): the output tile of one block in one z plane."""
        tx = 1 << self.tx_log2
        return 64 * self.mf // tx, tx

    def n_tiles(self, co: int) -> int:
        return -(-co // (8 * self.nf))

    def groups(self) -> int:
        """k-groups of 4 input channels per stage, rounded up to even (one
        k8 product takes two)."""
        return (self.k * self.k * self.cc // 4 + 1) // 2 * 2

    @property
    def cs(self) -> int:
        """Floats per slab voxel: an odd number of 16-byte words."""
        return self.cc if (self.cc // 4) % 2 else self.cc + 4

    def stage_bytes(self) -> int:
        """One stage: the halo slab and the three weight planes."""
        ty, tx = self.tile
        slab = (ty + self.k - 1) * (tx + self.k - 1) * self.cs * 4
        return slab + 3 * self.groups() * 8 * self.nf * 16

    def smem(self) -> int:
        """Shared memory of one block: the tap table, then the two-stage
        ring (which the f32 output tile reuses)."""
        tab = (self.groups() * 4 + 15) // 16 * 16
        return tab + max(2 * self.stage_bytes(), 64 * self.mf * 8 * self.nf
                         * 4)


def tcf_tiles(nf: int):
    """The ``(mf, tx_log2)`` tiles of :data:`TC_TILES` whose fragment sets
    fit the registers at ``nf``."""
    return tuple(t for t in TC_TILES if t[0] * nf <= TCF_MAX_FRAGS)


def tcf_channels(ci: int, k: int, nf: int):
    """``(cc, chunks)`` of an f32 input: the fewest padded channels
    (``cc * chunks >= ci``, ``cc`` a multiple of 4), then the widest chunk
    whose stage fits ``TCF_STAGE_BYTES`` (and whose block fits the card)
    at the largest halo slab of :func:`tcf_tiles`; depends on the layer
    alone, so one weight packing serves every shape."""
    plans = [TcfPlan(k, mf, nf, t, 4, 1) for mf, t in tcf_tiles(nf)]
    best = None
    for cc in range(4, -(-ci // 4) * 4 + 1, 4):
        wide = [p._replace(cc=cc) for p in plans]
        if cc > 4 and (max(p.stage_bytes() for p in wide) > TCF_STAGE_BYTES
                       or max(p.smem() for p in wide) > SMEM_PER_BLOCK):
            continue
        chunks = -(-ci // cc)
        key = (chunks * cc, -cc)
        if best is None or key < best[0]:
            best = (key, cc, chunks)
    return best[1], best[2]


def tcf_plan(shape, ci: int, co: int, k: int) -> TcfPlan:
    """The tile plan of an f32 ``k`` conv ``ci -> co`` over a ``(D, H,
    W)`` volume. ``nf`` covers ``co`` in one N tile up to 32 channels
    (wider layers take several, one block each). The M tile is the one of
    :func:`tcf_tiles` with the least estimated time: the voxels computed
    (ragged extents round up to whole tiles) times the shared-memory bytes
    per product (``512 / nf`` of A, ``512 / mf`` of the B planes),
    stretched when the grid has fewer than two blocks per SM."""
    d, h, w = shape
    nf = 1 if co <= 8 else 2 if co <= 16 else 4
    n_tiles = -(-co // (8 * nf))
    cc, chunks = tcf_channels(ci, k, nf)
    best = None
    for mf, tx_log2 in tcf_tiles(nf):
        tx = 1 << tx_log2
        ty = 64 * mf // tx
        nty, ntx = -(-h // ty), -(-w // tx)
        blocks = d * nty * ntx * n_tiles
        work = d * nty * ty * ntx * tx * n_tiles
        cost = work * (512 / nf + 512 / mf) * max(1.0, 2 * TC_SMS / blocks)
        if best is None or cost < best[0]:
            best = (cost, mf, tx_log2)
    return TcfPlan(k, best[1], nf, best[2], cc, chunks)


# conv3d_tc_f32's grid is conv3d_tc's: one block per (z, M tile, N tile)
tcf_blocks = tc_blocks


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to tf32 (10 stored mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: ``0x1000`` (half
    the last kept bit) added to the bit pattern, the low 13 bits cleared.
    The pattern is sign and magnitude, so the carry rounds the magnitude
    up for either sign; finite inputs only."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_planes(w: torch.Tensor) -> torch.Tensor:
    """f32 ``w`` -> ``(3, *w.shape)``: the planes ``hi = tf32_rna(w)``,
    ``mid = tf32_rna(w - hi)`` and ``lo = w - hi - mid`` (exact, at most 3
    significant bits: the three sum to ``w``, each a tf32 value), the
    weights of the split-tf32 kernels' products."""
    hi = tf32_rna(w)
    mid = tf32_rna(w - hi)
    return torch.stack([hi, mid, w - hi - mid])


def pack_tcf_weights(w: torch.Tensor, plan: TcfPlan) -> torch.Tensor:
    """f32 ``(k, k, k, Ci, Co)`` weights -> the kernel's B operand
    ``(n_tiles, k, chunks, 3, groups, 8 * nf, 4)``: per N tile, input plane
    dz and channel chunk, the planes ``hi = tf32_rna(w)``, ``mid =
    tf32_rna(w - hi)`` and ``lo = w - hi - mid`` (exact, at most 3
    significant bits: the three sum to ``w``) of one stage's k-groups
    (group ``(dy * k + dx) * cc / 4 + c4`` holds input channels ``chunk *
    cc + 4 * c4 + j``), each ``[n][j]``; zeros pad Ci, Co and an odd group
    count."""
    k, ci, co = w.shape[0], w.shape[3], w.shape[4]
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    c4 = plan.cc // 4
    wz = w.new_zeros((k, k, k, plan.cc * plan.chunks, bn * nt),
                     dtype=torch.float32)
    wz[..., :ci, :co] = w
    t = split_tf32_planes(wz).reshape(3, k, k * k, plan.chunks, c4, 4, nt,
                                      bn)
    t = t.permute(6, 1, 3, 0, 2, 4, 7, 5).reshape(nt, k, plan.chunks, 3,
                                                  k * k * c4, bn, 4)
    return F.pad(t, (0, 0, 0, 0, 0, plan.groups() - k * k * c4)).contiguous()


def tcf_packed(w: torch.Tensor, plan: TcfPlan) -> torch.Tensor:
    """:func:`pack_tcf_weights`, once per weight tensor (as
    :func:`tc_packed`: made again when ``w`` was written in place since or
    another packing is asked for)."""
    key = (plan.cc, plan.chunks, plan.nf,
           None if w.is_inference() else w._version)
    hit = getattr(w, "_tcf_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_tcf_weights(w, plan))
        w._tcf_packed = hit
    return hit[1]


@build.traced
def conv3d_tc_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  relu: bool = True) -> torch.Tensor:
    """The split-tf32 tensor-core conv on f32 ``x`` ``(D, H, W, Ci)`` with f32
    ``w`` ``(k, k, k, Ci, Co)``, k 3 or 5, and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv(x, w) + bias)`` to f32 accuracy, ``act``
    the ReLU when ``relu``.

    CPU tensor: the plain version. CUDA tensor: the
    ``csrc/conv3d_tc_f32.cu`` kernel on the current stream with
    :func:`tcf_plan`'s tiles and :func:`tcf_packed` weights, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_tc_plain(x, w, bias, relu)
    k = w.shape[0] if w.dim() == 5 else 0
    if k not in (3, 5):
        raise ValueError(f"conv3d_tc_f32: k = 3 or 5, got w {tuple(w.shape)}")
    d, h, wd, ci, co = _conv_checks(x, w, bias, k, "conv3d_tc_f32")
    if x.dtype != torch.float32:
        raise TypeError(f"conv3d_tc_f32: float32 only, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("conv3d_tc_f32: x must start on a 16-byte boundary")
    if d * h * wd * co == 0:
        return torch.empty((d, h, wd, co), dtype=torch.float32,
                           device=x.device)
    plan = tcf_plan((d, h, wd), ci, co, k)
    out = launch_tcf(x, tcf_packed(w, plan), bias, relu, plan)
    conv3d_tc_f32.launches += 1
    return out


conv3d_tc_f32.launches = 0


def launch_tcf(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
               relu: bool, plan: TcfPlan) -> torch.Tensor:
    """One launch of ``csrc/conv3d_tc_f32.cu`` on checked operands with the
    weights ``wp`` packed for ``plan`` (:func:`conv3d_tc_f32` picks
    both)."""
    d, h, wd, ci = x.shape
    co = bias.shape[0]
    out = torch.empty((d, h, wd, co), dtype=torch.float32, device=x.device)
    fn = build.function("conv3d_tc_f32", "ctunet_conv3d_tc_f32",
                        [_P] * 4 + [_I] * 13 + [_P])
    rc = fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, plan.k, int(bool(relu)), plan.mf, plan.nf,
            plan.tx_log2, plan.cc, plan.chunks, *build.stream_args(x))
    build.check(rc, "conv3d_tc_f32")
    return out


def _f32_tc(x, w, bias, relu, k: int, fn):
    """An f32 conv at ``k`` on :func:`conv3d_tc_f32`, counted on ``fn``
    too."""
    if x.device.type == "cpu":
        return conv3d_tc_plain(x, w, bias, relu)
    _require_cuda(x, fn.__name__)
    if x.dtype != torch.float32:
        raise TypeError(f"{fn.__name__}: float32 only, got {x.dtype}")
    if w.dim() != 5 or w.shape[0] != k:  # conv3d_tc_f32 checks the rest
        raise ValueError(f"{fn.__name__}: w must be ({k}, {k}, {k}, Ci, "
                         f"Co), got {tuple(w.shape)}")
    out = conv3d_tc_f32(x, w, bias, relu)
    if out.numel():  # an empty volume launches nothing
        fn.launches += 1
    return out


@build.traced
def conv3d_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               relu: bool) -> torch.Tensor:
    """The f32 k=3 conv, the kernel of K1 and K6 in f32: f32 ``x``
    ``(D, H, W, Ci)``, ``w`` ``(3, 3, 3, Ci, Co)`` and ``bias`` ``(Co,)`` ->
    ``act(conv(x, w) + bias)`` to f32 accuracy, ``act`` the ReLU when
    ``relu``.

    CPU tensor: the plain version. CUDA tensor: :func:`conv3d_tc_f32`
    (``csrc/conv3d_tc_f32.cu``) on the current stream, or an error.
    """
    return _f32_tc(x, w, bias, relu, 3, conv3d_f32)


conv3d_f32.launches = 0


@build.traced
def conv3d5_f32(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                relu: bool = True) -> torch.Tensor:
    """The f32 k=5 conv, the kernel of K5 in f32 (arguments as
    :func:`conv3d_f32` with ``w`` ``(5, 5, 5, Ci, Co)``, any Ci).

    CPU tensor: the plain version. CUDA tensor: :func:`conv3d_tc_f32`
    (``csrc/conv3d_tc_f32.cu``) on the current stream, or an error.
    """
    return _f32_tc(x, w, bias, relu, 5, conv3d5_f32)


conv3d5_f32.launches = 0


# --------------------------------------------------------------------------
# The direct kernels (csrc/conv3d.cu at k3, csrc/conv3d_k5.cu at k5): one
# thread per voxel x 8 output channels on the CUDA cores, bf16 or f32. No
# path launches them: phase 2 of chip_smoke.py times them beside the
# tensor-core kernels that replaced them.
# --------------------------------------------------------------------------

# dz-plane staging holds 25*Ci*8 f32 weights in one block's shared memory
K5_MAX_CI = SMEM_PER_BLOCK // (25 * 8 * 4)


def _direct(x, w, bias, relu, k: int, what: str):
    if x.device.type == "cpu":
        return conv3d_tc_plain(x, w, bias, relu)
    d, h, wd, ci, co = _conv_checks(x, w, bias, k, what)
    if k == 5 and ci > K5_MAX_CI:
        raise ValueError(f"{what}: Ci={ci} > {K5_MAX_CI}, the widest input "
                         "whose weight plane fits a block")
    out = torch.empty((d, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib, sym = (("conv3d", "ctunet_conv3d_bias_act") if k == 3 else
                ("conv3d_k5", "ctunet_conv3d5_bias_act"))
    if x.dtype == torch.float32:
        sym += "_f32"
    fn = build.function(lib, sym, [_P] * 4 + [_I] * 7 + [_P])
    rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            d, h, wd, ci, co, int(bool(relu)), *build.stream_args(x))
    build.check(rc, what)
    return out


def conv3d_bias_act_direct(x, w, bias, relu: bool) -> torch.Tensor:
    """The direct k=3 kernel (``csrc/conv3d.cu``) on CUDA tensors, bf16 or
    f32, for timing; the plain version on CPU tensors. Counts no
    launches."""
    return _direct(x, w, bias, relu, 3, "conv3d_bias_act_direct")


def conv3d5_bias_act_direct(x, w, bias, relu: bool = True) -> torch.Tensor:
    """The direct k=5 kernel (``csrc/conv3d_k5.cu``) on CUDA tensors, bf16
    or f32 with ``Ci <= K5_MAX_CI``, for timing; the plain version on CPU
    tensors. Counts no launches."""
    return _direct(x, w, bias, relu, 5, "conv3d5_bias_act_direct")


# --------------------------------------------------------------------------
# K1: Conv3D(k3, SAME) + folded BN + ReLU
# --------------------------------------------------------------------------


def conv3d_bn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: K6's plain version with the ReLU on."""
    return conv3d_bias_act_plain(x, w, bias, True)


@build.traced
def conv3d_bn_relu(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """K1 on ``x`` ``(D, H, W, Ci)`` with folded ``w`` ``(3, 3, 3, Ci, Co)``
    and f32 ``bias`` ``(Co,)`` -> ``(D, H, W, Co)``.

    CPU tensor: the plain version. CUDA tensor: :func:`conv3d_tc` in bf16,
    :func:`conv3d_f32` (the tensor-core :func:`conv3d_tc_f32`) in f32, or an
    error.
    """
    if x.device.type == "cpu":
        return conv3d_bn_relu_plain(x, w, bias)
    _conv_checks(x, w, bias, 3, "conv3d_bn_relu")
    conv = conv3d_tc if x.dtype == torch.bfloat16 else conv3d_f32
    out = conv(x, w, bias, True)
    if out.numel():  # an empty volume launches nothing
        conv3d_bn_relu.launches += 1
    return out


conv3d_bn_relu.launches = 0


# --------------------------------------------------------------------------
# K6: Conv3D(k3, SAME) + bias + optional ReLU, bf16 or f32
# --------------------------------------------------------------------------


def conv3d_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain PyTorch K6: :func:`conv3d_tc_plain` at k=3.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(3, 3, 3, Ci, Co)``; ``bias``:
        ``(Co,)`` f32.
    """
    return conv3d_tc_plain(x, w, bias, relu)


@build.traced
def conv3d_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    relu: bool) -> torch.Tensor:
    """K6 on ``x`` ``(D, H, W, Ci)`` with ``w`` ``(3, 3, 3, Ci, Co)`` of
    ``x``'s dtype (bf16 or f32) and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv(x, w) + bias)`` accumulated in f32, ``act``
    the ReLU when ``relu`` else the identity.

    CPU tensor: the plain version. CUDA tensor: :func:`conv3d_tc` in bf16,
    :func:`conv3d_f32` (the tensor-core :func:`conv3d_tc_f32`) in f32, or an
    error.
    """
    if x.device.type == "cpu":
        return conv3d_bias_act_plain(x, w, bias, relu)
    _conv_checks(x, w, bias, 3, "conv3d_bias_act")
    conv = conv3d_tc if x.dtype == torch.bfloat16 else conv3d_f32
    out = conv(x, w, bias, relu)
    if out.numel():  # an empty volume launches nothing
        conv3d_bias_act.launches += 1
    return out


conv3d_bias_act.launches = 0


# --------------------------------------------------------------------------
# K5: Conv3D(k5, SAME) + bias + optional ReLU, bf16 or f32
# --------------------------------------------------------------------------


def conv3d5_bias_act_plain(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """Plain PyTorch K5: :func:`conv3d_tc_plain` at k=5.

    :param x: ``(D, H, W, Ci)``; ``w``: ``(5, 5, 5, Ci, Co)``; ``bias``:
        ``(Co,)`` f32.
    """
    return conv3d_tc_plain(x, w, bias, relu)


@build.traced
def conv3d5_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """K5 on ``x`` ``(D, H, W, Ci)`` with ``w`` ``(5, 5, 5, Ci, Co)`` of
    ``x``'s dtype (bf16 or f32) and f32 ``bias`` ``(Co,)`` ->
    ``(D, H, W, Co)``: ``act(conv5(x, w) + bias)`` accumulated in f32,
    ``act`` the ReLU when ``relu`` (the legacy engine's conv units, BN
    folded into ``w`` and ``bias`` by :func:`fold_conv_unit`) else the
    identity.

    CPU tensor: the plain version. CUDA tensor: :func:`conv3d_tc` in bf16,
    :func:`conv3d5_f32` (the tensor-core :func:`conv3d_tc_f32`) in f32, or an
    error.
    """
    if x.device.type == "cpu":
        return conv3d5_bias_act_plain(x, w, bias, relu)
    _conv_checks(x, w, bias, 5, "conv3d5_bias_act")
    conv = conv3d_tc if x.dtype == torch.bfloat16 else conv3d5_f32
    out = conv(x, w, bias, relu)
    if out.numel():  # an empty volume launches nothing
        conv3d5_bias_act.launches += 1
    return out


conv3d5_bias_act.launches = 0


# --------------------------------------------------------------------------
# K2: MaxPool 2x2x2, stride 2 (bf16, f32; K2q, int8, below): the
# row-streaming kernel csrc/maxpool_rows.cu
# --------------------------------------------------------------------------

# threads of a block of csrc/maxpool_rows.cu, the blocks an SM holds at
# most, and the deepest ring of input-row stages a block keeps (a probe on
# the H100 of ring depths 1-6 and 1-4 blocks an SM at the paths' bf16, f32
# and int8 levels found nothing clearly faster; chip_smoke.py's phase 2
# times every plan within these limits)
POOL_THREADS = 256
POOL_BLOCKS_PER_SM = 3
POOL_MAX_STAGES = 3
# shared memory of one H100 SM (228 KB), and what each resident block costs
# of it beside its own
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024


class PoolPlan(NamedTuple):
    """Launch parameters of ``csrc/maxpool_rows.cu`` for one volume:
    ``stages`` output rows' inputs a block keeps in flight (a ring of 1-3
    stages of four input rows each), or 0 for the scalar path; ``row_cap``
    bytes of one input row's slot in a stage; ``out_vec`` bytes per output
    store; ``grid`` blocks of ``POOL_THREADS``, block ``b`` taking output
    rows ``b, b + grid, ...``; ``smem`` bytes of dynamic shared memory a
    block."""

    stages: int
    row_cap: int
    out_vec: int
    grid: int
    smem: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def pool_plans(d: int, h: int, w: int, c: int, itemsize: int,
               aligned: bool = True) -> list:
    """Every launch of the row-streaming pool of a ``(d, h, w, c)`` volume
    of ``itemsize``-byte values that fits the H100, its input and output
    starting on 16-byte boundaries when ``aligned``: for each ring depth a
    block's shared memory holds, deepest first, each count of resident
    blocks an SM holds with it (at most ``POOL_BLOCKS_PER_SM``), most first.

    The vector path (TMA copies into a ring of 1 to ``POOL_MAX_STAGES``
    stages) needs an input row of ``w * c * itemsize`` bytes that is a
    multiple of 16 and aligned tensors; otherwise the scalar path
    (``stages`` 0). The grid is never more blocks than output rows; each
    output row leaves in the widest store (16 bytes at most) that divides
    it. Raises ``ValueError`` for an empty output or a row too long for one
    block.
    """
    rows = (d // 2) * (h // 2)
    row, out = w * c * itemsize, (w // 2) * c * itemsize
    if rows <= 0 or out <= 0:
        raise ValueError(f"pool_plan: ({d}, {h}, {w}, {c}) pools to nothing")
    row_cap, out_cap = _round16(row), _round16(out)
    out_vec = 16
    while out % out_vec or (not aligned and out_vec > itemsize):
        out_vec //= 2
    vec = aligned and row % 16 == 0
    plans = []
    for stages in range(POOL_MAX_STAGES, 0, -1) if vec else (0,):
        smem = max(stages, 1) * 4 * row_cap + out_cap
        if smem > SMEM_PER_BLOCK:
            continue
        per_sm = min(POOL_BLOCKS_PER_SM,
                     SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED))
        grids = {min(rows, TC_SMS * n) for n in range(1, per_sm + 1)}
        plans += [PoolPlan(stages, row_cap, out_vec, g, smem)
                  for g in sorted(grids, reverse=True)]
    if not plans:
        raise ValueError(f"pool_plan: an input row of {row} bytes does not "
                         "fit one block's shared memory four times")
    return plans


def pool_plan(d: int, h: int, w: int, c: int, itemsize: int,
              aligned: bool = True) -> PoolPlan:
    """The plan :func:`maxpool2_rows` launches, the first of
    :func:`pool_plans`: the deepest ring with the most blocks it leaves room
    for. A deep ring keeps the most bytes in flight per SM; phase 2 of
    ``chip_smoke.py`` times it against the others at every path shape."""
    return pool_plans(d, h, w, c, itemsize, aligned)[0]


def maxpool2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: ``F.max_pool3d(kernel 2, stride 2)`` on
    ``(D, H, W, C)`` (odd extents floor)."""
    y = F.max_pool3d(x.permute(3, 0, 1, 2)[None], 2)
    return y[0].permute(1, 2, 3, 0).contiguous()


_POOL_ROWS = {torch.bfloat16: "ctunet_maxpool2_rows",
              torch.float32: "ctunet_maxpool2_rows_f32",
              torch.int8: "ctunet_maxpool2_rows_q"}


@build.traced
def maxpool2_rows(x: torch.Tensor, plan: PoolPlan = None) -> torch.Tensor:
    """The row-streaming max pool, the kernel of K2 (bf16, f32) and K2q
    (int8): ``(D, H, W, C)`` -> ``(D//2, H//2, W//2, C)``, the max of each
    2x2x2 window (odd extents floor, NaN kept).

    CPU tensor: the plain version. CUDA tensor: ``csrc/maxpool_rows.cu``
    on the current stream with ``plan`` (by default :func:`pool_plan`'s;
    ``chip_smoke.py`` times the others of :func:`pool_plans`), or an
    error.
    """
    if x.device.type == "cpu":
        return (maxpool2_q_plain(x) if x.dtype == torch.int8
                else maxpool2_plain(x))
    _require_cuda(x, "maxpool2_rows")
    if x.dtype not in _POOL_ROWS:
        raise TypeError(f"maxpool2_rows: bfloat16, float32 or int8, got "
                        f"{x.dtype}")
    _check(x, "x", x.dtype)
    d, h, w, c = x.shape
    out = torch.empty((d // 2, h // 2, w // 2, c), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = pool_plan(d, h, w, c, x.element_size(),
                         aligned=x.data_ptr() % 16 == 0
                         and out.data_ptr() % 16 == 0)
    fn = build.function("maxpool_rows", _POOL_ROWS[x.dtype],
                        [_P, _P] + [_I] * 10 + [_P])
    rc = fn(x.data_ptr(), out.data_ptr(), d, h, w, c, plan.stages,
            plan.grid, plan.row_cap, plan.out_vec, plan.smem,
            *build.stream_args(x))
    build.check(rc, "maxpool2_rows")
    maxpool2_rows.launches += 1
    return out


maxpool2_rows.launches = 0


@build.traced
def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """K2 on bf16 or f32 ``(D, H, W, C)`` -> ``(D//2, H//2, W//2, C)``.

    CPU tensor: the plain version. CUDA tensor: :func:`maxpool2_rows`
    (``csrc/maxpool_rows.cu``) on the current stream (f32: through
    :func:`maxpool2_f32`), or an error.
    """
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    if x.dtype == torch.float32:
        out = maxpool2_f32(x)
    elif x.dtype == torch.bfloat16:
        out = maxpool2_rows(x)
    else:
        raise TypeError(f"maxpool2: bfloat16 or float32, got {x.dtype}")
    if out.numel():  # an empty volume launches nothing
        maxpool2.launches += 1
    return out


maxpool2.launches = 0


@build.traced
def maxpool2_f32(x: torch.Tensor) -> torch.Tensor:
    """K2's f32 kernel on ``(D, H, W, C)``: :func:`maxpool2_rows` in f32.

    CPU tensor: the plain version. CUDA tensor: the kernel on the current
    stream, or an error.
    """
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"maxpool2_f32: float32, got {x.dtype}")
    out = maxpool2_rows(x)
    if out.numel():
        maxpool2_f32.launches += 1
    return out


maxpool2_f32.launches = 0


# The kernel K2 and K2q launched before maxpool2_rows (csrc/maxpool.cu: one
# thread per output element). No path launches it: phase 2 of chip_smoke.py
# times it beside the row-streaming kernel.


def _launch_pool(x: torch.Tensor, dtype, symbol: str,
                 what: str) -> torch.Tensor:
    """One launch of ``csrc/maxpool.cu``'s ``symbol`` on a ``dtype`` volume
    (none for an empty output)."""
    _require_cuda(x, what)
    d, h, w, c = x.shape
    _check(x, "x", dtype)
    out = torch.empty((d // 2, h // 2, w // 2, c), dtype=dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("maxpool", symbol, [_P, _P, _I, _I, _I, _I, _I, _P])
    rc = fn(x.data_ptr(), out.data_ptr(), d, h, w, c, *build.stream_args(x))
    build.check(rc, what)
    return out


def maxpool2_direct(x: torch.Tensor) -> torch.Tensor:
    """The direct pool (``csrc/maxpool.cu``) on a bf16 CUDA tensor, for
    timing; the plain version on a CPU tensor. Counts no launches."""
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    return _launch_pool(x, torch.bfloat16, "ctunet_maxpool2",
                        "maxpool2_direct")


def maxpool2_f32_direct(x: torch.Tensor) -> torch.Tensor:
    """The direct pool in f32 (16-byte loads where ``C % 4 == 0``), as
    :func:`maxpool2_direct`."""
    if x.device.type == "cpu":
        return maxpool2_plain(x)
    return _launch_pool(x, torch.float32, "ctunet_maxpool2_f32",
                        "maxpool2_f32_direct")


# --------------------------------------------------------------------------
# K1q: int8 Conv3D(k3, SAME) + requant epilogue
# --------------------------------------------------------------------------


def fma_requant(acc: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """``f32(acc) * scale + bias`` rounded once to f32, as the Pallas int8
    epilogues compute it (XLA fuses their multiply-add) and the int8
    kernels do (``__fmaf_rn``). f64 holds the product of two f32 values
    exactly; only the sum may round before the cast to f32, which can then
    differ from one rounding only when the f64 sum lands exactly on an f32
    midpoint."""
    return (acc.float().double() * scale.double() + bias.double()).float()


def conv3d_q_requant_plain(x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           zp: bool = True) -> torch.Tensor:
    """Plain PyTorch K1q: the int32 accumulator exactly (``F.conv3d`` in
    f64 on the int8 values, padded with the layout's fill: -128 in ``zp``
    mode, 0 otherwise; f32 is not exact past 2^24), then the epilogue of
    ``conv3d.py:1001-1013`` / ``:1597-1612`` (:func:`fma_requant`).

    :param x: int8 ``(D, H, W, Ci)``; ``w``: int8 ``(3, 3, 3, Ci, Co)``;
        ``scale``/``bias``: f32 ``(Co,)``.
    :returns: int8 ``(D, H, W, Co)``.
    """
    xf = F.pad(x.double().permute(3, 0, 1, 2)[None], (1,) * 6,
               value=-128.0 if zp else 0.0)
    acc = F.conv3d(xf, w.double().permute(4, 3, 0, 1, 2))[0]
    res = torch.clamp_min(fma_requant(acc.permute(1, 2, 3, 0), scale, bias),
                          0.0)
    res = (torch.clamp_max(res, 255.0) - 128.0 if zp
           else torch.clamp_max(res, 127.0))
    return torch.round(res).to(torch.int8)


def _q_checks(x, w, scale, bias, what: str):
    """Check K1q's operands and return ``(D, H, W, Ci, Co)``."""
    _require_cuda(x, what)
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    _check(x, "x", torch.int8)
    _check(w, "w", torch.int8, (3, 3, 3, ci, co), x.device)
    _check(scale, "scale", torch.float32, (co,), x.device)
    _check(bias, "bias", torch.float32, (co,), x.device)
    return d, h, wd, ci, co


@build.traced
def conv3d_q_requant(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, zp: bool = True) -> torch.Tensor:
    """K1q on int8 ``x`` ``(D, H, W, Ci)`` with int8 ``w``
    ``(3, 3, 3, Ci, Co)`` and f32 requant ``scale``/``bias`` ``(Co,)`` ->
    int8 ``(D, H, W, Co)``: ``round(min(relu(fma(acc, scale, bias)), 255)
    - 128)`` in ``zp`` mode (out-of-volume taps read -128), else
    ``round(min(relu(.), 127))`` (they read 0).

    CPU tensor: the plain version. CUDA tensor: the int8 tensor-core
    kernel :func:`conv3d_tc_q` (``csrc/conv3d_tc_q.cu``) on the current
    stream, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_q_requant_plain(x, w, scale, bias, zp)
    _q_checks(x, w, scale, bias, "conv3d_q_requant")
    out = conv3d_tc_q(x, w, scale, bias, zp)
    if out.numel():  # an empty volume launches nothing
        conv3d_q_requant.launches += 1
    return out


conv3d_q_requant.launches = 0


def conv3d_q_requant_direct(x: torch.Tensor, w: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            zp: bool = True) -> torch.Tensor:
    """K1q on the CUDA cores (``csrc/conv3d_q.cu``), the kernel
    :func:`conv3d_q_requant` launched before ``conv3d_tc_q``: kept for
    timing beside it (``chip_smoke.py`` phase 2); the plain version on CPU
    tensors. Counts no launches."""
    if x.device.type == "cpu":
        return conv3d_q_requant_plain(x, w, scale, bias, zp)
    d, h, wd, ci, co = _q_checks(x, w, scale, bias, "conv3d_q_requant_direct")
    out = torch.empty((d, h, wd, co), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("conv3d_q", "ctunet_conv3d_q_requant",
                        [_P] * 5 + [_I] * 7 + [_P])
    rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d, h, wd, ci, co, int(zp), *build.stream_args(x))
    build.check(rc, "conv3d_q_requant_direct")
    return out


# --------------------------------------------------------------------------
# conv3d_tc_q: int8 Conv3D(k3, SAME) + requant on the int8 tensor cores,
# the kernel of K1q (and K4a)
# --------------------------------------------------------------------------


# z-march (a block over several output planes, one slab load a plane):
# the most shared memory its resident weights, three slabs and the output
# tile may take, and the most planes a block takes
TCQ_ZM_BYTES = 48 * 1024
TCQ_ZB_MAX = 8


class TcqPlan(NamedTuple):
    """Launch parameters of ``csrc/conv3d_tc_q.cu`` for one layer at one
    shape: ``mf`` m16 fragments per warp (4 warps: ``64 * mf`` voxels a
    tile, ``1 << tx_log2`` of them along W); ``nf`` n8 tiles per block;
    ``u`` the bytes a voxel takes in a 16-byte k-group (4 or 8: ``16 //
    u`` neighbours along x share a group, for Ci <= u; 16: a group holds 16
    channels of one voxel); ``cc`` input channels per stage (``u``, or a
    multiple of 16), ``chunks`` stages per input plane; ``zb`` output
    planes a block marches over (one chunk only), 0 for one plane through
    the two-stage ring."""

    mf: int
    nf: int
    tx_log2: int
    u: int
    cc: int
    chunks: int
    zb: int = 0

    @property
    def tile(self):
        """(TY, TX): the output tile of one block in one z plane."""
        tx = 1 << self.tx_log2
        return 64 * self.mf // tx, tx

    def n_tiles(self, co: int) -> int:
        return -(-co // (8 * self.nf))

    @property
    def g(self) -> int:
        """Voxels along x in one slab slot (one k-group)."""
        return 16 // self.u

    @property
    def nx(self) -> int:
        """k-groups along x per (dz, dy): taps dx = xg * g .. + g - 1."""
        return -(-3 // self.g)

    @property
    def c16s(self) -> int:
        """16-byte channel groups of one slot."""
        return self.cc // 16 if self.u == 16 else 1

    @property
    def cs(self) -> int:
        """Bytes of one slab slot: an odd number of 16-byte words."""
        return 16 * (self.c16s if self.c16s % 2 else self.c16s + 1)

    def groups(self) -> int:
        """k-groups of one stage (3 dy x nx x c16s), rounded up to even
        (one k32 product takes two)."""
        return (3 * self.nx * self.c16s + 1) // 2 * 2

    def smem(self, zb: int) -> int:
        """Shared memory of one block: the tap table, then the z-march's
        output tile, resident weights and three slabs (``zb`` > 0) or the
        two-stage ring (which the output tile reuses)."""
        ty, tx = self.tile
        stage = ((ty + 2) * (tx + 2) * self.cs
                 + self.groups() * 8 * self.nf * 16)
        tile = 64 * self.mf * 8 * self.nf
        tab = (self.groups() * 4 + 15) // 16 * 16
        return tab + (tile + 3 * stage if zb else max(2 * stage, tile))


def tcq_channels(ci: int, nf: int):
    """``(u, cc, chunks)`` of a ``ci``-channel int8 input: ``u`` = 4 or 8
    where ``ci`` fits (one chunk); else 16-byte channel groups, the fewest
    padded channels, then the widest chunk whose stage fits
    ``TC_STAGE_BYTES`` at the largest halo slab of ``TC_TILES``."""
    if ci <= 8:
        u = 4 if ci <= 4 else 8
        return u, u, 1
    slab = max((64 * mf // (1 << t) + 2) * ((1 << t) + 2)
               for mf, t in TC_TILES)
    best = None
    for cc in range(16, -(-ci // 16) * 16 + 1, 16):
        plan = TcqPlan(4, nf, 3, 16, cc, 1)
        stage = slab * plan.cs + plan.groups() * 8 * nf * 16
        if cc > 16 and stage > TC_STAGE_BYTES:
            continue
        chunks = -(-ci // cc)
        key = (chunks * cc, -cc)
        if best is None or key < best[0]:
            best = (key, cc, chunks)
    return 16, best[1], best[2]


def tcq_plan(shape, ci: int, co: int) -> TcqPlan:
    """The tile plan of an int8 k3 conv ``ci -> co`` over a ``(D, H, W)``
    volume: ``nf`` and the M tile as :func:`tc_plan` chooses them, the
    groups by :func:`tcq_channels`; the z-march where the input is one
    chunk and its shared memory fits ``TCQ_ZM_BYTES``, with as many planes
    a block (up to ``TCQ_ZB_MAX``) as keep four blocks for each SM."""
    bf = tc_plan(shape, 16, co, 3)  # the M and N tiles depend on shape, co
    plan = TcqPlan(bf.mf, bf.nf, bf.tx_log2, *tcq_channels(ci, bf.nf))
    if plan.chunks > 1 or plan.smem(1) > TCQ_ZM_BYTES:
        return plan
    d, h, w = shape
    ty, tx = plan.tile
    per_plane = -(-h // ty) * -(-w // tx) * plan.n_tiles(co)
    zb = max(1, min(TCQ_ZB_MAX, d * per_plane // (4 * TC_SMS)))
    return plan._replace(zb=zb)


def tcq_blocks(shape, co: int, plan: TcqPlan):
    """The output planes and tiles of the kernel's grid, with its index
    arithmetic: ``(z, y0, x0, n0, vy, vx, ncol)`` for each plane ``z`` a
    block computes (``zb`` consecutive planes from ``blockIdx.y * zb``, or
    plane ``blockIdx.y``)."""
    d = shape[0]
    step = plan.zb or 1
    for zblk in range(-(-d // step)):  # blockIdx.y
        for blk in tc_blocks((1,) + tuple(shape[1:]), co, plan):
            for z in range(zblk * step, min(zblk * step + step, d)):
                yield (z,) + blk[1:]


def pack_tcq_weights(w: torch.Tensor, plan: TcqPlan) -> torch.Tensor:
    """int8 ``(3, 3, 3, Ci, Co)`` weights -> the kernel's B operand
    ``(n_tiles, 3, chunks, groups, 8 * nf, 16)``: per N tile, input plane
    dz and channel chunk, one stage's k-groups (group ``(dy * nx + xg) *
    c16s + c16``), each ``[n][16 bytes]``; byte ``j * unit + i`` of a group
    is input channel ``chunk * cc + 16 * c16 + i`` of tap ``dx = xg * g +
    j`` (``unit`` = ``u``, and ``g`` = 1 where ``u`` = 16). Zeros pad the
    channels, the taps past dx = 2, Co and an odd group count."""
    ci, co = w.shape[3], w.shape[4]
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    g, nx, c16s = plan.g, plan.nx, plan.c16s
    unit = 16 if plan.u == 16 else plan.u
    wz = w.new_zeros((3, 3, nx * g, plan.chunks * c16s * unit, nt * bn))
    wz[:, :, :3, :ci, :co] = w
    t = wz.reshape(3, 3, nx, g, plan.chunks, c16s, unit, nt, bn)
    # (nt, dz, chunk, dy, xg, c16, n, voxel of the group, byte)
    t = t.permute(7, 0, 4, 1, 2, 5, 8, 3, 6).reshape(
        nt, 3, plan.chunks, 3 * nx * c16s, bn, 16)
    return F.pad(t, (0, 0, 0, 0, 0, plan.groups() - 3 * nx * c16s)
                 ).contiguous()


def tcq_packed(w: torch.Tensor, plan: TcqPlan) -> torch.Tensor:
    """:func:`pack_tcq_weights`, once per weight tensor (as
    :func:`tc_packed`)."""
    key = (plan.nf, plan.u, plan.cc, plan.chunks,
           None if w.is_inference() else w._version)
    hit = getattr(w, "_tcq_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_tcq_weights(w, plan))
        w._tcq_packed = hit
    return hit[1]


@build.traced
def conv3d_tc_q(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, zp: bool = True) -> torch.Tensor:
    """The int8 tensor-core conv: K1q's function (:func:`conv3d_q_requant`)
    on int8 ``x`` ``(D, H, W, Ci)``, ``w`` ``(3, 3, 3, Ci, Co)``, f32
    ``scale``/``bias`` ``(Co,)``.

    CPU tensor: the plain version. CUDA tensor: the ``csrc/conv3d_tc_q.cu``
    kernel on the current stream with :func:`tcq_plan`'s tiles and
    :func:`tcq_packed` weights, or an error.
    """
    if x.device.type == "cpu":
        return conv3d_q_requant_plain(x, w, scale, bias, zp)
    d, h, wd, ci, co = _q_checks(x, w, scale, bias, "conv3d_tc_q")
    if x.data_ptr() % 16:
        raise ValueError("conv3d_tc_q: x must start on a 16-byte boundary")
    out = torch.empty((d, h, wd, co), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    plan = tcq_plan((d, h, wd), ci, co)
    wp = tcq_packed(w, plan)
    fn = build.function("conv3d_tc_q", "ctunet_conv3d_tc_q",
                        [_P] * 5 + [_I] * 14 + [_P])
    rc = fn(x.data_ptr(), wp.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), d, h, wd, ci, co, int(bool(zp)), plan.mf,
            plan.nf, plan.tx_log2, plan.u, plan.cc, plan.chunks, plan.zb,
            *build.stream_args(x))
    build.check(rc, "conv3d_tc_q")
    conv3d_tc_q.launches += 1
    return out


conv3d_tc_q.launches = 0


# --------------------------------------------------------------------------
# K2q: int8 MaxPool 2x2x2, stride 2
# --------------------------------------------------------------------------


def maxpool2_q_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2q: the max over each 2x2x2 block of an int8
    ``(D, H, W, C)`` volume (odd extents floor), by reshape and ``amax``
    (``F.max_pool3d`` takes no int8)."""
    d, h, w = (s // 2 for s in x.shape[:3])
    c = x.shape[3]
    y = x[:2 * d, :2 * h, :2 * w].reshape(d, 2, h, 2, w, 2, c)
    return y.amax(dim=(1, 3, 5)).contiguous()


@build.traced
def maxpool2_q(x: torch.Tensor) -> torch.Tensor:
    """K2q on int8 ``(D, H, W, C)`` -> ``(D//2, H//2, W//2, C)``.

    CPU tensor: the plain version. CUDA tensor: :func:`maxpool2_rows` in
    int8 on the current stream, or an error.
    """
    if x.device.type == "cpu":
        return maxpool2_q_plain(x)
    if x.dtype != torch.int8:
        raise TypeError(f"maxpool2_q: int8, got {x.dtype}")
    out = maxpool2_rows(x)
    if out.numel():
        maxpool2_q.launches += 1
    return out


maxpool2_q.launches = 0


def maxpool2_q_direct(x: torch.Tensor) -> torch.Tensor:
    """The direct pool (``csrc/maxpool.cu``) on an int8 CUDA tensor, as
    :func:`maxpool2_direct`."""
    if x.device.type == "cpu":
        return maxpool2_q_plain(x)
    return _launch_pool(x, torch.int8, "ctunet_maxpool2_q",
                        "maxpool2_q_direct")
