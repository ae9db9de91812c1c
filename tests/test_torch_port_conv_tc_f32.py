"""PyTorch port, the f32 tensor-core conv ``conv3d_tc_f32``
(``csrc/conv3d_tc_f32.cu``, split tf32 products): the host side that the
CPU can hold.

- The tile plan (``tcf_plan``) and the kernel's grid (``tcf_blocks``) write
  every output voxel and channel exactly once at ragged extents (14x19x19,
  W = 304) for every (Ci, Co) of the f32 paths, and every plan's stages fit
  ``TCF_STAGE_BYTES`` and a block's 227 KB.
- The weight split (``pack_tcf_weights``): three tf32 planes hi + mid + lo
  reproduce w exactly (hi + mid to within 2^-22 relative), and the
  rounding (``tf32_rna``) equals an integer-exact emulation of
  ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero).
- A plain-torch emulation of the kernel's stage loop (per block and per
  (dz, channel chunk) stage: the zero-filled halo slab with the kernel's
  channel stride, A rows gathered at the lane's row offset plus the tap
  table's, A split into tf32 halves, the packed hi / mid / lo weights, each
  k8 step's hi * hi product added to the f32 accumulator, then the stage's
  corrections a_lo * w_hi + a_hi * w_mid + a_hi * w_lo)
  held against the plain version within ``f32_tol`` (4 * 2^-23 *
  sqrt(terms) * max|ref|, the tolerance ``chip_smoke.py`` holds the kernel
  to on the card): both sum the same f32 products in different orders, and
  the split leaves each product off by at most ~2^-22 of it. The
  emulation takes each product of 8 terms and each stage's corrections
  exactly (f64) and rounds them once: the tensor cores' truncation of those
  short sums is not emulated, which is why the card holds the kernel to
  the same tolerance. The hi * hi product alone (plain TF32) falls outside
  that tolerance.
- The same emulation against the Pallas kernels in interpret mode, f32:
  ``conv3d_fused`` at k=5 and ``conv3d_chain`` at k=3, within ``f32_tol``
  of the Pallas output.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` (phases 2 and 7).
"""

import math
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import conv3d as kc

torch.set_num_threads(2)


def f32_tol(ref, n_terms: int) -> float:
    """``chip_smoke.py``'s f32 tolerance."""
    return 4.0 * 2.0 ** -23 * math.sqrt(n_terms) * float(
        torch.as_tensor(ref).float().abs().max())


def _path_pairs():
    """Every (k, Ci, Co) of the f32 paths: UNetSP's 16 convs (K1 serves 12,
    K6 trains all 16 forward and 15 as input gradients, Co -> Ci), the 18
    k=5 convs of ``UNet4_2IC`` (widths 7..112, 2 inputs) and of
    ``recAE_v2_fixed`` (8..128, 1 input), served, and trained with 17 input
    gradients each (``conv_impl = "pallas"``)."""
    pairs = set()
    widths, cin = (7, 14, 28, 56), 2
    convs = []
    for w in widths:
        convs += [(cin, w), (w, w)]
        cin = w
    for w in reversed(widths):
        convs += [(cin, w), (w, w)]
        cin = 2 * w
    for i, (ci, co) in enumerate(convs):
        pairs.add((3, ci, co))
        if i:
            pairs.add((3, co, ci))
    for i_size, cin in ((7, 2), (8, 1)):
        f = [i_size * 2 ** n for n in range(5)]
        legacy = []
        for n in range(5):
            legacy += [(cin, f[n]), (f[n], f[n])]
            cin = f[n]
        for n in range(4):
            legacy += [(cin, f[3 - n]), (f[3 - n], f[3 - n])]
            cin = 2 * f[3 - n]
        for i, (ci, co) in enumerate(legacy):
            pairs.add((5, ci, co))
            if i:  # the input gradients of f32 legacy training
                pairs.add((5, co, ci))
    return sorted(pairs)


PAIRS = _path_pairs()


@pytest.mark.parametrize("shape", [(14, 19, 19), (3, 19, 304)])
@pytest.mark.parametrize("k,ci,co", PAIRS)
def test_tcf_plan_covers_every_output_once(shape, k, ci, co):
    plan = kc.tcf_plan(shape, ci, co, k)
    ty, tx = plan.tile
    assert ty * tx == 64 * plan.mf
    assert plan.mf * plan.nf <= kc.TCF_MAX_FRAGS
    assert (plan.mf, plan.tx_log2) in kc.TC_TILES and plan.k == k
    assert plan.cc % 4 == 0 and plan.cc * plan.chunks >= ci
    assert plan.cc * (plan.chunks - 1) < ci  # no chunk of padding alone
    assert plan.cs >= plan.cc and plan.cs % 4 == 0
    assert (plan.cs // 4) % 2 == 1  # odd 16-byte words: no bank conflicts
    assert plan.cc == 4 or plan.stage_bytes() <= kc.TCF_STAGE_BYTES
    assert plan.smem() <= kc.SMEM_PER_BLOCK == 227 * 1024  # an H100 block
    count = np.zeros(shape + (co,), np.uint8)
    for z, y0, x0, n0, vy, vx, ncol in kc.tcf_blocks(shape, co, plan):
        assert vy > 0 and vx > 0 and ncol > 0
        count[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] += 1
    assert count.min() == 1 and count.max() == 1


def _rna_int(v: float) -> float:
    """tf32 round to nearest, ties away from zero, on the integer bits:
    keep the top 19 bits of the pattern, and add one unit of the last kept
    bit to the magnitude when the 13 dropped bits are at least half of
    it."""
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    kept, dropped = bits & ~0x1FFF, bits & 0x1FFF
    if dropped >= 0x1000:
        kept += 0x2000
    return struct.unpack("<f", struct.pack("<I", kept & 0xFFFFFFFF))[0]


def test_tf32_rna_equals_the_integer_rounding():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.standard_normal(2000) * 10.0 ** rng.integers(-30, 30, 2000),
        np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3.4e38, -3.4e38]),
    ]).astype(np.float32)
    # exact ties (dropped bits 0x1000) and neighbours of ties, both signs
    base = rng.integers(0x00800000, 0x7F000000, 64, dtype=np.int64)
    base = base & ~0x1FFF
    bits = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001])
    ties = bits.astype(np.uint32).view(np.float32)
    vals = np.concatenate([vals, ties, -ties])
    got = kc.tf32_rna(torch.from_numpy(vals)).numpy()
    want = np.array([_rna_int(float(v)) for v in vals], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    t = ties[:64]
    assert (np.abs(kc.tf32_rna(torch.from_numpy(t)).numpy()) > t).all()


@pytest.mark.parametrize("k,ci,co", [(3, 7, 14), (5, 28, 7), (3, 112, 28),
                                     (5, 1, 8)])
@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_pack_tcf_weights_splits_exactly(k, ci, co, scale):
    """hi + mid + lo equals w exactly, each a tf32 value, hi + mid within
    2^-22 of w, in the kernel's layout, at magnitudes far from 1 (the
    planes stay in f32's normal range: below it tf32's spacing is
    absolute, 2^-136)."""
    rng = np.random.default_rng(ci * 10 + co)
    w = torch.from_numpy((rng.standard_normal((k, k, k, ci, co)) * scale
                          * 10.0 ** rng.integers(-3, 3, (k, k, k, ci, co))
                          ).astype(np.float32))
    plan = kc.tcf_plan((4, 8, 16), ci, co, k)
    wp = kc.pack_tcf_weights(w, plan)
    bn, nt, c4 = 8 * plan.nf, plan.n_tiles(co), plan.cc // 4
    assert wp.shape == (nt, k, plan.chunks, 3, plan.groups(), bn, 4)
    assert wp.dtype == torch.float32
    assert not (wp.view(torch.int32) & 0x1FFF).any()  # every plane tf32

    def unpack(t):  # back to (k, k, k, Ci, Co)
        t = t[:, :, :, :k * k * c4].reshape(nt, k, plan.chunks, k * k, c4,
                                            bn, 4)
        return t.permute(1, 3, 2, 4, 6, 0, 5).reshape(
            k, k, k, plan.chunks * plan.cc, nt * bn)

    hi, mid, lo = (unpack(wp[:, :, :, j].double()) for j in range(3))
    assert torch.equal((hi + mid + lo)[..., :ci, :co], w.double())
    err = ((hi + mid)[..., :ci, :co] - w.double()).abs()
    assert float((err - 2.0 ** -22 * w.double().abs()).max()) <= 0.0
    assert not hi[..., ci:, :].any() and not hi[..., co:].any()
    assert not wp[:, :, :, :, k * k * c4:].any()  # the pad group


def _emulate(x, w, bias, relu, plan, split=True):
    """``csrc/conv3d_tc_f32.cu``'s data flow in plain torch: ``split``
    False keeps only the hi * hi product (plain TF32)."""
    d, h, wd, ci = x.shape
    co, k, p = w.shape[-1], plan.k, plan.k // 2
    ty, tx = plan.tile
    sy, sx = ty + k - 1, tx + k - 1
    cc, c4s, cs = plan.cc, plan.cc // 4, plan.cs
    bn, groups = 8 * plan.nf, plan.groups()
    wp = kc.pack_tcf_weights(w, plan).double()
    tab = []
    for g in range(groups):
        tap, c4 = divmod(g, c4s)
        dy, dx = divmod(tap, k)
        tab.append((dy * sx + dx) * cs + c4 * 4 if g < k * k * c4s else 0)
    m = torch.arange(ty * tx)
    row_off = ((m // tx) * sx + m % tx) * cs
    idx = (row_off[:, None, None] + torch.tensor(tab)[None, :, None]
           + torch.arange(4)[None, None, :]).reshape(ty * tx, -1)
    # zero border and channel padding: the kernel's zero-filled copies
    xp = F.pad(x.float(), (0, cc * plan.chunks - ci, p, p + tx, p, p + ty,
                           p, p))
    bias_p = F.pad(bias.float(), (0, plan.n_tiles(co) * bn - co))
    out = torch.full((d, h, wd, co), float("nan"))
    for z, y0, x0, n0, vy, vx, ncol in kc.tcf_blocks((d, h, wd), co, plan):
        acc = torch.zeros(ty * tx, bn)
        for dz in range(k):
            if not 0 <= z + dz - p < d:
                continue  # the kernel skips planes outside the volume
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs)
                slab[..., :cc] = xp[z + dz, y0:y0 + sy, x0:x0 + sx,
                                    chunk * cc:(chunk + 1) * cc]
                a = slab.reshape(-1)[idx]
                a_hi = kc.tf32_rna(a)
                a_lo = kc.tf32_rna(a - a_hi)
                a_hi, a_lo = a_hi.double(), a_lo.double()
                b_hi, b_mid, b_lo = wp[n0 // bn, dz, chunk].permute(
                    0, 1, 3, 2).reshape(3, -1, bn)
                # each k8 step's hi * hi product into the f32 sums
                for k8 in range(0, a.shape[1], 8):
                    acc = acc + (a_hi[:, k8:k8 + 8]
                                 @ b_hi[k8:k8 + 8]).float()
                if split:  # the stage's corrections
                    acc = acc + (a_lo @ b_hi + a_hi @ b_mid
                                 + a_hi @ b_lo).float()
        acc = acc + bias_p[n0:n0 + bn]
        if relu:
            acc = torch.relu(acc)
        tile = acc.reshape(ty, tx, bn)
        out[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] = tile[:vy, :vx, :ncol]
    return out


def _case(ci, co, k, shape, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape + (ci,)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, k, ci, co))
                          / math.sqrt(k ** 3 * ci)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(co).astype(np.float32) * 0.1)
    return x, w, b


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("ci,co", [(1, 8), (2, 7), (7, 7), (7, 14),
                                   (28, 7), (14, 28), (56, 56), (3, 5),
                                   (16, 30), (130, 40)])
def test_tcf_stage_loop_equals_plain(k, ci, co):
    shape = (3, 7, 19) if ci < 28 else (2, 5, 11)
    x, w, b = _case(ci, co, k, shape, seed=ci * 100 + co + k)
    plan = kc.tcf_plan(shape, ci, co, k)
    relu = co % 2 == 0  # both epilogues
    got = _emulate(x, w, b, relu, plan)
    want = (kc.conv3d_bias_act_plain if k == 3
            else kc.conv3d5_bias_act_plain)(x, w, b, relu)
    assert float(want.abs().max()) > 0.1
    tol = f32_tol(want, k ** 3 * ci)
    assert float((got - want).abs().max()) <= tol
    if ci >= 7:  # plain TF32 misses the tolerance by an order of magnitude
        tf32 = _emulate(x, w, b, relu, plan, split=False)
        assert float((tf32 - want).abs().max()) > 4 * tol


def test_tcf_stage_loop_matches_pallas_conv3d_fused_k5():
    """f32, 7 -> 14 channels over 4x16x16 (H a multiple of 8, W of the
    pack): ``conv3d_fused`` at k=5 in interpret mode."""
    shape, ci, co, k = (4, 16, 16), 7, 14, 5
    x, w, b = _case(ci, co, k, shape, seed=5)
    want = np.asarray(pc.conv3d_k3(
        jnp.asarray(x.numpy()), w.numpy(), bias=b.numpy(), pack=2,
        relu=True, interpret=True, out_dtype=jnp.float32))
    got = _emulate(x, w, b, True, kc.tcf_plan(shape, ci, co, k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=f32_tol(want, k ** 3 * ci))
    assert (want > 0).mean() > 0.2


def test_tcf_stage_loop_matches_pallas_conv3d_chain_k3():
    """f32, 14 -> 7 channels over 4x8x16 with a bias, no ReLU:
    ``conv3d_chain`` in interpret mode, driven as the JAX training conv
    drives it."""
    shape, ci, co = (4, 8, 16), 14, 7
    x, w, b = _case(ci, co, 3, shape, seed=3)
    d, hh, ww = shape
    pack = jpc.choose_train_pack(ww, ci, k=3)
    wp = ww // pack
    pw = jpc.pack_pad_jax(jnp.asarray(w.numpy()), pack, jnp.float32)
    xc = pc.to_chain(jnp.asarray(x.numpy()).reshape(d, hh, wp, pack * ci),
                     pack)
    yc = pc.conv3d_chain(xc, pw, jnp.asarray(pc.pack_bias(b.numpy(), pack)),
                         hh, wp, relu=False, interpret=True,
                         out_dtype=jnp.float32)
    want = np.asarray(pc.unpack_output(pc.from_chain(yc, hh, wp, pack * co),
                                       pack, co))
    got = _emulate(x, w, b, False, kc.tcf_plan(shape, ci, co, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=f32_tol(want, 27 * ci))
    assert (want < 0).any() and (want > 0).any()


def test_tcf_packing_is_kept_per_weight_tensor():
    _, w, _ = _case(14, 28, 5, (2, 4, 8), seed=1)
    plan = kc.tcf_plan((2, 4, 8), 14, 28, 5)
    first = kc.tcf_packed(w, plan)
    assert kc.tcf_packed(w, plan) is first
    w.mul_(2.0)  # an in-place update (an optimizer step) packs anew
    again = kc.tcf_packed(w, plan)
    assert again is not first
    torch.testing.assert_close(again, 2.0 * first)  # scaling by 2 is exact


def test_tcf_wrapper_routes_and_checks():
    assert kernels.WRAPPERS["conv3d_tc_f32"] is kc.conv3d_tc_f32
    kernels.reset_launches()
    x, w, b = _case(3, 5, 3, (2, 3, 4), seed=2)
    assert torch.equal(kc.conv3d_tc_f32(x, w, b),
                       kc.conv3d_tc_plain(x, w, b, True))
    assert torch.equal(kc.conv3d5_f32(x, _case(3, 5, 5, (2, 3, 4), 3)[1], b),
                       kc.conv3d5_bias_act_plain(
                           x, _case(3, 5, 5, (2, 3, 4), 3)[1], b))
    assert sum(kernels.launches().values()) == 0  # the CPU runs the plain
    meta = x.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.conv3d_tc_f32(meta, w, b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.conv3d_f32(meta, w, b, True)
