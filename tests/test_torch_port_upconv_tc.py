"""PyTorch port, the tensor-core upsampling kernel ``upconv_tc``
(``csrc/upconv_tc.cu``: K3, K7a and K7b in bf16): the host side that the
CPU can hold.

- The tile plan (``uptc_plan``) and the kernel's grid arithmetic
  (``uptc_blocks``) write every output voxel and channel exactly once, for
  K3 and K7 with one or two operands, at ragged half-resolution extents and
  at every channel count of the paths; two stages and the output tile fit
  a block's shared memory.
- The weight packing (``pack_weights``, ``pack_wone``), run through a
  plain-torch emulation of the kernel's stage and offset loop (per block
  and per (input plane, channel chunk) stage: the zero-filled halo slab
  with the kernel's channel stride, A rows gathered at the lane's row
  offset plus the slab offset, B from the stage's slots in the order of
  ``slot_table``, f32 sums per parity, bias, the ones-channel term of the
  in-bounds taps, ReLU, the depth-to-space), equals the plain versions in
  f32. atol 1e-5 of the largest output: both sum the same f32 products in
  different orders, with weights scaled by their fan-in so outputs are
  O(1).
- One small case of the emulation against the Pallas
  ``upconv_fused_chain_split`` (f32 output, atol/rtol 1e-4 as
  ``tests/test_torch_port_kernels.py``) and ``conv_transpose_k2s2_dual``
  (bf16: the emulation rounded once, within 2 bf16 ulps of the largest
  output, each side rounding an f32 sum taken in its own order) in
  interpret mode.
- The wrappers take the plain version for a CPU tensor, refuse other
  devices and dtypes, and keep the ``*_direct`` entries.

The kernel itself is held against the plain versions on the card by
``chip_smoke.py`` phase 2.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import convt as ct
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import convt as kt
from ctunet_tpu_torch.ops.kernels import upconv as ku
from ctunet_tpu_torch.ops.kernels import upsample_tc as ut

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, bytes
# (ca, cb, co, k3): UNetSP's K3 levels, UNet4_2IC's and recAE_v2_fixed's
# K7a/K7b
PATH_LAYERS = [
    (56, 0, 56, True), (56, 56, 28, True), (28, 28, 14, True),
    (14, 14, 7, True),
    (112, 0, 112, False), (56, 56, 112, False), (28, 28, 56, False),
    (14, 14, 28, False),
    (128, 0, 128, False), (64, 64, 128, False), (32, 32, 64, False),
    (16, 16, 32, False),
]


def _emulate(a, b, wa, wb, wone, bias, k3, plan):
    """``csrc/upconv_tc.cu``'s data flow in plain torch (f32 sums)."""
    d2, h2, w2, _ = a.shape
    co = wa.shape[-1]
    h = 1 if k3 else 0
    ty, tx = plan.tile
    sy, sx = ty + 2 * h, tx + 2 * h
    cc, cs, bn = plan.cc, plan.cc + 8, 8 * plan.nf
    wp = ut.pack_weights(wa, wb, plan).float()
    wo = ut.pack_wone(wone) if k3 else None
    # zero border, tile overhang and channel padding: the kernel's
    # zero-filled copies, operand a's chunks then b's
    ops = []
    for op, n in ((a, plan.chunks_a), (b, plan.chunks_b)):
        if n:
            ops.append(F.pad(op.float(), (0, n * cc - op.shape[-1], h,
                                          h + tx, h, h + ty, 1, 1)))
    xp = torch.cat(ops, -1)
    m = torch.arange(ty * tx)
    my, mx = m // tx, m % tx
    row_off = (my * sx + mx) * cs
    bias_p = F.pad(bias.float(), (0, plan.n_tiles(co) * bn - co))
    out = torch.full((2 * d2, 2 * h2, 2 * w2, co), float("nan"))
    for z, y0, x0, pg, n0, vy, vx, ncol in ut.uptc_blocks((d2, h2, w2), co,
                                                         plan):
        acc = torch.zeros(plan.np, ty * tx, bn)
        table = ut.slot_table(plan, pg)
        for dzi in range(plan.n_dz):
            zi = z + plan.dz_lo(pg) + dzi
            if not 0 <= zi < d2:
                continue  # the kernel skips planes outside the volume
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs)
                slab[..., :cc] = xp[zi + 1, y0:y0 + sy, x0:x0 + sx,
                                    chunk * cc:(chunk + 1) * cc]
                flat = slab.reshape(-1)
                wst = wp[pg, n0 // bn, dzi, chunk]
                for s, (o, j, _, _) in enumerate(table[dzi]):
                    off = ((o // 3) * sx + o % 3) * cs if k3 else 0
                    rows = flat[(row_off + off)[:, None]
                                + torch.arange(cc)[None, :]]
                    acc[j] += rows @ wst[s].permute(0, 2, 1).reshape(cc, bn)
        for j in range(plan.np):
            p = pg * plan.np + j
            pz, py, px = ut.parity(p)
            v = acc[j] + bias_p[n0:n0 + bn]
            if k3:
                # ones channel: the full sum inside, tap by tap at a face
                fz = torch.full((ty * tx,), z == (d2 - 1 if pz else 0))
                fy = y0 + my == (h2 - 1 if py else 0)
                fx = x0 + mx == (w2 - 1 if px else 0)
                at_face = fz | fy | fx
                cols = F.pad(wo[p], (0, plan.n_tiles(co) * bn - co))[
                    :, n0:n0 + bn]
                taps = torch.zeros(ty * tx, bn)
                for t in range(8):
                    tz, tyy, txx = ut.parity(t)
                    out_t = ((fz & (tz == pz)) | (fy & (tyy == py))
                             | (fx & (txx == px)))
                    taps += (~out_t).float()[:, None] * cols[t]
                v = v + torch.where(at_face[:, None], taps, cols[8][None])
                v = torch.relu(v)
            tile = v.reshape(ty, tx, bn)[:vy, :vx, :ncol]
            out[2 * z + pz, 2 * y0 + py:2 * (y0 + vy):2,
                2 * x0 + px:2 * (x0 + vx):2, n0:n0 + ncol] = tile
    return out


def _operands(ca, cb, co, k3, shape2, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    kw = 4 if k3 else 2
    fan = (8 if k3 else 1) * (ca + cb + 1)

    def arr(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(
            np.float32)).to(dtype)

    a = arr(*shape2, ca)
    b = arr(*shape2, cb) if cb else None
    wa = arr(kw, kw, kw, ca, co, scale=fan ** -0.5)
    wb = arr(kw, kw, kw, cb, co, scale=fan ** -0.5) if cb else None
    wone = arr(4, 4, 4, co, scale=fan ** -0.5) if k3 else None
    bias = arr(co, scale=0.1).float()
    return a, b, wa, wb, wone, bias


def _plain(a, b, wa, wb, wone, bias, k3):
    return ut.upconv_tc_plain(a, b, wa, wb, wone, bias, k3)


@pytest.mark.parametrize("shape2", [(3, 5, 7), (7, 19, 19), (14, 19, 19),
                                    (28, 38, 38)])
@pytest.mark.parametrize("ca,cb,co,k3", PATH_LAYERS)
def test_uptc_plan_covers_every_output_once(shape2, ca, cb, co, k3):
    plan = ut.uptc_plan(shape2, ca, cb, co, k3)
    ty, tx = plan.tile
    assert ty * tx == 64 * plan.mf and (plan.mf, plan.tx_log2) in ut.UT_TILES
    assert plan.np * plan.mf * plan.nf <= ut.UT_MAX_TILES
    assert plan.cc in (16, 32, 64)
    assert plan.chunks_a * plan.cc >= ca and plan.chunks_b * plan.cc >= cb
    assert (plan.chunks_b == 0) == (cb == 0)
    # two stages (slab + the widest stage's weights), the slot table and
    # the staged output tile fit a block
    h = 1 if k3 else 0
    stage = (2 * (ty + 2 * h) * (tx + 2 * h) * (plan.cc + 8)
             + 2 * plan.slots * plan.cc * 8 * plan.nf)
    tile = 2 * plan.np * 64 * plan.mf * 8 * plan.nf
    assert 4 * 3 * (9 if k3 else 1) * (plan.np + 1) + max(
        2 * stage, tile) <= SMEM_PER_BLOCK
    count = np.zeros(tuple(2 * s for s in shape2) + (co,), np.uint8)
    for z, y0, x0, pg, n0, vy, vx, ncol in ut.uptc_blocks(shape2, co, plan):
        assert vy > 0 and vx > 0 and ncol > 0
        for j in range(plan.np):
            pz, py, px = ut.parity(pg * plan.np + j)
            count[2 * z + pz, 2 * y0 + py:2 * (y0 + vy):2,
                  2 * x0 + px:2 * (x0 + vx):2, n0:n0 + ncol] += 1
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("k3", [True, False])
@pytest.mark.parametrize("np_", [2, 4, 8])
def test_slot_table_numbers_each_stage_densely(k3, np_):
    """Each (parity, tap) of a parity group appears in exactly one stage
    slot, slots are numbered 0.. in (offset, parity) order, and no plane
    holds more than the plan's widest stage."""
    plan = ut.UpPlan(k3, np_, 1, 1, 3, 16, 1, 0)
    for pg in range(plan.n_pg):
        seen = set()
        for row in ut.slot_table(plan, pg):
            assert len(row) <= plan.slots
            assert [(o, j) for o, j, _, _ in row] == sorted(
                (o, j) for o, j, _, _ in row)
            seen |= {(p, t) for _, _, p, t in row}
        parities = range(pg * np_, (pg + 1) * np_)
        assert seen == {(p, t) for p in parities
                        for t in (range(8) if k3 else [0])}


@pytest.mark.parametrize("ca,cb,co,k3", [
    (56, 0, 56, True), (28, 28, 14, True), (14, 14, 7, True),
    (16, 8, 14, True), (12, 0, 28, True),
    (112, 0, 112, False), (28, 28, 56, False), (14, 14, 28, False),
    (16, 16, 32, False), (7, 5, 9, False), (64, 64, 128, False),
])
def test_uptc_pack_through_the_stage_loop_equals_plain(ca, cb, co, k3):
    shape2 = (3, 5, 7) if ca + cb <= 56 else (2, 3, 5)
    ops = _operands(ca, cb, co, k3, shape2, seed=ca * 100 + cb * 10 + co)
    plan = ut.uptc_plan(shape2, ca, cb, co, k3)
    got = _emulate(*ops, k3, plan)
    want = _plain(*ops, k3)
    scale = float(want.abs().max())
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * max(1.0, scale))


@pytest.mark.parametrize("np_,mf,nf,tx_log2", [(8, 2, 1, 3), (8, 1, 2, 4),
                                               (4, 2, 2, 3), (4, 1, 4, 4),
                                               (2, 2, 4, 3), (2, 1, 1, 4)])
@pytest.mark.parametrize("dual", [False, True])
def test_k3_ones_term_at_every_face_edge_and_corner(np_, mf, nf, tx_log2,
                                                    dual):
    """K3 with the convT bias large against the rest, over 2x3x2 (every
    half-resolution voxel on a face, edges and corners in every
    combination) and 4x5x9, in every parity grouping and tile: the
    emulation equals the plain version, whose ones channel is 1 inside the
    volume and 0 outside."""
    for shape2 in ((2, 3, 2), (4, 5, 9)):
        a, b, wa, wb, wone, bias = _operands(6, 5 if dual else 0, 7, True,
                                             shape2, seed=np_ + mf)
        wone = wone * 20.0
        plan = ut.UpPlan(True, np_, mf, nf, tx_log2, 16, 1, int(dual))
        got = _emulate(a, b, wa, wb, wone, bias, True, plan)
        want = _plain(a, b, wa, wb, wone, bias, True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("np_,mf,nf", [(8, 1, 2), (4, 2, 2), (2, 2, 4)])
def test_k7_pack_in_every_grouping_equals_plain(np_, mf, nf):
    ops = _operands(20, 12, 24, False, (3, 5, 7), seed=np_)
    plan = ut.UpPlan(False, np_, mf, nf, 3, 16, 2, 1)
    np.testing.assert_allclose(_emulate(*ops, False, plan).numpy(),
                               _plain(*ops, False).numpy(), rtol=0,
                               atol=1e-5)


def test_uptc_emulation_matches_pallas_upconv_split(rng):
    """K3, (3+2)->4 from 2x4x16 half resolution: the emulation on the
    operands ``prepare``-style splitting gives, against
    ``upconv_fused_chain_split`` in interpret mode (f32 out)."""
    dh, hh, ww, pin = 2, 4, 16, 4
    wp = ww // pin
    ca, cb, ct_, co = 3, 2, 5, 4
    kk = (rng.standard_normal((2, 2, 2, ct_, ca + cb)) * 0.3).astype(
        np.float32)
    bb = rng.standard_normal(ct_).astype(np.float32)
    w0 = (rng.standard_normal((3, 3, 3, ct_, co)) * 0.3).astype(np.float32)
    b0 = rng.standard_normal(co).astype(np.float32)
    kT, ci_split = uc.augment_upconv_kernel(kk, bb, ca)
    R = uc.composite_response(kT, w0)
    sa, sb = uc.build_upconv_matrices_split(R, pin, ci_split)
    a = rng.standard_normal((dh, hh, ww, ca)).astype(np.float32)
    b = rng.standard_normal((dh, hh, ww, cb)).astype(np.float32)
    ones = np.ones((dh, hh, ww, 1), np.float32)

    def chain(v):
        v = np.concatenate([v, ones], -1)
        return pc.to_chain(jnp.asarray(v.reshape(dh, hh, wp, -1)), pin)

    out = uc.upconv_fused_chain_split(
        chain(a), (jnp.asarray(sa[0]), jnp.asarray(sa[1])),
        jnp.asarray(uc.pack_out_bias(b0, 2 * pin)), hh, wp, pin, ca + 1,
        b_chain=chain(b),
        split_b=(jnp.asarray(sb[0]), jnp.asarray(sb[1])), cw_b=cb + 1,
        interpret=True)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, 2 * pin * co), 2 * pin, co))
    wa, wone, wb = ku.split_response(torch.from_numpy(R), ca)
    plan = ut.uptc_plan((dh, hh, ww), ca, cb, co, True)
    got = _emulate(torch.from_numpy(a), torch.from_numpy(b), wa, wb, wone,
                   torch.from_numpy(b0), True, plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_uptc_emulation_matches_pallas_convt_dual(rng):
    """K7b, (7+7)->14 from 4x8x8 in bf16 against
    ``conv_transpose_k2s2_dual`` + ``unpack2`` in interpret mode."""
    ca, cb, co = 7, 7, 14
    a = rng.standard_normal((4, 8, 8, ca)).astype(np.float32)
    b = rng.standard_normal((4, 8, 8, cb)).astype(np.float32)
    kern = (rng.standard_normal((2, 2, 2, co, ca + cb)) * 0.3).astype(
        np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    aj, bj = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ma, pb = ct.build_matrices(kern[..., :ca], bias)
    mb, _ = ct.build_matrices(kern[..., ca:], bias)
    out = ct.conv_transpose_k2s2_dual(aj, bj, jnp.asarray(ma),
                                      jnp.asarray(mb), jnp.asarray(pb),
                                      interpret=True)
    want = np.array(jnp.asarray(ct.unpack2(out, co), jnp.float32))
    wa, wb, bi = kt.convt_weights(
        torch.from_numpy(kern.transpose(4, 3, 0, 1, 2)),
        torch.from_numpy(bias), ca)
    at = torch.from_numpy(np.array(jnp.asarray(aj, jnp.float32))).to(
        torch.bfloat16)
    bt = torch.from_numpy(np.array(jnp.asarray(bj, jnp.float32))).to(
        torch.bfloat16)
    plan = ut.uptc_plan((4, 8, 8), ca, cb, co, False)
    emu = _emulate(at, bt, wa, wb, None, bi, False, plan)
    tol = 2.0 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(np.abs(want).max()))
    np.testing.assert_allclose(emu.to(torch.bfloat16).float().numpy(), want,
                               rtol=0, atol=tol)


def test_uptc_packing_is_kept_per_weight_tensor():
    a, b, wa, wb, wone, bias = _operands(14, 14, 7, True, (2, 3, 4), seed=3,
                                         dtype=torch.bfloat16)
    plan = ut.uptc_plan((2, 3, 4), 14, 14, 7, True)
    first = ut.uptc_packed(wa, wb, wone, plan)
    assert ut.uptc_packed(wa, wb, wone, plan) is first
    wb.mul_(2.0)  # an in-place update of either operand packs anew
    again = ut.uptc_packed(wa, wb, wone, plan)
    assert again is not first
    assert again[0].shape == first[0].shape == (
        plan.n_pg, plan.n_tiles(7), plan.n_dz, plan.chunks, plan.slots,
        plan.cc // 8, 8 * plan.nf, 8)
    assert again[1].shape == (8, 9, 7) and again[1].dtype == torch.float32


@pytest.mark.parametrize("k3", [True, False])
def test_wrappers_route_cpu_tensors_to_the_plain_versions(k3):
    kernels.reset_launches()
    a, b, wa, wb, wone, bias = _operands(6, 4, 5, k3, (2, 3, 4), seed=4,
                                         dtype=torch.bfloat16)
    want = _plain(a, b, wa, wb, wone, bias, k3)
    assert torch.equal(ut.upconv_tc(a, b, wa, wb, wone, bias, k3), want)
    if k3:
        got = ku.upconv_bn_relu(a, b, wa, wb, wone, bias)
        direct = ku.upconv_bn_relu_direct(a, b, wa, wb, wone, bias)
    else:
        got = kt.convt_k2s2_dual(a, b, wa, wb, bias)
        direct = kt.convt_k2s2_dual_direct(a, b, wa, wb, bias)
        one = kt.convt_k2s2_plain(a, None, wa, None, bias)
        assert torch.equal(kt.convt_k2s2(a, wa, bias), one)
        assert torch.equal(kt.convt_k2s2_direct(a, wa, bias), one)
    assert torch.equal(got, want) and torch.equal(direct, want)
    assert got.dtype == torch.bfloat16
    counts = kernels.launches()
    assert counts["upconv_tc"] == 0  # the CPU runs the plain versions
    assert kernels.WRAPPERS["upconv_tc"] is ut.upconv_tc


def test_wrappers_refuse_other_devices_and_dtypes(monkeypatch):
    a, b, wa, wb, wone, bias = _operands(6, 4, 5, True, (2, 3, 4), seed=5)
    meta = [t.to("meta") for t in (a, b, wa, wb, wone)]
    for fn in (lambda: ut.upconv_tc(*meta, bias, True),
               lambda: ku.upconv_bn_relu(*meta, bias),
               lambda: ku.upconv_bn_relu_direct(*meta, bias),
               lambda: kt.convt_k2s2(meta[0], meta[2], bias),
               lambda: kt.convt_k2s2_direct(meta[0], meta[2], bias),
               lambda: kt.convt_k2s2_dual(meta[0], meta[1], meta[2],
                                          meta[3], bias),
               lambda: kt.convt_k2s2_dual_direct(meta[0], meta[1], meta[2],
                                                 meta[3], bias)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn()
    # past the device check (as on a card), f32 operands are refused
    # before anything is built or launched
    monkeypatch.setattr(ut, "_require_cuda", lambda x, what: None)
    with pytest.raises(TypeError, match="bfloat16"):
        ut.upconv_tc(*meta, bias.to("meta"), True)
    k7 = _operands(6, 0, 5, False, (2, 3, 4), seed=6)
    with pytest.raises(TypeError, match="bfloat16"):
        ut.upconv_tc(k7[0].to("meta"), None, k7[2].to("meta"), None, None,
                     k7[5].to("meta"), False)
