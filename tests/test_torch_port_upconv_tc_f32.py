"""PyTorch port, the f32 tensor-core upsampling kernel ``upconv_tc_f32``
(``csrc/upconv_tc_f32.cu``: K3, K7a and K7b in f32 on split tf32
products): the host side that the CPU can hold.

- The tile plan (``uptcf_plan``) and the kernel's grid (``uptc_blocks``)
  write every output voxel and channel exactly once, for K3 and K7 with
  one or two operands, at ragged half-resolution extents and at every
  channel count of the f32 paths; every stage fits ``UTF_STAGE_BYTES`` and
  every block a card's 227 KB.
- The weight split (``pack_weights_f32``): three tf32 planes hi + mid + lo
  that reproduce the slot weights exactly, hi + mid within 2^-22 of them.
- A plain-torch emulation of the kernel's stage and offset loop (per block
  and per (input plane, channel chunk) stage: the zero-filled halo slab
  with the kernel's channel stride, A rows gathered at the lane's row
  offset plus the slab offset, A split into tf32 halves, B from the
  stage's slots in ``uptcf_slots`` order as three planes, each k8 step's
  hi * hi product added to the f32 sums, the stage's corrections a_lo *
  w_hi + a_hi * w_mid + a_hi * w_lo added once per stage; bias, the
  ones-channel term of the in-bounds taps, ReLU, the depth-to-space) held
  against the plain versions within ``f32_tol`` (4 * 2^-23 * sqrt(terms) *
  max|ref|, the tolerance ``chip_smoke.py`` holds the kernel to on the
  card; terms 8 * (Ca + Cb + 1) for K3, Ca + Cb for K7), in every parity
  grouping. The emulation takes each k8 product and each stage's
  corrections exactly (f64) and rounds them once: the tensor cores'
  truncation of those short sums is not emulated, which is why the card
  holds the kernel to the same tolerance. The hi * hi product alone (plain
  TF32) falls outside it.
- The K3 ones-channel term at every face, edge and corner.
- The same emulation against the Pallas ``upconv_fused_chain_split`` and
  ``conv_transpose_k2s2_dual`` in f32, interpret mode, within ``f32_tol``,
  and the f32 engines (UNetSP's K3, the legacy models' K7a/K7b served by
  the emulation) against the JAX f32 engine at its tests' tolerance (atol
  5e-4, rtol 1e-3).
- Routing: CPU tensors take the plain versions; other devices and dtypes
  are refused; on a patched card (``build.function`` records what it is
  asked for and launches nothing) an f32 call of ``upconv_f32``,
  ``convt_f32`` and the K3 / K7a / K7b wrappers launches
  ``ctunet_upconv_tc_f32`` with ``uptcf_plan``'s tiles and counts on
  ``upconv_tc_f32``; the packing is kept per weight tensor.

The kernel itself is held against the plain versions on the card by
``chip_smoke.py`` (phases 2 and 7).
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu import engine as jax_engine
from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import convt as ct
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import build
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import convt as kt
from ctunet_tpu_torch.ops.kernels import upconv as ku
from ctunet_tpu_torch.ops.kernels import upsample_tc as ut
from test_torch_port_f32 import ENGINES, _jax_weights

torch.set_num_threads(2)

F32 = torch.float32
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


def f32_tol(ref, n_terms: int) -> float:
    """``chip_smoke.py``'s f32 tolerance."""
    return 4.0 * 2.0 ** -23 * math.sqrt(n_terms) * float(
        torch.as_tensor(ref).float().abs().max())


def _terms(ca, cb, k3):
    return 8 * (ca + cb + 1) if k3 else ca + cb


def _emulate(a, b, wa, wb, wone, bias, k3, plan, split=True):
    """``csrc/upconv_tc_f32.cu``'s data flow in plain torch: ``split``
    False keeps only the hi * hi product (plain TF32)."""
    d2, h2, w2, _ = a.shape
    co = wa.shape[-1]
    h = 1 if k3 else 0
    ty, tx = plan.tile
    sy, sx = ty + 2 * h, tx + 2 * h
    cc, cs, bn = plan.cc, plan.cc + 4, 8 * plan.nf
    wp = ut.pack_weights_f32(wa, wb, plan).double()
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
        table = ut.uptcf_slots(plan, pg)
        for dzi in range(plan.n_dz):
            zi = z + plan.dz_lo(pg) + dzi
            if not 0 <= zi < d2:
                continue  # the kernel skips planes outside the volume
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs)
                slab[..., :cc] = xp[zi + 1, y0:y0 + sy, x0:x0 + sx,
                                    chunk * cc:(chunk + 1) * cc]
                flat = slab.reshape(-1)
                # (slots, 3, cc / 4, bn, 4) -> (slots, 3, cc, bn)
                wst = wp[pg, n0 // bn, dzi, chunk].permute(0, 1, 2, 4, 3)
                wst = wst.reshape(-1, 3, cc, bn)
                corr = torch.zeros(plan.np, ty * tx, bn, dtype=torch.float64)
                # the kernel's order: k8 steps, then slab offsets, then
                # parities
                order = sorted(enumerate(table[dzi]), key=lambda r: r[1][:2])
                for k8 in range(0, cc, 8):
                    for s, (o, j, _, _) in order:
                        off = ((o // 3) * sx + o % 3) * cs if k3 else 0
                        rows = flat[(row_off + off)[:, None]
                                    + torch.arange(k8, k8 + 8)[None, :]]
                        a_hi = kc.tf32_rna(rows)
                        a_lo = kc.tf32_rna(rows - a_hi).double()
                        a_hi = a_hi.double()
                        b_hi, b_mid, b_lo = wst[s, :, k8:k8 + 8]
                        acc[j] += (a_hi @ b_hi).float()
                        if split:
                            corr[j] += (a_lo @ b_hi + a_hi @ b_mid
                                        + a_hi @ b_lo)
                acc += corr.float()
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
                v = torch.relu(v + torch.where(at_face[:, None], taps,
                                               cols[8][None]))
            tile = v.reshape(ty, tx, bn)[:vy, :vx, :ncol]
            out[2 * z + pz, 2 * y0 + py:2 * (y0 + vy):2,
                2 * x0 + px:2 * (x0 + vx):2, n0:n0 + ncol] = tile
    return out


def _operands(ca, cb, co, k3, shape2, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    kw = 4 if k3 else 2
    fan = (8 if k3 else 1) * (ca + cb + 1)

    def arr(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(
            np.float32))

    a = arr(*shape2, ca)
    b = arr(*shape2, cb) if cb else None
    wa = arr(kw, kw, kw, ca, co, scale=scale * fan ** -0.5)
    wb = arr(kw, kw, kw, cb, co, scale=scale * fan ** -0.5) if cb else None
    wone = arr(4, 4, 4, co, scale=scale * fan ** -0.5) if k3 else None
    bias = arr(co, scale=0.1)
    return a, b, wa, wb, wone, bias


def _plain(a, b, wa, wb, wone, bias, k3):
    return ut.upconv_tc_plain(a, b, wa, wb, wone, bias, k3)


@pytest.mark.parametrize("shape2", [(3, 5, 7), (7, 19, 19), (14, 19, 19),
                                    (28, 38, 38)])
@pytest.mark.parametrize("ca,cb,co,k3", PATH_LAYERS)
def test_uptcf_plan_covers_every_output_once(shape2, ca, cb, co, k3):
    plan = ut.uptcf_plan(shape2, ca, cb, co, k3)
    ty, tx = plan.tile
    assert ty * tx == 64 * plan.mf and (plan.mf, plan.tx_log2) in ut.UT_TILES
    assert plan.np * plan.mf * plan.nf <= ut.UTF_MAX_TILES == 8
    assert plan.k3 == k3 and plan.cc % 8 == 0
    assert plan.chunks_a * plan.cc >= ca and plan.chunks_b * plan.cc >= cb
    # no chunk of padding alone
    assert plan.cc * (plan.chunks_a - 1) < ca
    assert (plan.chunks_b == 0) == (cb == 0)
    assert cb == 0 or plan.cc * (plan.chunks_b - 1) < cb
    assert plan.cc == 8 or ut.uptcf_stage_bytes(plan) <= ut.UTF_STAGE_BYTES
    assert ut.uptcf_smem(plan) <= kc.SMEM_PER_BLOCK == 227 * 1024
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
def test_uptcf_slots_are_the_kernels_static_numbering(k3, np_):
    """Each (parity, tap) of a parity group has exactly one stage slot, at
    the index the kernel computes when it is compiled (K3: ``4 j + 2 ty +
    tx``, tap ``tz`` the plane; K7: ``j``), and reads the slab offset that
    :func:`reads` (the geometry ``upconv_tc`` shares) gives it. K3 takes 2
    or 4 parities a block, of one ``pz``."""
    plan = ut.UpPlan(k3, np_, 1, 1, 3, 8, 1, 0)
    if k3 and np_ == 8:
        with pytest.raises(ValueError, match="2 or 4 parities"):
            ut.uptcf_slots(plan, 0)
        return
    for pg in range(plan.n_pg):
        seen = set()
        for dzi, row in enumerate(ut.uptcf_slots(plan, pg)):
            assert len(row) == plan.slots
            for s, (o, j, p, t) in enumerate(row):
                assert p == pg * np_ + j
                tz, ty, tx = ut.parity(t)
                assert s == (4 * j + 2 * ty + tx if k3 else j)
                assert not k3 or tz == dzi
                assert ut.reads(k3, plan.dz_lo(pg) + dzi, o, p) == t
                seen.add((p, t))
        assert seen == {(p, t) for p in range(pg * np_, (pg + 1) * np_)
                        for t in (range(8) if k3 else [0])}


@pytest.mark.parametrize("ca,cb,co,k3", [(14, 14, 7, True), (56, 0, 56, True),
                                         (7, 5, 9, False),
                                         (28, 28, 56, False)])
@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_pack_weights_f32_splits_exactly(ca, cb, co, k3, scale):
    """hi + mid + lo equals each slot weight exactly, each plane a tf32
    value, hi + mid within 2^-22 of the weight, at magnitudes far from 1
    (the planes stay in f32's normal range)."""
    wa, wb = _operands(ca, cb, co, k3, (2, 3, 4), seed=ca + co,
                       scale=scale)[2:4]
    rng = np.random.default_rng(co)
    wa = wa * torch.from_numpy(10.0 ** rng.integers(-3, 3, wa.shape)).float()
    plan = ut.uptcf_plan((2, 3, 4), ca, cb, co, k3)
    wp = ut.pack_weights_f32(wa, wb, plan)
    bn, nt = 8 * plan.nf, plan.n_tiles(co)
    assert wp.shape == (plan.n_pg, nt, plan.n_dz, plan.chunks, plan.slots, 3,
                        plan.cc // 4, bn, 4)
    assert wp.dtype == F32
    assert not (wp.view(torch.int32) & 0x1FFF).any()  # every plane tf32
    g = ut._slot_weights(wa, wb, plan, ut.uptcf_slots).double().reshape(
        plan.n_pg, plan.n_dz, plan.slots, plan.chunks, plan.cc // 4, 4, nt,
        bn).permute(0, 6, 1, 3, 2, 4, 7, 5)
    planes = wp.double()
    assert torch.equal(planes.sum(5), g)
    err = (planes[:, :, :, :, :, 0] + planes[:, :, :, :, :, 1] - g).abs()
    assert float((err - 2.0 ** -22 * g.abs()).max()) <= 0.0
    assert g.abs().max() > 0


@pytest.mark.parametrize("ca,cb,co,k3", [
    (56, 0, 56, True), (28, 28, 14, True), (14, 14, 7, True),
    (14, 6, 28, True), (10, 0, 9, True), (7, 5, 7, True),
    (112, 0, 112, False), (28, 28, 56, False), (14, 14, 28, False),
    (16, 16, 32, False), (7, 5, 9, False), (64, 64, 128, False),
])
def test_uptcf_stage_loop_equals_plain(ca, cb, co, k3):
    shape2 = (3, 5, 7) if ca + cb <= 56 else (2, 3, 5)
    ops = _operands(ca, cb, co, k3, shape2, seed=ca * 100 + cb * 10 + co)
    plan = ut.uptcf_plan(shape2, ca, cb, co, k3)
    got = _emulate(*ops, k3, plan)
    want = _plain(*ops, k3)
    assert float(want.abs().max()) > 0.1
    tol = f32_tol(want, _terms(ca, cb, k3))
    assert float((got - want).abs().max()) <= tol
    if ca + cb >= 28:  # plain TF32 misses the tolerance
        tf32 = _emulate(*ops, k3, plan, split=False)
        assert float((tf32 - want).abs().max()) > 4 * tol


@pytest.mark.parametrize("np_,mf,nf,tx_log2", [(4, 1, 1, 3), (4, 2, 1, 4),
                                               (4, 1, 2, 4), (2, 2, 1, 3),
                                               (2, 2, 2, 3), (2, 1, 4, 4)])
@pytest.mark.parametrize("dual", [False, True])
def test_k3_ones_term_at_every_face_edge_and_corner(np_, mf, nf, tx_log2,
                                                    dual):
    """K3 with the convT bias large against the rest, over 2x3x2 (every
    half-resolution voxel on a face, edges and corners in every
    combination) and 4x5x9, in every parity grouping and tile the kernel
    takes (``np * mf * nf <= UTF_MAX_TILES``): the
    emulation equals the plain version, whose ones channel is 1 inside the
    volume and 0 outside."""
    for shape2 in ((2, 3, 2), (4, 5, 9)):
        a, b, wa, wb, wone, bias = _operands(6, 10 if dual else 0, 7, True,
                                             shape2, seed=np_ + mf)
        wone = wone * 20.0
        plan = ut.UpPlan(True, np_, mf, nf, tx_log2, 8, 1, int(dual) * 2)
        got = _emulate(a, b, wa, wb, wone, bias, True, plan)
        want = _plain(a, b, wa, wb, wone, bias, True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=f32_tol(want, _terms(6, 10, True)))


@pytest.mark.parametrize("np_,mf,nf", [(8, 1, 1), (4, 1, 2), (2, 1, 4)])
def test_k7_pack_in_every_grouping_equals_plain(np_, mf, nf):
    ops = _operands(20, 14, 24, False, (3, 5, 7), seed=np_)
    plan = ut.UpPlan(False, np_, mf, nf, 3, 8, 3, 2)
    want = _plain(*ops, False)
    np.testing.assert_allclose(_emulate(*ops, False, plan).numpy(),
                               want.numpy(), rtol=0,
                               atol=f32_tol(want, 34))


def test_uptcf_emulation_matches_pallas_upconv_split(rng):
    """K3, (6+2)->4 from 2x4x16 half resolution in f32: the emulation on
    the operands ``prepare``-style splitting gives, against
    ``upconv_fused_chain_split`` in interpret mode."""
    dh, hh, ww, pin = 2, 4, 16, 4
    wp = ww // pin
    ca, cb, ct_, co = 6, 2, 5, 4
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
    assert want.dtype == np.float32 and (want > 0).mean() > 0.2
    wa, wone, wb = ku.split_response(torch.from_numpy(R), ca)
    plan = ut.uptcf_plan((dh, hh, ww), ca, cb, co, True)
    got = _emulate(torch.from_numpy(a), torch.from_numpy(b), wa, wb, wone,
                   torch.from_numpy(b0), True, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=f32_tol(want, _terms(ca, cb, True)))


def test_uptcf_emulation_matches_pallas_convt_dual(rng):
    """K7b, (14+6)->14 from 4x8x8 in f32 against
    ``conv_transpose_k2s2_dual`` + ``unpack2`` in interpret mode."""
    ca, cb, co = 14, 6, 14
    a = rng.standard_normal((4, 8, 8, ca)).astype(np.float32)
    b = rng.standard_normal((4, 8, 8, cb)).astype(np.float32)
    kern = (rng.standard_normal((2, 2, 2, co, ca + cb)) * 0.3).astype(
        np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    ma, pb = ct.build_matrices(kern[..., :ca], bias)
    mb, _ = ct.build_matrices(kern[..., ca:], bias)
    out = ct.conv_transpose_k2s2_dual(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(ma), jnp.asarray(mb),
                                      jnp.asarray(pb), interpret=True)
    want = np.asarray(ct.unpack2(out, co), np.float32)
    wa, wb, bi = kt.convt_weights(
        torch.from_numpy(kern.transpose(4, 3, 0, 1, 2)),
        torch.from_numpy(bias), ca, F32)
    plan = ut.uptcf_plan((4, 8, 8), ca, cb, co, False)
    got = _emulate(torch.from_numpy(a), torch.from_numpy(b), wa, wb, None,
                   bi, False, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=f32_tol(want, ca + cb))


@pytest.fixture
def emulated_upsampling(monkeypatch):
    """Serve K3 and K7a/K7b on CPU tensors through the emulation of
    ``upconv_tc_f32``'s loop at the plan it would launch with (the f32
    wrappers call the plain versions by name on the CPU); counts the
    calls."""
    calls = collections.Counter()

    def k3(a, b, wa, wb, wone, bias):
        calls["K3"] += 1
        plan = ut.uptcf_plan(a.shape[:3], a.shape[3],
                             0 if b is None else b.shape[3], wa.shape[-1],
                             True)
        return _emulate(a, b, wa, wb, wone, bias, True, plan)

    def k7(a, b, wa, wb, bias):
        calls["K7"] += 1
        plan = ut.uptcf_plan(a.shape[:3], a.shape[3],
                             0 if b is None else b.shape[3], wa.shape[-1],
                             False)
        return _emulate(a, b, wa, wb, None, bias, False, plan)

    monkeypatch.setattr(ku, "upconv_bn_relu_plain", k3)
    monkeypatch.setattr(kt, "convt_k2s2_plain", k7)
    return calls


@pytest.mark.parametrize("name,cin", ENGINES)
def test_f32_engine_on_the_uptcf_loop_matches_jax_engine(
        rng, emulated_upsampling, name, cin):
    """The port's f32 engine, its K3 / K7a / K7b on ``upconv_tc_f32``'s
    loop emulation, against the JAX engine in f32 with its Pallas kernels
    in interpret mode, same weights and input."""
    shape = (16, 16, 16)
    vs, sd = _jax_weights(name, cin, shape)
    x = rng.random((1, *shape, cin)).astype(np.float32)
    want = jax_engine.build_predict(name, vs, compute_dtype=jnp.float32,
                                    interpret=True)(jnp.asarray(x))
    got = tengine.build_predict(name, sd, F32, device="cpu")(
        torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-3)
    legacy = tengine.ENGINE_CONFIGS[name]["family"] == "legacy"
    assert emulated_upsampling == ({"K7": 4} if legacy else {"K3": 4})


def test_uptcf_packing_is_kept_per_weight_tensor():
    a, b, wa, wb, wone, bias = _operands(14, 14, 7, True, (2, 3, 4), seed=3)
    plan = ut.uptcf_plan((2, 3, 4), 14, 14, 7, True)
    first = ut.uptcf_packed(wa, wb, wone, plan)
    assert ut.uptcf_packed(wa, wb, wone, plan) is first
    assert ut.uptc_packed(wa, wb, wone, plan) is not first  # bf16's own
    wb.mul_(2.0)  # an in-place update of either operand packs anew
    again = ut.uptcf_packed(wa, wb, wone, plan)
    assert again is not first
    assert again[0].shape == first[0].shape == (
        plan.n_pg, plan.n_tiles(7), plan.n_dz, plan.chunks, plan.slots, 3,
        plan.cc // 4, 8 * plan.nf, 4)
    assert again[1].shape == (8, 9, 7) and again[1].dtype == F32
    # scaling by 2 is exact in every plane: operand b's slots doubled
    assert not torch.equal(again[0], first[0])
    assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("k3", [True, False])
def test_upconv_tc_f32_routes_cpu_tensors_to_the_plain_versions(k3):
    assert kernels.WRAPPERS["upconv_tc_f32"] is ut.upconv_tc_f32
    kernels.reset_launches()
    a, b, wa, wb, wone, bias = _operands(6, 4, 5, k3, (2, 3, 4), seed=4)
    want = _plain(a, b, wa, wb, wone, bias, k3)
    assert torch.equal(ut.upconv_tc_f32(a, b, wa, wb, wone, bias, k3), want)
    if k3:
        got = ku.upconv_f32(a, b, wa, wb, wone, bias)
    else:
        got = kt.convt_f32(a, b, wa, wb, bias)
    assert torch.equal(got, want) and got.dtype == F32
    assert sum(kernels.launches().values()) == 0  # the CPU runs the plain


def test_upconv_tc_f32_refuses_other_devices_and_dtypes(monkeypatch):
    a, b, wa, wb, wone, bias = _operands(6, 4, 5, True, (2, 3, 4), seed=5)
    meta = [t.to("meta") for t in (a, b, wa, wb, wone)]
    for fn in (lambda: ut.upconv_tc_f32(*meta, bias, True),
               lambda: ku.upconv_f32(*meta, bias),
               lambda: kt.convt_f32(meta[0], meta[1], meta[2], meta[3],
                                    bias)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn()
    # past the device check (as on a card), bf16 operands are refused
    # before anything is built or launched
    monkeypatch.setattr(ut, "_require_cuda", lambda x, what: None)
    asked = []
    monkeypatch.setattr(build, "function",
                        lambda *args: asked.append(args) or None)
    bf = [t.to("meta", torch.bfloat16) for t in (a, b, wa, wb, wone)]
    with pytest.raises(TypeError, match="float32"):
        ut.upconv_tc_f32(*bf, bias.to("meta"), True)
    k7 = _operands(6, 0, 5, False, (2, 3, 4), seed=6)
    with pytest.raises(TypeError, match="float32"):
        ut.upconv_tc_f32(k7[0].to("meta", torch.bfloat16), None,
                         k7[2].to("meta", torch.bfloat16), None, None,
                         k7[5].to("meta"), False)
    with pytest.raises(ValueError, match="ones-channel"):
        ut.upconv_tc_f32(k7[0].to("meta"), None, k7[2].to("meta"), None,
                         meta[4], k7[5].to("meta"), False)
    assert asked == []


@pytest.fixture
def card(monkeypatch):
    """A card that launches nothing: ``meta`` tensors pass the device
    checks, ``build.function`` records each ``(library, symbol)`` and the
    arguments of each call, and reports success."""
    asked = []

    def function(lib, symbol, argtypes):
        def call(*args):
            asked.append((lib, symbol, args))
            return 0
        return call

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, None))
    for mod in (ku, kt, ut):
        monkeypatch.setattr(mod, "_require_cuda", lambda t, what: None)
    kernels.reset_launches()
    return asked


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["upconv_bn_relu", "upconv_f32",
                                  "convt_k2s2", "convt_k2s2_dual",
                                  "convt_f32"])
def test_f32_call_launches_upconv_tc_f32(card, monkeypatch, name):
    a, b = _meta(2, 3, 4, 14), _meta(2, 3, 4, 14)
    bias = _meta(7)
    k3 = name.startswith("upconv")
    kw = 4 if k3 else 2
    wa, wb = _meta(kw, kw, kw, 14, 7), _meta(kw, kw, kw, 14, 7)
    wone = _meta(4, 4, 4, 7)
    call = {"upconv_bn_relu": lambda: ku.upconv_bn_relu(a, b, wa, wb, wone,
                                                        bias),
            "upconv_f32": lambda: ku.upconv_f32(a, b, wa, wb, wone, bias),
            "convt_k2s2": lambda: kt.convt_k2s2(a, wa, bias),
            "convt_k2s2_dual": lambda: kt.convt_k2s2_dual(a, b, wa, wb,
                                                          bias),
            "convt_f32": lambda: kt.convt_f32(a, b, wa, wb, bias)}[name]
    # the plan the weights were packed for
    pack_calls = []
    orig = ut.pack_weights_f32
    monkeypatch.setattr(ut, "pack_weights_f32", lambda wa_, wb_, plan: (
        pack_calls.append(plan) or orig(wa_, wb_, plan)))
    out = call()
    assert out.dtype == F32 and out.shape == (4, 6, 8, 7)
    assert [(lib, sym) for lib, sym, _ in card] == [
        ("upconv_tc_f32", "ctunet_upconv_tc_f32")]
    args = card[0][2]
    one = name == "convt_k2s2"
    plan = ut.uptcf_plan((2, 3, 4), 14, 0 if one else 14, 7, k3)
    assert pack_calls == [plan]
    assert args[6:] == (2, 3, 4, 14, 0 if one else 14, 7, int(k3), int(k3),
                        plan.np, plan.mf, plan.nf, plan.tx_log2, plan.cc,
                        plan.chunks_a, plan.chunks_b, 0, None)
    assert (args[1] is None) == one and (args[3] is None) == (not k3)
    counts = kernels.launches()
    assert counts["upconv_tc_f32"] == 1
    wrapper = name if name.endswith("f32") else (
        "upconv_f32" if k3 else "convt_f32")
    assert counts[wrapper] == 1
    assert counts["upconv_tc"] == counts["conv3d_tc_f32"] == 0
    assert sum(counts.values()) == (2 if name.endswith("f32") else 3)
