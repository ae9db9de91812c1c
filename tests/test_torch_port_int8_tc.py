"""PyTorch port, the int8 tensor-core kernels ``conv3d_tc_q``
(``csrc/conv3d_tc_q.cu``: K1q, K4a) and ``upconv_tc_q``
(``csrc/upconv_tc_q.cu``: K3q, K4b): the host side that the CPU can hold.
Every comparison is exact integer equality.

- The tile plans (``tcq_plan``, ``uptcq_plan``) and the kernels' grid
  arithmetic write every output voxel and channel exactly once at ragged
  extents and at every channel count of the int8 path; two stages and the
  output tile fit a block's shared memory.
- The weight packings (``pack_tcq_weights``, ``pack_weights_q``), run
  through a plain-torch emulation of each kernel's stage loop (per block
  and per (input plane, chunk) stage: the slab as the kernel's loader
  writes it, with the layout's fill outside the volume in every byte, the
  ones lane at 127 inside, and junk bytes past the channels; A rows
  gathered at the lane's slot plus the group's offset, B from the packed
  stage, int sums, the requant epilogue), equal ``conv3d_q_requant_plain``
  / ``upconv_q_requant_plain`` in both ``zp`` modes, also at small odd
  extents where every voxel lies at a face, edge or corner.
- The emulations equal the Pallas ``conv3d_chain_split(scale=, zp=True)``
  and ``upconv_fused_chain_split(scale2=, zp=True)`` in interpret mode.
- The wrappers route CPU tensors to the plain versions, refuse other
  devices and dtypes, and keep the ``*_direct`` entries.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` phase 2, at every shape of the int8 path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import upconv as ku
from ctunet_tpu_torch.ops.kernels import upsample_tc as ut

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, bytes
JUNK = 77  # what the emulated slab holds past the channels (zero weights)
# (ci, co) of the int8 path's 12 K1q launches (8 distinct) and the
# (ca, cb, co) of its 4 K3q launches
K1Q_LAYERS = [(2, 7), (7, 7), (7, 14), (14, 14), (14, 28), (28, 28),
              (28, 56), (56, 56)]
K3Q_LAYERS = [(56, 0, 56), (56, 56, 28), (28, 28, 14), (14, 14, 7)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _requant(acc, scale, bias, zp, round_first):
    """The int8 epilogues on exact sums: K1q subtracts 128 in f32 before
    it rounds, K3q rounds first (``round_first``)."""
    r = torch.clamp_min(kc.fma_requant(acc, scale, bias), 0.0)
    top = 255.0 if zp else 127.0
    if round_first:
        q = torch.round(torch.clamp_max(r, top)) - (128.0 if zp else 0.0)
    else:
        q = torch.round(torch.clamp_max(r, top) - (128.0 if zp else 0.0))
    return q.to(torch.int8)


# --------------------------------------------------------------------------
# conv3d_tc_q (K1q)
# --------------------------------------------------------------------------


def _emulate_conv(x, w, scale, bias, zp, plan):
    """``csrc/conv3d_tc_q.cu``'s data flow in plain torch (exact sums)."""
    d, h, wd, ci = x.shape
    co = w.shape[-1]
    ty, tx = plan.tile
    sy, sx = ty + 2, tx + 2
    g, u, cs, c16s = plan.g, plan.u, plan.cs, plan.c16s
    bn, groups = 8 * plan.nf, plan.groups()
    unit = 16 if u == 16 else u
    wp = kc.pack_tcq_weights(w, plan).double()
    fill = -128.0 if zp else 0.0
    # the cells the loader reads: channels past Ci hold junk, and the fill
    # lies around the volume (tile overhang and the slots' extra voxels too)
    cpad = plan.chunks * c16s * unit
    cells = torch.full((d, h, wd, cpad), float(JUNK), dtype=torch.float64)
    cells[..., :ci] = x.double()
    cells = F.pad(cells, (0, 0, 1, 1 + tx + g, 1, 1 + ty, 1, 1), value=fill)
    tab = []
    for gg in range(groups):
        t, c16 = divmod(gg, c16s)
        dy, xg = divmod(t, plan.nx)
        tab.append((dy * sx + xg * g) * cs + 16 * c16
                   if gg < 3 * plan.nx * c16s else 0)
    m = torch.arange(ty * tx)
    row_off = ((m // tx) * sx + m % tx) * cs
    idx = (row_off[:, None, None] + torch.tensor(tab)[None, :, None]
           + torch.arange(16)[None, None, :]).reshape(ty * tx, -1)
    out = torch.full((d, h, wd, co), 99, dtype=torch.int8)
    scale_p = F.pad(scale, (0, plan.n_tiles(co) * bn - co))
    bias_p = F.pad(bias, (0, plan.n_tiles(co) * bn - co))
    for z, y0, x0, n0, vy, vx, ncol in kc.tcq_blocks((d, h, wd), co, plan):
        acc = torch.zeros(ty * tx, bn, dtype=torch.float64)
        for dz in range(3):  # every plane: those outside read the fill
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs, dtype=torch.float64)
                for j in range(g):  # voxel j of each slot at byte u * j
                    src = cells[z + dz, y0:y0 + sy, x0 + j:x0 + j + sx]
                    if u == 16:
                        slab[..., :16 * c16s] = src[
                            ..., chunk * plan.cc:(chunk + 1) * plan.cc]
                    else:
                        slab[..., u * j:u * (j + 1)] = src
                a = slab.reshape(-1)[idx]
                b = wp[n0 // bn, dz, chunk].permute(0, 2, 1).reshape(-1, bn)
                acc += a @ b
        q = _requant(acc, scale_p[n0:n0 + bn], bias_p[n0:n0 + bn], zp,
                     False)
        out[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] = q.reshape(
            ty, tx, bn)[:vy, :vx, :ncol]
    return out


def _fit(acc):
    """A requant scale and bias ``(Co,)`` that map each channel's range of
    exact sums ``acc (..., Co)`` onto [2, 252], so the outputs cover the
    int8 range and an error in any sum moves some output."""
    a = acc.reshape(-1, acc.shape[-1])
    lo, hi = a.amin(0), a.amax(0)
    scale = (250.0 / (hi - lo).clamp_min(1.0)).float()
    return scale, (2.0 - lo * scale.double()).float()


def _conv_acc(x, w, zp):
    """K1q's exact sums, as ``conv3d_q_requant_plain`` takes them."""
    xf = F.pad(x.double().permute(3, 0, 1, 2)[None], (1,) * 6,
               value=-128.0 if zp else 0.0)
    acc = F.conv3d(xf, w.double().permute(4, 3, 0, 1, 2))[0]
    return acc.permute(1, 2, 3, 0)


def _conv_case(ci, co, shape, seed, zp=True, const=None):
    """int8 activations (``const`` everywhere if given) and weights, and a
    fitted requant scale and bias."""
    rng = np.random.default_rng(seed)
    x = _t(rng.integers(-128 if zp else 0, 128, shape + (ci,)).astype(
        np.int8))
    if const is not None:
        x = torch.full_like(x, const)
    w = _t(rng.integers(-127, 128, (3, 3, 3, ci, co)).astype(np.int8))
    return (x, w) + _fit(_conv_acc(x, w, zp))


@pytest.mark.parametrize("shape", [(19, 38, 76), (76, 304, 19),
                                   (38, 19, 304), (224, 304, 304)])
@pytest.mark.parametrize("ci,co", K1Q_LAYERS + [(1, 8), (5, 3), (9, 16),
                                                (33, 70)])
def test_tcq_plan_covers_every_output_once(shape, ci, co):
    plan = kc.tcq_plan(shape, ci, co)
    ty, tx = plan.tile
    assert ty * tx == 64 * plan.mf and (plan.mf, plan.tx_log2) in kc.TC_TILES
    assert plan.u == (4 if ci <= 4 else 8 if ci <= 8 else 16)
    if plan.u < 16:
        assert (plan.cc, plan.chunks) == (plan.u, 1)
    else:
        assert plan.cc % 16 == 0 and plan.cc * plan.chunks >= ci
        assert plan.cc * (plan.chunks - 1) < ci  # no chunk of padding alone
    # a group's 16 bytes: g voxels of u bytes; every tap dx in some group
    assert plan.g * (16 if plan.u == 16 else plan.u) == 16
    assert plan.nx * plan.g >= 3
    # the tap table and two stages (slab + weights) or the output tile, or
    # in the z-march the tile, three slabs and the three planes' weights,
    # fit a block
    stage = ((ty + 2) * (tx + 2) * plan.cs
             + plan.groups() * 8 * plan.nf * 16)
    tile = 64 * plan.mf * 8 * plan.nf
    tab = (plan.groups() * 4 + 15) // 16 * 16
    assert plan.smem(plan.zb) == tab + (
        tile + 3 * stage if plan.zb else max(2 * stage, tile))
    assert plan.smem(plan.zb) <= SMEM_PER_BLOCK
    if plan.zb:
        assert plan.chunks == 1 and plan.smem(1) <= kc.TCQ_ZM_BYTES
        assert 1 <= plan.zb <= kc.TCQ_ZB_MAX
    if shape[0] > 200:
        assert plan.zb == (kc.TCQ_ZB_MAX if ci <= 16 else 0)
        return  # the path's full size: the plan alone
    count = np.zeros(shape + (co,), np.uint8)
    for z, y0, x0, n0, vy, vx, ncol in kc.tcq_blocks(shape, co, plan):
        assert vy > 0 and vx > 0 and ncol > 0
        count[z, y0:y0 + vy, x0:x0 + vx, n0:n0 + ncol] += 1
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("zp", [True, False])
@pytest.mark.parametrize("ci,co", K1Q_LAYERS + [(1, 8), (3, 5), (5, 9),
                                                (8, 8), (9, 16), (16, 7),
                                                (33, 24)])
def test_tcq_pack_through_the_stage_loop_equals_plain(ci, co, zp):
    shape = (3, 7, 19) if ci * co < 1000 else (2, 5, 11)
    x, w, scale, bias = _conv_case(ci, co, shape, seed=ci * 100 + co, zp=zp)
    plan = kc.tcq_plan(shape, ci, co)
    got = _emulate_conv(x, w, scale, bias, zp, plan)
    want = kc.conv3d_q_requant_plain(x, w, scale, bias, zp)
    assert len(torch.unique(want)) > 20  # the epilogue is exercised
    assert torch.equal(got, want)


@pytest.mark.parametrize("zp", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 2), (4, 5, 9)])
@pytest.mark.parametrize("ci,co,tx_log2,mf,zb", [
    (2, 7, 3, 2, 3), (7, 7, 4, 4, 1), (7, 14, 3, 4, 0), (14, 8, 4, 2, 2),
    (28, 16, 3, 2, 0)])
def test_tcq_fill_at_every_face_edge_and_corner(shape, ci, co, tx_log2, mf,
                                               zb, zp):
    """Small odd extents: every voxel's neighbourhood holds out-of-volume
    taps, which read -128 (``zp``) or 0 in every channel; the inputs sit
    far from the fill, and the requant spreads the sums of the faces,
    edges and corners over the int8 range, so a wrong fill moves
    outputs."""
    x, w, scale, bias = _conv_case(ci, co, shape, seed=ci + co, zp=zp,
                                   const=100)
    base = kc.tcq_plan(shape, ci, co)
    plan = base._replace(mf=mf, tx_log2=tx_log2, zb=zb)
    got = _emulate_conv(x, w, scale, bias, zp, plan)
    want = kc.conv3d_q_requant_plain(x, w, scale, bias, zp)
    assert len(torch.unique(want)) > 4  # the faces give different sums
    assert torch.equal(got, want)


@pytest.mark.parametrize("pack,cin,cout,dhw", [
    (4, 3, 5, (6, 8, 32)),
    (2, 8, 8, (4, 6, 16)),
])
def test_tcq_emulation_matches_pallas_conv3d_chain_split(pack, cin, cout,
                                                         dhw):
    """``conv3d_chain_split(scale=, zp=True)`` in interpret mode, laid out
    with ``to_chain`` and the -128 fill (as
    ``tests/test_torch_port_int8_kernels.py``), against the emulation."""
    rng = np.random.default_rng(cin)
    d, hh, ww = dhw
    wp = ww // pack
    x = rng.integers(-128, 128, (d, hh, ww, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.float32)
    scale, bias = (t.numpy() for t in _fit(_conv_acc(
        _t(x), _t(w.astype(np.int8)), True)))
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * cin)), pack,
                     fill=-128)
    wm, wc = pc.pack_weights_split(w, pack)
    out = pc.conv3d_chain_split(
        xc, jnp.asarray(wm.astype(np.int8)), jnp.asarray(wc.astype(np.int8)),
        jnp.asarray(pc.pack_bias(bias, pack)), hh, wp, pack, cin,
        scale=jnp.asarray(pc.pack_bias(scale, pack)), zp=True,
        interpret=True)
    want = np.asarray(pc.unpack_output(pc.from_chain(out, hh, wp,
                                                     pack * cout), pack,
                                       cout))
    plan = kc.tcq_plan(dhw, cin, cout)
    got = _emulate_conv(_t(x), _t(w.astype(np.int8)), _t(scale), _t(bias),
                        True, plan)
    assert len(np.unique(want)) > 10
    np.testing.assert_array_equal(got.numpy(), want)


def test_tcq_packing_is_kept_per_weight_tensor():
    _, w, _, _ = _conv_case(14, 28, (2, 4, 8), seed=1)
    plan = kc.tcq_plan((2, 4, 8), 14, 28)
    first = kc.tcq_packed(w, plan)
    assert kc.tcq_packed(w, plan) is first
    w.mul_(-1)  # an in-place update packs anew
    again = kc.tcq_packed(w, plan)
    assert again is not first and torch.equal(again, -first)
    assert first.dtype == torch.int8 and first.shape == (
        plan.n_tiles(28), 3, plan.chunks, plan.groups(), 8 * plan.nf, 16)


# --------------------------------------------------------------------------
# upconv_tc_q (K3q)
# --------------------------------------------------------------------------


def _emulate_up(a, b, wa, wb, wone, scale, bias8, zp, plan):
    """``csrc/upconv_tc_q.cu``'s data flow in plain torch (exact sums)."""
    d2, h2, w2, ca = a.shape
    co = wa.shape[-1]
    cb = 0 if b is None else b.shape[-1]
    geo = plan.geometry
    ty, tx = geo.tile
    sy, sx = ty + 2, tx + 2
    cg, cs, bn = plan.cg, 16 * (plan.cg + 1), 8 * plan.nf
    wp = ut.pack_weights_q(wa, wb, wone, plan).double()
    fill = -128.0 if zp else 0.0
    # the lanes as the loader writes them: [a | 127 | junk] in ga groups,
    # [b | junk] in gb groups, junk to the last chunk's end; the fill in
    # every lane outside the volume
    lanes = torch.full((d2, h2, w2, 16 * plan.chunks * cg), float(JUNK),
                       dtype=torch.float64)
    lanes[..., :ca] = a.double()
    lanes[..., ca] = 127.0
    if cb:
        lanes[..., 16 * plan.ga:16 * plan.ga + cb] = b.double()
    xp = F.pad(lanes, (0, 0, 1, 1 + tx, 1, 1 + ty, 1, 1), value=fill)
    m = torch.arange(ty * tx)
    my, mx = m // tx, m % tx
    row_off = (my * sx + mx) * cs
    scale_p = F.pad(scale, (0, plan.n_tiles(co) * bn - co))
    bias_p = F.pad(bias8, (0, plan.n_tiles(co) * bn - co))
    out = torch.full((2 * d2, 2 * h2, 2 * w2, co), 99, dtype=torch.int8)
    for z, y0, x0, pg, n0, vy, vx, ncol in ut.uptc_blocks((d2, h2, w2), co,
                                                         geo):
        acc = torch.zeros(geo.np, ty * tx, bn, dtype=torch.float64)
        table = ut.slot_table(geo, pg)
        for dzi in range(geo.n_dz):  # every plane: outside ones read fill
            zi = z + geo.dz_lo(pg) + dzi
            for chunk in range(plan.chunks):
                slab = torch.zeros(sy, sx, cs, dtype=torch.float64)
                slab[..., :16 * cg] = xp[zi + 1, y0:y0 + sy, x0:x0 + sx,
                                         16 * cg * chunk:16 * cg * (chunk
                                                                    + 1)]
                flat = slab.reshape(-1)
                wst = wp[pg, n0 // bn, dzi, chunk]
                for s, (o, j, _, _) in enumerate(table[dzi]):
                    off = ((o // 3) * sx + o % 3) * cs
                    rows = flat[(row_off + off)[:, None]
                                + torch.arange(16 * cg)[None, :]]
                    acc[j] += rows @ wst[s].permute(0, 2, 1).reshape(
                        16 * cg, bn)
        for j in range(geo.np):
            p = pg * geo.np + j
            pz, py, px = ut.parity(p)
            q = _requant(acc[j], scale_p[n0:n0 + bn], bias_p[p, n0:n0 + bn],
                         zp, True)
            out[2 * z + pz, 2 * y0 + py:2 * (y0 + vy):2,
                2 * x0 + px:2 * (x0 + vx):2, n0:n0 + ncol] = q.reshape(
                    ty, tx, bn)[:vy, :vx, :ncol]
    return out


def _up_acc(a, b, wa, wb, wone, zp):
    """K3q's exact sums, as ``upconv_q_requant_plain`` takes them."""
    parts = [a.double(), torch.full_like(a[..., :1], 127,
                                         dtype=torch.float64)]
    ws = [wa.double(), wone.double()[..., None, :]]
    if b is not None:
        parts.append(b.double())
        ws.append(wb.double())
    x = F.pad(torch.cat(parts, -1).permute(3, 0, 1, 2)[None], (1,) * 6,
              value=-128.0 if zp else 0.0)
    acc = F.conv_transpose3d(x, torch.cat(ws, 3).permute(3, 4, 0, 1, 2),
                             stride=2, padding=1)[0, :, 2:-2, 2:-2, 2:-2]
    return acc.permute(1, 2, 3, 0)


def _up_case(ca, cb, co, shape2, seed, zp=True, const=None):
    """int8 half-resolution operands (``const`` = (a, b) values everywhere
    if given) and composite weights (operand b's ones row zero, as the dual
    layout has it), a fitted requant scale and one bias row per output
    parity (the fitted bias plus the parity index, so that a wrong row
    moves outputs)."""
    rng = np.random.default_rng(seed)
    lo = -128 if zp else 0
    a = _t(rng.integers(lo, 128, shape2 + (ca,)).astype(np.int8))
    b = _t(rng.integers(lo, 128, shape2 + (cb,)).astype(np.int8)) if cb \
        else None
    if const is not None:
        a = torch.full_like(a, const[0])
        b = None if b is None else torch.full_like(b, const[1])
    cin = ca + 1 + (cb + 1 if cb else 0)
    r = rng.integers(-127, 128, (4, 4, 4, cin, co)).astype(np.int8)
    if cb:
        r[:, :, :, -1] = 0
    wa, wone, wb = ku.split_response(_t(r), ca if cb else None)
    scale, bias = _fit(_up_acc(a, b, wa, wb, wone, zp))
    bias8 = bias[None] + torch.arange(8, dtype=torch.float32)[:, None]
    return a, b, wa, wb, wone, scale, bias8.contiguous()


@pytest.mark.parametrize("shape2", [(3, 5, 7), (7, 19, 19), (14, 19, 19),
                                    (112, 152, 152)])
@pytest.mark.parametrize("ca,cb,co", K3Q_LAYERS + [(15, 0, 9), (16, 16, 8),
                                                   (5, 3, 7), (31, 1, 12),
                                                   (64, 64, 32)])
def test_uptcq_plan_covers_every_output_once(shape2, ca, cb, co):
    plan = ut.uptcq_plan(shape2, ca, cb, co)
    geo = plan.geometry
    ty, tx = geo.tile
    assert plan.np * plan.mf * plan.nf <= ut.UT_MAX_TILES
    assert plan.cg % 2 == 0
    assert (plan.ga, plan.gb) == (-(-(ca + 1) // 16), -(-cb // 16))
    gt = plan.ga + plan.gb
    assert plan.chunks * plan.cg >= gt > (plan.chunks - 1) * plan.cg
    stage = ((ty + 2) * (tx + 2) * 16 * (plan.cg + 1)
             + geo.slots * plan.cg * 8 * plan.nf * 16)
    tile = plan.np * 64 * plan.mf * 8 * plan.nf
    assert (4 * 27 * (plan.np + 1) + 15) // 16 * 16 + max(
        2 * stage, tile) <= SMEM_PER_BLOCK
    if shape2[0] > 100:
        return  # the path's full size: the plan alone
    count = np.zeros(tuple(2 * s for s in shape2) + (co,), np.uint8)
    for z, y0, x0, pg, n0, vy, vx, ncol in ut.uptc_blocks(shape2, co, geo):
        assert vy > 0 and vx > 0 and ncol > 0
        for j in range(plan.np):
            pz, py, px = ut.parity(pg * plan.np + j)
            count[2 * z + pz, 2 * y0 + py:2 * (y0 + vy):2,
                  2 * x0 + px:2 * (x0 + vx):2, n0:n0 + ncol] += 1
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("zp", [True, False])
@pytest.mark.parametrize("ca,cb,co", K3Q_LAYERS + [(15, 0, 9), (16, 16, 8),
                                                   (5, 3, 7), (31, 1, 12)])
def test_uptcq_pack_through_the_stage_loop_equals_plain(ca, cb, co, zp):
    shape2 = (3, 5, 7) if ca + cb <= 32 else (2, 3, 5)
    ops = _up_case(ca, cb, co, shape2, seed=ca * 100 + cb * 10 + co, zp=zp)
    plan = ut.uptcq_plan(shape2, ca, cb, co)
    got = _emulate_up(*ops, zp, plan)
    want = ku.upconv_q_requant_plain(*ops, zp)
    assert len(torch.unique(want)) > 20  # the epilogue is exercised
    assert torch.equal(got, want)


@pytest.mark.parametrize("np_,mf,nf,tx_log2", [(8, 2, 1, 3), (8, 1, 2, 4),
                                               (4, 2, 2, 3), (4, 1, 4, 4),
                                               (2, 2, 4, 3), (2, 1, 1, 4)])
@pytest.mark.parametrize("dual", [False, True])
def test_k3q_fill_and_ones_lane_at_every_face_edge_and_corner(np_, mf, nf,
                                                              tx_log2, dual):
    """2x3x2 (every half-resolution voxel on a face, edges and corners in
    every combination) and 4x5x9, in every parity grouping and tile, in
    both modes: the ones lane is 127 inside and the fill outside, and the
    fill lies in every lane of every out-of-volume tap; the operands sit
    far from the fill, and the requant spreads the sums of the faces,
    edges and corners over the int8 range, so a wrong lane moves
    outputs."""
    for zp in (True, False):
        for shape2 in ((2, 3, 2), (4, 5, 9)):
            a, b, wa, wb, wone, scale, bias8 = _up_case(
                6, 5 if dual else 0, 7, shape2, seed=np_ + mf, zp=zp,
                const=(90, 40))
            ga, gb = 1, 1 if dual else 0
            plan = ut.UpqPlan(np_, mf, nf, tx_log2, 2, 1, ga, gb)
            got = _emulate_up(a, b, wa, wb, wone, scale, bias8, zp, plan)
            want = ku.upconv_q_requant_plain(a, b, wa, wb, wone, scale,
                                             bias8, zp)
            assert len(torch.unique(want)) > 4  # the faces differ
            assert torch.equal(got, want), (zp, shape2)


def test_uptcq_emulation_matches_pallas_upconv_split(rng):
    """K3q, (3+2)->4 from 4x8x32 half resolution against
    ``upconv_fused_chain_split(scale2=, zp=True)`` in interpret mode (halo
    -128 in every lane, ones lane 127, a bias row per parity), laid out as
    ``tests/test_torch_port_int8_kernels.py`` lays it out."""
    dh, hh, ww, pin = 4, 8, 32, 4
    wp = ww // pin
    ca, cb, co = 3, 2, 4
    cin = ca + 1 + cb + 1
    R = rng.integers(-60, 61, (4, 4, 4, cin, co)).astype(np.float32)
    R[:, :, :, -1] = 0.0
    a = rng.integers(-128, 128, (dh, hh, ww, ca)).astype(np.int8)
    b = rng.integers(-128, 128, (dh, hh, ww, cb)).astype(np.int8)
    wa, wone, wb = ku.split_response(_t(R.astype(np.int8)), ca)
    scale, base = (t.numpy() for t in _fit(_up_acc(_t(a), _t(b), wa, wb,
                                                   wone, True)))
    pout = 2 * pin
    scale_lane = uc.pack_out_bias(scale, pout)[0]
    base_lane = uc.pack_out_bias(base, pout)[0]

    def chain(v):
        v = np.concatenate([v, np.full(v.shape[:3] + (1,), 127, v.dtype)],
                           -1)
        return pc.to_chain(jnp.asarray(v.reshape(dh, hh, wp, -1)), pin,
                           fill=-128)

    sa, sb = uc.build_upconv_matrices_split(R, pin, ca + 1)
    colsum = sum(m.sum(axis=(2, 3)) for m in (sa[0], sa[1], sb[0], sb[1]))
    b4 = jnp.asarray(np.stack([
        (base_lane + 128.0 * colsum[i, j] * scale_lane).astype(np.float32)
        for i in range(2) for j in range(2)]))

    def q8(m):
        return jnp.asarray(m.astype(np.int8))

    out = uc.upconv_fused_chain_split(
        chain(a), (q8(sa[0]), q8(sa[1])), b4, hh, wp, pin, ca + 1,
        b_chain=chain(b), split_b=(q8(sb[0]), q8(sb[1])), cw_b=cb + 1,
        scale2=jnp.asarray(uc.pack_out_bias(scale, pout)), interpret=True,
        zp=True)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, pout * co), pout, co))
    bias8 = tq.parity_bias(R, base, scale)
    plan = ut.uptcq_plan((dh, hh, ww), ca, cb, co)
    got = _emulate_up(_t(a), _t(b), wa, wb, wone, _t(scale), _t(bias8),
                      True, plan)
    assert len(np.unique(want)) > 10
    np.testing.assert_array_equal(got.numpy(), want)


def test_uptcq_packing_is_kept_per_weight_tensor():
    _, _, wa, wb, wone, _, _ = _up_case(14, 14, 7, (2, 3, 4), seed=3)
    plan = ut.uptcq_plan((2, 3, 4), 14, 14, 7)
    first = ut.uptcq_packed(wa, wb, wone, plan)
    assert ut.uptcq_packed(wa, wb, wone, plan) is first
    wone.mul_(-1)  # an in-place update of any of the three packs anew
    again = ut.uptcq_packed(wa, wb, wone, plan)
    assert again is not first
    geo = plan.geometry
    assert again.dtype == torch.int8 and again.shape == first.shape == (
        geo.n_pg, plan.n_tiles(7), geo.n_dz, plan.chunks, geo.slots,
        plan.cg, 8 * plan.nf, 16)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("zp", [True, False])
def test_wrappers_route_cpu_tensors_to_the_plain_versions(zp):
    kernels.reset_launches()
    x, w, scale, bias = _conv_case(7, 14, (2, 3, 5), seed=5, zp=zp)
    want = kc.conv3d_q_requant_plain(x, w, scale, bias, zp)
    for fn in (kc.conv3d_q_requant, kc.conv3d_tc_q,
               kc.conv3d_q_requant_direct):
        got = fn(x, w, scale, bias, zp)
        assert got.dtype == torch.int8 and torch.equal(got, want)
    ops = _up_case(14, 14, 7, (2, 3, 2), seed=6, zp=zp)
    want = ku.upconv_q_requant_plain(*ops, zp)
    for fn in (ku.upconv_q_requant, ut.upconv_tc_q,
               ku.upconv_q_requant_direct):
        got = fn(*ops, zp)
        assert got.dtype == torch.int8 and torch.equal(got, want)
    counts = kernels.launches()  # the CPU runs the plain versions
    assert all(counts[k] == 0 for k in ("conv3d_q_requant", "conv3d_tc_q",
                                        "upconv_q_requant", "upconv_tc_q"))
    assert kernels.WRAPPERS["conv3d_tc_q"] is kc.conv3d_tc_q
    assert kernels.WRAPPERS["upconv_tc_q"] is ut.upconv_tc_q


def test_wrappers_refuse_other_devices_and_dtypes(monkeypatch):
    x, w, scale, bias = _conv_case(7, 7, (2, 3, 4), seed=7)
    ops = _up_case(14, 14, 7, (2, 3, 2), seed=8)
    xm, wm = x.to("meta"), w.to("meta")
    upm = [None if t is None else t.to("meta") for t in ops]
    for fn in (lambda: kc.conv3d_q_requant(xm, wm, scale, bias),
               lambda: kc.conv3d_tc_q(xm, wm, scale, bias),
               lambda: kc.conv3d_q_requant_direct(xm, wm, scale, bias),
               lambda: ku.upconv_q_requant(*upm),
               lambda: ut.upconv_tc_q(*upm),
               lambda: ku.upconv_q_requant_direct(*upm)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn()
    # past the device check (as on a card), other dtypes are refused
    # before anything is built or launched
    monkeypatch.setattr(kc, "_require_cuda", lambda t, what: None)
    monkeypatch.setattr(ku, "_require_cuda", lambda t, what: None)
    sm, bm = scale.to("meta"), bias.to("meta")
    with pytest.raises(TypeError, match="int8"):
        kc.conv3d_tc_q(xm.to(torch.bfloat16), wm, sm, bm)
    with pytest.raises(TypeError, match="int8"):
        kc.conv3d_q_requant(xm, wm.float(), sm, bm)
    with pytest.raises(TypeError, match="int8"):
        ut.upconv_tc_q(upm[0].float(), *upm[1:])
    with pytest.raises(TypeError, match="float32"):
        ku.upconv_q_requant(*upm[:5], upm[5].double(), upm[6])
