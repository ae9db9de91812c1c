"""PyTorch port, int8 kernels K1q-K3q: plain versions against the Pallas
kernels, and the quantized operands against ``ctunet_tpu.engine_q``.

The same int8 inputs, made from a numpy seed, go through the Pallas kernel
of ``ctunet_tpu`` (``interpret=True``, laid out with ``to_chain`` and the
layout's fill, read back with ``from_chain``/``unpack_output`` as
``tests/test_split_taps.py`` does) and through the port's wrapper, which on
a CPU tensor runs its plain PyTorch version. Every int8 comparison is
exact: the accumulators are exact integers on both sides and the f32
epilogue rounds at the same places. The CUDA kernels are held against
these plain versions on the card, exactly, by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu.engine import _FusedUnit
from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import upconv as ku

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)  # f32 on both sides, summation order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i8(rng, shape, lo=-128):
    return rng.integers(lo, 128, shape).astype(np.int8)


# --------------------------------------------------------------------------
# K1q
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["split_zp", "full_zp", "full_sym"])
@pytest.mark.parametrize("pack,cin,cout,dhw", [
    (4, 3, 5, (6, 8, 32)),
    (2, 8, 8, (4, 6, 16)),
    (1, 5, 3, (4, 4, 8)),
    (2, 7, 7, (2, 2, 4)),   # every voxel touches a border
])
def test_k1q_matches_pallas(rng, form, pack, cin, cout, dhw):
    """K1q's plain version against ``conv3d_chain_split(scale=, zp=True)``
    and ``conv3d_chain_q`` (K4a) in zp and symmetric mode: out-of-volume
    taps read the layout's fill (-128 / 0), exactly."""
    zp = form != "full_sym"
    d, hh, ww = dhw
    wp = ww // pack
    x = _i8(rng, (d, hh, ww, cin), -128 if zp else 0)
    w = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.float32)
    scale = (rng.random(cout) * 0.01 + 0.001).astype(np.float32)
    bias = (rng.standard_normal(cout) * 3).astype(np.float32)
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * cin)), pack,
                     fill=-128 if zp else 0)
    ps = jnp.asarray(pc.pack_bias(scale, pack))
    pb = jnp.asarray(pc.pack_bias(bias, pack))
    if form == "split_zp":
        wm, wc = pc.pack_weights_split(w, pack)
        out = pc.conv3d_chain_split(
            xc, jnp.asarray(wm.astype(np.int8)),
            jnp.asarray(wc.astype(np.int8)), pb, hh, wp, pack, cin,
            scale=ps, zp=True, interpret=True)
    else:
        out = pc.conv3d_chain_q(
            xc, jnp.asarray(pc.pack_weights(w, pack).astype(np.int8)), ps,
            pb, hh, wp, interpret=True, zp=zp)
    want = pc.unpack_output(pc.from_chain(out, hh, wp, pack * cout), pack,
                            cout)
    got = kc.conv3d_q_requant(_t(x), _t(w.astype(np.int8)), _t(scale),
                              _t(bias), zp=zp)
    assert got.dtype == torch.int8 and got.shape == (d, hh, ww, cout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k1q_epilogue_rounds_like_jax():
    """The epilogue of ``conv3d.py:1001-1013``: f32(acc) rounds to nearest
    (|acc| may pass 2^24), the clamp comes before the round, and .5 goes
    to even."""
    x = torch.full((1, 1, 1, 1), 127, dtype=torch.int8)
    w = torch.zeros((3, 3, 3, 1, 4), dtype=torch.int8)
    w[1, 1, 1, 0] = torch.tensor([127, 1, 2, 3], dtype=torch.int8)
    scale = torch.tensor([1.0, 0.5, 0.25, 0.5])
    bias = torch.tensor([-16100.0, 64.0, 0.0, 0.0])
    got = kc.conv3d_q_requant(x, w, scale, bias, zp=False)
    # 16129 - 16100 = 29; 63.5 + 64 clamps to 127; 63.5 -> 64 (even);
    # 190.5 clamps to 127
    assert got.flatten().tolist() == [29, 127, 64, 127]
    # one output voxel with 27 taps x 40 channels of 127 * 127, one weight
    # 126: acc = 17419193, odd and above 2^24
    x = torch.full((3, 3, 3, 40), 127, dtype=torch.int8)
    w = torch.full((3, 3, 3, 40, 1), 127, dtype=torch.int8)
    w[0, 0, 0, 0, 0] = 126
    acc = 27 * 40 * 127 * 127 - 127
    assert acc > 2 ** 24 and acc % 2
    scale = np.float32(1.0 / 3.0) * np.float32(1e-5)
    bias = np.float32(-55.0)
    want = np.float32(float(np.float32(acc)) * float(scale) + float(bias))
    want = np.round(np.minimum(np.maximum(want, 0.0), 255.0) - 128.0)
    got = kc.conv3d_q_requant(x, w, torch.tensor([scale]),
                              torch.tensor([bias]))
    assert int(got[1, 1, 1, 0]) == int(want)


# One accumulator, scale and bias where one rounding and two differ:
# 63479 * 0.0085461335 - 542 is 0.50001 rounded once (FMA), 0.5 rounded
# twice, so the requantized value is 1 or 0 (-127 or -128 in zp mode).
FMA_ACC_X = np.array([127, 127, 127, 127, 106], np.int8)
FMA_ACC_W = np.array([127, 127, 127, 118, 1], np.int8)  # x . w = 63479
FMA_SCALE = np.float32(0.008546133525669575)
FMA_BIAS = np.float32(-542.0)


@pytest.mark.parametrize("form", ["split", "full"])
def test_k1q_epilogue_rounds_once_like_pallas(form):
    """The Pallas epilogue's ``acc * scale + bias`` rounds once (XLA
    contracts it into a fused multiply-add), and so does K1q's."""
    pack, (d, hh, ww), ci = 2, (2, 2, 4), FMA_ACC_X.size
    x = np.full((d, hh, ww, ci), -128, np.int8)
    x[1, 0, 2] = FMA_ACC_X
    w = np.zeros((3, 3, 3, ci, 1), np.float32)
    w[1, 1, 1, :, 0] = FMA_ACC_W
    scale, bias = np.array([FMA_SCALE]), np.array([FMA_BIAS])
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, ww // pack, -1)), pack,
                     fill=-128)
    ps = jnp.asarray(pc.pack_bias(scale, pack))
    pb = jnp.asarray(pc.pack_bias(bias, pack))
    if form == "split":
        wm, wc = pc.pack_weights_split(w, pack)
        out = pc.conv3d_chain_split(
            xc, jnp.asarray(wm.astype(np.int8)),
            jnp.asarray(wc.astype(np.int8)), pb, hh, ww // pack, pack, ci,
            scale=ps, zp=True, interpret=True)
    else:
        out = pc.conv3d_chain_q(
            xc, jnp.asarray(pc.pack_weights(w, pack).astype(np.int8)), ps,
            pb, hh, ww // pack, interpret=True, zp=True)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, hh, ww // pack, pack), pack, 1))
    got = kc.conv3d_q_requant(_t(x), _t(w.astype(np.int8)), _t(scale),
                              _t(bias)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got[1, 0, 2, 0]) == -127


# --------------------------------------------------------------------------
# K2q
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pack,c,dhw", [
    (4, 7, (4, 8, 32)), (2, 14, (4, 6, 8)), (16, 3, (2, 4, 32)),
])
def test_k2q_matches_pallas(rng, pack, c, dhw):
    d, hh, ww = dhw
    x = _i8(rng, (d, hh, ww, c))
    wp = ww // pack
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * c)), pack,
                     fill=-128)
    out = pc.maxpool2_chain(xc, hh, wp, pack, c, interpret=True, fill=-128)
    half = pack // 2
    want = pc.unpack_output(pc.from_chain(out, hh // 2, wp, half * c), half,
                            c)
    got = kc.maxpool2_q(_t(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# K3q (and the bf16 K3 against the full-tap K4b form)
# --------------------------------------------------------------------------


def _k3_case(rng, dual, pin, dhw, int8):
    """Operands of one fused upconv with the engine's lane layout: operand
    a's channels then its ones lane, operand b's channels then its ones
    lane, whose composite row is zero (``augment_upconv_kernel``)."""
    dh, hh, ww = dhw
    ca, cb, co = 3, (2 if dual else 0), 4
    cin = ca + 1 + (cb + 1 if dual else 0)
    if int8:
        R = rng.integers(-60, 61, (4, 4, 4, cin, co)).astype(np.float32)
        a = _i8(rng, (dh, hh, ww, ca))
        b = _i8(rng, (dh, hh, ww, cb))
    else:
        R = (rng.standard_normal((4, 4, 4, cin, co)) * 0.3).astype(
            np.float32)
        a = rng.standard_normal((dh, hh, ww, ca)).astype(np.float32)
        b = rng.standard_normal((dh, hh, ww, cb)).astype(np.float32)
    if dual:
        R[:, :, :, -1] = 0.0
    return R, a, b, ca, cb, co


def _chain(v, one, pin, fill):
    dh, hh, ww = v.shape[:3]
    v = np.concatenate([v, np.full(v.shape[:3] + (1,), one, v.dtype)], -1)
    return pc.to_chain(jnp.asarray(v.reshape(dh, hh, ww // pin, -1)), pin,
                       fill=fill)


@pytest.mark.parametrize("form", ["split", "full"])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("pin,dhw", [(4, (4, 8, 32)), (2, (2, 2, 8))])
def test_k3q_matches_pallas(rng, form, dual, pin, dhw):
    """K3q's plain version against ``upconv_fused_chain_split(scale2=,
    zp=True)`` and ``upconv_fused_chain`` (K4b): halos read -128 in every
    lane, the ones lane 127 inside, and the bias row follows the output
    parity (4 rows with x parity in the lanes there, 8 rows here)."""
    dh, hh, ww = dhw
    wp = ww // pin
    R, a, b, ca, cb, co = _k3_case(rng, dual, pin, dhw, int8=True)
    scale = (rng.random(co) * 0.01 + 0.001).astype(np.float32)
    base = rng.standard_normal(co).astype(np.float32)
    ci_split = ca + 1 if dual else None
    pout = 2 * pin
    scale_lane = uc.pack_out_bias(scale, pout)[0]
    base_lane = uc.pack_out_bias(base, pout)[0]
    s2 = jnp.asarray(uc.pack_out_bias(scale, pout))
    a_c = _chain(a, 127, pin, -128)
    b_c = _chain(b, 127, pin, -128) if dual else None
    if form == "split":
        sa, sb = uc.build_upconv_matrices_split(R, pin, ci_split)
        colsum = sum(m.sum(axis=(2, 3)) for m in
                     (sa[0], sa[1]) + ((sb[0], sb[1]) if dual else ()))
    else:
        ma, mb = uc.build_upconv_matrices(R, pin, ci_split)
        colsum = ma.sum(axis=(2, 3)) + (mb.sum(axis=(2, 3)) if dual else 0)
    b4 = jnp.asarray(np.stack([
        (base_lane + 128.0 * colsum[i, j] * scale_lane).astype(np.float32)
        for i in range(2) for j in range(2)]))
    if form == "split":
        q8 = lambda m: jnp.asarray(m.astype(np.int8))  # noqa: E731
        out = uc.upconv_fused_chain_split(
            a_c, (q8(sa[0]), q8(sa[1])), b4, hh, wp, pin, ca + 1,
            b_chain=b_c, split_b=(q8(sb[0]), q8(sb[1])) if dual else None,
            cw_b=cb + 1 if dual else 0, scale2=s2, interpret=True, zp=True)
    else:
        out = uc.upconv_fused_chain(
            a_c, jnp.asarray(ma.astype(np.int8)), b4, hh, wp, b_chain=b_c,
            mats_b=jnp.asarray(mb.astype(np.int8)) if dual else None,
            scale2=s2, interpret=True, zp=True)
    want = pc.unpack_output(pc.from_chain(out, 2 * hh, wp, pout * co), pout,
                            co)
    wa, wone, wb = ku.split_response(_t(R.astype(np.int8)),
                                       ca if dual else None)
    bias8 = tq.parity_bias(R, base, scale)
    got = ku.upconv_q_requant(_t(a), _t(b) if dual else None, wa, wb, wone,
                              _t(scale), _t(bias8))
    assert got.dtype == torch.int8 and got.shape == (2 * dh, 2 * hh, 2 * ww,
                                                     co)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["split", "full"])
def test_k3q_epilogue_rounds_once_like_pallas(form):
    """As K1q: one rounding for ``acc * scale + bias``. Only the composite
    tap R[1, 1, 1] is nonzero, so the even output voxel 2m sees a[m]."""
    pin, (dh, hh, ww), ca, co = 2, (2, 2, 4), FMA_ACC_X.size, 1
    a = np.full((dh, hh, ww, ca), -128, np.int8)
    a[1, 0, 2] = FMA_ACC_X
    R = np.zeros((4, 4, 4, ca + 1, co), np.float32)
    R[1, 1, 1, :ca, 0] = FMA_ACC_W
    scale = np.array([FMA_SCALE])
    b4 = jnp.asarray(np.repeat(uc.pack_out_bias(
        np.full(co, FMA_BIAS, np.float32), 2 * pin), 4, axis=0))
    s2 = jnp.asarray(uc.pack_out_bias(scale, 2 * pin))
    a_c = _chain(a, 127, pin, -128)
    if form == "split":
        sa, _ = uc.build_upconv_matrices_split(R, pin, None)
        out = uc.upconv_fused_chain_split(
            a_c, tuple(jnp.asarray(m.astype(np.int8)) for m in sa), b4, hh,
            ww // pin, pin, ca + 1, scale2=s2, interpret=True, zp=True)
    else:
        ma, _ = uc.build_upconv_matrices(R, pin, None)
        out = uc.upconv_fused_chain(
            a_c, jnp.asarray(ma.astype(np.int8)), b4, hh, ww // pin,
            scale2=s2, interpret=True, zp=True)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, 2 * hh, ww // pin, 2 * pin * co), 2 * pin, co))
    wa, wone, _ = ku.split_response(_t(R.astype(np.int8)), None)
    got = ku.upconv_q_requant(_t(a), None, wa, None, wone, _t(scale),
                              _t(np.full((8, co), FMA_BIAS, np.float32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[2, 0, 4, 0]) == -127


@pytest.mark.parametrize("dual", [False, True])
def test_k3_matches_pallas_full_taps(rng, dual):
    """The bf16 K3's plain version against the full-tap
    ``upconv_fused_chain`` (K4b's float mode), f32 data."""
    pin, dhw = 4, (4, 8, 32)
    dh, hh, ww = dhw
    wp = ww // pin
    R, a, b, ca, cb, co = _k3_case(rng, dual, pin, dhw, int8=False)
    bias = rng.standard_normal(co).astype(np.float32)
    ci_split = ca + 1 if dual else None
    ma, mb = uc.build_upconv_matrices(R, pin, ci_split)
    out = uc.upconv_fused_chain(
        _chain(a, 1.0, pin, 0), jnp.asarray(ma),
        jnp.asarray(uc.pack_out_bias(bias, 2 * pin)), hh, wp,
        b_chain=_chain(b, 1.0, pin, 0) if dual else None,
        mats_b=jnp.asarray(mb) if dual else None, interpret=True)
    want = pc.unpack_output(pc.from_chain(out, 2 * hh, wp, 2 * pin * co),
                            2 * pin, co)
    wa, wone, wb = ku.split_response(_t(R), ca if dual else None)
    got = ku.upconv_bn_relu(_t(a), _t(b) if dual else None, wa, wb, wone,
                            _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# quantized operands, bit-equal to ctunet_tpu.engine_q before packing
# --------------------------------------------------------------------------


def _unit(rng, cin, cout):
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    bn = dict(scale=rng.random(cout).astype(np.float32) + 0.5,
              bias=rng.standard_normal(cout).astype(np.float32))
    st = dict(mean=rng.standard_normal(cout).astype(np.float32) * 0.1,
              var=rng.random(cout).astype(np.float32) + 0.1)
    unit = _FusedUnit({"conv": {"kernel": w}, "bn": bn}, {"bn": st},
                      interpret=True)
    return unit, (unit.w, unit.scale, unit.bias)


def _capture(monkeypatch, module, name, store):
    orig = getattr(module, name)

    def spy(arr, *a, **k):
        store.append(np.array(arr))
        return orig(arr, *a, **k)

    monkeypatch.setattr(module, name, spy)


def _override(rng, q, k, co):
    flip = rng.integers(-1, 2, q.shape).astype(np.float32)
    return {"q": np.clip(q + flip, -127, 127).astype(np.float32),
            "k": np.asarray(k, np.float32)[:co] * 1.01,
            "db": (rng.standard_normal(co) * 1e-2).astype(np.float32)}


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("with_override", [False, True])
def test_quant_conv_bit_equal(rng, monkeypatch, split, with_override):
    cin, cout = 5, 7
    unit, unit_np = _unit(rng, cin, cout)
    s_in = (rng.random(cin + 1) * 0.02 + 1e-3).astype(np.float32)
    s_out = (rng.random(cout + 1) * 0.02 + 1e-3).astype(np.float32)
    s_in[-1] = s_out[-1] = jq._Q1
    ov = None
    if with_override:
        q, k, _, _ = tq.quant_conv(*unit_np, s_in, s_out)
        ov = _override(rng, q, k, cout)
    weights, biases = [], []
    name = "pack_weights_split" if split else "pack_weights"
    _capture(monkeypatch, pc, name, weights)
    _capture(monkeypatch, pc, "pack_bias", biases)
    jq._quant_conv(unit, s_in, s_out, 2, ov, split=split)
    q_w, k, s, b = tq.quant_conv(*unit_np, s_in, s_out, ov)
    np.testing.assert_array_equal(weights[0][..., :cin, :cout], q_w)
    assert (weights[0][..., cin, :] == 0).all()  # the ones lane's row
    np.testing.assert_array_equal(biases[0][:cout], s)
    np.testing.assert_array_equal(biases[1][:cout], b)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dual,with_override", [
    (False, False), (True, False), (True, True)])
def test_quant_upconv_bit_equal(rng, monkeypatch, split, dual,
                                with_override):
    """The composite ``r_q``, the requant scale and the per-parity bias
    (the JAX rows hold (z, y) parity with x parity in the lanes)."""
    ca, cb, ct, co, pa = 4, 3, 5, 6, 2
    cin = ca + cb if dual else ca
    kk = (rng.standard_normal((2, 2, 2, ct, cin)) * 0.3).astype(np.float32)
    bb = rng.standard_normal(ct).astype(np.float32)
    unit, unit_np = _unit(rng, ct, co)
    s_a = (rng.random((ca if dual else cin) + 1) * 0.02 + 1e-3).astype(
        np.float32)
    s_b = (rng.random(cb + 1) * 0.02 + 1e-3).astype(np.float32) if dual \
        else None
    s_out = (rng.random(co + 1) * 0.02 + 1e-3).astype(np.float32)
    for s in (s_a, s_out) + ((s_b,) if dual else ()):
        s[-1] = jq._Q1
    ca_arg = ca if dual else None
    ov = None
    if with_override:
        r_q, k, _, _ = tq.quant_upconv(kk, bb, unit_np, ca_arg, s_a, s_b,
                                       s_out)
        ov = _override(rng, r_q, k, co)
    mats, lanes = [], []
    name = "build_upconv_matrices_split" if split else "build_upconv_matrices"
    _capture(monkeypatch, uc, name, mats)
    _capture(monkeypatch, uc, "pack_out_bias", lanes)
    out = jq._quant_upconv((kk, bb), unit, ca_arg, s_a, s_b, s_out, pa, ov,
                           split=split)
    r_q, k, s, bias8 = tq.quant_upconv(kk, bb, unit_np, ca_arg, s_a, s_b,
                                       s_out, ov)
    np.testing.assert_array_equal(mats[0][..., :co], r_q)
    np.testing.assert_array_equal(lanes[0][:co], s)
    bias4 = np.asarray(out[3])
    cpo = co + 1
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                np.testing.assert_array_equal(
                    bias4[2 * pz + py, px * cpo: px * cpo + co],
                    bias8[4 * pz + 2 * py + px])
