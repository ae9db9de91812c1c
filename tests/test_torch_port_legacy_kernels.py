"""PyTorch port, legacy-path kernels K5 (k=5 conv) and K7a/K7b (ConvT
k2s2): plain versions against the Pallas kernels; and the parity tests that
close the TPU kernels without a caller (K8a, K8b, K8c) and the probe
replica P, against the plain versions of the port's kernels that compute
the same functions.

The same inputs, made from a numpy seed, go through the Pallas kernel of
``ctunet_tpu`` in interpret mode and through the port's wrapper, which on a
CPU tensor runs its plain PyTorch version. Tolerances: f32 on both sides
differs only in summation order (atol 1e-5 of the largest output for K5's
125-tap sums, 1e-4 elsewhere as ``tests/test_torch_port_kernels.py``);
bf16 outputs are each rounded once from f32 sums taken in different
orders, so they may land one bf16 ulp apart: 2 ulps of the largest output.
int8 comparisons are exact. The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ctunet_tpu.engine import _conv_transpose_k2s2
from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import convt as ct
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import convt as kt
from ctunet_tpu_torch.ops.kernels import upconv as ku

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _bf16_tol(ref: np.ndarray) -> float:
    """2 bf16 ulps at the largest magnitude of ``ref``."""
    m = float(np.abs(ref).max())
    return 2.0 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(m))


# --------------------------------------------------------------------------
# K5: Conv3D(k5, SAME) + bias + optional ReLU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,relu", [("float32", True),
                                        ("float32", False),
                                        ("bfloat16", True)])
def test_k5_plain_matches_pallas_conv3d_fused(rng, dtype, relu):
    """``conv3d5_bias_act_plain`` on the operands ``fold_conv_unit`` makes
    (BN folded in f32, weights rounded once to the dtype, f32 bias with the
    conv bias folded in) against ``conv3d_k3`` -> ``conv3d_fused`` at k=5
    (pack 2, H a multiple of 8: the Pallas kernel itself runs)."""
    d, hh, ww, cin, cout = 8, 16, 16, 7, 14
    x = rng.random((d, hh, ww, cin)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 5, cin, cout)) * 0.1).astype(np.float32)
    cb = rng.standard_normal(cout).astype(np.float32) * 0.1
    bn = (rng.random(cout).astype(np.float32) + 0.5,
          rng.standard_normal(cout).astype(np.float32) * 0.1,
          rng.standard_normal(cout).astype(np.float32) * 0.1,
          rng.random(cout).astype(np.float32) + 0.5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x, jdt)
    want = _f32(pc.conv3d_k3(xj, w, bias=cb, bn=bn, pack=2, relu=relu,
                             interpret=True, out_dtype=jdt))
    wf, bias = kc.fold_conv_unit(_t(w.transpose(4, 3, 0, 1, 2)), _t(cb),
                                 *(_t(a) for a in bn), dtype=tdt)
    got = kc.conv3d5_bias_act(_t(_f32(xj)).to(tdt), wf, bias, relu)
    assert got.dtype == tdt and got.shape == (d, hh, ww, cout)
    assert float(np.abs(want).max()) > 0.1
    atol = (1e-5 * float(np.abs(want).max()) if dtype == "float32"
            else _bf16_tol(want))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_k5_plain_is_the_k5_conv_at_ragged_shapes(rng):
    """The ragged shapes the Pallas kernel leaves to XLA (the 14x19x19
    center) are the same function: ``padding=2`` SAME conv, every voxel
    within two of a face."""
    x = _t(rng.standard_normal((3, 5, 7, 4)).astype(np.float32))
    w = _t(rng.standard_normal((5, 5, 5, 4, 3)).astype(np.float32))
    b = _t(rng.standard_normal(3).astype(np.float32))
    want = torch.zeros((3, 5, 7, 3))
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2, 2, 2))
    for dz in range(5):
        for dy in range(5):
            for dx in range(5):
                want += xp[dz:dz + 3, dy:dy + 5, dx:dx + 7] @ w[dz, dy, dx]
    got = kc.conv3d5_bias_act(x, w, b, relu=False)
    np.testing.assert_allclose(got.numpy(), (want + b).numpy(), **TOL)


# --------------------------------------------------------------------------
# K7a / K7b: ConvT(k2, s2) + bias
# --------------------------------------------------------------------------


def _convt_case(rng, ca, cb, co, dhw=(4, 8, 8)):
    a = rng.standard_normal(dhw + (ca,)).astype(np.float32)
    b = rng.standard_normal(dhw + (cb,)).astype(np.float32)
    kern = (rng.standard_normal((2, 2, 2, co, ca + cb)) * 0.3).astype(
        np.float32)  # flax transpose_kernel layout (2, 2, 2, O, I)
    bias = rng.standard_normal(co).astype(np.float32)
    return a, b, kern, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dual", [False, True])
def test_k7_plain_matches_pallas(rng, dtype, dual):
    """K7a against ``conv_transpose_k2s2`` + ``unpack2`` and K7b against
    ``conv_transpose_k2s2_dual`` + ``unpack2`` (Wh % 8 == 0)."""
    ca, cb, co = 7, 7, 14
    a, b, kern, bias = _convt_case(rng, ca, cb if dual else 0, co)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    aj, bj = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    if dual:
        ma, pb = ct.build_matrices(kern[..., :ca], bias)
        mb, _ = ct.build_matrices(kern[..., ca:], bias)
        out = ct.conv_transpose_k2s2_dual(aj, bj, jnp.asarray(ma),
                                          jnp.asarray(mb), jnp.asarray(pb),
                                          interpret=True)
    else:
        ma, pb = ct.build_matrices(kern, bias)
        out = ct.conv_transpose_k2s2(aj, jnp.asarray(ma), jnp.asarray(pb),
                                     interpret=True)
    want = _f32(ct.unpack2(out, co))
    wa, wb, bi = kt.convt_weights(_t(kern.transpose(4, 3, 0, 1, 2)),
                                  _t(bias), ca if dual else None, tdt)
    at = _t(_f32(aj)).to(tdt)
    if dual:
        got = kt.convt_k2s2_dual(at, _t(_f32(bj)).to(tdt), wa, wb, bi)
    else:
        got = kt.convt_k2s2(at, wa, bi)
    assert got.dtype == tdt and got.shape == (8, 16, 16, co)
    atol = 1e-4 if dtype == "float32" else _bf16_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_k7_plain_matches_engine_einsum(rng):
    """The legacy engine's own ConvT (``engine._conv_transpose_k2s2`` on
    the materialized concat) in f32: the same function, weight-split."""
    ca, cb, co = 5, 3, 6
    a, b, kern, bias = _convt_case(rng, ca, cb, co, dhw=(3, 2, 5))
    want = np.asarray(_conv_transpose_k2s2(
        jnp.asarray(np.concatenate([a, b], -1)), jnp.asarray(kern),
        jnp.asarray(bias)))
    wa, wb, bi = kt.convt_weights(_t(kern.transpose(4, 3, 0, 1, 2)),
                                  _t(bias), ca, torch.float32)
    got = kt.convt_k2s2_dual(_t(a), _t(b), wa, wb, bi)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# K8c: conv_transpose_chain (K7's function on the chain layout)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dual", [False, True])
def test_k8c_conv_transpose_chain_matches_k7_plain(rng, dual):
    pa, (dh, hh, ww) = 2, (3, 4, 8)
    wp = ww // pa
    ca, cb, co = 3, 2, 4
    a, b, kern, bias = _convt_case(rng, ca, cb if dual else 0, co,
                                   dhw=(dh, hh, ww))
    ma, pb = ct.build_chain_matrices(kern[..., :ca], bias, pa)
    chain = lambda v: pc.to_chain(  # noqa: E731
        jnp.asarray(v.reshape(dh, hh, wp, -1)), pa)
    kw = {}
    if dual:
        mb, _ = ct.build_chain_matrices(kern[..., ca:], bias, pa)
        kw = dict(b_chain=chain(b), mats_b=jnp.asarray(mb))
    out = ct.conv_transpose_chain(chain(a), jnp.asarray(ma),
                                  jnp.asarray(pb), hh, wp, interpret=True,
                                  **kw)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, 2 * pa * co), 2 * pa, co))
    wa, wb, bi = kt.convt_weights(_t(kern.transpose(4, 3, 0, 1, 2)),
                                  _t(bias), ca if dual else None,
                                  torch.float32)
    got = (kt.convt_k2s2_dual(_t(a), _t(b), wa, wb, bi) if dual
           else kt.convt_k2s2(_t(a), wa, bi))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------
# K8a: conv3d_chain_v3 (K1's / K1q's function, dy-stacked)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["float", "int8_zp"])
def test_k8a_conv3d_chain_v3_matches_k1_plain(rng, mode):
    pack, (d, hh, ww), cin, cout = 4, (3, 8, 16), 5, 6
    wp = ww // pack
    b = rng.standard_normal(cout).astype(np.float32)
    pb = jnp.asarray(pc.pack_bias(b, pack))
    if mode == "float":
        x = rng.standard_normal((d, hh, ww, cin)).astype(np.float32)
        w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.3).astype(
            np.float32)
        xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, -1)), pack)
        out = pc.conv3d_chain_v3(
            xc, jnp.asarray(pc.pack_weights_stacked(w, pack)), pb, hh, wp,
            interpret=True, out_dtype=jnp.float32)
        got = kc.conv3d_bn_relu(_t(x), _t(w), _t(b))
    else:
        x = rng.integers(-128, 128, (d, hh, ww, cin)).astype(np.int8)
        w = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.float32)
        scale = (rng.random(cout) * 0.01 + 0.001).astype(np.float32)
        xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, -1)), pack,
                         fill=-128)
        out = pc.conv3d_chain_v3(
            xc, jnp.asarray(pc.pack_weights_stacked(w, pack).astype(np.int8)),
            pb, hh, wp, interpret=True,
            scale=jnp.asarray(pc.pack_bias(scale, pack)), zp=True)
        got = kc.conv3d_q_requant(_t(x), _t(w.astype(np.int8)), _t(scale),
                                  _t(b), zp=True)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, hh, wp, pack * cout), pack, cout))
    if mode == "float":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# K8b: upconv_fused_chain_v3 (K3's / K3q's function, stacked)
# --------------------------------------------------------------------------


def _chain_ones(v, one, pin, fill):
    """Operand + its ones lane, chained at pack ``pin`` (the engine's lane
    layout, ``tests/test_torch_port_int8_kernels.py``)."""
    dh, hh, ww = v.shape[:3]
    v = np.concatenate([v, np.full(v.shape[:3] + (1,), one, v.dtype)], -1)
    return pc.to_chain(jnp.asarray(v.reshape(dh, hh, ww // pin, -1)), pin,
                       fill=fill)


@pytest.mark.parametrize("mode", ["float", "int8_zp"])
def test_k8b_upconv_fused_chain_v3_matches_k3_plain(rng, mode):
    pin, (dh, hh, ww) = 4, (3, 4, 16)
    wp = ww // pin
    ca, cb, co = 3, 2, 4
    cin = ca + 1 + cb + 1
    int8 = mode == "int8_zp"
    if int8:
        R = rng.integers(-60, 61, (4, 4, 4, cin, co)).astype(np.float32)
        a = rng.integers(-128, 128, (dh, hh, ww, ca)).astype(np.int8)
        b = rng.integers(-128, 128, (dh, hh, ww, cb)).astype(np.int8)
    else:
        R = (rng.standard_normal((4, 4, 4, cin, co)) * 0.3).astype(
            np.float32)
        a = rng.standard_normal((dh, hh, ww, ca)).astype(np.float32)
        b = rng.standard_normal((dh, hh, ww, cb)).astype(np.float32)
    R[:, :, :, -1] = 0.0  # operand b's ones lane carries no response
    ma, mb = uc.build_upconv_matrices(R, pin, ca + 1)
    base = rng.standard_normal(co).astype(np.float32)
    wa, wone, wb = ku.split_response(_t(R.astype(np.int8) if int8 else R),
                                     ca)
    if int8:
        from ctunet_tpu_torch import engine_q as tq

        scale = (rng.random(co) * 0.01 + 0.001).astype(np.float32)
        scale_lane = uc.pack_out_bias(scale, 2 * pin)[0]
        base_lane = uc.pack_out_bias(base, 2 * pin)[0]
        colsum = ma.sum(axis=(2, 3)) + mb.sum(axis=(2, 3))
        b4 = jnp.asarray(np.stack([
            (base_lane + 128.0 * colsum[i, j] * scale_lane).astype(np.float32)
            for i in range(2) for j in range(2)]))
        q8 = lambda m: jnp.asarray(  # noqa: E731
            uc.stack_upconv_matrices(m.astype(np.int8)))
        out = uc.upconv_fused_chain_v3(
            _chain_ones(a, 127, pin, -128), q8(ma), b4, hh, wp,
            b_chain=_chain_ones(b, 127, pin, -128), mats_b=q8(mb),
            scale2=jnp.asarray(uc.pack_out_bias(scale, 2 * pin)),
            interpret=True, zp=True)
        got = ku.upconv_q_requant(_t(a), _t(b), wa, wb, wone, _t(scale),
                                  _t(tq.parity_bias(R, base, scale)))
    else:
        st = lambda m: jnp.asarray(uc.stack_upconv_matrices(m))  # noqa: E731
        out = uc.upconv_fused_chain_v3(
            _chain_ones(a, 1.0, pin, 0), st(ma),
            jnp.asarray(uc.pack_out_bias(base, 2 * pin)), hh, wp,
            b_chain=_chain_ones(b, 1.0, pin, 0), mats_b=st(mb),
            interpret=True)
        got = ku.upconv_bn_relu(_t(a), _t(b), wa, wb, wone, _t(base))
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, 2 * pin * co), 2 * pin, co))
    assert got.shape == (2 * dh, 2 * hh, 2 * ww, co)
    if int8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------
# P: the probe's replica of conv3d_chain_q (tools/probes/mb_tap_sweep.py)
# --------------------------------------------------------------------------


def test_probe_replica_at_27_taps_matches_k1q_plain(rng):
    """``mb_tap_sweep.py::run_q`` builds ``conv3d_chain_q``'s pallas_call
    with a truncated tap list to time it; at all 27 taps it is K1q's
    function. The replica's construction, at a small shape, in interpret
    mode (the probe itself runs at 224x304x304 when imported)."""
    D, H, W, pack, cw, cout = 3, 8, 16, 4, 8, 8
    wp = W // pack
    xq = rng.integers(-128, 128, (D, H, W, cw)).astype(np.int8)
    xc = pc.to_chain(jnp.asarray(xq.reshape(D, H, wp, pack * cw)), pack,
                     fill=-128)
    w = rng.integers(-20, 21, (3, 3, 3, cw, cout)).astype(np.float32)
    scale = (rng.random(cout) * 0.001 + 0.0005).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    ps = jnp.asarray(pc.pack_bias(scale, pack))
    pb = jnp.asarray(pc.pack_bias(bias, pack))
    pw = jnp.asarray(pc.pack_weights(w, pack).astype(np.int8))
    dp2, rows, cin_p = xc.shape
    wpad = rows // (H + 2)
    cout_p = pw.shape[2]
    ht = H
    n_h, rout, dma_rows = H // ht, ht * wpad, (ht + 2) * wpad
    taps = tuple((dz, dy * wpad + t + 7)
                 for dz in range(3) for dy in range(3) for t in range(3))
    kern = functools.partial(
        pc._chain_kernel_ring_q, taps=taps, rout=rout, dma_rows=dma_rows,
        relu=True, wp=wp, wpad=wpad, ht=ht, n_h=n_h, hh=H, d=D, zp=True,
        gh=0)
    out = pl.pallas_call(
        kern, grid=(n_h, D),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
        out_shape=jax.ShapeDtypeStruct((dp2, rows, cout_p), jnp.int8),
        scratch_shapes=[
            pltpu.VMEM((4, dma_rows + 16, cin_p), jnp.int8),
            pltpu.VMEM((2, rout, cout_p), jnp.int32),
            pltpu.VMEM((2, rout, cout_p), jnp.int8),
            pltpu.VMEM((max(rout, 2 * wpad), cout_p), jnp.int8),
            pltpu.SemaphoreType.DMA((4,)),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )(xc, pw, ps, pb)
    want = np.asarray(pc.unpack_output(
        pc.from_chain(out, H, wp, pack * cout), pack, cout))
    got = kc.conv3d_q_requant(_t(xq), _t(w.astype(np.int8)), _t(scale),
                              _t(bias), zp=True)
    np.testing.assert_array_equal(got.numpy(), want)

