"""PyTorch port, kernels K1-K3: plain versions against the Pallas kernels.

The same inputs, made from a numpy seed, go through the Pallas kernel of
``ctunet_tpu`` (``interpret=True``, f32 ``out_dtype``, laid out with
``to_chain`` and read back with ``from_chain``/``unpack_output`` as
``tests/test_split_taps.py`` does) and through the port's kernel wrapper,
which on a CPU tensor runs its plain PyTorch version. Tolerance atol/rtol
1e-4: both sides are f32 and differ only in summation order. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import upconv as ku

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("pack,cin,cout,dhw", [
    (4, 3, 5, (6, 8, 32)),
    (2, 7, 7, (6, 8, 32)),
    (8, 2, 7, (6, 8, 32)),
    (1, 5, 3, (6, 8, 32)),
    (2, 7, 7, (2, 2, 4)),   # every voxel touches a border
])
def test_k1_conv_matches_pallas_split(rng, pack, cin, cout, dhw):
    d, hh, ww = dhw
    x = rng.standard_normal((d, hh, ww, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    wp = ww // pack
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * cin)), pack)
    wm, wc = pc.pack_weights_split(w, pack)
    out = pc.conv3d_chain_split(
        xc, jnp.asarray(wm), jnp.asarray(wc),
        jnp.asarray(pc.pack_bias(b, pack)), hh, wp, pack, cin,
        interpret=True, out_dtype=jnp.float32,
    )
    want = pc.unpack_output(pc.from_chain(out, hh, wp, pack * cout), pack,
                            cout)
    got = kc.conv3d_bn_relu(_t(x), _t(w), _t(b))
    assert got.dtype == torch.float32 and got.shape == (d, hh, ww, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k1_fold_matches_jax_engine(rng):
    """BN fold and weight rounding are those of ``engine._FusedUnit``:
    ``w*scale`` in f32, then bf16; bias f32 — bit for bit."""
    from ctunet_tpu.engine import _FusedUnit

    cin, cout = 7, 14
    w = rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32)
    bn = dict(scale=rng.random(cout).astype(np.float32) + 0.5,
              bias=rng.standard_normal(cout).astype(np.float32))
    st = dict(mean=rng.standard_normal(cout).astype(np.float32),
              var=rng.random(cout).astype(np.float32) + 0.1)
    unit = _FusedUnit({"conv": {"kernel": w}, "bn": bn}, {"bn": st},
                      interpret=True)
    wf, bias = kc.fold_conv_unit(
        _t(w.transpose(4, 3, 0, 1, 2)), None, _t(bn["scale"]),
        _t(bn["bias"]), _t(st["mean"]), _t(st["var"]))
    want_w = jnp.asarray(unit.w * unit.scale[None, None, None, None, :],
                         jnp.bfloat16)
    assert wf.dtype == torch.bfloat16 and bias.dtype == torch.float32
    np.testing.assert_array_equal(wf.float().numpy(),
                                  np.asarray(want_w, np.float32))
    np.testing.assert_array_equal(bias.numpy(), unit.bias)


@pytest.mark.parametrize("pack,c,dhw", [
    (4, 7, (4, 8, 32)), (2, 14, (4, 6, 8)), (16, 3, (2, 4, 32)),
])
def test_k2_pool_matches_pallas(rng, pack, c, dhw):
    d, hh, ww = dhw
    x = rng.standard_normal((d, hh, ww, c)).astype(np.float32)
    wp = ww // pack
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * c)), pack)
    out = pc.maxpool2_chain(xc, hh, wp, pack, c, interpret=True)
    half = pack // 2
    want = pc.unpack_output(
        pc.from_chain(out, hh // 2, wp, half * c), half, c)
    got = kc.maxpool2(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k2_pool_is_f_max_pool3d(rng):
    x = _t(rng.standard_normal((5, 6, 7, 3)).astype(np.float32))
    want = torch.nn.functional.max_pool3d(x.permute(3, 0, 1, 2)[None], 2)
    assert torch.equal(kc.maxpool2(x), want[0].permute(1, 2, 3, 0))


def test_k3_composite_matches_jax(rng):
    """The port's copies of ``augment_upconv_kernel`` / ``composite_response``
    give the JAX package's arrays exactly."""
    kk = rng.standard_normal((2, 2, 2, 6, 6)).astype(np.float32)
    bb = rng.standard_normal(6).astype(np.float32)
    w0 = rng.standard_normal((3, 3, 3, 6, 4)).astype(np.float32)
    s0 = rng.random(4).astype(np.float32)
    for ca in (None, 2):
        ka, sa = ku.augment_upconv_kernel(kk, bb, ca)
        kb, sb = uc.augment_upconv_kernel(kk, bb, ca)
        assert sa == sb
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(ku.composite_response(ka, w0, s0),
                                      uc.composite_response(kb, w0, s0))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("pin,dhw", [(4, (4, 8, 32)), (2, (2, 2, 8))])
def test_k3_upconv_matches_pallas_split(rng, dual, pin, dhw):
    """Fused upsample+conv from half-resolution operands; ``(2, 2, 8)``
    makes every output voxel a border voxel, where the convT bias (the
    ones channel, 1 inside and 0 outside) depends on position."""
    dh, hh, ww = dhw
    wp = ww // pin
    ca, cb, ct, co = 3, (2 if dual else 0), 5, 4
    kk = (rng.standard_normal((2, 2, 2, ct, ca + cb)) * 0.3).astype(
        np.float32)
    bb = rng.standard_normal(ct).astype(np.float32)
    w0 = (rng.standard_normal((3, 3, 3, ct, co)) * 0.3).astype(np.float32)
    b0 = rng.standard_normal(co).astype(np.float32)
    kT, ci_split = uc.augment_upconv_kernel(kk, bb, ca if dual else None)
    R = uc.composite_response(kT, w0)
    sa, sb = uc.build_upconv_matrices_split(R, pin, ci_split)
    a = rng.standard_normal((dh, hh, ww, ca)).astype(np.float32)
    b = rng.standard_normal((dh, hh, ww, cb)).astype(np.float32)
    ones = np.ones((dh, hh, ww, 1), np.float32)

    def chain(v):  # operand + its ones lane, chained at pack pin
        v = np.concatenate([v, ones], -1)
        return pc.to_chain(jnp.asarray(v.reshape(dh, hh, wp, -1)), pin)

    cw_a = ca + 1
    cw_b = cb + 1 if dual else 0
    out = uc.upconv_fused_chain_split(
        chain(a), (jnp.asarray(sa[0]), jnp.asarray(sa[1])),
        jnp.asarray(uc.pack_out_bias(b0, 2 * pin)), hh, wp, pin, cw_a,
        b_chain=chain(b) if dual else None,
        split_b=(jnp.asarray(sb[0]), jnp.asarray(sb[1])) if dual else None,
        cw_b=cw_b, interpret=True,
    )
    want = pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, 2 * pin * co), 2 * pin, co)
    wa, wone, wb = ku.split_response(_t(R), ca if dual else None)
    got = ku.upconv_bn_relu(_t(a), _t(b) if dual else None, wa, wb, wone,
                            _t(b0))
    assert got.shape == (2 * dh, 2 * hh, 2 * ww, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k3_border_bias_is_position_dependent(rng):
    """A constant convT bias added everywhere would be wrong within one
    voxel of each face: the fused result equals ConvT then conv with zero
    padding of the UPSAMPLED tensor only when the ones channel is 0 outside
    the volume."""
    d2 = (2, 3, 2)
    ca, ct, co = 2, 3, 2
    up_w = _t(rng.standard_normal((ca, ct, 2, 2, 2)).astype(np.float32))
    up_b = _t(rng.standard_normal(ct).astype(np.float32) + 2.0)
    conv_w = _t(rng.standard_normal((co, ct, 3, 3, 3)).astype(np.float32))
    ones = torch.ones(co)
    wa, wb, wone, bias = ku.prepare_upconv(
        up_w, up_b, conv_w, None, ones, torch.zeros(co), torch.zeros(co),
        ones - 1e-5, None, dtype=torch.float32)
    a = _t(rng.standard_normal(d2 + (ca,)).astype(np.float32))
    got = ku.upconv_bn_relu(a, None, wa, wb, wone, bias)
    up = torch.nn.functional.conv_transpose3d(
        a.permute(3, 0, 1, 2)[None], up_w, up_b, stride=2)
    want = torch.relu(torch.nn.functional.conv3d(up, conv_w, padding=1))
    np.testing.assert_allclose(got.numpy(),
                               want[0].permute(1, 2, 3, 0).numpy(), **TOL)


def test_cuda_wrappers_refuse_other_devices():
    x = torch.zeros((2, 2, 2, 1), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.maxpool2(x)
