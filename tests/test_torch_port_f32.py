"""PyTorch port, f32 serving: the f32 kernels of K1, K2, K3, K5 and
K7a/K7b, their routing, and the f32 engines.

- **Plain versions against the Pallas kernels in f32** (interpret mode),
  at shapes where every output voxel lies within one voxel of a face:
  K1 ``conv3d_chain_split``, K2 ``maxpool2_chain`` (exact: a max rounds
  nothing), K3 ``upconv_fused_chain_split`` (one and two operands) and
  K7a/K7b ``conv_transpose_k2s2(_dual)``. Tolerance ``REL`` = 1e-5 of each
  output's largest magnitude: both sides sum the same f32 products in
  different orders (at most a few hundred terms here, each order within
  ~1e-6 relative).
- **Plain-torch emulations of the new f32 CUDA kernels' loops**
  (``csrc/upconv.cu``, ``csrc/convt.cu``, ``csrc/maxpool.cu``) against the
  plain versions at odd shapes (2x3x2, 4x5x9 half resolution): K3's parity
  classes, its two taps per dimension with R index ``3 - p - 2t`` and the
  ones channel added only for taps inside the volume; K7's parity and its
  second operand read by a second pointer; K2's window with odd extents
  flooring and NaN kept. Same tolerance (the max exactly).
- **Routing on a patched card**: ``build.function`` records the symbol it
  is asked for and launches nothing, ``_require_cuda`` passes ``meta``
  tensors. An f32 call of each wrapper asks for its f32 entry (K1, K6 and
  K5: ``ctunet_conv3d_tc_f32``, the f32 tensor-core conv, counted on
  ``conv3d_tc_f32`` too; K3, K7a and K7b: ``ctunet_upconv_tc_f32``, the
  f32 tensor-core upsampling, counted on ``upconv_tc_f32`` too; K2:
  ``ctunet_maxpool2_rows_f32``, counted on ``maxpool2_rows`` too) and never
  for ``conv3d_tc``, ``upconv_tc`` or a bf16 symbol, and counts on its f32
  kernel; the engines
  (``build_predict``, ``build_predict_q`` with an f32 head) build and run
  for that card in f32.
- **The slice on the CPU**: each engine configuration in f32, with its K2,
  K3 and K7 calls served by the kernel emulations, against
  ``ctunet_tpu.engine.build_predict(compute_dtype=float32,
  interpret=True)`` at the JAX engine tests' tolerance (atol 5e-4, rtol
  1e-3, ``tests/test_engine.py``).

Reused, not repeated here: the int8 engine with ``bf16_head = 1`` in f32
against ``ctunet_tpu.engine_q`` (``test_torch_port_int8_mixed.py``), and
``Model`` training with ``conv_impl = chain`` in f32 and serving its masks
(``test_torch_port_train_step.py::test_model_trains_saves_and_serves``).
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` (phases 2 and 7).
"""

import collections
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine as jax_engine
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops.pallas import conv3d as pc
from ctunet_tpu.ops.pallas import convt as ct
from ctunet_tpu.ops.pallas import upconv as uc
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import build
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import convt as kt
from ctunet_tpu_torch.ops.kernels import upconv as ku
from ctunet_tpu_torch.ops.kernels import upsample_tc as ut

torch.set_num_threads(2)

REL = 1e-5  # of each output's largest magnitude
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# --------------------------------------------------------------------------
# plain versions against the Pallas kernels, f32, every face
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pack,cin,cout,dhw", [
    (4, 3, 6, (2, 2, 8)),
    (2, 2, 7, (3, 2, 4)),
    (1, 5, 3, (2, 3, 2)),
])
def test_f32_k1_plain_matches_pallas_split(rng, pack, cin, cout, dhw):
    """K1 in f32: every voxel of these volumes touches a face."""
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
    assert got.dtype == F32
    _close(got.numpy(), want)


@pytest.mark.parametrize("pack,c,dhw", [
    (2, 5, (2, 2, 4)), (2, 8, (4, 2, 8)), (4, 7, (2, 6, 16)),
])
def test_f32_k2_plain_matches_pallas(rng, pack, c, dhw):
    d, hh, ww = dhw
    x = rng.standard_normal((d, hh, ww, c)).astype(np.float32)
    x[0, 0, 0, 0] = -np.inf
    wp = ww // pack
    xc = pc.to_chain(jnp.asarray(x.reshape(d, hh, wp, pack * c)), pack)
    out = pc.maxpool2_chain(xc, hh, wp, pack, c, interpret=True)
    want = pc.unpack_output(
        pc.from_chain(out, hh // 2, wp, pack // 2 * c), pack // 2, c)
    got = kc.maxpool2(_t(x))
    assert got.dtype == F32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("pin,dhw", [(4, (2, 3, 8)), (1, (2, 3, 2)),
                                     (2, (3, 2, 4))])
def test_f32_k3_plain_matches_pallas_split(rng, dual, pin, dhw):
    """K3 in f32 from half-resolution operands at extents of 2-3: every
    output voxel is within one voxel of a face, where the ones channel
    (the convT bias) depends on position."""
    dh, hh, ww = dhw
    wp = ww // pin
    ca, cb, ct_, co = 3, (2 if dual else 0), 5, 4
    kk = (rng.standard_normal((2, 2, 2, ct_, ca + cb)) * 0.3).astype(
        np.float32)
    bb = (rng.standard_normal(ct_) + 1.0).astype(np.float32)
    w0 = (rng.standard_normal((3, 3, 3, ct_, co)) * 0.3).astype(np.float32)
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

    out = uc.upconv_fused_chain_split(
        chain(a), (jnp.asarray(sa[0]), jnp.asarray(sa[1])),
        jnp.asarray(uc.pack_out_bias(b0, 2 * pin)), hh, wp, pin, ca + 1,
        b_chain=chain(b) if dual else None,
        split_b=(jnp.asarray(sb[0]), jnp.asarray(sb[1])) if dual else None,
        cw_b=cb + 1 if dual else 0, interpret=True,
    )
    want = pc.unpack_output(
        pc.from_chain(out, 2 * hh, wp, 2 * pin * co), 2 * pin, co)
    wa, wone, wb = ku.split_response(_t(R), ca if dual else None)
    got = ku.upconv_bn_relu(_t(a), _t(b) if dual else None, wa, wb, wone,
                            _t(b0))
    assert got.dtype == F32 and got.shape == (2 * dh, 2 * hh, 2 * ww, co)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dhw", [(2, 3, 8), (1, 2, 8)])
def test_f32_k7_plain_matches_pallas(rng, dual, dhw):
    """K7a against ``conv_transpose_k2s2``, K7b against
    ``conv_transpose_k2s2_dual`` (both + ``unpack2``; Wh % 8 == 0)."""
    ca, cb, co = 5, 3, 6
    a = rng.standard_normal(dhw + (ca,)).astype(np.float32)
    b = rng.standard_normal(dhw + (cb,)).astype(np.float32)
    nb = cb if dual else 0
    kern = (rng.standard_normal((2, 2, 2, co, ca + nb)) * 0.3).astype(
        np.float32)  # flax transpose_kernel layout (2, 2, 2, O, I)
    bias = rng.standard_normal(co).astype(np.float32)
    if dual:
        ma, pb = ct.build_matrices(kern[..., :ca], bias)
        mb, _ = ct.build_matrices(kern[..., ca:], bias)
        out = ct.conv_transpose_k2s2_dual(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb),
            jnp.asarray(pb), interpret=True)
    else:
        ma, pb = ct.build_matrices(kern, bias)
        out = ct.conv_transpose_k2s2(jnp.asarray(a), jnp.asarray(ma),
                                     jnp.asarray(pb), interpret=True)
    want = np.asarray(ct.unpack2(out, co), np.float32)
    wa, wb, bi = kt.convt_weights(_t(kern.transpose(4, 3, 0, 1, 2)),
                                  _t(bias), ca if dual else None, F32)
    got = (kt.convt_k2s2_dual(_t(a), _t(b), wa, wb, bi) if dual
           else kt.convt_k2s2(_t(a), wa, bi))
    assert got.dtype == F32
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# plain-torch emulations of the f32 CUDA kernels' loops
# --------------------------------------------------------------------------


def emulate_upconv_f32(a, b, wa, wb, wone, bias, ones_inside=True):
    """``csrc/upconv.cu`` in f32: per output parity ``p`` (grid.z) and
    half-resolution voxel ``m`` (a thread), the 8 taps ``t`` in {0,1}^3
    read ``u = m + p - 1 + t`` with weights ``R[3 - p - 2t]``; a tap whose
    ``u`` lies outside is skipped whole, its ones-channel term included
    (``ones_inside=False`` adds that term at every tap instead: the error
    the kernel must not make). f32 sums, then ``relu(acc + bias)``."""
    d2, h2, w2, _ = a.shape
    co = wa.shape[-1]
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    ap = torch.nn.functional.pad(a.float(), pad)
    bp = None if b is None else torch.nn.functional.pad(b.float(), pad)
    inside = torch.nn.functional.pad(torch.ones(d2, h2, w2), pad[2:])
    out = torch.empty(2 * d2, 2 * h2, 2 * w2, co)
    for p in itertools.product((0, 1), repeat=3):
        acc = torch.zeros(d2, h2, w2, co)
        for t in itertools.product((0, 1), repeat=3):
            # u + 1 (the padded index) = m + p + t
            sl = tuple(slice(p[i] + t[i], p[i] + t[i] + n)
                       for i, n in enumerate((d2, h2, w2)))
            k = tuple(3 - p[i] - 2 * t[i] for i in range(3))
            acc = acc + ap[sl] @ wa[k].float()
            if bp is not None:
                acc = acc + bp[sl] @ wb[k].float()
            live = inside[sl][..., None] if ones_inside else 1.0
            acc = acc + live * wone[k].float()
        out[p[0]::2, p[1]::2, p[2]::2] = torch.relu(acc + bias.float())
    return out.to(a.dtype)


def emulate_convt_f32(a, b, wa, wb, bias):
    """``csrc/convt.cu`` in f32: one thread per output voxel ``v``, parity
    ``(z & 1, y & 1, x & 1)``, input voxel ``v >> 1``; operand a's channels
    then, by a second pointer, operand b's (the concat is never built), then
    the bias."""
    d, h, w, _ = a.shape
    zo, yo, xo = torch.meshgrid(torch.arange(2 * d), torch.arange(2 * h),
                                torch.arange(2 * w), indexing="ij")
    par = (zo & 1, yo & 1, xo & 1)
    src = (zo >> 1, yo >> 1, xo >> 1)
    acc = torch.einsum("zyxi,zyxio->zyxo", a.float()[src], wa.float()[par])
    if b is not None:
        acc = acc + torch.einsum("zyxj,zyxjo->zyxo", b.float()[src],
                                 wb.float()[par])
    return (acc + bias.float()).to(a.dtype)


def emulate_maxpool_f32(x):
    """``csrc/maxpool.cu`` in f32 (``maxpool2_f32_direct``; the path's
    f32 pool, ``csrc/maxpool_rows.cu``, is emulated in
    ``test_torch_port_maxpool_rows.py``): from -inf, each of the 8 window
    values ``in[2o + (a, b, d)]`` is taken when it is larger or NaN (a NaN,
    once taken, stays); odd extents floor."""
    d, h, w = (s // 2 for s in x.shape[:3])
    m = torch.full((d, h, w, x.shape[3]), -torch.inf, dtype=x.dtype)
    for a, b, c in itertools.product((0, 1), repeat=3):
        v = x[a:2 * d:2, b:2 * h:2, c:2 * w:2]
        m = torch.where((v > m) | torch.isnan(v), v, m)
    return m


def _upconv_case(rng, shp, ca, cb, co):
    a = _t(rng.standard_normal(shp + (ca,)).astype(np.float32))
    b = _t(rng.standard_normal(shp + (cb,)).astype(np.float32)) if cb else None
    wa = _t((rng.standard_normal((4, 4, 4, ca, co)) * 0.3).astype(np.float32))
    wb = (_t((rng.standard_normal((4, 4, 4, cb, co)) * 0.3).astype(
        np.float32)) if cb else None)
    wone = _t((rng.standard_normal((4, 4, 4, co)) + 1.0).astype(np.float32))
    bias = _t(rng.standard_normal(co).astype(np.float32))
    return a, b, wa, wb, wone, bias


@pytest.mark.parametrize("shp", [(2, 3, 2), (4, 5, 9)])
@pytest.mark.parametrize("ca,cb,co", [(3, 0, 5), (3, 2, 9)])
def test_f32_k3_kernel_loop_matches_plain(rng, shp, ca, cb, co):
    ops = _upconv_case(rng, shp, ca, cb, co)
    want = ku.upconv_bn_relu_plain(*ops)
    _close(emulate_upconv_f32(*ops).numpy(), want.numpy())
    # the ones channel added at out-of-volume taps too: wrong at the faces
    wrong = emulate_upconv_f32(*ops, ones_inside=False)
    assert float((wrong - want).abs().max()) > 1e-2


@pytest.mark.parametrize("shp", [(2, 3, 2), (4, 5, 9)])
@pytest.mark.parametrize("ca,cb,co", [(5, 0, 6), (4, 3, 9)])
def test_f32_k7_kernel_loop_matches_plain(rng, shp, ca, cb, co):
    a = _t(rng.standard_normal(shp + (ca,)).astype(np.float32))
    b = _t(rng.standard_normal(shp + (cb,)).astype(np.float32)) if cb else None
    wa = _t(rng.standard_normal((2, 2, 2, ca, co)).astype(np.float32))
    wb = (_t(rng.standard_normal((2, 2, 2, cb, co)).astype(np.float32))
          if cb else None)
    bias = _t(rng.standard_normal(co).astype(np.float32))
    want = kt.convt_k2s2_plain(a, b, wa, wb, bias)
    _close(emulate_convt_f32(a, b, wa, wb, bias).numpy(), want.numpy())


@pytest.mark.parametrize("shp", [(4, 6, 4), (5, 7, 5), (9, 11, 19)])
@pytest.mark.parametrize("c", [1, 7, 8])
def test_f32_k2_kernel_loop_matches_plain(rng, shp, c):
    x = _t(rng.standard_normal(shp + (c,)).astype(np.float32))
    x[0, 0, 0, 0] = float("nan")
    x[-1, -1, -1, -1] = -float("inf")
    x[1, 1, 1, 0] = float("inf")
    got, want = emulate_maxpool_f32(x), kc.maxpool2_plain(x)
    assert got.shape == tuple(s // 2 for s in shp) + (c,)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[0, 0, 0, 0]))


# --------------------------------------------------------------------------
# routing on a patched card
# --------------------------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    """A card that launches nothing: ``meta`` tensors pass the device
    checks, ``build.function`` records each ``(library, symbol)`` it is
    asked for and returns an entry point that reports success."""
    asked = []

    def function(lib, symbol, argtypes):
        asked.append((lib, symbol))
        return lambda *args: 0

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, None))
    for mod in (kc, ku, kt, ut):
        monkeypatch.setattr(mod, "_require_cuda", lambda t, what: None)
    kernels.reset_launches()
    return asked


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_calls(dtype):
    """Each wrapper of the f32 paths with ``meta`` operands of ``dtype``
    (biases f32): ``{name: (call, f32 kernel counter)}``."""
    m = lambda *s: _meta(*s, dtype=dtype)  # noqa: E731
    x, w3, w5, bias = m(4, 6, 8, 3), m(3, 3, 3, 3, 5), m(5, 5, 5, 3, 5), \
        _meta(5)
    a, b = m(2, 3, 4, 3), m(2, 3, 4, 2)
    return {
        "conv3d_bn_relu": (lambda: kc.conv3d_bn_relu(x, w3, bias),
                           "conv3d_f32"),
        "conv3d_bias_act": (lambda: kc.conv3d_bias_act(x, w3, bias, False),
                            "conv3d_f32"),
        "conv3d5_bias_act": (lambda: kc.conv3d5_bias_act(x, w5, bias),
                             "conv3d5_f32"),
        "maxpool2": (lambda: kc.maxpool2(x), "maxpool2_f32"),
        "upconv_bn_relu": (lambda: ku.upconv_bn_relu(
            a, b, m(4, 4, 4, 3, 5), m(4, 4, 4, 2, 5), m(4, 4, 4, 5), bias),
            "upconv_f32"),
        "convt_k2s2": (lambda: kt.convt_k2s2(a, m(2, 2, 2, 3, 5), bias),
                       "convt_f32"),
        "convt_k2s2_dual": (lambda: kt.convt_k2s2_dual(
            a, b, m(2, 2, 2, 3, 5), m(2, 2, 2, 2, 5), bias), "convt_f32"),
    }


F32_ENTRY = {
    "conv3d_bn_relu": ("conv3d_tc_f32", "ctunet_conv3d_tc_f32"),
    "conv3d_bias_act": ("conv3d_tc_f32", "ctunet_conv3d_tc_f32"),
    "conv3d5_bias_act": ("conv3d_tc_f32", "ctunet_conv3d_tc_f32"),
    "maxpool2": ("maxpool_rows", "ctunet_maxpool2_rows_f32"),
    "upconv_bn_relu": ("upconv_tc_f32", "ctunet_upconv_tc_f32"),
    "convt_k2s2": ("upconv_tc_f32", "ctunet_upconv_tc_f32"),
    "convt_k2s2_dual": ("upconv_tc_f32", "ctunet_upconv_tc_f32"),
}
BF16_ENTRY = {
    "conv3d_bn_relu": ("conv3d_tc", "ctunet_conv3d_tc"),
    "conv3d_bias_act": ("conv3d_tc", "ctunet_conv3d_tc"),
    "conv3d5_bias_act": ("conv3d_tc", "ctunet_conv3d_tc"),
    "maxpool2": ("maxpool_rows", "ctunet_maxpool2_rows"),
    "upconv_bn_relu": ("upconv_tc", "ctunet_upconv_tc"),
    "convt_k2s2": ("upconv_tc", "ctunet_upconv_tc"),
    "convt_k2s2_dual": ("upconv_tc", "ctunet_upconv_tc"),
}


@pytest.mark.parametrize("name", sorted(F32_ENTRY))
def test_f32_call_asks_for_the_f32_entry(card, name):
    call, counter = _wrapper_calls(F32)[name]
    out = call()
    assert out.dtype == F32 and out.device.type == "meta"
    assert card == [F32_ENTRY[name]]
    counts = kernels.launches()
    assert counts[name] == 1 and counts[counter] == 1
    assert counts["conv3d_tc"] == counts["upconv_tc"] == 0
    # the f32 convs launch through conv3d_tc_f32, the f32 upsamplings
    # through upconv_tc_f32, the f32 pool through maxpool2_rows, which count
    # as well
    tcf = counts["conv3d_f32"] + counts["conv3d5_f32"]
    utf = counts["upconv_f32"] + counts["convt_f32"]
    assert counts["conv3d_tc_f32"] == tcf
    assert counts["upconv_tc_f32"] == utf
    assert counts["maxpool2_rows"] == counts["maxpool2_f32"]
    assert sum(counts.values()) == 2 + tcf + utf + counts["maxpool2_rows"]


@pytest.mark.parametrize("name", sorted(BF16_ENTRY))
def test_bf16_call_keeps_its_kernel(card, name):
    call, counter = _wrapper_calls(torch.bfloat16)[name]
    assert call().dtype == torch.bfloat16
    assert card == [BF16_ENTRY[name]]
    counts = kernels.launches()
    assert counts[counter] == 0 and counts[name] == 1
    assert counts["conv3d_tc_f32"] == 0


def test_f32_kernels_refuse_other_dtypes(card):
    x, bias = _meta(4, 6, 8, 3, dtype=torch.bfloat16), _meta(5)
    a = _meta(2, 3, 4, 3, dtype=torch.bfloat16)
    for call in (
            lambda: kc.conv3d_f32(x, _meta(3, 3, 3, 3, 5,
                                           dtype=torch.bfloat16), bias, True),
            lambda: kc.conv3d5_f32(x, _meta(5, 5, 5, 3, 5,
                                            dtype=torch.bfloat16), bias),
            lambda: kc.maxpool2_f32(x),
            lambda: ku.upconv_f32(a, None, _meta(4, 4, 4, 3, 5,
                                                 dtype=torch.bfloat16),
                                  None, _meta(4, 4, 4, 5,
                                              dtype=torch.bfloat16), bias),
            lambda: kt.convt_f32(a, None, _meta(2, 2, 2, 3, 5,
                                                dtype=torch.bfloat16), None,
                                 bias)):
        with pytest.raises(TypeError):
            call()
    # an f32 operand with bf16 weights is refused before any launch
    with pytest.raises(TypeError):
        kc.conv3d_bn_relu(_meta(4, 6, 8, 3),
                          _meta(3, 3, 3, 3, 5, dtype=torch.bfloat16), bias)
    assert card == [] and sum(kernels.launches().values()) == 0


def test_f32_kernels_run_the_plain_versions_on_the_cpu(rng):
    kernels.reset_launches()
    x = _t(rng.standard_normal((4, 6, 8, 3)).astype(np.float32))
    w = _t(rng.standard_normal((3, 3, 3, 3, 5)).astype(np.float32))
    b = _t(rng.standard_normal(5).astype(np.float32))
    assert torch.equal(kc.conv3d_f32(x, w, b, True),
                       kc.conv3d_tc_plain(x, w, b, True))
    assert torch.equal(kc.maxpool2_f32(x), kc.maxpool2_plain(x))
    ops = _upconv_case(rng, (2, 3, 2), 3, 2, 5)
    assert torch.equal(ku.upconv_f32(*ops), ku.upconv_bn_relu_plain(*ops))
    assert sum(kernels.launches().values()) == 0


def _seeded(name, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(name).state_dict()


ENGINES = [("UNetSP", 2), ("UNetDO", 1), ("UNet4_2IC", 2),
           ("recAE_v2_fixed", 1)]


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
@pytest.mark.parametrize("name,cin", ENGINES)
def test_engine_builds_and_runs_on_the_card_in_its_dtype(card, monkeypatch,
                                                         name, cin, dtype):
    """``build_predict`` for the card in f32 (it refused before this slice)
    and bf16: per volume 12 K1, 4 K2 and 4 K3 (generic) or 18 K5, 4 K2,
    1 K7a and 3 K7b (legacy), each on the kernel of its dtype."""
    monkeypatch.setattr(tengine, "resolve_device",
                        lambda d: torch.device("meta"))
    sd = load_any(UNETSP_10K) if name == "UNetSP" else _seeded(name)
    predict = tengine.build_predict(name, sd, dtype, device="cuda")
    out = predict(_meta(1, 32, 32, 32, cin))
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == dtype and o.shape[:4] == (1, 32, 32, 32)
               for o in out)
    asked = collections.Counter(sym for _, sym in card)
    if tengine.ENGINE_CONFIGS[name]["family"] == "generic":
        f32 = {"ctunet_conv3d_tc_f32": 12, "ctunet_maxpool2_rows_f32": 4,
               "ctunet_upconv_tc_f32": 4}
        bf16 = {"ctunet_conv3d_tc": 12, "ctunet_maxpool2_rows": 4,
                "ctunet_upconv_tc": 4}
    else:
        f32 = {"ctunet_conv3d_tc_f32": 18, "ctunet_maxpool2_rows_f32": 4,
               "ctunet_upconv_tc_f32": 4}
        bf16 = {"ctunet_conv3d_tc": 18, "ctunet_maxpool2_rows": 4,
                "ctunet_upconv_tc": 4}
    assert asked == (f32 if dtype == F32 else bf16)
    counts = kernels.launches()
    if dtype == F32:
        assert counts["conv3d_tc"] == counts["upconv_tc"] == 0
        assert (counts["conv3d_f32"] + counts["conv3d5_f32"]
                + counts["maxpool2_f32"] + counts["upconv_f32"]
                + counts["convt_f32"]) == sum(f32.values())
        assert counts["conv3d_tc_f32"] == (counts["conv3d_f32"]
                                           + counts["conv3d5_f32"])
        assert counts["upconv_tc_f32"] == (counts["upconv_f32"]
                                           + counts["convt_f32"])
    else:
        assert counts["conv3d_tc_f32"] == counts["upconv_tc_f32"] == 0


@pytest.fixture(scope="module")
def int8_scales():
    """The int8 engine's scales for UNetSP at 16^3 (one CPU calibration)."""
    x = torch.rand((16, 16, 16, 2), generator=torch.Generator().manual_seed(1))
    scales = {}
    tq.build_predict_q("UNetSP", load_any(UNETSP_10K), x, F32, device="cpu",
                       bf16_head=1, export_scales=scales)
    return scales


def test_int8_engine_with_an_f32_head_builds_and_runs_on_the_card(
        card, monkeypatch, int8_scales):
    """``build_predict_q`` for the card in f32 (it refused before this
    slice): the first encoder block's two units on the f32 conv, the rest
    on the int8 kernels, nothing on a bf16 kernel."""
    monkeypatch.setattr(tq, "resolve_device", lambda d: torch.device("meta"))
    predict = tq.build_predict_q(
        "UNetSP", load_any(UNETSP_10K), _meta(16, 16, 16, 2), F32,
        device="cuda", bf16_head=1, import_scales=int8_scales)
    full, flap = predict(_meta(1, 16, 16, 16, 2))
    assert full.dtype == flap.dtype == F32
    assert collections.Counter(sym for _, sym in card) == {
        "ctunet_conv3d_tc_f32": 2, "ctunet_conv3d_tc_q": 10,
        "ctunet_maxpool2_rows_q": 4, "ctunet_upconv_tc_q": 4}
    counts = kernels.launches()
    assert counts["conv3d_f32"] == counts["conv3d_tc_f32"] == 2
    assert counts["conv3d_tc"] == 0


# --------------------------------------------------------------------------
# the slice on the CPU: f32 engines with the kernel emulations vs JAX
# --------------------------------------------------------------------------


@pytest.fixture
def emulated_kernels(monkeypatch):
    """Serve K2, K3 and K7a/K7b on CPU tensors through the emulations of
    the f32 CUDA kernels' loops (the wrappers call the plain versions by
    name); counts the calls."""
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(kc, "maxpool2_plain",
                        counted("K2", emulate_maxpool_f32))
    monkeypatch.setattr(ku, "upconv_bn_relu_plain",
                        counted("K3", emulate_upconv_f32))
    monkeypatch.setattr(kt, "convt_k2s2_plain",
                        counted("K7", emulate_convt_f32))
    return calls


def _jax_weights(name, cin, shape):
    """JAX-initialised weights with BatchNorm statistics moved off their
    init values, as a flax tree and as the port's state_dict."""
    if tengine.ENGINE_CONFIGS[name]["family"] == "legacy":
        sd = _seeded(name, seed=3)
        rng = np.random.default_rng(3)
        for k, v in sd.items():
            if k.endswith("running_var"):
                sd[k] = v * 1.1 + 0.01
            elif k.endswith("running_mean"):
                sd[k] = v + 0.01 * _t(rng.standard_normal(v.shape).astype(
                    np.float32))
        params, stats = to_flax(sd)
        return {"params": params, "batch_stats": stats}, sd
    m = jax_build_model(name, compute_dtype="float32", use_checkpoint=False)
    vs = jax.jit(m.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *shape, cin)), False)
    stats = jax.tree.map(lambda s: s * 1.05 + 0.01, vs["batch_stats"])
    vs = {"params": vs["params"], "batch_stats": stats}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), vs)
    return vs, from_flax(tree["params"], tree["batch_stats"])


@pytest.mark.parametrize("name,cin", ENGINES)
def test_f32_engine_on_the_kernel_loops_matches_jax_engine(
        rng, emulated_kernels, name, cin):
    """The port's f32 engine, its K2/K3/K7 on the f32 kernels' loop
    emulations, against the JAX engine in f32 with its Pallas kernels in
    interpret mode, same weights and input."""
    shape = (16, 16, 16)
    vs, sd = _jax_weights(name, cin, shape)
    x = rng.random((1, *shape, cin)).astype(np.float32)
    want = jax_engine.build_predict(name, vs, compute_dtype=jnp.float32,
                                    interpret=True)(jnp.asarray(x))
    got = tengine.build_predict(name, sd, F32, device="cpu")(_t(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-3)
    legacy = tengine.ENGINE_CONFIGS[name]["family"] == "legacy"
    assert emulated_kernels == ({"K2": 4, "K7": 4} if legacy
                                else {"K2": 4, "K3": 4})
