"""PyTorch port, the 5-block family's int8 engine and AdaQuant on the CPU
against ``ctunet_tpu`` (``UNetSPSmall`` on the committed
``unetspsmall_3k`` weights; the float paths are in
``test_torch_port_spsmall.py``).

- The port's calibration within 2 bf16 ulps of the JAX engine's (Pallas
  in interpret mode); given the JAX scales the port exports them
  unchanged and serves the same integers (probabilities within 1e-5 from
  the f32 heads' summation order, masks equal), at 32^3 and (``slow``)
  at 32x32x64.
- The int8 refusal rule: over a sweep of shapes the port raises
  ``Unsupported`` exactly where the JAX plan raises ``ValueError``, both
  before calibration.
- AdaQuant at n = 5 against ``ctunet_tpu.quant_opt`` (the
  ``test_torch_port_int8_adaquant.py`` rules), its ``d4.*``/``u4.*``
  units included.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu import quant_opt as jopt
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu_torch import checkpoint as tckpt
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch import quant_opt as topt
from test_torch_port_int8_adaquant import (INT_AGREE, K_RTOL, LOSS_RTOL,
                                           _losses)
from test_torch_port_int8_engine import BF16_RTOL, PROB_ATOL, ROOT, _pair
from test_torch_port_spsmall import skull_and_atlas

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small3k():
    """The committed weights: the JAX variables and the port's
    state_dict."""
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetspsmall_3k"),
                      "UNetSPSmall")
    return vs, tckpt.load_any(tckpt.UNETSPSMALL_3K)


@pytest.fixture(scope="module")
def jax_int8(small3k):
    """The JAX int8 engine calibrated on the 32^3 volume (interpret mode):
    its exported scales and outputs."""
    vs, _ = small3k
    x = skull_and_atlas()
    scales = {}
    fwd = jq.build_predict_q("UNetSPSmall", vs, jnp.asarray(x[0]),
                             compute_dtype=jnp.float32, interpret=True,
                             export_scales=scales)
    return x, scales, [np.asarray(o, np.float32)
                       for o in fwd(jnp.asarray(x))]


def _int8_matches(sd, x, scales, want):
    got_scales = {}
    fwd = tq.build_predict_q("UNetSPSmall", sd, torch.from_numpy(x[0]),
                             torch.float32, device="cpu",
                             import_scales=scales,
                             export_scales=got_scales)
    assert set(got_scales) == set(scales)
    for tag in scales:
        for g, w in zip(_pair(got_scales[tag]), _pair(scales[tag])):
            np.testing.assert_array_equal(g, w, err_msg=tag)
    got = fwd(torch.from_numpy(x))
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        g = g.numpy()
        np.testing.assert_allclose(g, w, atol=PROB_ATOL, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert want[0].argmax(-1).any()
    return fwd


def test_int8_calibration_matches_jax(small3k, jax_int8):
    """Same 21 tags (entry, 10 encoder units, 10 decoder outputs), ones
    lanes at 1/255, every scale within 2 bf16 ulps of the JAX engine's."""
    _, sd = small3k
    x, want, _ = jax_int8
    got = {}
    tq.build_predict_q("UNetSPSmall", sd, torch.from_numpy(x[0]),
                       torch.float32, device="cpu", export_scales=got)
    assert set(got) == set(want) and len(want) == 21
    for tag in want:
        for g, w in zip(_pair(got[tag]), _pair(want[tag])):
            assert g.shape == w.shape, tag
            assert g[-1] == w[-1] == np.float32(1 / 255.0)
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, err_msg=tag)


def test_int8_engine_matches_jax(small3k, jax_int8):
    """Given the JAX scales: the same scales out, the same integers
    (probabilities within 1e-5 from the f32 heads' summation order, masks
    equal), 15 K1q + 5 K2q + 5 K3q int8 units."""
    _, sd = small3k
    x, scales, want = jax_int8
    fwd = _int8_matches(sd, x, scales, want)
    q_convs = [t for t, v in fwd.layers.items() if v[0].dtype == torch.int8]
    assert len(q_convs) == 20  # 10 encoder, 5 upconv, 5 decoder units


@pytest.mark.slow
def test_int8_engine_matches_jax_non_cubic(small3k):
    """At 32x32x64 (its W a second packed width of the JAX plan)."""
    vs, sd = small3k
    x = skull_and_atlas((32, 32, 64))
    scales = {}
    want = jq.build_predict_q("UNetSPSmall", vs, jnp.asarray(x[0]),
                              compute_dtype=jnp.float32, interpret=True,
                              export_scales=scales)(jnp.asarray(x))
    _int8_matches(sd, x, scales, [np.asarray(o, np.float32) for o in want])


class _Planned(Exception):
    """Raised by a stubbed calibration: the plan accepted the shape."""


SWEEP = [(32, 32, 32), (32, 24, 32), (16, 16, 16), (64, 32, 32),
         (32, 64, 32), (32, 32, 64), (48, 32, 32), (32, 48, 32),
         (32, 32, 48), (32, 32, 40), (32, 32, 96), (96, 96, 96),
         (64, 64, 80), (128, 128, 128), (224, 512, 512), (224, 304, 304),
         (192, 208, 208), (64, 96, 96), (16, 32, 32), (32, 32, 16),
         (8, 8, 8), (64, 64, 64)]


@pytest.mark.parametrize("model_class", ["UNetSPSmall", "UNetSP"])
def test_int8_refusal_matches_jax_plan(monkeypatch, small3k, model_class):
    """Over the shape sweep (``tests/test_quant.py:185-198``'s (32, 24, 32)
    among them) the port raises ``Unsupported`` exactly where the JAX plan
    raises ``ValueError`` ("chainable", "layout mismatch"); both plan
    before calibration, which is stubbed to report acceptance."""
    if model_class == "UNetSPSmall":
        vs, sd = small3k
    else:
        vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"),
                          "UNetSP")
        sd = tckpt.load_any(tckpt.UNETSP_10K)

    def planned(*a, **k):
        raise _Planned

    monkeypatch.setattr(jq, "calibrate", planned)
    monkeypatch.setattr(tq, "calibrate", planned)
    verdicts = {}
    for shape in SWEEP:
        calib = np.zeros(shape + (2,), np.float32)
        sides = []
        for build, args in ((jq.build_predict_q, (vs, calib)),
                            (tq.build_predict_q,
                             (sd, torch.from_numpy(calib)))):
            kw = {} if build is jq.build_predict_q else {"device": "cpu"}
            try:
                build(model_class, *args, **kw)
            except _Planned:
                sides.append("int8")
            except ValueError as e:
                assert build is jq.build_predict_q or isinstance(
                    e, tq.Unsupported), e
                sides.append("refused")
        assert sides[0] == sides[1], (shape, sides)
        verdicts[shape] = sides[0]
    assert verdicts[(32, 24, 32)] == "refused"
    assert verdicts[(224, 512, 512)] == "int8"
    n = 32 if model_class == "UNetSPSmall" else 16
    for shape, v in verdicts.items():  # every Model shape serves int8
        if all(s % n == 0 for s in shape):
            assert v == "int8", shape


@pytest.fixture(scope="module")
def rounding(small3k):
    """AdaQuant at 0 and 3 steps on both sides, from the port's scales,
    on two 32^3 volumes: level 4 then holds 16 voxels, the deepest level's
    count in ``test_torch_port_int8_adaquant.py`` (16x16x32, level 3)."""
    vs, sd = small3k
    x = np.concatenate([skull_and_atlas(seed=s) for s in (3, 5)])
    scales = {}
    tq.build_predict_q("UNetSPSmall", sd, torch.from_numpy(x[0]),
                       torch.float32, device="cpu", export_scales=scales)
    out = {}
    for n_steps in (0, 3):
        runs = []
        for fn, w in ((jopt.optimize_rounding, vs),
                      (topt.optimize_rounding, sd)):
            buf = io.StringIO()
            kw = {} if fn is jopt.optimize_rounding else {"device": "cpu"}
            with contextlib.redirect_stdout(buf):
                ov = fn("UNetSPSmall", w, x, scales, steps=n_steps,
                        verbose=True, **kw)
            runs.append((ov, _losses(buf.getvalue())))
        out[n_steps] = runs
    return out


def test_adaquant_five_blocks_matches_jax(rounding):
    """Round to nearest at 0 steps (integers exact, ``k`` within
    ``K_RTOL``) over the 20 units with ``d4.*``/``u4.*``; after 3 steps at
    least ``INT_AGREE`` of the integers agree and each unit's best loss is
    within ``LOSS_RTOL``."""
    (want0, _), (got0, _) = rounding[0]
    assert set(got0) == set(want0) and len(want0) == 20
    assert {"d4.0", "d4.1", "u4.0", "u4.1"} <= set(got0)
    for tag in want0:
        np.testing.assert_array_equal(got0[tag]["q"], want0[tag]["q"],
                                      err_msg=tag)
        np.testing.assert_allclose(got0[tag]["k"], want0[tag]["k"],
                                   rtol=K_RTOL, err_msg=tag)
    (want, want_l), (got, got_l) = rounding[3]
    same = total = 0
    for tag in want:
        same += int((got[tag]["q"] == want[tag]["q"]).sum())
        total += want[tag]["q"].size
        np.testing.assert_allclose(got_l[tag][1], want_l[tag][1],
                                   rtol=LOSS_RTOL, err_msg=tag)
    assert same / total >= INT_AGREE, same / total
