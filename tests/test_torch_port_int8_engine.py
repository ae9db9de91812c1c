"""PyTorch port, int8 engine: ``ctunet_tpu_torch.engine_q`` against
``ctunet_tpu.engine_q`` (Pallas kernels in interpret mode).

UNetSP with the committed ``unetsp_10k`` weights on a 16x16x32 synthetic
skull + atlas. Calibration: the port's bf16 engine and the JAX bf16 engine
record the same per-channel maxima up to bf16 rounding (2 bf16 ulps,
relative). Given the JAX scales (``import_scales``), the int8 activations
are exact integers on both sides, so the masks are equal and the f32 head
differs only in summation order (probabilities within 1e-5), for both
``split_taps`` forms of the JAX build and for its ``sparse`` skip.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import spherical_shell

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 32)
PROB_ATOL = 1e-5
BF16_RTOL = 2.0 ** -6  # 2 bf16 ulps
# the chain layout's halo zeros weigh more at this small shape than at the
# serving size; measured worst case 0.20 here
QUANTILE_RTOL = 0.3


def skull_and_atlas(shape=SHAPE):
    """A shell with a cap removed (the flap) and the atlas shell."""
    skull = spherical_shell(shape, seed=3).astype(np.float32)
    skull[: shape[0] // 3, : shape[1] // 2] = 0.0
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    return np.stack([skull, atlas], -1)[None]


@pytest.fixture(scope="module")
def net():
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"), "UNetSP")
    return vs, load_any(UNETSP_10K), skull_and_atlas()


@pytest.fixture(scope="module")
def jax_split(net):
    """The JAX int8 engine (split taps, the default) calibrated on ``x``:
    its exported scales and its outputs."""
    vs, _, x = net
    scales = {}
    fwd = jq.build_predict_q("UNetSP", vs, jnp.asarray(x[0]),
                             compute_dtype=jnp.float32, interpret=True,
                             export_scales=scales)
    return scales, [np.asarray(o, np.float32) for o in fwd(jnp.asarray(x))]


def _pair(v):
    """An export entry as a tuple of scale arrays (``(s_in, s_out)`` or
    ``(s,)``)."""
    return tuple(np.asarray(s, np.float32)
                 for s in (v if isinstance(v, tuple) else (v,)))


def assert_outputs_match(got, want):
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=PROB_ATOL, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert want[0].argmax(-1).any() and want[1].argmax(-1).any()


def test_calibration_matches_jax(net, jax_split):
    """Max calibration: same tags, ones lanes at 1/255, every scale within
    2 bf16 ulps of the JAX engine's (both calibrate through bf16 engines
    that sum in different orders)."""
    _, sd, x = net
    want, _ = jax_split
    got = {}
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", export_scales=got)
    assert set(got) == set(want)
    for tag in want:
        assert len(_pair(got[tag])) == len(_pair(want[tag])), tag
        for g, w in zip(_pair(got[tag]), _pair(want[tag])):
            assert g.shape == w.shape, tag
            assert g[-1] == w[-1] == np.float32(1 / 255.0)
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, err_msg=tag)


@pytest.mark.parametrize("split_taps", [True, False])
def test_engine_matches_jax(net, jax_split, split_taps):
    """Given the JAX scales, against both JAX forms: split taps
    (``conv3d_chain_split`` / ``upconv_fused_chain_split``, the default)
    and full taps (``conv3d_chain_q`` / ``upconv_fused_chain``, K4a/K4b)."""
    vs, sd, x = net
    scales, want = jax_split
    if not split_taps:
        want = [np.asarray(o, np.float32) for o in jq.build_predict_q(
            "UNetSP", vs, jnp.asarray(x[0]), compute_dtype=jnp.float32,
            interpret=True, import_scales=scales,
            split_taps=False)(jnp.asarray(x))]
    fwd = tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]),
                             torch.float32, device="cpu",
                             import_scales=scales, split_taps=split_taps)
    assert_outputs_match(fwd(torch.from_numpy(x)), want)


def test_quantile_calibration_close_to_jax(net):
    """Clipped calibration (``calib_quantile < 1``): the port takes the
    per-channel quantile over the volume's voxels (by ``kthvalue``: one
    channel at 224x304x304 passes ``torch.quantile``'s 2^24 limit); the
    JAX engine takes it per packed lane over the chain layout, halo zeros
    included, then the lane maximum per channel. Both floor it at max/64.
    On this volume the two agree within ``QUANTILE_RTOL``."""
    vs, sd, x = net
    want, got = {}, {}
    jq.build_predict_q("UNetSP", vs, jnp.asarray(x[0]),
                       compute_dtype=jnp.float32, interpret=True, jit=False,
                       calib_quantile=0.999, export_scales=want)
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", calib_quantile=0.999, export_scales=got)
    worst = 0.0
    for tag in want:
        for g, w in zip(_pair(got[tag]), _pair(want[tag])):
            worst = max(worst, float(np.max(np.abs(g / w - 1.0))))
    assert worst <= QUANTILE_RTOL


def test_engine_serves_sparse_as_dense(net, jax_split):
    """``sparse = 2`` (the JAX engine's constant-region skip, ``sparse_gh``
    of ``conv3d_chain_q``) changes no integer: the port's sparse engine
    equals its dense one bit for bit, and the JAX engine built with the
    same ``sparse`` (full taps, interpret mode), given the same scales, at
    16x16x16, the smallest shape with even extents at every pool level
    (scales are per channel, not per shape)."""
    vs, sd, _ = net
    scales, _ = jax_split
    x = skull_and_atlas((16, 16, 16))
    want = [np.asarray(o, np.float32) for o in jq.build_predict_q(
        "UNetSP", vs, jnp.asarray(x[0]), compute_dtype=jnp.float32,
        interpret=True, import_scales=scales, sparse=2)(jnp.asarray(x))]
    xt = torch.from_numpy(x)
    got, dense = (tq.build_predict_q("UNetSP", sd, xt[0], torch.float32,
                                     device="cpu", import_scales=scales,
                                     sparse=sp)(xt) for sp in (2, 0))
    for g, d in zip(got, dense):
        assert torch.equal(g, d)
    assert_outputs_match(got, want)


def test_engine_refuses_what_it_does_not_serve(net):
    _, sd, x = net
    xt = torch.from_numpy(x[0])
    # the 5-block family is served where its 5 pool levels are even
    # (test_torch_port_spsmall_int8.py); 16x16x32 pools to 1x1x2
    from ctunet_tpu_torch.checkpoint import UNETSPSMALL_3K

    with pytest.raises(tq.Unsupported, match="pool level 4"):
        tq.build_predict_q("UNetSPSmall", load_any(UNETSPSMALL_3K), xt,
                           device="cpu")
    with pytest.raises(tq.Unsupported):
        tq.build_predict_q("UNetSP", sd, xt[:, :, :24], device="cpu")
    assert issubclass(tq.Unsupported, ValueError)
