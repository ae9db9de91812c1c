"""PyTorch port, int8 engine with its mixed-precision splits against
``ctunet_tpu.engine_q`` (Pallas kernels in interpret mode): ``bf16_head``
(leading encoder blocks in float, the chain quantized once at the switch)
and ``bf16_tail`` (final decoder blocks in float after one dequant).

Both builds take the same scales (``import_scales``, from the port's own
calibration) and compute in f32. The float units differ between the two
packages only in summation order (~1e-7 here), the int8 units not at all,
so the outputs agree like the all-int8 engine's: probabilities within
1e-5, masks equal. (With the head in float, a summation-order difference
could in principle move one value across a rounding boundary at the
int8 switch; on this input none does.)
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
from test_torch_port_int8_engine import ROOT, skull_and_atlas

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def net():
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"), "UNetSP")
    sd = load_any(UNETSP_10K)
    x = skull_and_atlas()
    scales = {}
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", export_scales=scales)
    return vs, sd, x, scales


def _both(net, **kw):
    vs, sd, x, scales = net
    want = jq.build_predict_q("UNetSP", vs, jnp.asarray(x[0]),
                              compute_dtype=jnp.float32, interpret=True,
                              import_scales=scales, **kw)(jnp.asarray(x))
    got = tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]),
                             torch.float32, device="cpu",
                             import_scales=scales, **kw)(torch.from_numpy(x))
    return [g.numpy() for g in got], [np.asarray(w, np.float32) for w in want]


@pytest.mark.parametrize("split", ["bf16_tail", "bf16_head"])
def test_mixed_precision_matches_jax(net, split):
    got, want = _both(net, **{split: 1})
    for g, w in zip(got, want):
        assert w.argmax(-1).any()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
