"""PyTorch port, training conv (K6): the plain version and the autograd
function on the CPU against the JAX package.

``ctunet_tpu_torch.ops.chain_conv_train.conv3d_chain_train`` (on CPU tensors
the kernel's plain version forward and as input gradient, the tap-shifted
weight gradient as on the card) is held against
``ctunet_tpu.ops.chain_conv_train.conv3d_chain_train``, whose forward and
input gradient run the Pallas kernel ``conv3d_chain`` in interpret mode, and
against ``conv3d_chain(relu=True)`` with a bias. Inputs come from a numpy
seed. Tolerances are those of ``tests/test_chain_conv_train.py`` (f32 sums
in different orders): value atol 2e-4, dx 5e-4, dw 5e-3, rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctunet_tpu.ops import chain_conv_train as jcct
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.ops.pallas import conv3d as jk
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch.ops import chain_conv_train as cct
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import conv3d as kc

torch.set_num_threads(2)


def _data(shape, cin, cout, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *shape, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((batch, *shape, cout)).astype(np.float32)
    return x, w, cot


def _port(x, w, cot, plain=False):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = cct.conv3d_chain_train(xt, wt, plain=plain)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(cot))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _jax(x, w, cot):
    assert jcct._supported(jnp.asarray(x), jnp.asarray(w)) > 1, (
        "the case must reach the Pallas kernel")
    y, vjp = jax.vjp(jcct.conv3d_chain_train, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(cot))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _assert_close(got, want):
    for g, w_, atol in zip(got, want, (2e-4, 5e-4, 5e-3)):
        np.testing.assert_allclose(g, w_, atol=atol, rtol=1e-3)


def test_value_dx_dw_match_jax_chain_interpret():
    data = _data((4, 8, 16), 4, 4)
    _assert_close(_port(*data), _jax(*data))


@pytest.mark.parametrize("shape,cin,cout,batch", [
    ((6, 8, 16), 7, 7, 1), ((4, 8, 16), 2, 7, 2), ((6, 8, 16), 14, 7, 1)])
def test_value_dx_dw_match_jax_chain_interpret_larger(shape, cin, cout,
                                                      batch):
    data = _data(shape, cin, cout, batch, seed=1)
    _assert_close(_port(*data), _jax(*data))


def test_plain_version_matches_jax_conv3d_chain_with_bias_and_relu():
    """K6's own function: ``conv3d_chain(relu=True)`` with a bias, driven
    as ``chain_conv_train._chain_conv_one`` drives it."""
    shape, cin, cout = (4, 8, 16), 4, 4
    x, w, _ = _data(shape, cin, cout, seed=2)
    bias = np.linspace(-0.5, 0.5, cout).astype(np.float32)
    pack = jpc.choose_train_pack(shape[-1], cin, k=3)
    d, hh, ww = shape
    wp = ww // pack
    pw = jpc.pack_pad_jax(jnp.asarray(w), pack, jnp.float32)
    xc = jk.to_chain(jnp.asarray(x[0]).reshape(d, hh, wp, pack * cin), pack)
    yc = jk.conv3d_chain(xc, pw, jnp.asarray(jk.pack_bias(bias, pack)), hh,
                         wp, relu=True, interpret=True, out_dtype=jnp.float32)
    want = np.asarray(jk.unpack_output(
        jk.from_chain(yc, hh, wp, pack * cout), pack, cout))
    got = kc.conv3d_bias_act(torch.from_numpy(x[0]), torch.from_numpy(w),
                             torch.from_numpy(bias), True).numpy()
    assert (want == 0).any() and (want > 0).any()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape,cin,cout,batch", [
    ((3, 5, 7), 3, 5, 2),      # ragged extents, batch sums
    ((2, 2, 2), 2, 1, 1),      # every voxel touches a border
    ((5, 4, 6), 1, 4, 1)])
def test_autograd_function_matches_torch_autograd(shape, cin, cout, batch):
    """``dx`` (kernel on flipped, swapped weights) and ``dw`` (27 flat
    tap-shifted matmuls over the zero-padded operands) against PyTorch's own
    autograd through ``F.conv3d``, f64 for an exact reference."""
    x, w, cot = _data(shape, cin, cout, batch, seed=3)
    y, dx, dw = _port(x, w, cot)
    xt = torch.from_numpy(x).double().requires_grad_()
    wt = torch.from_numpy(w).double().requires_grad_()
    ref = F.conv3d(xt.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2),
                   padding=1).permute(0, 2, 3, 4, 1)
    rdx, rdw = torch.autograd.grad(ref, (xt, wt),
                                   torch.from_numpy(cot).double())
    np.testing.assert_allclose(y, ref.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(dx, rdx.numpy(), atol=1e-5)
    np.testing.assert_allclose(dw, rdw.numpy(), atol=1e-4, rtol=1e-5)


def test_plain_flag_and_input_without_grad():
    """``plain=True`` is the same function on the CPU, and an input that
    needs no gradient (the network input) gets none."""
    x, w, cot = _data((3, 4, 5), 2, 3, seed=4)
    for a, b in zip(_port(x, w, cot), _port(x, w, cot, plain=True)):
        np.testing.assert_array_equal(a, b)
    wt = torch.from_numpy(w).requires_grad_()
    y = cct.conv3d_chain_train(torch.from_numpy(x), wt)
    y.backward(torch.from_numpy(cot))
    assert wt.grad is not None and wt.grad.shape == wt.shape


def test_bf16_rounds_dx_and_dw_to_the_operand_dtypes():
    x, w, cot = _data((4, 4, 8), 3, 3, seed=5)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    y = cct.conv3d_chain_train(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt),
                                 torch.from_numpy(cot).bfloat16())
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    _, rdx, rdw = _port(xt.detach().float().numpy(),
                        wt.detach().float().numpy(),
                        torch.from_numpy(cot).bfloat16().float().numpy())
    # one bf16 rounding of dx; dw also rounds each plane's partial sum
    np.testing.assert_allclose(dx.float().numpy(), rdx, atol=2 ** -6,
                               rtol=2 ** -7)
    np.testing.assert_allclose(dw.float().numpy(), rdw, atol=2 ** -3,
                               rtol=2 ** -6)


def test_flip_swap_matches_jax():
    w = _data((2, 2, 2), 3, 5)[1]
    np.testing.assert_array_equal(
        cct.flip_swap(torch.from_numpy(w)).numpy(),
        np.asarray(jpc._flip_swap(jnp.asarray(w))))


def test_wrapper_checks_and_registration():
    assert kernels.WRAPPERS["conv3d_bias_act"] is kc.conv3d_bias_act
    kernels.reset_launches()
    x, w, _ = _data((2, 3, 4), 2, 2)
    kc.conv3d_bias_act(torch.from_numpy(x[0]), torch.from_numpy(w),
                       torch.zeros(2), False)
    # the CPU path is the plain version: it launches nothing
    assert kernels.launches()["conv3d_bias_act"] == 0
    with pytest.raises(ValueError, match="3x3x3"):
        cct.conv3d_chain_train(torch.from_numpy(x),
                               torch.zeros(5, 5, 5, 2, 2))
    with pytest.raises(TypeError, match="differ"):
        cct.conv3d_chain_train(torch.from_numpy(x),
                               torch.from_numpy(w).bfloat16())
    with pytest.raises(ValueError, match="cpu or cuda"):
        kc.conv3d_bias_act(torch.from_numpy(x[0]).to("meta"),
                           torch.from_numpy(w), torch.zeros(2), False)


@pytest.mark.parametrize("name", ["UNetSP", "UNet4b2i3o"])
def test_engine_sparse_route_equals_k1_plain(name):
    """``build_predict(sparse=)`` sends every conv unit through K6 with the
    ReLU and the folded bias: on the CPU exactly K1's plain version."""
    from ctunet_tpu_torch.models import build_model

    torch.manual_seed(0)
    m = build_model(name)
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.normal_(0, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
    sd = m.state_dict()
    x = torch.from_numpy(np.random.default_rng(6).random(
        (1, 16, 16, 32, 2)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        base = tengine.build_predict(name, sd, dtype, device="cpu")(x)
        got = tengine.build_predict(name, sd, dtype, device="cpu",
                                    sparse=8)(x)
        base = base if isinstance(base, tuple) else (base,)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, base):
            assert torch.equal(a, b)
