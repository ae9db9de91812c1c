"""The plain reference agrees with the package's plain PyTorch model at a
small size, and ``flops.py`` with a count made by hooks on that model.
(These tests import both; the reference imports neither the package nor
JAX.)"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import flops, inputs  # noqa: E402
from gpubench.reference import train as ref_train  # noqa: E402
from gpubench.reference import unet as ref_unet  # noqa: E402

SPECS = {
    "UNetSP": (dict(n_blocks=4, i_size=7, input_channels=2, out_channels=3,
                    head="double"), "unetsp_10k.npz", (16, 32, 48)),
    "UNetSPSmall": (dict(n_blocks=5, i_size=4, input_channels=2,
                         out_channels=3, head="double_softmax"),
                    "unetspsmall_3k.npz", (32, 32, 64)),
}
CPU = torch.device("cpu")


def _port_model(name: str, weights):
    from ctunet_tpu_torch.checkpoint import unflatten
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.models.convert import from_flax

    tree = unflatten({k: v.numpy() for k, v in weights.items()})
    model = build_model(name)
    model.load_state_dict(from_flax(tree["params"], tree["batch_stats"]))
    return model.configure("xla", torch.float32)


def _input(shape, seed):
    vol = inputs.skulls(shape, 1, seed, CPU, broken=True)[0][0]
    return torch.stack([torch.as_tensor(vol),
                        torch.as_tensor(inputs.atlas(shape, CPU))], -1)[None]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_serves_as_the_plain_model(name):
    spec, asset, shape = SPECS[name]
    weights = inputs.read_npz(
        os.path.join(ROOT, "ctunet_tpu_torch", "assets", asset), CPU)
    model = _port_model(name, weights).eval()
    x = _input(shape, 3)
    with torch.no_grad():
        want = model(x)
        p, s = ref_unet.split_weights(weights)
        got = ref_unet.forward(p, s, x, spec["n_blocks"], spec["head"])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_reference_synthesis_draws_as_the_package():
    from ctunet_tpu_torch.ops import synthesis

    vol = torch.as_tensor(inputs.skulls((32, 48, 48), 1, 5, CPU,
                                        broken=False)[0][0])
    for seed in range(6):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        broken, (full, flap) = synthesis.flap_rec_transform(g1, vol)
        r_broken, r_full, r_flap = ref_train.synthesize(g2, vol)
        assert torch.equal(broken, r_broken) and torch.equal(full, r_full)
        assert torch.equal(flap, r_flap)
        assert torch.equal(torch.rand(4, generator=g1),
                           torch.rand(4, generator=g2))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_trains_as_the_package_in_f32(name):
    """Three f32 steps of the package (``conv_impl = xla``) and of the
    reference from the same weights, skulls and draws: the same losses
    and first gradients, and the same parameters after."""
    from ctunet_tpu_torch import problem, steps

    spec, _, shape = SPECS[name]
    weights = inputs.init_weights(spec, 11, CPU)
    atlas = inputs.atlas(shape, CPU)
    vols = [torch.as_tensor(v[0]) for v in
            inputs.skulls(shape, 3, 12, CPU, broken=False)]
    model = _port_model(name, weights)
    cfg = dict(optimizer="adam", learning_rate=1e-4)
    state = steps.TrainState(model, steps.make_optimizer(
        cfg, model.parameters()))
    step = steps.make_train_step(
        model, problem.FlapRecWithShapePriorDoubleOut(),
        dict(ce_lambda=1, dice_lambda=1), atlas=atlas,
        compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(13)
    losses, grads = [], None
    for v in vols:
        state, terms = step(state, {"image": v[None]}, gen)
        losses.append(float(terms["epoch_loss"]))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    p, s = ref_unet.split_weights({k: v.clone() for k, v in weights.items()})
    r_losses, r_grads = ref_train.run_steps(
        p, torch.as_tensor(atlas), vols, torch.Generator().manual_seed(13),
        spec["n_blocks"], spec["head"], 1e-4, stats=s)
    np.testing.assert_allclose(losses, r_losses, rtol=2e-5)
    # one leaf each way: the first conv and the head
    torch.testing.assert_close(
        grads["d_blocks.0.block.0.weight"],
        r_grads["d0/unit0/conv/kernel"].permute(4, 3, 0, 1, 2),
        rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(grads["last_conv.bias"],
                               r_grads["last_conv/bias"],
                               rtol=1e-3, atol=1e-7)
    # the change over the three steps: Adam's first steps move each
    # element by about the learning rate whatever its gradient, so the
    # few with gradients at rounding level may differ; the norms agree
    w0 = weights["params/unet/d0/unit0/conv/kernel"].permute(4, 3, 0, 1, 2)
    moved = model.d_blocks[0].block[0].weight.detach() - w0
    r_moved = p["d0/unit0/conv/kernel"].permute(4, 3, 0, 1, 2) - w0
    assert float((moved - r_moved).norm() / r_moved.norm()) < 2e-2
    # the running statistics after the three steps, of the first unit and
    # of the deepest decoder unit
    bn = model.d_blocks[0].block[1]
    torch.testing.assert_close(bn.running_mean, s["d0/unit0/bn/mean"],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(bn.running_var, s["d0/unit0/bn/var"],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_flops_match_a_count_by_hooks(name):
    """Forward FLOPs of ``flops.py`` against hooks on the package's model:
    every conv and ConvTranspose it calls, plus its weight-split head."""
    from ctunet_tpu_torch.models import unet as port_unet

    spec, asset, shape = SPECS[name]
    weights = inputs.read_npz(
        os.path.join(ROOT, "ctunet_tpu_torch", "assets", asset), CPU)
    model = _port_model(name, weights).eval()
    counted = []

    def conv_hook(mod, args, out):
        k = mod.weight.shape
        counted.append(2 * out[..., 0].numel() * k[0] * k[1] * k[2] * k[3]
                       * k[4])

    def convt_hook(mod, args, out):
        x = args[0]
        counted.append(2 * x[..., 0].numel() * x.shape[-1]
                       * mod.weight.shape[1] * 8)

    for m in model.modules():
        if isinstance(m, port_unet.Conv3d):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, port_unet.ConvTranspose2x):
            m.register_forward_hook(convt_hook)
    with torch.no_grad():
        model(_input(shape, 4))
    head = 2 * int(np.prod(shape)) * model.last_conv.weight.shape[1] * \
        model.last_conv.weight.shape[0]
    assert sum(counted) + head == flops.forward_flops(spec, shape)
    assert flops.train_flops(spec, shape) == \
        3 * flops.forward_flops(spec, shape) - \
        flops.first_conv_flops(spec, shape)
