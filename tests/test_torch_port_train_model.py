"""PyTorch port, train mode of the model's layers, the losses and the
synthesis against the JAX package, on the CPU in f32.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in the port. Tolerances: the layers and losses compute the same
f32 formulas in another summation order (rtol 1e-6 for the losses, atol
1e-5/1e-6 for BatchNorm and the pool); the synthesis cores are exact on
integer-valued draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu.models import unet as junet
from ctunet_tpu.ops import codecs as jcodecs
from ctunet_tpu.ops import losses as jlosses
from ctunet_tpu.ops import synthesis as jsyn
from ctunet_tpu.problem import FlapRecWithShapePriorDoubleOut as JHandler
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models import unet as tunet
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from ctunet_tpu_torch.ops import codecs, losses, synthesis
from ctunet_tpu_torch.problem import (FlapRecDoubleOut,
                                      FlapRecWithShapePriorDoubleOut,
                                      single_output_losses)

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def test_batchnorm_train_matches_flax_semantics(rng):
    """Batch statistics, output and gradient in train mode; the running
    update keeps the biased variance (``nn.BatchNorm3d`` would not)."""
    x = (rng.standard_normal((2, 4, 6, 8, 5)) * 2 + 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    mean0 = rng.standard_normal(5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    bn = junet.BatchNorm()
    vs = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
          "batch_stats": {"mean": jnp.asarray(mean0),
                          "var": jnp.asarray(var0)}}

    def f(xx):
        y, mut = bn.apply(vs, xx, False, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (want, stats)), want_dx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))

    m = tunet.BatchNorm(5, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        m.weight.copy_(_t(scale)), m.bias.copy_(_t(bias))
        m.running_mean.copy_(_t(mean0)), m.running_var.copy_(_t(var0))
    xt = _t(x).requires_grad_()
    y = m(xt)
    (dx,) = torch.autograd.grad(y, xt, _t(cot))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)
    biased = x.reshape(-1, 5).var(0)
    n = x.size // 5
    unbiased_update = 0.9 * var0 + 0.1 * biased * n / (n - 1)
    assert np.abs(m.running_var.numpy() - unbiased_update).max() > 1e-4
    # eval mode: the stored statistics, as the JAX module uses them
    want_eval = bn.apply({"params": vs["params"], "batch_stats": stats},
                         jnp.asarray(x), True)
    np.testing.assert_allclose(m.eval()(_t(x)).detach().numpy(),
                               np.asarray(want_eval), atol=1e-5)


def test_batchnorm_bf16_keeps_f32_statistics(rng):
    x = rng.standard_normal((1, 4, 4, 8, 3)).astype(np.float32)
    m = tunet.BatchNorm(3, eps=1e-5, momentum=0.1).train()
    y = m(_t(x).bfloat16())
    assert y.dtype == torch.bfloat16
    assert m.running_mean.dtype == torch.float32


@pytest.mark.parametrize("shape", [(4, 4, 8), (5, 6, 7)])
def test_maxpool_splits_tie_gradients_like_jax(rng, shape):
    """A binary input ties almost everywhere: the gradient is split evenly
    among the maxima (odd extents floor)."""
    x = (rng.random((2, *shape, 3)) > 0.5).astype(np.float32)
    d, h, w = (s // 2 for s in shape)
    cot = rng.standard_normal((2, d, h, w, 3)).astype(np.float32)
    want, vjp = jax.vjp(junet._maxpool, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = _t(x).requires_grad_()
    y = tunet.maxpool2(xt)
    (dx,) = torch.autograd.grad(y, xt, _t(cot))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-6)
    # torch's own pool routes a tie's whole gradient to one element
    x2 = _t(x).requires_grad_()
    y2 = torch.nn.functional.max_pool3d(x2.permute(0, 4, 1, 2, 3), 2)
    (dx2,) = torch.autograd.grad(y2, x2, _t(cot).permute(0, 4, 1, 2, 3))
    assert (dx2 - dx).abs().max() > 0.1


def test_convtranspose_matches_jax(rng):
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    k = rng.standard_normal((2, 2, 2, 4, 6)).astype(np.float32)  # (.., O, I)
    b = rng.standard_normal(4).astype(np.float32)
    want = junet._ConvT2x2(4).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    m = tunet.ConvTranspose2x(6, 4, 2, stride=2)
    with torch.no_grad():
        m.weight.copy_(_t(np.transpose(k, (4, 3, 0, 1, 2))))
        m.bias.copy_(_t(b))
    np.testing.assert_allclose(m(_t(x)).detach().numpy(), np.asarray(want),
                               atol=1e-5)
    # and PyTorch's own ConvTranspose3d on the NCDHW view
    ref = torch.nn.functional.conv_transpose3d(
        _t(x).permute(0, 4, 1, 2, 3), m.weight, m.bias, stride=2)
    np.testing.assert_allclose(m(_t(x)).detach().numpy(),
                               ref.permute(0, 2, 3, 4, 1).detach().numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["chain", "pallas", "xla_dw", "plain"])
def test_conv_impls_compute_the_same_function(rng, impl):
    torch.manual_seed(1)
    m = build_model("UNetSP").train()
    x = _t(rng.random((1, 16, 16, 16, 2)).astype(np.float32))
    outs = {}
    for name in ("xla", impl):
        m.configure(name)
        m.zero_grad()
        full, flap = m(x)
        (full.square().sum() + flap.sum()).backward()
        outs[name] = (full.detach(), m.d_blocks[0].block[0].weight.grad.clone(),
                      m.u_blocks[1].block[1].weight.grad.clone())
    for a, b in zip(outs["xla"], outs[impl]):
        # f32 sums over 4096 voxels in another order: 1e-4 of the largest
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))
    with pytest.raises(ValueError, match="conv_impl"):
        m.configure("cudnn")


def test_dropout_drops_whole_channels():
    blk = tunet.UNetBlock(2, 64, dropout_p=0.5).train()
    y = blk(torch.rand(2, 4, 4, 4, 2) + 0.5)
    gone = (y == 0).all(dim=(1, 2, 3))
    assert gone.any() and not gone.all()
    kept = ~gone[:, None, None, None, :].expand_as(y)
    assert ((y != 0) | ~kept).float().mean() > 0.3  # ReLU zeros remain
    assert (blk.eval()(torch.rand(1, 4, 4, 4, 2)) == 0).all(
        dim=(1, 2, 3)).sum() < 64


def test_to_flax_round_trips_and_matches_apply(rng):
    from ctunet_tpu.models import build_model as jax_build_model

    torch.manual_seed(2)
    m = build_model("UNetSP")
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.running_mean.normal_(0, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
    sd = m.state_dict()
    params, stats = to_flax(sd)
    back = from_flax(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    x = rng.random((1, 16, 16, 16, 2)).astype(np.float32)
    jm = jax_build_model("UNetSP", compute_dtype="float32",
                         use_checkpoint=False)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                    False)
    with torch.no_grad():
        got = m.eval()(_t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


# --------------------------------------------------------------------------
# Losses and codecs
# --------------------------------------------------------------------------


def _pred_target(rng, shape=(2, 6, 8, 10)):
    pred = rng.random((*shape, 2)).astype(np.float32)
    lab = (rng.random(shape) > 0.7).astype(np.int32)
    return pred, np.eye(2, dtype=np.float32)[lab], lab


def test_losses_match_jax(rng):
    pred, onehot, lab = _pred_target(rng)
    for name, args in (("dice_loss", (pred, onehot)),
                       ("softmax_cross_entropy", (pred, lab)),
                       ("dice_coeff", (pred, onehot))):
        want = getattr(jlosses, name)(*map(jnp.asarray, args))
        got = getattr(losses, name)(*map(_t, args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    # both empty: NaN like the reference
    empty = np.zeros_like(onehot)
    empty[..., 0] = 1
    assert np.isnan(float(losses.dice_coeff(_t(empty), _t(empty))))
    assert np.isnan(float(jlosses.dice_coeff(jnp.asarray(empty),
                                             jnp.asarray(empty))))


def test_loss_gradients_match_jax(rng):
    pred, onehot, lab = _pred_target(rng, (1, 4, 6, 8))

    def jf(p):
        return (jlosses.dice_loss(jax.nn.softmax(p, -1), jnp.asarray(onehot))
                + jlosses.softmax_cross_entropy(p, jnp.asarray(lab)))

    want = jax.grad(jf)(jnp.asarray(pred))
    pt = _t(pred).requires_grad_()
    (losses.dice_loss(torch.softmax(pt, -1), _t(onehot))
     + losses.softmax_cross_entropy(pt, _t(lab))).backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-9)


def test_hausdorff_matches_jax(rng):
    pred, onehot, _ = _pred_target(rng, (1, 8, 10, 12))
    want = jlosses.hausdorff(pred, onehot)
    assert losses.hausdorff(pred, onehot) == pytest.approx(want, rel=1e-6)
    assert losses.hausdorff_device_argmax(_t(pred), _t(onehot)) == \
        pytest.approx(jlosses.hausdorff_device_argmax(
            jnp.asarray(pred), jnp.asarray(onehot)), rel=1e-6)


def test_one_hot_matches_jax(rng):
    lab = (rng.random((3, 4, 5)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(codecs.one_hot(_t(lab), 2).numpy(),
                                  np.asarray(jcodecs.one_hot(jnp.asarray(lab),
                                                             2)))


@pytest.mark.parametrize("cfg", [
    dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True),
    dict(ce_lambda=0.5, dice_lambda=None),
    dict(ce_lambda=None, dice_lambda=2.0)])
def test_handler_losses_match_jax(rng, cfg):
    p1, t1, _ = _pred_target(rng)
    p2, t2, _ = _pred_target(rng)
    want, wterms = JHandler.compute_losses(
        (jnp.asarray(p1), jnp.asarray(p2)),
        (jnp.asarray(t1), jnp.asarray(t2)), cfg)
    got, terms = FlapRecWithShapePriorDoubleOut.compute_losses(
        (_t(p1), _t(p2)), (_t(t1), _t(t2)), cfg)
    assert set(terms) == set(wterms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(wterms[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the single-output composition (base handler)
    from ctunet_tpu.problem import ProblemHandler

    want1, wt1 = ProblemHandler.compute_losses(jnp.asarray(p1),
                                               jnp.asarray(t1), cfg)
    got1, gt1 = single_output_losses(_t(p1), _t(t1), cfg)
    assert set(gt1) == set(wt1)
    np.testing.assert_allclose(float(got1), float(want1), rtol=1e-6)


def test_handlers_bind_train_datasets_and_pairs(rng):
    from ctunet_tpu_torch.data import datasets as ds

    h = FlapRecWithShapePriorDoubleOut()
    assert h.train_dataset_class is ds.FlapRecWShapePrior2OTrainDataset
    assert h.append_atlas and h.double_output
    h2 = FlapRecDoubleOut()
    assert h2.train_dataset_class is ds.FlapRec2OTrainDataset
    assert not h2.append_atlas
    broken = (rng.random((4, 5, 6)) > 0.6).astype(np.float32)
    flap = ((rng.random((4, 5, 6)) > 0.8) & (broken == 0)).astype(np.float32)
    wx, (wfull, wflap) = JHandler().targets_from_pair(jnp.asarray(broken),
                                                      jnp.asarray(flap))
    gx, (gfull, gflap) = h.targets_from_pair(_t(broken), _t(flap))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gfull.numpy(), np.asarray(wfull))
    np.testing.assert_array_equal(gflap.numpy(), np.asarray(wflap))


# --------------------------------------------------------------------------
# Synthesis: cores equal given the same drawn values, drawing layer by
# statistics
# --------------------------------------------------------------------------

SHAPE = (20, 24, 28)


@pytest.mark.parametrize("center,size", [((10, 12, 14), 5), ((0, 3, 27), 7),
                                         ((19, 23, 0), 3)])
def test_keep_masks_equal_jax(center, size):
    c = np.asarray(center, np.float32)
    for name, extra in (("sphere_keep_mask", ()), ("box_keep_mask", ()),
                        ("flap_keep_mask", (1.25,))):
        want = getattr(jsyn, name)(SHAPE, jnp.asarray(c), jnp.float32(size),
                                   *map(jnp.float32, extra))
        got = getattr(synthesis, name)(SHAPE, _t(c), float(size), *extra)
        assert 0 < float(got.mean()) < 1
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


def test_nonzero_voxel_core_equals_jax():
    vol = spherical_shell(SHAPE, seed=3).astype(np.float32)
    key = jax.random.key(4)
    bits = np.asarray(jax.random.bits(key, SHAPE, jnp.uint32))
    want, want_any = jsyn.random_nonzero_voxel(key, jnp.asarray(vol))
    got, got_any = synthesis.nonzero_voxel_core(
        _t(vol), _t(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got_any) == bool(want_any) is True
    assert vol[tuple(int(v) for v in got)] > 0
    _, none = synthesis.nonzero_voxel_core(torch.zeros(SHAPE),
                                           _t(bits.astype(np.int64)))
    assert not bool(none)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_blank_patch_core_equals_jax_given_its_draws(seed):
    """Replay ``random_blank_patch``'s own draws (same key splits) through
    the port's core."""
    vol = spherical_shell(SHAPE, seed=seed).astype(np.float32)
    key = jax.random.key(seed)
    want_out, want_flap = jsyn.random_blank_patch(key, jnp.asarray(vol))
    k_coin, k_pick, k_size, k_type, k_diam = jax.random.split(key, 5)
    center, _ = jsyn.random_nonzero_voxel(k_pick, jnp.asarray(vol))
    min_r, max_r = jsyn._radius_bounds(SHAPE)
    assert (min_r, max_r) == synthesis.radius_bounds(SHAPE)
    size = float(jax.random.randint(k_size, (), min_r, max_r))
    c_diam = float(jax.random.uniform(k_diam, (), minval=0.25, maxval=1.0)
                   * size / 4.0)
    p_type = int(jax.random.randint(k_type, (), 0, 3))
    got_out, got_flap = synthesis.blank_patch_core(
        _t(vol), _t(np.asarray(center)), size, p_type, np.float32(c_diam),
        True)
    assert float(got_flap.sum()) > 0
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_flap.numpy(), np.asarray(want_flap))
    # the same type by name, and the no-op branch
    named = synthesis.blank_patch_core(
        _t(vol), _t(np.asarray(center)), size, synthesis.PATCH_TYPES[p_type],
        np.float32(c_diam), True)
    assert torch.equal(named[0], got_out)
    out, flap = synthesis.blank_patch_core(_t(vol), _t(np.asarray(center)),
                                           size, p_type, c_diam, False)
    assert torch.equal(out, _t(vol)) and float(flap.sum()) == 0


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_salt_and_pepper_core_equals_jax_given_its_draws(p):
    vol = spherical_shell(SHAPE, seed=5).astype(np.float32)
    key = jax.random.key(6)
    want = jsyn.salt_and_pepper(key, jnp.asarray(vol), p=p, noise_density=0.3)
    k_coin, k_d, k_bits = jax.random.split(key, 3)
    density = np.float32(jax.random.uniform(k_d, (), minval=0.0, maxval=0.3))
    bits = np.asarray(jax.random.bits(k_bits, SHAPE, jnp.uint32)).astype(
        np.int64)
    coin = float(jax.random.uniform(k_coin, ()))
    got = synthesis.salt_and_pepper_core(
        _t(vol), density,
        _t((bits & 0xFFFF).astype(np.float32) * np.float32(1 / 65536)),
        _t((bits >> 16).astype(np.float32) * np.float32(1 / 65536)),
        coin <= p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != vol).any() == (p == 1.0)


@pytest.mark.parametrize("axis,apply", [(0, True), (1, True), (2, True),
                                        (1, False)])
def test_random_flip_core(rng, axis, apply):
    img = rng.random((4, 4, 4)).astype(np.float32)
    got = synthesis.random_flip_core(_t(img), axis, apply).numpy()
    np.testing.assert_array_equal(got, np.flip(img, axis) if apply else img)


def test_drawing_layer_statistics():
    """The draws follow the JAX package's distributions: size in
    [min_r, max_r), the three types about equally often, c_diam in
    [size/16, size/4], the picked voxel nonzero and spread over the shell,
    the noise density below its maximum."""
    vol = _t(spherical_shell(SHAPE, seed=7).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    min_r, max_r = synthesis.radius_bounds(SHAPE)
    types, centers = [], []
    for _ in range(150):
        d = synthesis.draw_blank_patch(gen, vol)
        size = float(d["size"])
        assert min_r <= size < max_r and size == int(size)
        assert size / 16 - 1e-6 <= float(d["c_diam"]) <= size / 4 + 1e-6
        assert bool(d["apply"])
        c = tuple(int(v) for v in d["center"])
        assert float(vol[c]) > 0
        types.append(int(d["p_type"]))
        centers.append(c)
    assert min(np.bincount(types, minlength=3)) >= 30
    assert len(set(centers)) > 140
    assert not bool(synthesis.draw_blank_patch(gen, vol, prob=0.0)["apply"])
    dens = [float(synthesis.draw_salt_and_pepper(gen, vol, 1.0, 0.05)[
        "density"]) for _ in range(50)]
    assert 0 <= min(dens) and max(dens) <= 0.05 and np.std(dens) > 0.005
    d = synthesis.draw_salt_and_pepper(gen, torch.zeros(64, 64, 64), 1.0, 0.2)
    for u in (d["u_black"], d["u_white"]):
        assert 0.49 < float(u.mean()) < 0.51 and float(u.max()) < 1.0
    flips = [int((synthesis.random_flip(gen, vol) != vol).any())
             for _ in range(60)]
    assert 10 < sum(flips) < 50


def test_flap_rec_transform_partitions_the_skull():
    vol = _t(spherical_shell(SHAPE, seed=8).astype(np.float32)) * 3.0
    gen = torch.Generator().manual_seed(1)
    h = FlapRecWithShapePriorDoubleOut()
    for _ in range(4):
        broken, (full, flap) = synthesis.flap_rec_transform(gen, vol,
                                                            noise_p=0.0)
        assert float(flap.sum()) > 0
        assert torch.equal(broken + flap, full)
        assert torch.equal(full, (vol > 0).float())
    x, (t_full, t_flap) = h.synthesize(gen, vol)
    assert x.shape == vol.shape
    assert t_full.shape == t_flap.shape == (*SHAPE, 2)
    assert torch.equal(t_full.sum(-1), torch.ones(SHAPE))
    # same generator state, same pair
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = synthesis.flap_rec_transform(g1, vol)
    b = synthesis.flap_rec_transform(g2, vol)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
