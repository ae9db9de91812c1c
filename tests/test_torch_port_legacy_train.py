"""PyTorch port, legacy training on the CPU: the k=5 training conv, the
legacy train step against the JAX step, and ``Model`` training both
AutoImplant 2020 INIs.

- The k=5 training conv (``ops/chain_conv_train.py``, ``conv_impl =
  "pallas"``; on the CPU the K5 kernel's plain version and the 125
  tap-shifted weight-gradient matmuls) against ``ctunet_tpu``'s
  ``packed_conv.conv3d_pallas``, whose forward and input gradient run the
  Pallas ``conv3d_fused`` in interpret mode on the CPU
  (``packed_conv.py:143``): forward, ``dx`` and ``dw`` within atol 2e-4
  (the step test's), f32 on both sides, with a cotangent of a mean loss's
  size (each element 1/sqrt(voxels)) so that ``dw`` is O(1) as in a step.
- The legacy train step (``UNet4_2IC`` with the atlas, ``recAE_v2_fixed``
  without) in f32, from one set of weights carried across with
  ``models/convert.py``, on stored (broken, flap) pairs, so no random
  synthesis: the JAX step with ``conv_impl = "xla"``, the port's with
  ``xla`` and ``pallas``. Tolerances of ``tests/test_torch_port_train_step.py``:
  loss history rtol 1e-4 (the argmax-counting Dice coefficient atol
  2e-3), step-1 gradients atol 2e-4, BatchNorm statistics atol 1e-5
  after step 1. At 32^3, not 16x16x32: there the center block's batch
  statistics come from 4 values a channel (batch 2 of 1x1x2), the
  variance ``E[x^2] - E[x]^2`` that both packages take in f32 loses most
  of its digits to cancellation, and every JAX ``conv_impl`` then parts
  from the port by up to 6.6e-4 in the gradients (the port's own graph in
  f64 agrees with its f32 run to 4e-6). At 32^3 (16 values) they agree
  within 1.1e-4.
- ``Model`` runs each legacy INI as written but for the CSVs
  (``make_dataset`` volumes), one epoch and ``device = "cpu"``, under its
  own ``xla`` and under ``pallas`` (18 forward and 17 input-gradient K5
  calls a train step, counted on the wrapper), saves, resumes and serves
  ``pred_<name>/*_fl.nii.gz`` from the trained checkpoint.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import steps as jsteps
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import codecs as jcodecs
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.problem import FlapRec as JFlapRec
from ctunet_tpu.problem import FlapRecWithShapePrior as JFlapRecSP
from ctunet_tpu_torch import Model, checkpoint, default_params, load_params
from ctunet_tpu_torch import steps
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import to_flax
from ctunet_tpu_torch.ops import chain_conv_train as cct
from ctunet_tpu_torch.ops import codecs
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.problem import FlapRec, FlapRecWithShapePrior
from ctunet_tpu_torch.utils import nifti
from test_torch_port_legacy_model import seeded_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 32)
CFG = dict(optimizer="adam", learning_rate=1e-4)  # the INIs'
LOSS = dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True)
INIS = {
    "UNet4_2IC": os.path.join(ROOT, "examples", "autoimplant2020", "UNetSP",
                              "AutoImplant2020_wShapePrior.ini"),
    "recAE_v2_fixed": os.path.join(ROOT, "examples", "autoimplant2020",
                                   "UNet", "AutoImplant2020_woShapePrior.ini"),
}
K5_FWD, K5_DGRAD = 18, 17  # a legacy train step: the network input's none


# --------------------------------------------------------------------------
# The k=5 training conv against conv3d_pallas
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,d,h,w,ci,co", [(2, 16, 16, 32, 7, 14),
                                           (1, 8, 8, 16, 28, 7)])
def test_k5_training_conv_matches_conv3d_pallas(b, d, h, w, ci, co):
    rng = np.random.default_rng(ci)
    x = rng.standard_normal((b, d, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((5, 5, 5, ci, co))
         * (125 * ci) ** -0.5).astype(np.float32)
    g = (rng.standard_normal((b, d, h, w, co))
         / np.sqrt(b * d * h * w)).astype(np.float32)
    y, vjp = jax.vjp(jpc.conv3d_pallas, jnp.asarray(x), jnp.asarray(k))
    dx, dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    yt = cct.conv3d_chain_train(xt, kt)
    dxt, dwt = torch.autograd.grad(yt, (xt, kt), torch.from_numpy(g))
    for name, got, want in (("y", yt, y), ("dx", dxt, dx), ("dw", dwt, dw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-4, rtol=0, err_msg=name)
    # plain=True is the same function
    yp = cct.conv3d_chain_train(xt, kt, plain=True)
    np.testing.assert_array_equal(yp.detach().numpy(), yt.detach().numpy())


def test_k5_training_conv_skips_the_input_gradient(monkeypatch):
    """The network input needs no gradient: its backward launches no
    kernel, and ``dw`` is still k^3 taps."""
    calls = []
    orig = kc.conv3d5_bias_act

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(kc, "conv3d5_bias_act", counting)
    x = torch.rand(1, 8, 8, 16, 2)
    k = torch.rand(5, 5, 5, 2, 7).requires_grad_()
    y = cct.conv3d_chain_train(x, k)
    (dw,) = torch.autograd.grad(y.sum(), (k,))
    assert calls == [(5, 5, 5, 2, 7)] and dw.shape == (5, 5, 5, 2, 7)
    x.requires_grad_()
    torch.autograd.grad(cct.conv3d_chain_train(x, k).sum(), (x, k))
    assert calls[1:] == [(5, 5, 5, 2, 7), (5, 5, 5, 7, 2)]
    with pytest.raises(ValueError, match="5x5x5"):
        cct.conv3d_chain_train(x, torch.rand(4, 4, 4, 2, 7))


# --------------------------------------------------------------------------
# The legacy train step against the JAX step
# --------------------------------------------------------------------------


class JPairsSP(JFlapRecSP):
    """The JAX handler on stored (broken, flap) pairs."""

    def targets_from_pair(self, broken, flap):
        return broken, jcodecs.one_hot(flap, 2)


class JPairs(JFlapRec):
    def targets_from_pair(self, broken, flap):
        return broken, jcodecs.one_hot(flap, 2)


class PairsSP(FlapRecWithShapePrior):
    """The port's handler on stored (broken, flap) pairs."""

    def targets_from_pair(self, broken, flap):
        return broken, codecs.one_hot(flap, 2)


class Pairs(FlapRec):
    def targets_from_pair(self, broken, flap):
        return broken, codecs.one_hot(flap, 2)


HANDLERS = {"UNet4_2IC": (JPairsSP, PairsSP, True),
            "recAE_v2_fixed": (JPairs, Pairs, False)}


STEP_SHAPE = (32, 32, 32)


def _pairs(batch=2, seed=0):
    """Stored (broken, flap) pairs and an atlas, from a numpy seed."""
    rng = np.random.default_rng(seed)
    broken, flaps = [], []
    for i in range(batch):
        full = spherical_shell(STEP_SHAPE, seed=seed + i).astype(np.float32)
        zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in STEP_SHAPE)]
        c = np.argwhere(full > 0)[rng.integers(0, int(full.sum()))]
        hole = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) <= 16
        flaps.append(full * hole)
        broken.append(full * ~hole)
    atlas = spherical_shell(STEP_SHAPE, radius_frac=0.42).astype(np.float32)
    return np.stack(broken), np.stack(flaps), atlas


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


_JAX_RUNS = {}


def _jax_run(mc):
    """Three JAX train steps (``conv_impl = "xla"``) and the step-1
    gradients: ``(losses, grads, batch_stats after step 1)``."""
    if mc in _JAX_RUNS:
        return _JAX_RUNS[mc]
    jh, _, with_atlas = HANDLERS[mc]
    broken, flaps, atlas = _pairs()
    atlas = atlas if with_atlas else None
    params, stats = to_flax(seeded_state_dict(mc))
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    jpc.set_conv_impl("xla")
    jm = jax_build_model(mc, compute_dtype="float32", use_checkpoint=False)
    opt = jsteps.make_optimizer(CFG)
    handler = jh()
    chans = [jnp.asarray(broken)]
    if with_atlas:
        chans.append(jnp.broadcast_to(atlas[None], broken.shape))
    x = jnp.stack(chans, -1)
    _, targets = jax.vmap(handler.targets_from_pair)(jnp.asarray(broken),
                                                     jnp.asarray(flaps))

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, True,
                          mutable=["batch_stats"])
        return handler.compute_losses(out, targets, LOSS)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)
    step = jsteps.make_train_step(jm, handler, opt, LOSS, atlas=atlas,
                                  compute_dtype=jnp.float32, from_pairs=True,
                                  donate=False)
    state = jsteps.TrainState(params, stats, opt.init(params),
                              jnp.zeros((), jnp.int32))
    batch = {"image": jnp.asarray(broken), "flap": jnp.asarray(flaps)}
    losses, stats1 = [], None
    for i in range(3):
        state, terms = step(state, batch, jax.random.key(i))
        losses.append({k: float(v) for k, v in terms.items()})
        stats1 = state.batch_stats if stats1 is None else stats1
    _JAX_RUNS[mc] = (losses, grads, stats1)
    return _JAX_RUNS[mc]


def _port_run(mc, impl, n_steps=3):
    _, ph, with_atlas = HANDLERS[mc]
    broken, flaps, atlas = _pairs()
    model = build_model(mc)
    model.load_state_dict(seeded_state_dict(mc))
    model.configure(impl, torch.float32)
    state = steps.TrainState(model, steps.make_optimizer(CFG,
                                                         model.parameters()))
    step = steps.make_train_step(model, ph(), LOSS,
                                 atlas=atlas if with_atlas else None,
                                 compute_dtype=torch.float32, from_pairs=True)
    batch = {"image": torch.from_numpy(broken),
             "flap": torch.from_numpy(flaps)}
    gen = torch.Generator().manual_seed(0)
    losses, grads, stats1 = [], None, None
    for _ in range(n_steps):
        state, terms = step(state, batch, gen)
        losses.append({k: float(v) for k, v in terms.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            stats1 = to_flax(model.state_dict())[1]
    return losses, grads, stats1, state


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mc", ["UNet4_2IC", "recAE_v2_fixed"])
def test_legacy_train_steps_match_jax(mc, impl):
    want_losses, want_grads, want_stats = _jax_run(mc)
    losses, grads, stats1, state = _port_run(mc, impl)
    assert state.step == 3
    for got, want in zip(losses, want_losses):
        assert set(got) == set(want) == {"ce", "dice_loss", "dice_coef",
                                         "epoch_loss"}
        for k in got:
            tol = (dict(atol=2e-3, rtol=0) if k == "dice_coef"
                   else dict(rtol=1e-4))
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    sd = seeded_state_dict(mc)
    sd.update(grads)
    got_grads, _ = to_flax(sd)
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(got_grads)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4,
                                   err_msg=str(path))
    for (path, w), (_, g) in zip(_leaves(want_stats), _leaves(stats1)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("impl", ["chain", "plain"])
def test_legacy_conv_impls_route(monkeypatch, impl):
    """``chain`` takes ``F.conv3d`` at k=5 (as the JAX ``chain`` takes the
    XLA conv there) and launches no K5; ``plain`` is ``pallas`` on the
    plain version. Both give ``xla``'s step-1 loss."""
    calls = {"k5": 0, "k5_plain": 0}
    for name, key in (("conv3d5_bias_act", "k5"),
                      ("conv3d5_bias_act_plain", "k5_plain")):
        orig = getattr(kc, name)

        def counting(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(kc, name, counting)
    losses, _, _, _ = _port_run("recAE_v2_fixed", impl, n_steps=1)
    # per sample of the batch of 2
    want = {"chain": {"k5": 0, "k5_plain": 0},
            "plain": {"k5": 0, "k5_plain": 2 * (K5_FWD + K5_DGRAD)}}[impl]
    assert calls == want
    ref, _, _, _ = _port_run("recAE_v2_fixed", "xla", n_steps=1)
    np.testing.assert_allclose(losses[0]["epoch_loss"],
                               ref[0]["epoch_loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="conv_impl"):
        build_model("UNet4_2IC").configure("cudnn")


# --------------------------------------------------------------------------
# Model: both INIs train, save, resume and serve
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy_train")
    csv = make_dataset(str(root / "data"), n=2, shape=SHAPE, seed=21)
    register_atlas(SHAPE, spherical_shell(SHAPE, radius_frac=0.42))
    return root, csv


def _ini_params(mc, root, csv, name, impl):
    p = load_params(INIS[mc], default_params())
    p.update(name=name, device="cpu", n_epochs=1, train_files_csv=csv,
             validation_files_csv=csv, test_files_csv=csv,
             workspace_path=str(root / "ws"), conv_impl=impl)
    return p


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mc", ["UNet4_2IC", "recAE_v2_fixed"])
def test_model_trains_legacy_ini(data, monkeypatch, mc, impl):
    root, csv = data
    ini = load_params(INIS[mc], default_params())
    assert (ini["model_class"], ini["conv_impl"], ini["batch_size"]) == (
        mc, "xla", 1)
    calls = {"k5": 0, "dgrad": 0}
    orig_conv, orig_flip = kc.conv3d5_bias_act, cct.flip_swap

    def conv(*a, **kw):
        calls["k5"] += 1
        return orig_conv(*a, **kw)

    def flip(w):
        calls["dgrad"] += w.shape[0] == 5
        return orig_flip(w)

    monkeypatch.setattr(kc, "conv3d5_bias_act", conv)
    monkeypatch.setattr(cct, "flip_swap", flip)
    name = f"{mc}_{impl}"
    m = Model(params=_ini_params(mc, root, csv, name, impl))
    # 2 train + 2 eval steps (batch 1, 2 volumes), then 2 volumes served
    # by the legacy engine (18 K5 each) twice: by the INI's per-epoch
    # autosave, and after training
    n_train = K5_FWD + K5_DGRAD if impl == "pallas" else 0
    n_eval = K5_FWD if impl == "pallas" else 0
    assert calls == {"k5": 2 * n_train + 2 * n_eval + 4 * K5_FWD,
                     "dgrad": 2 * K5_DGRAD if impl == "pallas" else 0}
    assert m.state.step == 2 and len(m.step_losses) == 2
    assert all(np.isfinite(float(v)) for v in m.step_losses)
    hist = m.writer.history
    for key in ("train/epoch/epoch_loss", "val/epoch/dice_coef",
                "val/epoch/ce"):
        assert [s for s, _ in hist[key]] == [1], key
    out = sorted(glob.glob(str(root / "data" / f"pred_{name}" / "*")))
    assert [os.path.basename(f) for f in out] == [
        f"skull_00{i}_{s}.nii.gz" for i in (0, 1) for s in ("fl", "i")]
    assert nifti.read(out[0]).data.shape == SHAPE

    # the checkpoint reloads to the trained state, resumes, and serves
    ckpt = m.params["model_path"]
    saved = checkpoint.restore_checkpoint(ckpt)
    live = m.state.model.state_dict()
    assert saved["step"] == 2 and set(saved["model"]) == set(live)
    for k, v in live.items():
        assert torch.equal(saved["model"][k], v), k
    resumed = Model(params=dict(_ini_params(mc, root, csv, name + "_r", impl),
                                test_flag=False, resume_model=ckpt))
    assert resumed.state.step == 4
    assert resumed.state.optimizer.param_groups[0]["count"] == 4
    served = Model(params=dict(_ini_params(mc, root, csv, name, impl),
                               train_flag=False))
    assert served.state is None and served.n_served == 2
    for k, v in live.items():
        assert torch.equal(served.state_dict[k], v), k
