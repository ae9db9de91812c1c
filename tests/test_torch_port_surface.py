"""PyTorch port, the rest of ``ctunet_tpu``'s public surface against the
JAX package on the CPU: ``quant_opt.simulate_scales``,
``models/convert.export_state_dict``, the generic ``UNet``'s options,
``utils/misc.model_summary`` and ``view``, the surface names, and a
third-party ``ProblemHandler`` registered, trained and served through
``Model``.

Inputs come from numpy seeds; one set of weights goes to both packages
through ``models/convert.py``. Tolerances:

- ``simulate_scales``: rtol 1e-5 (f32 convs summed in another order;
  measured 6.4e-6); an int8 engine given those scales serves what the JAX
  engine serves on them (masks equal, probabilities within 1e-5: the
  int8 tests' ``assert_outputs_match``);
- ``export_state_dict``: equal keys and equal arrays;
- the ``UNet`` options in f32: outputs atol 1e-5, one train step's
  gradients within 1e-5 of each tensor's largest entry, floored at a
  tenth of the model's largest gradient (see the test);
- ``model_summary``: the parameter and BatchNorm counts equal JAX's, the
  FLOPs within 1% of the analytic count;
- the custom handler's loss history: rtol 1e-4 (the port's ``Model``
  tests').
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctunet_tpu
from ctunet_tpu import checkpoint as jcheckpoint
from ctunet_tpu import engine as jengine
from ctunet_tpu import engine_q as jq
from ctunet_tpu import models as jmodels
from ctunet_tpu import problem as jproblem
from ctunet_tpu import quant_opt as jqo
from ctunet_tpu import registry as jregistry
from ctunet_tpu import trainer as jtrainer
from ctunet_tpu.data import atlas as jatlas
from ctunet_tpu.data import datasets as jds
from ctunet_tpu.models import torch_port
from ctunet_tpu.models.unet import UNet as JUNet
from ctunet_tpu.ops import codecs as jcodecs
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu_torch import Model, checkpoint, engine, engine_q, models
from ctunet_tpu_torch import problem, quant_opt, registry, trainer
from ctunet_tpu_torch.data import atlas as tatlas
from ctunet_tpu_torch.data import datasets as tds
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.models.convert import (export_state_dict, from_flax,
                                             to_flax)
from ctunet_tpu_torch.models.unet import UNet
from ctunet_tpu_torch.ops import codecs
from ctunet_tpu_torch.utils import misc, nifti
from test_torch_port_int8_engine import assert_outputs_match

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(ROOT, ".ckpts", "unetsp_10k")
CLASSES = ("UNet4b2i3o", "UNet5b2i3o", "UNet4b1i3o", "UNetSP",
           "UNetSPSmall", "UNetDO", "recAE_v2_fixed", "UNet4_2IC")
GENERIC = CLASSES[:6]


def _skull(shape, seed=3):
    """A shell with a cap removed beside the atlas shell, ``(1, ..., 2)``."""
    skull = spherical_shell(shape, seed=seed).astype(np.float32)
    skull[: shape[0] // 3, : shape[1] // 2] = 0.0
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    return np.stack([skull, atlas], -1)[None]


def _pairs(v):
    return tuple(np.asarray(s, np.float32)
                 for s in (v if isinstance(v, tuple) else (v,)))


@pytest.fixture(scope="module")
def weights():
    return (jcheckpoint.load_any(JAX_CKPT, "UNetSP"),
            checkpoint.load_any(checkpoint.UNETSP_10K))


# --------------------------------------------------------------------------
# quant_opt.simulate_scales
# --------------------------------------------------------------------------


def test_simulate_scales_matches_jax(weights):
    vs, sd = weights
    x = _skull((32, 32, 32))
    want = jqo.simulate_scales("UNetSP", vs, x)
    got = quant_opt.simulate_scales("UNetSP", sd, x, device="cpu")
    assert set(got) == set(want)
    for tag in want:
        assert len(_pairs(got[tag])) == len(_pairs(want[tag])), tag
        for g, w in zip(_pairs(got[tag]), _pairs(want[tag])):
            assert g.dtype == np.float32 and g[-1] == np.float32(1 / 255.0)
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=tag)
    with pytest.raises(ValueError):
        quant_opt.simulate_scales("UNet4_2IC", sd, x, device="cpu")


def test_engine_on_simulated_scales_matches_jax_engine(weights):
    """Scales from the port's simulation (on a 32^3 skull) imported by the
    port's int8 engine and by the JAX engine (interpret mode) at 16^3:
    the same integers, so the same masks."""
    vs, sd = weights
    scales = quant_opt.simulate_scales("UNetSP", sd, _skull((32, 32, 32)),
                                       device="cpu")
    x = _skull((16, 16, 16))
    want = [np.asarray(o, np.float32) for o in jq.build_predict_q(
        "UNetSP", vs, jnp.asarray(x[0]), compute_dtype=jnp.float32,
        interpret=True, import_scales=scales)(jnp.asarray(x))]
    fwd = engine_q.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]),
                                   torch.float32, device="cpu",
                                   import_scales=scales)
    assert fwd.scales.keys() == scales.keys()
    assert_outputs_match(fwd(torch.from_numpy(x)), want)


# --------------------------------------------------------------------------
# models/convert.export_state_dict
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mc", ["UNetSP", "UNetSPSmall"])
def test_export_state_dict_matches_jax(tmp_path, mc):
    torch.manual_seed(1)
    sd = models.build_model(mc).state_dict()
    params, stats = to_flax(sd)
    want = torch_port.export_state_dict(
        {"params": params, "batch_stats": stats}, mc)
    got = export_state_dict(sd, mc)
    assert set(got) == set(want) == set(sd)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / "export.pt")
    torch.save({k: torch.as_tensor(v) for k, v in got.items()}, path)
    back = checkpoint.load_pt(path)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    models.build_model(mc).load_state_dict(back)


def test_export_state_dict_refuses_like_jax():
    sd = models.build_model("UNet4_2IC").state_dict()
    for fn, arg in ((torch_port.export_state_dict, {}), (export_state_dict,
                                                         sd)):
        with pytest.raises(NotImplementedError):
            fn(arg, "UNet4_2IC")
        with pytest.raises(KeyError):
            fn(arg, "NoSuchModel")
    sp = models.build_model("UNetSP").state_dict()
    sp.pop("last_conv.bias")
    with pytest.raises(KeyError):
        export_state_dict(sp, "UNetSP")


# --------------------------------------------------------------------------
# the generic UNet's options
# --------------------------------------------------------------------------

OPTIONS = {"cat=False": dict(cat=False),
           "no skips": dict(use_skip_connections=False),
           "residual": dict(residual=True),
           "fc_layer": dict(fc_layer=None)}  # sized per shape below


def _option(name, shape):
    kw = dict(OPTIONS[name])
    if name == "fc_layer":  # Dense over the pooled (D/4, H/4, W/4, 4)
        kw["fc_layer"] = (int(np.prod(shape)) // 64 * 4, 6)
    return kw


def _pair(name, shape, seed=0):
    """The JAX ``UNet`` and the port's with the same option, initialised by
    JAX with perturbed BatchNorm statistics, the weights carried over."""
    kw = _option(name, shape)
    jm = JUNet(input_channels=2, out_channels=3, i_size=2, n_blocks=2,
               use_checkpoint=False, **kw)
    x0 = jnp.zeros((1, *shape, 2))
    vs = jm.init(jax.random.key(seed), x0, False)
    stats = jax.tree.map(lambda s: s * 1.1 + 0.01, vs["batch_stats"])
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), vs["params"])
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), stats)
    tm = UNet(input_channels=2, out_channels=3, i_size=2, n_blocks=2, **kw)
    tm.load_state_dict(from_flax(params, stats))
    assert set(to_flax(tm.state_dict(), root=None)[0]) == set(params)
    return jm, {"params": params, "batch_stats": stats}, tm


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16)])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_unet_option_matches_jax(name, shape):
    jm, vs, tm = _pair(name, shape)
    x = np.random.default_rng(1).random((2, *shape, 2)).astype(np.float32)
    want_eval = jm.apply(vs, jnp.asarray(x), False)
    want_train, _ = jm.apply(vs, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = tm.eval()(torch.from_numpy(x))
        got_train = tm.train()(torch.from_numpy(x))
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("impl", ["plain", "xla"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_unet_option_gradients_match_jax(name, impl):
    """One train-mode step's gradients of a squared loss: the port on the
    kernels' plain versions (``plain``) or ``F.conv3d`` (``xla``) against
    ``jax.grad`` of the JAX model, weights compared in flax's layout.

    Each tensor is held within 1e-5 of its own largest entry, beyond the
    f32 rounding of the reference itself: how far ``jax.grad`` moves when
    the batch's two samples swap places, which leaves the loss the same
    function. That rounding exceeds the 1e-5 only where a gradient cancels
    in its sum: BatchNorm scales and biases at 1e-4 to 1e-2 of the model's
    largest gradient, and a bias ahead of a train-mode BatchNorm (exactly
    0). Those tensors are printed."""
    shape = (8, 8, 8)
    jm, vs, tm = _pair(name, shape, seed=2)
    rng = np.random.default_rng(3)
    x = rng.random((2, *shape, 2)).astype(np.float32)
    t = rng.random((2, *shape, 3)).astype(np.float32)
    jpc.set_conv_impl("xla")

    def jax_grads(x, t):
        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": vs["batch_stats"]},
                              jnp.asarray(x), True, mutable=["batch_stats"])
            return jnp.mean(jnp.square(out - t))

        g = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, vs["params"]))
        return dict(jax.tree_util.tree_flatten_with_path(g)[0])

    want = jax_grads(x, t)
    swapped = jax_grads(x[::-1].copy(), t[::-1].copy())
    tm.configure(impl, torch.float32).train()
    torch.mean(torch.square(tm(torch.from_numpy(x))
                            - torch.from_numpy(t))).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    sd = {k: grads.get(k, v) for k, v in tm.state_dict().items()}
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_flax(sd, root=None)[0])[0])
    assert set(got) == set(want)
    widened = {}
    for path, w in want.items():
        w = np.asarray(w)
        own = 1e-5 * float(np.abs(w).max())
        noise = float(np.abs(np.asarray(swapped[path]) - w).max())
        if 2 * noise > own:
            widened[jax.tree_util.keystr(path)] = (own + 2 * noise) / max(
                own, np.finfo(np.float32).tiny)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=own + 2 * noise,
                                   err_msg=str(path))
    print(f"{name}/{impl}: tolerance over 1e-5 x own max, by the "
          f"reference's rounding:", {k: f"{v:.3g}x" for k, v in
                                     sorted(widened.items())})


def test_unet_defaults_keep_registered_models():
    """Every registered model keeps its state_dict: no option key."""
    for mc in GENERIC:
        keys = models.build_model(mc).state_dict()
        assert not [k for k in keys if "skip_" in k or "center" in k], mc


# --------------------------------------------------------------------------
# model_summary, view
# --------------------------------------------------------------------------


def _jax_counts(mc):
    """Parameter and BatchNorm statistics counts of the JAX model (shapes
    only, no compile)."""
    n_in = jmodels.MODEL_INPUT_CHANNELS[mc]
    m = jmodels.build_model(mc, compute_dtype="float32")
    vs = jax.eval_shape(lambda: m.init(jax.random.key(0), jnp.zeros(
        (1, 32, 32, 32, n_in)), False))

    def count(tree):
        return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))

    return count(vs["params"]), count(vs["batch_stats"])


@pytest.mark.parametrize("mc", CLASSES)
def test_model_summary_counts_match_jax(mc):
    n_params, n_bn = _jax_counts(mc)
    text = misc.model_summary(
        models.build_model(mc),
        (1, 32, 32, 32, models.MODEL_INPUT_CHANNELS[mc]), print_out=False)
    assert f"{n_params:,d}" in text.split("TOTAL trainable")[1].split("\n")[0]
    assert f"{n_bn:,d}" in text.split("running stats")[1].split("\n")[0]


def _analytic_flops(mc, shape):
    """k^3 Ci Co 2 per output voxel over the convs, Ci Co 2 per output
    voxel of each ConvT (one tap each) and of the 1x1 head."""
    m = models.build_model(mc)
    total, side = 0.0, np.array(shape, float)
    for name, p in m.named_parameters():
        if p.dim() != 5:
            continue
        level = int(name.split(".")[1]) if "blocks" in name else 0
        n = m.n_blocks
        if name.startswith("d_blocks"):
            vox = np.prod(side / 2 ** level)
        elif name.startswith("u_blocks"):
            vox = np.prod(side / 2 ** (n - 1 - level))
        else:
            vox = np.prod(side)
        if name.endswith("block.0.weight") and name.startswith("u_"):
            total += 2.0 * p.shape[0] * p.shape[1] * vox  # ConvT, per out
        else:
            total += 2.0 * p.shape[0] * p.shape[1] * p[0, 0].numel() * vox
    return total


@pytest.mark.parametrize("mc", ["UNetSP", "UNetSPSmall"])
def test_model_summary_flops_are_the_functions(mc):
    shape = (224, 304, 304) if mc == "UNetSP" else (224, 512, 512)
    text = misc.model_summary(models.build_model(mc), (1, *shape, 2),
                              print_out=False)
    line = [ln for ln in text.splitlines() if "FLOPs" in ln][0]
    assert "the function's" in line
    got = float(line.split(":")[-1].split(" G")[0]) * 1e9
    want = _analytic_flops(mc, shape)
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_view_writes_pngs(tmp_path):
    vol = spherical_shell((16, 16, 16)).astype(np.float32)
    for x, name in ((vol, "a.png"),
                    (torch.from_numpy(vol)[None, ..., None], "b.png")):
        out = misc.view(x, str(tmp_path / name))
        assert out == str(tmp_path / name)
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError):
        misc.view(np.zeros((4, 4)))


# --------------------------------------------------------------------------
# the surface names
# --------------------------------------------------------------------------


def test_surface_names_equal_jax(tmp_path):
    assert models.MODEL_INPUT_CHANNELS == jmodels.MODEL_INPUT_CHANNELS
    assert models.DOUBLE_OUTPUT_MODELS == jmodels.DOUBLE_OUTPUT_MODELS
    for mc in CLASSES + ("NoSuchModel",):
        assert engine.supports(mc) == jengine.supports(mc), mc
    assert all(engine.supports(mc) for mc in CLASSES)
    pt = tmp_path / "w.pt"
    torch.save({"a": torch.zeros(1)}, str(pt))
    for path in (str(pt), str(tmp_path), str(tmp_path / "missing.pt"),
                 checkpoint.UNETSP_10K):
        assert (checkpoint.is_torch_checkpoint(path)
                == jcheckpoint.is_torch_checkpoint(path)), path
    assert checkpoint.is_torch_checkpoint(str(pt))
    for name in ("ConvUnit", "ResidualBlock", "CenterBlock",
                 "MODEL_INPUT_CHANNELS", "DOUBLE_OUTPUT_MODELS"):
        assert name in models.__all__ and hasattr(models, name), name
    assert set(jmodels.__all__) - {"CenterBlock", "ConvUnit",
                                   "ResidualBlock"} <= set(models.__all__) | {
        "PackedResidentModel"}


def test_load_ini_file_builds_the_model_as_jax(tmp_path, capsys):
    ini = tmp_path / "tiny.ini"
    ini.write_text(
        "[General]\ns_name = tiny\ns_model_class = UNetSP\n"
        "s_problem_handler = FlapRecWithShapePriorDoubleOut\n"
        f"s_workspace_path = {tmp_path / 'ws'}\ns_device = cpu\n"
        "[Train]\nb_train_flag = False\n[Test]\nb_test_flag = False\n")
    assert trainer.load_ini_file(str(ini)) is None
    assert jtrainer.load_ini_file(str(ini)) is None
    with pytest.raises(FileNotFoundError):
        trainer.load_ini_file(str(tmp_path / "none.ini"))


# --------------------------------------------------------------------------
# a third-party ProblemHandler through Model
# --------------------------------------------------------------------------

HANDLER = "PairFlapSkullHandler"  # registered by this test module only


def _two_head_losses(base, prediction, target, cfg):
    """The base's single-output loss on each head, summed."""
    total, terms = 0.0, {}
    for sfx, p, t in zip(("sk", "fl"), prediction, target):
        loss, part = base.compute_losses(p, t, cfg)
        terms.update({f"{k}_{sfx}": v for k, v in part.items()
                      if k != "epoch_loss"})
        total = total + loss
    terms["epoch_loss"] = total
    return total, terms


@registry.register_problem(HANDLER)
class PortPairHandler(problem.ProblemHandler):
    """Stored (broken, flap) pairs, both heads, the flap written."""

    train_dataset_class = tds.FlapRecWShapePrior2OTrainDataset
    test_dataset_class = tds.NiftiImageWithAtlasDataset
    append_atlas = True
    double_output = True

    def targets_from_pair(self, broken, flap):
        full = torch.clamp(broken + flap, 0.0, 1.0)
        return broken, (codecs.one_hot(full, 2), codecs.one_hot(flap, 2))

    @staticmethod
    def compute_losses(prediction, target, cfg):
        return _two_head_losses(problem.ProblemHandler, prediction, target,
                                cfg)

    def write_predictions(self, predictions, input_filepaths,
                          output_folder_name, input_imgs=None):
        return super().write_predictions(predictions[1], input_filepaths,
                                         output_folder_name)


@jregistry.register_problem(HANDLER)
class JaxPairHandler(jproblem.ProblemHandler):
    train_dataset_class = jds.FlapRecWShapePrior2OTrainDataset
    test_dataset_class = jds.NiftiImageWithAtlasDataset
    append_atlas = True
    double_output = True

    def targets_from_pair(self, broken, flap):
        full = jnp.clip(broken + flap, 0.0, 1.0)
        return broken, (jcodecs.one_hot(full, 2), jcodecs.one_hot(flap, 2))

    @staticmethod
    def compute_losses(prediction, target, cfg):
        return _two_head_losses(jproblem.ProblemHandler, prediction, target,
                                cfg)

    def write_predictions(self, predictions, input_filepaths,
                          output_folder_name, input_imgs=None):
        return super().write_predictions(predictions[1], input_filepaths,
                                         output_folder_name)


def test_custom_handler_trains_and_serves_as_jax(tmp_path):
    shape = (16, 16, 16)
    full = spherical_shell(shape, seed=4).astype(np.float32)
    flap = full.copy()
    flap[shape[0] // 2:] = 0.0
    flap[:, : shape[1] // 2] = 0.0
    data = tmp_path / "data"
    data.mkdir()
    broken_p, flap_p = str(data / "s_nfg_d.nii.gz"), str(data /
                                                         "s_nfg_i.nii.gz")
    nifti.write(broken_p, nifti.NiftiImage(full - flap, np.eye(4)))
    nifti.write(flap_p, nifti.NiftiImage(flap, np.eye(4)))
    train_csv, test_csv = str(data / "train.csv"), str(data / "test.csv")
    for path, row in ((train_csv, [broken_p, flap_p]),
                      (test_csv, [broken_p, ""])):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows([["image", "mask"], row])
    atlas = spherical_shell(shape, radius_frac=0.42)
    tatlas.register_atlas(shape, atlas)
    jatlas.register_atlas(shape, atlas)
    torch.manual_seed(0)
    pt = str(tmp_path / "start.pt")
    torch.save(models.build_model("UNetSP").state_dict(), pt)

    def params(name):
        return dict(train_flag=True, test_flag=True, name=name,
                    model_class="UNetSP", problem_handler=HANDLER,
                    device="cpu", workspace_path=str(tmp_path / name),
                    train_files_csv=train_csv,
                    validation_files_csv=train_csv, test_files_csv=test_csv,
                    resume_model=pt, n_epochs=1, batch_size=1,
                    optimizer="adam", learning_rate=1e-4, ce_lambda=1.0,
                    dice_lambda=1.0, conv_impl="xla",
                    compute_dtype="float32", n_workers=1, seed=0)

    m = Model(params=params("port"))
    assert isinstance(m.problem_handler, PortPairHandler)
    written = os.path.join(str(data), "pred_port", "s_nfg_d_fl.nii.gz")
    assert nifti.read(written).data.shape == shape
    jm = ctunet_tpu.Model(params=params("jax"))
    got, want = m.writer.history, jm.writer.history
    assert set(got) == set(want) and "train/epoch/epoch_loss" in got
    for k in want:
        tol = (dict(atol=2e-3, rtol=0) if "dice_coef" in k
               else dict(rtol=1e-4))
        np.testing.assert_allclose([v for _, v in got[k]],
                                   [v for _, v in want[k]], err_msg=k, **tol)
    jwritten = os.path.join(str(data), "pred_jax", "s_nfg_d_fl.nii.gz")
    np.testing.assert_array_equal(nifti.read(written).data,
                                  nifti.read(jwritten).data)
