"""PyTorch port, legacy serving path: ``Model`` on the CPU with the settings
of the AutoImplant 2020 INIs, against ``ctunet_tpu``.

- ``examples/autoimplant2020/UNetSP/AutoImplant2020_wShapePrior.ini``
  (``UNet4_2IC``, ``FlapRecWithShapePrior``, atlas as the 2nd channel) and
  ``examples/autoimplant2020/UNet/AutoImplant2020_woShapePrior.ini``
  (``recAE_v2_fixed``, ``FlapRec``), test only, on ``make_dataset`` skulls
  at 32^3 from a reference-named ``.pt`` written here: the port writes
  ``pred_<name>/<file>_{fl,i}.nii.gz`` with the input's affine, and its f32
  masks equal ``ctunet_tpu``'s ``Model`` masks on the same file over every
  voxel the f32 model decides by more than 2^-7 in probability (the two
  f32 forwards differ by ~1e-6, far inside that margin: the
  ``tests/test_e2e.py`` pattern);
- the bf16 engine (plain versions) against ``ctunet_tpu``'s bf16 legacy
  engine with the Pallas kernels in interpret mode;
- the single-output writer against ``ctunet_tpu``'s; training a legacy
  model with its handler, and the refusal of a model whose output count
  is not its handler's; ``use_int8``, which serves the bf16 engine.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctunet_tpu
from ctunet_tpu import engine as jax_engine
from ctunet_tpu.data.atlas import register_atlas as jax_register_atlas
from ctunet_tpu.problem import FlapRec as JaxFlapRec
from ctunet_tpu_torch import Model, default_params, load_params
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.data.datasets import NiftiImageDataset
from ctunet_tpu_torch.engine import build_predict
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import to_flax
from ctunet_tpu_torch.problem import FlapRec
from ctunet_tpu_torch.utils import nifti
from test_torch_port_legacy_model import seeded_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 32)
DECIDED = 2.0 ** -7
CONFIGS = {
    "wShapePrior": os.path.join(ROOT, "examples", "autoimplant2020", "UNetSP",
                                "AutoImplant2020_wShapePrior.ini"),
    "woShapePrior": os.path.join(ROOT, "examples", "autoimplant2020", "UNet",
                                 "AutoImplant2020_woShapePrior.ini"),
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy_serve")
    csv = make_dataset(str(root / "data"), n=2, shape=SHAPE, seed=11)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    register_atlas(SHAPE, atlas)
    jax_register_atlas(SHAPE, atlas)
    return root, csv, atlas


def _inputs(path, atlas, cin):
    vol = nifti.read(path).data.astype(np.float32)
    return np.stack([vol, atlas][:cin], -1)


@pytest.fixture(scope="module")
def weights(synth):
    """Per INI: a reference-named ``.pt`` of seeded weights whose
    ``last_conv`` is rescaled so that the f32 model's logit gap on the
    first volume has a standard deviation of 4 and a median of 0: both
    classes hold voxels, and most voxels are decided (random weights give
    a gap of ~0.1 around its median)."""
    root, csv, atlas = synth
    first = NiftiImageDataset(csv).files[0]
    out = {}
    for key, ini in CONFIGS.items():
        mc = load_params(ini, default_params())["model_class"]
        sd = seeded_state_dict(mc, seed=5)
        m = build_model(mc)
        x = torch.from_numpy(_inputs(first, atlas, m.input_channels)[None])
        sd["last_conv.bias"].zero_()
        m.load_state_dict(sd)
        with torch.no_grad():
            p = m.eval()(x)
        gap = torch.log(p[..., 1]) - torch.log(p[..., 0])
        k = 4.0 / float(gap.std())
        sd["last_conv.weight"] *= k
        sd["last_conv.bias"][1] = -k * gap.median()
        path = str(root / f"{key}.pt")
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
        out[key] = (mc, sd, path)
    return out


def _params(ini, synth, pt, name, **over):
    root, csv, _ = synth
    p = load_params(ini, default_params())
    p.update(train_flag=False, test_flag=True, name=name, device="cpu",
             workspace_path=str(root / "ws"), test_files_csv=csv,
             resume_model=pt, n_workers=1)
    p.update(over)
    return p


def _masks(csv, name):
    out = {}
    for path in NiftiImageDataset(csv).files:
        base = os.path.basename(path).replace(".nii.gz", "")
        d = os.path.join(os.path.dirname(path), f"pred_{name}")
        out[base] = nifti.read(os.path.join(d, f"{base}_fl.nii.gz"))
    return out


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_legacy_model_serves_like_ctunet_tpu(synth, weights, key):
    root, csv, atlas = synth
    mc, sd, pt = weights[key]
    ini = CONFIGS[key]
    m = Model(params=_params(ini, synth, pt, f"port_{key}",
                             compute_dtype="float32"))
    assert m.n_served == 2
    got = _masks(csv, f"port_{key}")
    ctunet_tpu.Model(params=_params(ini, synth, pt, f"jax_{key}",
                                    compute_dtype="float32"))
    want = _masks(csv, f"jax_{key}")
    model = build_model(mc)
    model.load_state_dict(sd)
    for path in NiftiImageDataset(csv).files:
        base = os.path.basename(path).replace(".nii.gz", "")
        src = nifti.read(path)
        img = got[base]
        assert img.data.dtype == np.uint8 and img.data.shape == SHAPE
        np.testing.assert_array_equal(img.affine, src.affine)
        copy = nifti.read(os.path.join(os.path.dirname(path),
                                       f"pred_port_{key}", f"{base}_i.nii.gz"))
        np.testing.assert_array_equal(copy.data, src.data)
        with torch.no_grad():
            p = model.eval()(torch.from_numpy(
                _inputs(path, atlas, model.input_channels)[None]))
        decided = ((p[0, ..., 1] - p[0, ..., 0]).abs() > DECIDED).numpy()
        fg = float(img.data.mean())
        assert 0.01 < fg < 0.99, f"vacuous mask: foreground share {fg}"
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(img.data[decided],
                                      want[base].data[decided])


def test_legacy_model_bf16_and_int8_serve_the_bf16_engine(synth, weights):
    """The INI's own compute dtype (bf16) serves the kernels' engine; with
    ``use_int8`` the legacy model has no int8 path (``engine_q``'s
    ``Unsupported``, as ``ctunet_tpu``'s ``ValueError``) and the bf16 engine
    serves the same masks. bf16 against f32: near-tie voxels flip."""
    _, csv, _ = synth
    _, _, pt = weights["wShapePrior"]
    ini = CONFIGS["wShapePrior"]
    Model(params=_params(ini, synth, pt, "port_f32", compute_dtype="float32"))
    Model(params=_params(ini, synth, pt, "port_bf16"))
    m = Model(params=_params(ini, synth, pt, "port_int8", use_int8=True,
                             int8_adaquant=True))
    assert m.int8_engines == {SHAPE + (2,): None}
    f32, b16, i8 = (_masks(csv, n) for n in ("port_f32", "port_bf16",
                                             "port_int8"))
    for base in f32:
        np.testing.assert_array_equal(i8[base].data, b16[base].data)
        assert int((b16[base].data != f32[base].data).sum()) <= 0.01 * \
            np.prod(SHAPE)


def test_legacy_bf16_engine_matches_jax_bf16_engine():
    """bf16 engines, 16^3, UNet4_2IC. They round at different places:
    the JAX engine rounds the ConvT twice (the einsum's bf16 output, then
    ``+ bias``; ROADMAP Queue 3), the port once; each conv output is one
    bf16 rounding of an f32 sum taken in another order. The probabilities
    (near 0.5 with these weights) agree to 1 bf16 ulp of [0.5, 1) here;
    the tolerance is 2 (2^-7)."""
    sd = seeded_state_dict("UNet4_2IC", seed=2)
    params, stats = to_flax(sd)
    x = np.random.default_rng(2).random((1, 16, 16, 16, 2)).astype(np.float32)
    want = np.asarray(jax_engine.build_predict(
        "UNet4_2IC", {"params": params, "batch_stats": stats},
        compute_dtype=jnp.bfloat16, interpret=True)(jnp.asarray(x)),
        np.float32)
    got = build_predict("UNet4_2IC", sd, torch.bfloat16, device="cpu")(
        torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert float(want.std()) > 1e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** -8)


def test_single_output_writer_matches_ctunet_tpu(tmp_path, rng):
    """``_fl`` per sample, ``_c{i}`` per sub-volume when a sample holds
    several, the ``_i`` copy: the same files, bytes of data and affines as
    ``ctunet_tpu.problem.FlapRec``'s writer."""
    affine = np.diag([0.5, 0.45, 0.45, 1.0])
    paths = []
    for i in range(2):
        p = str(tmp_path / f"v{i}.nii.gz")
        nifti.write(p, nifti.NiftiImage(
            (rng.random((4, 5, 6)) > 0.5).astype(np.uint8), affine))
        paths.append(p)
    single = rng.integers(0, 2, (2, 4, 5, 6)).astype(np.uint8)
    multi = rng.random((2, 3, 4, 5, 6, 2)).astype(np.float32)
    for pred, tag in ((single, "s"), (multi, "m")):
        saved = FlapRec().write_predictions(pred, paths, f"port_{tag}")
        ref = JaxFlapRec().write_predictions(pred, paths, f"jax_{tag}")
        assert [os.path.basename(p) for p in saved] == \
            [os.path.basename(p) for p in ref]
        for a, b in zip(saved, ref):
            ia, ib = nifti.read(a), nifti.read(b)
            np.testing.assert_array_equal(ia.data, ib.data)
            np.testing.assert_array_equal(ia.affine, ib.affine)
    assert os.path.basename(saved[0]) == "v0_c0.nii.gz"


@pytest.mark.parametrize("mc,handler", [
    ("UNet4_2IC", "FlapRecWithShapePrior"),
    ("UNet4_2IC", "FlapRecWithShapePriorDoubleOut"),
    ("UNetSP", "FlapRec"),
    ("UNet4b2i3o", "FlapRec"),
])
def test_legacy_and_single_output_training_raise(synth, tmp_path, mc,
                                                 handler):
    """Training a legacy model with its single-output handler builds a
    training ``Model``; a model whose output count is not its handler's
    is refused before any step, naming both. (Legacy training and the
    single-output synthesis are held in test_torch_port_legacy_train.py
    and test_torch_port_warp.py.)"""
    _, csv, _ = synth
    params = dict(train_flag=True, test_flag=False, name="x",
                  model_class=mc, problem_handler=handler, device="cpu",
                  workspace_path=str(tmp_path), train_files_csv=csv,
                  validation_files_csv=csv, n_epochs=1, batch_size=1,
                  ce_lambda=1.0, dice_lambda=1.0, n_workers=1)
    if handler == "FlapRecWithShapePrior":
        m = Model(params=params)
        assert m.state.step == 2 and len(m.step_losses) == 2
    else:
        with pytest.raises(ValueError, match=f"{mc}.*{handler}"):
            Model(params=params)
    broken, target = FlapRec().synthesize(torch.Generator().manual_seed(0),
                                          torch.ones(16, 16, 16))
    assert broken.shape == (16, 16, 16) and target.shape == (16, 16, 16, 2)
    assert float(target[..., 1].sum()) > 0


def test_legacy_model_without_card_raises(synth, weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _, _, pt = weights["woShapePrior"]
    params = _params(CONFIGS["woShapePrior"], synth, pt, "nocard")
    params.pop("device")  # the INI says tpu: the card
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(params=params)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_predict("recAE_v2_fixed", seeded_state_dict("recAE_v2_fixed"))
