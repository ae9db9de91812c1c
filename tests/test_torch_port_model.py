"""PyTorch port: config, NIfTI, weights and the f32 forward against ctunet_tpu.

- the same params dict as ``ctunet_tpu.load_params`` for every INI under
  ``examples/``; NIfTI files written by one package read back equal by the
  other;
- ``from_flax`` weights in the port's UNetSP/UNetDO/UNet4b2i3o against
  ``model.apply(train=False)`` of ``ctunet_tpu``, with non-trivial BN
  statistics (the ``tests/test_engine.py`` fixture), and the port's engine
  (plain path, f32) against the same — atol 5e-4, rtol 1e-3 as
  ``tests/test_engine.py:53-55``;
- the committed ``.npz`` export against the orbax restore, exactly, and a
  reference-layout ``.pt`` loading natively;
- no module of ``ctunet_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  flax, orbax or ``ctunet_tpu``.
"""

import ast
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctunet_tpu
import ctunet_tpu_torch
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.utils import nifti as jax_nifti
from ctunet_tpu_torch import checkpoint as tckpt
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax
from ctunet_tpu_torch.utils import nifti as t_nifti

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=5e-4, rtol=1e-3)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize(
    "ini", sorted(glob.glob(os.path.join(ROOT, "examples", "**", "*.ini"),
                            recursive=True)),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_params_match_ctunet_tpu(ini):
    want = ctunet_tpu.load_params(ini, ctunet_tpu.default_params())
    got = ctunet_tpu_torch.load_params(ini,
                                       ctunet_tpu_torch.default_params())
    assert got == want


def test_default_params_match():
    assert ctunet_tpu_torch.default_params() == ctunet_tpu.default_params()


@pytest.mark.parametrize("writer,reader", [(t_nifti, jax_nifti),
                                           (jax_nifti, t_nifti)])
def test_nifti_roundtrip_across_packages(tmp_path, rng, writer, reader):
    affine = np.array([[0.5, 0.0, 0.0, -10.0], [0.0, 0.45, 0.1, 20.0],
                       [0.0, 0.0, 0.45, 5.0], [0.0, 0.0, 0.0, 1.0]])
    for i, dt in enumerate((np.uint8, np.float32, np.int16)):
        data = (rng.random((5, 6, 7)) * 100).astype(dt)
        path = str(tmp_path / f"v{i}.nii.gz")
        writer.write(path, writer.NiftiImage(data, affine))
        img = reader.read(path)
        np.testing.assert_array_equal(img.data, data)
        # the header stores the affine in f32: both readers agree exactly
        np.testing.assert_array_equal(img.affine, writer.read(path).affine)
        np.testing.assert_allclose(img.affine, affine, atol=1e-6)
        assert img.origin == writer.read(path).origin


@pytest.fixture(scope="module")
def variants():
    """``ctunet_tpu`` models with non-trivial BN stats, their
    ``model.apply(train=False)`` output on one input, and the converted
    state_dict (``tests/test_engine.py::_variables``)."""
    rng = np.random.default_rng(0)
    shape = (16, 16, 32)
    out = {}
    for name, in_ch in (("UNetSP", 2), ("UNetDO", 1), ("UNet4b2i3o", 2)):
        m = jax_build_model(name, compute_dtype="float32",
                            use_checkpoint=False)
        x0 = jnp.zeros((1, *shape, in_ch), jnp.float32)
        vs = jax.jit(m.init, static_argnums=(2,))(jax.random.key(0), x0,
                                                   False)
        stats = jax.tree.map(
            lambda s: s * (1.0 + 0.1 * jax.random.uniform(
                jax.random.key(1), s.shape)) + 0.01,
            vs["batch_stats"])
        vs = {"params": vs["params"], "batch_stats": stats}
        x = rng.random((1, *shape, in_ch)).astype(np.float32)
        want = m.apply(vs, jnp.asarray(x), False)
        want = [np.asarray(w) for w in
                (want if isinstance(want, tuple) else (want,))]
        for w in want:
            assert float(w.std()) > 1e-3, "degenerate (constant) output"
        sd = from_flax(_np_tree(vs["params"]), _np_tree(vs["batch_stats"]))
        out[name] = (x, want, sd)
    return out


@pytest.mark.parametrize("name", ["UNetSP", "UNetDO", "UNet4b2i3o"])
def test_from_flax_model_matches_apply(variants, name):
    x, want, sd = variants[name]
    m = build_model(name)
    m.load_state_dict(sd)  # strict: every key maps
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", ["UNetSP", "UNetDO", "UNet4b2i3o"])
def test_engine_plain_path_matches_apply(variants, name):
    """The engine's own code on CPU tensors (K1-K3 plain versions, the
    folded weights, the composite upconv, the weight-split head; the
    single 3-channel head for UNet4b2i3o)."""
    x, want, sd = variants[name]
    predict = tengine.build_predict(name, sd, torch.float32, device="cpu")
    got = predict(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_engine_refuses_unported_families():
    """The port's engine serves every family ``ctunet_tpu``'s does, the
    5-block family included (``test_torch_port_spsmall.py`` holds it
    against JAX); a family neither knows is refused."""
    from ctunet_tpu import engine as jengine

    assert set(tengine.ENGINE_CONFIGS) == set(jengine.ENGINE_CONFIGS)
    x = torch.zeros(1, 32, 32, 32, 2)
    for name in ("UNetSPSmall", "UNet5b2i3o"):
        torch.manual_seed(0)
        sd = build_model(name).state_dict()
        out = tengine.build_predict(name, sd, torch.float32, device="cpu")(x)
        out = out if isinstance(out, tuple) else (out,)
        assert [tuple(o.shape) for o in out] == (
            [(1, 32, 32, 32, 2)] * 2 if name == "UNetSPSmall"
            else [(1, 32, 32, 32, 3)])
    with pytest.raises(KeyError, match="no engine config"):
        tengine.build_predict("UNet6b", {}, device="cpu")


def test_committed_npz_equals_orbax_restore():
    """``load_any(npz)`` + ``from_flax`` == ``from_flax`` of the orbax
    restore of ``.ckpts/unetsp_10k``, bit for bit."""
    from ctunet_tpu.checkpoint import load_any as jax_load_any

    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"), "UNetSP")
    want = from_flax(_np_tree(vs["params"]), _np_tree(vs["batch_stats"]))
    got = tckpt.load_any(tckpt.UNETSP_10K)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    build_model("UNetSP").load_state_dict(got)


def test_reference_pt_state_dict_loads(tmp_path, variants):
    """A reference-layout ``.pt`` (``module.`` prefix, dead ``cblock``
    keys) loads natively and equals the ``from_flax`` conversion."""
    from ctunet_tpu.models.torch_port import export_state_dict

    _, _, sd = variants["UNetSP"]
    # ctunet_tpu's own exporter writes the reference torch layout
    ref = export_state_dict(tckpt.unflatten(_flax_flat(sd)), "UNetSP")
    ref = {f"module.{k}": torch.from_numpy(np.asarray(v))
           for k, v in ref.items()}
    ref["module.cblock.block.0.weight"] = torch.zeros(1)
    path = str(tmp_path / "ref.pt")
    torch.save(ref, path)
    got = tckpt.load_any(path)
    for k, v in sd.items():
        assert torch.equal(got[k].float(), v.float()), k


def _flax_flat(sd):
    """Port state_dict -> flat flax keys (inverse of ``from_flax``)."""
    flat = {}

    def unit(src, dst, conv_idx):
        bn = conv_idx + 1
        flat[f"params/unet/{dst}/conv/kernel"] = (
            sd[f"{src}.{conv_idx}.weight"].numpy().transpose(2, 3, 4, 1, 0))
        flat[f"params/unet/{dst}/bn/scale"] = sd[f"{src}.{bn}.weight"].numpy()
        flat[f"params/unet/{dst}/bn/bias"] = sd[f"{src}.{bn}.bias"].numpy()
        flat[f"batch_stats/unet/{dst}/bn/mean"] = (
            sd[f"{src}.{bn}.running_mean"].numpy())
        flat[f"batch_stats/unet/{dst}/bn/var"] = (
            sd[f"{src}.{bn}.running_var"].numpy())

    for i in range(4):
        for j, c in enumerate((0, 3)):
            unit(f"d_blocks.{i}.block", f"d{i}/unit{j}", c)
        for j, c in enumerate((1, 4)):
            unit(f"u_blocks.{i}.block", f"u{i}/unit{j}", c)
        flat[f"params/unet/u{i}/upconv/kernel"] = (
            sd[f"u_blocks.{i}.block.0.weight"].numpy().transpose(2, 3, 4, 1,
                                                                 0))
        flat[f"params/unet/u{i}/upconv/bias"] = (
            sd[f"u_blocks.{i}.block.0.bias"].numpy())
    flat["params/unet/last_conv/kernel"] = (
        sd["last_conv.weight"].numpy().transpose(2, 3, 4, 1, 0))
    flat["params/unet/last_conv/bias"] = sd["last_conv.bias"].numpy()
    return flat


def test_npz_roundtrip_through_flat_keys(tmp_path, variants):
    """The ``.npz`` layout the export tool writes loads back exactly."""
    _, _, sd = variants["UNetDO"]
    path = str(tmp_path / "w.npz")
    np.savez(path, **_flax_flat(sd))
    got = tckpt.load_any(path)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


_FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "ctunet_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_ctunet_tpu():
    files = glob.glob(os.path.join(ROOT, "ctunet_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 20
    for mod in ("models/legacy.py", "ops/kernels/convt.py", "engine.py"):
        assert os.path.join(ROOT, "ctunet_tpu_torch", mod) in files, mod
    bad = []
    for f in files:
        for mod in _imports(f):
            if mod.split(".")[0] in _FORBIDDEN:
                bad.append((os.path.relpath(f, ROOT), mod))
    assert not bad, bad
