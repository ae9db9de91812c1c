"""PyTorch port, legacy k=5 family (``recAE_v2_fixed``, ``UNet4_2IC``): the
model, its weights and the f32 engine against ``ctunet_tpu``.

- the port's ``nn.Module`` on weights carried by ``convert.from_flax``
  against flax ``model.apply(train=False)``, with non-trivial BatchNorm
  statistics (the ``tests/test_engine.py`` recipe), at 16^3;
- one reference-named state_dict (a ``.pt`` with the ``module.`` prefix)
  serving both packages: ``torch_port.port_state_dict`` on the JAX side,
  ``checkpoint.load_any`` + ``load_state_dict`` on the port;
- the port's engine (``device="cpu"``: the kernels' plain versions, f32)
  against ``ctunet_tpu.engine.build_predict(..., interpret=True)``, whose
  full-resolution k=5 units run the Pallas ``conv3d_fused``;
- the launch plan: 18 K5, 4 K2, 1 K7a and 3 K7b per volume.

Tolerance atol 5e-4, rtol 1e-3, as ``tests/test_engine.py:90`` for the
same comparison (f32 on both sides, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine as jax_engine
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.models.torch_port import port_state_dict
from ctunet_tpu_torch import checkpoint as tckpt
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.ops.kernels import convt as kt

torch.set_num_threads(2)

TOL = dict(atol=5e-4, rtol=1e-3)
SHAPE = (16, 16, 16)
MODELS = [("recAE_v2_fixed", 1), ("UNet4_2IC", 2)]


def seeded_state_dict(name: str, seed: int = 0):
    """The reference's torch init from ``seed``, with BatchNorm scale,
    shift and running statistics moved off their init values (positive
    variances, small shifts: ReLUs stay live)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = build_model(name).state_dict()
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        u = torch.from_numpy(rng.random(v.shape).astype(np.float32))
        if k.endswith("running_var"):
            sd[k] = v * (1.0 + 0.1 * u) + 0.01
        elif k.endswith("running_mean"):
            sd[k] = 0.01 + 0.02 * (u - 0.5)
        elif k.endswith(".weight") and v.ndim == 1:  # BN scale
            sd[k] = 0.8 + 0.4 * u
        elif k.endswith(".bias") and v.ndim == 1 and "last_conv" not in k:
            sd[k] = v + 0.02 * (u - 0.5)
    return sd


@pytest.fixture(scope="module")
def legacy():
    """Per model: input, flax ``apply`` output on the flax tree, and the
    state_dict ``from_flax`` carries back from that tree."""
    rng = np.random.default_rng(0)
    out = {}
    for name, cin in MODELS:
        params, stats = to_flax(seeded_state_dict(name))
        vs = {"params": params, "batch_stats": stats}
        m = jax_build_model(name, compute_dtype="float32",
                            use_checkpoint=False)
        x = rng.random((1, *SHAPE, cin)).astype(np.float32)
        want = np.asarray(jax.jit(lambda v, x: m.apply(v, x, False))(
            vs, jnp.asarray(x)))
        assert float(want.std()) > 1e-3, "degenerate (constant) output"
        out[name] = (x, want, vs, from_flax(params, stats))
    return out


@pytest.mark.parametrize("name", [n for n, _ in MODELS])
def test_legacy_model_matches_flax_apply(legacy, name):
    x, want, _, sd = legacy[name]
    m = build_model(name)
    m.load_state_dict(sd)  # strict: every key maps
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    assert got.shape == (1, *SHAPE, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", [n for n, _ in MODELS])
def test_legacy_flax_tree_round_trip(legacy, name):
    """``from_flax`` then ``to_flax`` gives the JAX tree back exactly, at
    its root (no ``unet`` level)."""
    _, _, vs, sd = legacy[name]
    params, stats = to_flax(sd)
    for tree, back in ((vs["params"], params), (vs["batch_stats"], stats)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(back_flat[path], leaf)


def test_reference_pt_serves_both_packages(tmp_path, legacy):
    """One reference-named ``.pt`` (``module.`` prefix, BN
    ``num_batches_tracked``): the JAX package ports it with
    ``port_state_dict``, the port loads it with ``load_any`` (keeping the
    live ``cblock_center``), and both forwards agree."""
    name = "UNet4_2IC"
    x, _, _, sd = legacy[name]
    ref = {f"module.{k}": v for k, v in seeded_state_dict(name, 3).items()}
    path = str(tmp_path / "unet4_2ic.pt")
    torch.save(ref, path)
    got_sd = tckpt.load_any(path)
    assert any(k.startswith("cblock_center.") for k in got_sd)
    m = build_model(name)
    m.load_state_dict(got_sd)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    vs = port_state_dict({k: v.numpy() for k, v in ref.items()}, name)
    jm = jax_build_model(name, compute_dtype="float32", use_checkpoint=False)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(
        vs, jnp.asarray(x)))
    assert float(want.std()) > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", [n for n, _ in MODELS])
def test_legacy_engine_matches_jax_engine_interpret(legacy, name):
    """The port's legacy engine (plain versions, f32) against
    ``_build_legacy_predict`` with the Pallas k=5 kernel in interpret
    mode, same weights."""
    x, want, vs, sd = legacy[name]
    jw = np.asarray(jax_engine.build_predict(
        name, vs, compute_dtype=jnp.float32, interpret=True)(jnp.asarray(x)))
    got = tengine.build_predict(name, sd, torch.float32, device="cpu")(
        torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, *SHAPE, 2)
    assert float(got.std()) > 1e-3
    np.testing.assert_allclose(got.numpy(), jw, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_legacy_engine_launch_plan(monkeypatch):
    """Per volume at 32^3: 18 K5 (8 encoder, 2 center, 8 decoder), 4 K2,
    1 K7a (the first decoder block) and 3 K7b (the others, on the
    unconcatenated pair), counted on the plain versions' calls."""
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    for mod, name in ((kc, "conv3d5_bias_act"), (kc, "maxpool2"),
                      (kt, "convt_k2s2"), (kt, "convt_k2s2_dual")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    sd = seeded_state_dict("UNet4_2IC")
    predict = tengine.build_predict("UNet4_2IC", sd, torch.bfloat16,
                                    device="cpu")
    x = torch.rand((1, 32, 32, 32, 2))
    out = predict(x)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 32, 32, 32, 2)
    assert calls == {"conv3d5_bias_act": 18, "maxpool2": 4,
                     "convt_k2s2": 1, "convt_k2s2_dual": 3}
    with pytest.raises(ValueError, match="divide by 16"):
        predict(torch.rand((1, 24, 32, 32, 2)))


def test_legacy_engine_takes_no_record_or_sparse():
    sd = seeded_state_dict("recAE_v2_fixed")
    for kw in (dict(record=lambda t: t), dict(sparse=8)):
        with pytest.raises(NotImplementedError, match="legacy"):
            tengine.build_predict("recAE_v2_fixed", sd, device="cpu", **kw)
