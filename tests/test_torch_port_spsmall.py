"""PyTorch port, the 5-block family (``UNetSPSmall``, ``UNet5b2i3o``) on the
CPU against ``ctunet_tpu``.

- The models against ``model.apply(train=False)`` at 32^3 in f32 (the
  committed ``unetspsmall_3k`` weights and random ones with non-trivial BN
  statistics), atol 5e-4 / rtol 1e-3 as ``tests/test_engine.py:58-72``;
  833,923 parameters (``tests/test_models.py:24-27``); the committed
  ``.npz`` equal to the orbax restore bit for bit; five ``d*``/``u*``
  blocks through ``models/convert.py`` both ways and from a reference
  ``.pt``.
- The f32 engine against the JAX engine (interpret mode) at 32^3, same
  tolerance; the ``double_softmax`` head returns f32 as the JAX engine's
  packed head does.
- (int8 and AdaQuant: ``test_torch_port_spsmall_int8.py``.)
- One train step of ``UNetSPSmall`` against the JAX step (loss rtol 1e-4,
  gradients atol 2e-4), whose double-output loss softmaxes the already
  softmaxed heads (quirk Q4, ``ctunet_tpu/problem.py:20-21``).
- The pool multiple: 32 for the 5-block classes in ``Model``'s padding,
  fg-crop serving and fg-crop training.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine as je
from ctunet_tpu import steps as jsteps
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.problem import FlapRecWithShapePriorDoubleOut as JHandler
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import checkpoint as tckpt
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch import steps
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
from test_torch_port_foreground import _write_csv
from test_torch_port_int8_engine import ROOT

torch.set_num_threads(2)

SHAPE = (32, 32, 32)  # the smallest cube with even extents at 5 levels
TOL = dict(atol=5e-4, rtol=1e-3)
FIVE = ("UNetSPSmall", "UNet5b2i3o")
CFG = dict(optimizer="adam", learning_rate=1e-4)
LOSS = dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True)


def skull_and_atlas(shape=SHAPE, seed=3):
    """A shell with a cap removed and the atlas shell, ``(1, D, H, W, 2)``
    f32."""
    skull = spherical_shell(shape, seed=seed).astype(np.float32)
    skull[: shape[0] // 3, : shape[1] // 2] = 0.0
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    return np.stack([skull, atlas], -1)[None]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def small3k():
    """The committed weights: the JAX variables and the port's
    state_dict."""
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetspsmall_3k"),
                      "UNetSPSmall")
    return vs, tckpt.load_any(tckpt.UNETSPSMALL_3K)


def _random_variables(name):
    """Random JAX weights with non-trivial BN statistics
    (``tests/test_engine.py::_variables``)."""
    m = jax_build_model(name, compute_dtype="float32", use_checkpoint=False)
    vs = jax.jit(m.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *SHAPE, 2), jnp.float32), False)
    stats = jax.tree.map(
        lambda s: s * (1.0 + 0.1 * jax.random.uniform(
            jax.random.key(1), s.shape)) + 0.01, vs["batch_stats"])
    return m, {"params": vs["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def applied(small3k):
    """``{name: (x, model.apply outputs, state_dict)}``: UNetSPSmall on
    the 3k weights, UNet5b2i3o on random ones."""
    out = {}
    x = skull_and_atlas()
    for name in FIVE:
        if name == "UNetSPSmall":
            m = jax_build_model(name, compute_dtype="float32",
                                use_checkpoint=False)
            vs, sd = small3k
        else:
            m, vs = _random_variables(name)
            sd = from_flax(_np_tree(vs["params"]),
                           _np_tree(vs["batch_stats"]))
        want = m.apply(vs, jnp.asarray(x), False)
        want = [np.asarray(w) for w in
                (want if isinstance(want, tuple) else (want,))]
        out[name] = (x, want, sd)
    return out


@pytest.mark.parametrize("name", FIVE)
def test_model_matches_apply(applied, name):
    x, want, sd = applied[name]
    m = build_model(name)
    m.load_state_dict(sd)  # strict: every key of five blocks maps
    assert sum(p.numel() for p in m.parameters()) == 833923
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (2 if name == "UNetSPSmall" else 1)
    for g, w in zip(got, want):
        assert float(w.std()) > 1e-3, "degenerate (constant) output"
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    if name == "UNetSPSmall":  # softmaxed heads: each sums to one
        for g in got:
            np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", FIVE)
def test_engine_plain_path_matches_apply(applied, name):
    """The engine's own code on CPU tensors at five levels, f32: K1-K3's
    plain versions, the composite upconv, the weight-split head."""
    x, want, sd = applied[name]
    got = tengine.build_predict(name, sd, torch.float32,
                                device="cpu")(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_committed_npz_equals_orbax_restore(small3k):
    """``load_any(unetspsmall_3k.npz)`` == ``from_flax`` of the orbax
    restore of ``.ckpts/unetspsmall_3k``, bit for bit."""
    vs, got = small3k
    want = from_flax(_np_tree(vs["params"]), _np_tree(vs["batch_stats"]))
    assert got.keys() == want.keys()
    assert sum(k.startswith("d_blocks.4.") for k in got) == 12
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_round_trip_and_reference_pt(tmp_path, small3k):
    """``to_flax`` inverts ``from_flax`` at five blocks, and the JAX
    package's reference-layout export (``module.`` prefix, a dead
    ``cblock`` key) loads to the same state_dict."""
    from ctunet_tpu.models.torch_port import export_state_dict

    vs, sd = small3k
    params, stats = to_flax(sd)
    assert set(params["unet"]) == {f"d{i}" for i in range(5)} | {
        f"u{i}" for i in range(5)} | {"last_conv"}
    back = from_flax(params, stats)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ref = export_state_dict(vs, "UNetSPSmall")
    ref = {f"module.{k}": torch.from_numpy(np.asarray(v))
           for k, v in ref.items()}
    ref["module.cblock.block.0.weight"] = torch.zeros(1)
    path = str(tmp_path / "ref.pt")
    torch.save(ref, path)
    got = tckpt.load_any(path)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k].float(), v.float()), k


@pytest.fixture(scope="module")
def jax_engine_f32(small3k):
    """The JAX engine (Pallas in interpret mode), f32, at 32^3."""
    vs, _ = small3k
    x = skull_and_atlas()
    out = je.build_predict("UNetSPSmall", vs, compute_dtype=jnp.float32,
                           interpret=True)(jnp.asarray(x))
    return x, out


def test_engine_f32_matches_jax_engine(small3k, jax_engine_f32):
    """The double_softmax head returns f32 on both sides (the JAX packed
    head softmaxes the f32 sigmoid maps, ``engine.py:463-484``)."""
    _, sd = small3k
    x, want = jax_engine_f32
    got = tengine.build_predict("UNetSPSmall", sd, torch.float32,
                                device="cpu")(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert np.asarray(want[0]).argmax(-1).any()


def test_bf16_engine_returns_f32_softmax(small3k, applied):
    """In bf16 the head still softmaxes the f32 sigmoid and returns f32,
    within bf16 rounding of the f32 model."""
    x, want, sd = applied["UNetSPSmall"]
    got = tengine.build_predict("UNetSPSmall", sd, torch.bfloat16,
                                device="cpu")(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2)


def _pairs(seed=0):
    """One stored (broken, flap) pair at 32^3 and the atlas."""
    rng = np.random.default_rng(seed)
    full = spherical_shell(SHAPE, seed=seed).astype(np.float32)
    zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in SHAPE)]
    c = np.argwhere(full > 0)[rng.integers(0, int(full.sum()))]
    hole = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) <= 36
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    return (full * ~hole)[None], (full * hole)[None], atlas


@pytest.fixture(scope="module")
def jax_step(small3k):
    """One JAX train step (``conv_impl = "xla"``) of UNetSPSmall from the
    3k weights: its terms and step-1 gradients."""
    vs, _ = small3k
    broken, flaps, atlas = _pairs()
    jpc.set_conv_impl("xla")
    jm = jax_build_model("UNetSPSmall", compute_dtype="float32",
                         use_checkpoint=False)
    handler = JHandler()
    x = jnp.stack([jnp.asarray(broken),
                   jnp.broadcast_to(atlas[None], broken.shape)], -1)
    _, targets = jax.vmap(handler.targets_from_pair)(jnp.asarray(broken),
                                                     jnp.asarray(flaps))

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": vs["batch_stats"]},
                          x, True, mutable=["batch_stats"])
        return handler.compute_losses(out, targets, LOSS)[0]

    grads = jax.grad(loss_fn)(vs["params"])
    opt = jsteps.make_optimizer(CFG)
    step = jsteps.make_train_step(jm, handler, opt, LOSS, atlas=atlas,
                                  compute_dtype=jnp.float32, from_pairs=True,
                                  donate=False)
    state = jsteps.TrainState(vs["params"], vs["batch_stats"],
                              opt.init(vs["params"]),
                              jnp.zeros((), jnp.int32))
    _, terms = step(state, {"image": jnp.asarray(broken),
                            "flap": jnp.asarray(flaps)}, jax.random.key(0))
    return {k: float(v) for k, v in terms.items()}, grads


@pytest.mark.parametrize("impl", ["xla", "chain"])
def test_train_step_matches_jax(small3k, jax_step, impl):
    _, sd = small3k
    want, grads = jax_step
    broken, flaps, atlas = _pairs()
    model = build_model("UNetSPSmall")
    model.load_state_dict(sd)
    model.configure(impl, torch.float32)
    state = steps.TrainState(model, steps.make_optimizer(
        CFG, model.parameters()))
    step = steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(),
                                 LOSS, atlas=atlas,
                                 compute_dtype=torch.float32,
                                 from_pairs=True)
    _, terms = step(state, {"image": torch.from_numpy(broken),
                            "flap": torch.from_numpy(flaps)},
                    torch.Generator().manual_seed(0))
    got = {k: float(v) for k, v in terms.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-3,
                                   err_msg=k)
    g_jax = from_flax(_np_tree(grads), _np_tree(small3k[0]["batch_stats"]))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_jax[k].numpy(),
                                   atol=2e-4, err_msg=k)


def test_pool_multiple_is_per_model(tmp_path, small3k):
    """32 for the 5-block classes (``ctunet_tpu/trainer.py:53-56``), 16
    for the rest: a 40x48x40 volume is padded to 64x64x64 and served;
    its fg-crop window and its int8 engine's input are multiples of 32;
    the fg-crop training window snaps to 32 and an explicit
    ``s_fg_train_size`` that does not is refused."""
    shape = (40, 48, 40)
    vol = spherical_shell(shape, radius_frac=0.2, center=(20, 24, 20))
    csv, _ = _write_csv(str(tmp_path / "serve"), [vol], vol)
    base = dict(name="pm", problem_handler="FlapRecWithShapePriorDoubleOut",
                device="cpu", workspace_path=str(tmp_path / "ws"),
                n_workers=1, compute_dtype="float32")
    m = Model(params=dict(base, test_flag=True, model_class="UNetSPSmall",
                          test_files_csv=csv,
                          resume_model=tckpt.UNETSPSMALL_3K, fg_crop=True,
                          fg_margin=2, use_int8=True))
    assert m.pool_multiple == 32 and m.n_served == 1
    (q_shape,) = m.int8_engines  # the crop window of the 64^3 canvas
    assert all(s % 32 == 0 for s in q_shape[:3])
    assert q_shape[:3] != (64, 64, 64)
    for mc, n in (("UNetSP", 16), ("UNet5b2i3o", 32), ("UNet4_2IC", 16)):
        assert tengine.pool_multiple(mc) == n
    shape = (64, 96, 96)
    vol = spherical_shell(shape, radius_frac=0.1, center=(40, 52, 52))
    csv, _ = _write_csv(str(tmp_path / "train"), [vol], vol)
    train = dict(base, train_flag=True, model_class="UNetSPSmall",
                 train_files_csv=csv, validation_files_csv=csv, n_epochs=1,
                 batch_size=1, fg_crop_train=True, fg_margin=2,
                 conv_impl="xla", dice_lambda=1.0, ce_lambda=1.0)
    t = Model(params=train)
    want = steps.fg_crop_size_for([vol], shape, margin=2, multiple=32)
    assert want is not None and t.fg_train_size == want
    assert all(s % 32 == 0 for s in want)
    assert want != steps.fg_crop_size_for([vol], shape, margin=2,
                                          multiple=16)
    with pytest.raises(AssertionError, match="divide by 32"):
        Model(params=dict(train, fg_train_size="32,32,48", name="pm2"))
