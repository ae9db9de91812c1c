"""PyTorch port, ``param_dtype`` and ``profile_dir`` on the CPU.

- Models hold their conv, ConvTranspose and head parameters in
  ``param_dtype`` (bf16 or f16) and their BatchNorm scale, shift and
  statistics in f32, as the JAX model's variables are.
- The optimizer on the same gradients is optax's in bf16, bit for bit in
  at least 99.8% of the entries (each Python constant and each bias
  correction rounded to bf16 first, as JAX's weak types are). In f16 the
  parameters and moments are held in f16, but optax's arithmetic there is
  reproduced only for momentum SGD (see the test).
- One train step with ``param_dtype = bfloat16`` (f32 compute, stored
  pairs; UNetSP at 16x16x32 and UNet4_2IC at 32^3, ``conv_impl =
  "pallas"`` on the kernels' plain versions) against the JAX step with the
  same settings: loss rtol 1e-4 and BatchNorm statistics atol 1e-5 (the
  step tests'), every dtype as JAX's, and each bf16 parameter within
  ``2 * lr`` plus one bf16 ulp of JAX's, with at least 98% bit-equal and
  99% within one ulp (measured: UNetSP 99.29% bit-equal, 99.69% within one
  ulp; UNet4_2IC 98.54% and 99.30%). The rest are gradients near zero
  whose sign differs between the two packages' f32 sums (the step tests
  allow them 2e-4): Adam turns either sign into a step of ``lr``.
- Serving a bf16-parameter checkpoint: every engine folds in f32, so it
  equals the engine built on the same values in f32, and the f32 engine
  matches the JAX f32 engine on the same bf16 variables (atol 5e-4, rtol
  1e-3, ``tests/test_engine.py``'s).
- Loaded weights keep their own dtype under ``param_dtype``, as the JAX
  trainer keeps a loaded tree's (f32 ``.npz``: f32 parameters and
  moments).
- ``profile_dir``: ``Model.train`` for two epochs writes one trace, of
  epoch 1.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctunet_tpu import engine as jengine
from ctunet_tpu import steps as jsteps
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import packed_conv as jpc
from ctunet_tpu.problem import FlapRecWithShapePriorDoubleOut as JHandler
from ctunet_tpu_torch import Model, checkpoint, engine, engine_q, steps
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
from test_torch_port_legacy_model import seeded_state_dict
import test_torch_port_legacy_train as legacy_train
import test_torch_port_train_step as train_step

torch.set_num_threads(2)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
CFG = dict(optimizer="adam", learning_rate=1e-4)
LOSS = dict(ce_lambda=1.0, dice_lambda=1.0, save_dice_plots=True)


def _ulp(a, mantissa_bits: int):
    """The spacing of a float format with ``mantissa_bits`` at ``a``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30)))
                   - mantissa_bits)


def _is_bn(path) -> bool:
    return any(getattr(k, "key", None) == "bn" for k in path)


def _jax_params(params, dtype):
    """A flax ``params`` tree in ``dtype``, the BatchNorm leaves in f32."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if _is_bn(path)
                                    else dtype), params)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("mc,cin", [("UNetSP", 2), ("UNetSPSmall", 2),
                                    ("UNet4_2IC", 2)])
def test_parameters_held_as_in_the_jax_model(mc, cin, name):
    tdt, jdt = DTYPES[name]
    jm = jax_build_model(mc, compute_dtype="float32", param_dtype=name,
                         use_checkpoint=False)
    vs = jax.eval_shape(lambda k, x: jm.init(k, x, False),
                        jax.random.key(0), jnp.zeros((1, 32, 32, 32, cin)))
    want = sorted(str(leaf.dtype) for leaf in jax.tree.leaves(vs["params"]))
    assert {str(a.dtype) for a in jax.tree.leaves(vs["batch_stats"])} == {
        "float32"}
    model = build_model(mc, tdt)
    got = sorted(str(p.dtype).replace("torch.", "")
                 for p in model.parameters())
    assert got == want
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert m.weight.dtype == m.running_var.dtype == torch.float32


def _optax_run(cfg, p0, grads, jdt):
    opt = jsteps.make_optimizer(cfg)

    @jax.jit
    def update(p, state, g, value):
        u, state = opt.update(g, state, p, value=value)
        return optax.apply_updates(p, u), state

    p = jnp.asarray(p0, jdt)
    state = opt.init(p)
    for i, g in enumerate(grads):
        p, state = update(p, state, jnp.asarray(g, jdt), _plateau_value(i))
    return np.asarray(p, np.float32)


def _plateau_value(i: int) -> float:
    return 1.0 + 1e-3 * (i % 3 == 0)  # a plateau every third step


def _port_run(cfg, p0, grads, tdt):
    p = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    opt = steps.make_optimizer(cfg, [p])
    for i, g in enumerate(grads):
        p.grad = torch.from_numpy(g).to(tdt)
        opt.step(value=torch.tensor(_plateau_value(i)))
    for v in opt.state[p].values():  # moments in the parameter's dtype
        assert v.dtype == tdt
    assert p.dtype == tdt
    return p.detach().float().numpy()


@pytest.mark.parametrize("cfg", [
    dict(optimizer="adam", learning_rate=1e-4),
    dict(optimizer="adam", learning_rate=1e-3, weight_decay=1e-2),
    dict(optimizer="adamw", learning_rate=1e-3, weight_decay=1e-2),
    dict(optimizer="rmsprop", learning_rate=1e-3, momentum=0.9),
    dict(optimizer="sgd", learning_rate=1e-2, momentum=0.9),
    dict(optimizer="adam", learning_rate=1e-3, scheduler=True),
], ids=["adam", "adam_l2", "adamw", "rmsprop", "sgd", "adam_plateau"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_optimizer_matches_optax_on_the_same_gradients(cfg, seed):
    """12 steps in bf16, gradients over five decades: at least 99.8% of
    the entries bit-equal, the rest within 8 ulps (measured: adam, adamw,
    rmsprop and sgd bit-equal; with the plateau scheduler 4 of 4000
    entries 1-2 ulps off, where XLA fuses the f32 scale's product into the
    add; an rmsprop draw outside these seeds showed one entry 5 ulps off,
    bf16 ``rsqrt`` rounded apart)."""
    rng = np.random.default_rng(seed)
    p0 = (rng.standard_normal(4000) * 0.05).astype(np.float32)
    grads = [(rng.standard_normal(4000)
              * 10.0 ** rng.uniform(-6, -1, 4000)).astype(np.float32)
             for _ in range(12)]
    want = _optax_run(cfg, p0, grads, jnp.bfloat16)
    got = _port_run(cfg, p0, grads, torch.bfloat16)
    off = np.abs(got - want) / _ulp(want, 7)
    assert (off == 0).mean() >= 0.998 and off.max() <= 8, (
        (off == 0).mean(), off.max())


def test_f16_optimizer_holds_f16_and_matches_sgd():
    """f16 parameters and moments stay f16. optax's f16 arithmetic is not
    reproduced to the bit: XLA on the CPU keeps f16 chains in f32 between
    its roundings, where the port rounds every operation, and Adam's eps
    (1e-8) is 0 in f16, so both produce NaNs, on different entries, where
    a moment underflows. Momentum SGD, which has neither, is held: one
    step, at least 98% bit-equal and the rest within one ulp of the larger
    operand (measured 98.6%, 1)."""
    rng = np.random.default_rng(2)
    p0 = (rng.standard_normal(4000) * 0.05).astype(np.float32)
    grads = [(rng.standard_normal(4000)
              * 10.0 ** rng.uniform(-2, -1, 4000)).astype(np.float32)]
    cfg = dict(optimizer="sgd", learning_rate=1e-2, momentum=0.9)
    want = _optax_run(cfg, p0, grads, jnp.float16)
    got = _port_run(cfg, p0, grads, torch.float16)
    # in ulps of the larger of the parameter before and after the step:
    # where the update cancels most of it, XLA's one rounding and the
    # port's two differ by an ulp of the operands, many of the result
    scale = np.maximum(np.abs(p0.astype(np.float16).astype(np.float32)),
                       np.maximum(np.abs(want), np.abs(got)))
    off = np.abs(got - want) / _ulp(scale, 10)
    assert (off == 0).mean() >= 0.98 and off.max() <= 1
    for name in ("adam", "rmsprop"):
        _port_run(dict(optimizer=name), p0, grads, torch.float16)


_JAX_STEPS = {}


def _jax_step(mc):
    if mc in _JAX_STEPS:
        return _JAX_STEPS[mc]
    if mc == "UNetSP":
        broken, flaps, atlas = train_step._pairs()
        handler = JHandler()
    else:
        broken, flaps, atlas = legacy_train._pairs()
        handler = legacy_train.HANDLERS[mc][0]()
    params, stats = to_flax(seeded_state_dict(mc),
                            root="unet" if mc == "UNetSP" else None)
    params = _jax_params(params, jnp.bfloat16)
    stats = jax.tree.map(jnp.asarray, stats)
    jpc.set_conv_impl("xla")
    jm = jax_build_model(mc, compute_dtype="float32",
                         param_dtype="bfloat16", use_checkpoint=False)
    opt = jsteps.make_optimizer(CFG)
    step = jsteps.make_train_step(jm, handler, opt, LOSS, atlas=atlas,
                                  compute_dtype=jnp.float32, from_pairs=True,
                                  donate=False)
    state = jsteps.TrainState(params, stats, opt.init(params),
                              jnp.zeros((), jnp.int32))
    batch = {"image": jnp.asarray(broken), "flap": jnp.asarray(flaps)}
    state, terms = step(state, batch, jax.random.key(0))
    _JAX_STEPS[mc] = (state, float(terms["epoch_loss"]))
    return _JAX_STEPS[mc]


@pytest.mark.parametrize("mc", ["UNetSP", "UNet4_2IC"])
def test_bf16_param_train_step_matches_jax(mc):
    want_state, want_loss = _jax_step(mc)
    if mc == "UNetSP":
        broken, flaps, atlas = train_step._pairs()
        handler = FlapRecWithShapePriorDoubleOut()
    else:
        broken, flaps, atlas = legacy_train._pairs()
        handler = legacy_train.HANDLERS[mc][1]()
    model = build_model(mc, torch.bfloat16)
    model.load_state_dict(seeded_state_dict(mc))
    model.configure("pallas", torch.float32)
    state = steps.TrainState(model, steps.make_optimizer(
        CFG, model.parameters()))
    step = steps.make_train_step(model, handler, LOSS, atlas=atlas,
                                 compute_dtype=torch.float32,
                                 from_pairs=True)
    _, terms = step(state, {"image": torch.from_numpy(broken),
                            "flap": torch.from_numpy(flaps)},
                    torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(terms["epoch_loss"]), want_loss,
                               rtol=1e-4)
    # dtypes: parameters, moments and statistics as JAX keeps them
    for p in model.parameters():
        assert p.grad.dtype == p.dtype
        assert {v.dtype for v in state.optimizer.state[p].values()} == {
            p.dtype}
    jax_moments = {str(a.dtype) for a in jax.tree.leaves(
        want_state.opt_state) if a.ndim}
    assert jax_moments == {"bfloat16", "float32"}
    root = "unet" if mc == "UNetSP" else None
    got_params, got_stats = to_flax(model.state_dict(), root=root)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_leaves_with_path(want_state.batch_stats),
            jax.tree_util.tree_leaves_with_path(got_stats)):
        assert w.dtype == jnp.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                   err_msg=str(path))
    sd_dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    lr = CFG["learning_rate"]
    before, _ = to_flax(seeded_state_dict(mc), root=root)
    want_mu = dict(jax.tree_util.tree_leaves_with_path(next(
        st for st in jax.tree.leaves(want_state.opt_state,
                                     is_leaf=lambda st: hasattr(st, "mu"))
        if hasattr(st, "mu")).mu))
    mu_sd = {k: state.optimizer.state[v]["mu"].float() if v.requires_grad
             else v for k, v in model.state_dict(keep_vars=True).items()}
    port_mu = dict(jax.tree_util.tree_leaves_with_path(
        to_flax(mu_sd, root=root)[0]))
    mu_max = max(float(np.abs(np.asarray(m)).max())
                 for k, m in want_mu.items() if _is_bn(k))
    n = equal = within = 0
    for (path, w), (_, g), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(want_state.params),
            jax.tree_util.tree_leaves_with_path(got_params),
            jax.tree_util.tree_leaves_with_path(before)):
        w32 = np.asarray(w, np.float32)
        if _is_bn(path):  # f32 on both sides
            assert w.dtype == jnp.float32
            # every entry moved on both sides: Adam's first step is about
            # lr whatever the gradient (measured: at least 0.67 lr)
            assert (np.abs(w32 - b) >= 0.5 * lr).all(), path
            assert (np.abs(g - b) >= 0.5 * lr).all(), path
            # and by the same gradient: the first moments, (1 - b1) g,
            # within 1e-3 of the largest BatchNorm one (measured 1.5e-4:
            # the f32 sums' absolute error, as in the f32 step tests)
            np.testing.assert_allclose(port_mu[path],
                                       np.asarray(want_mu[path]), rtol=0,
                                       atol=1e-3 * mu_max, err_msg=str(path))
            continue
        assert w.dtype == jnp.bfloat16
        ulp = _ulp(w32, 7)
        diff = np.abs(g - w32)
        # two updates of opposite sign, each lr within bf16's rounding of
        # the Adam ratio, then each sum rounded at its own value
        bound = 2 * CFG["learning_rate"] * (1 + 2.0 ** -6) + np.maximum(
            ulp, _ulp(g, 7))
        assert (diff <= bound).all(), path
        n += w32.size
        equal += int((diff == 0).sum())
        within += int((diff <= ulp).sum())
    assert torch.bfloat16 in set(sd_dtypes.values())
    assert equal / n >= 0.98, equal / n
    assert within / n >= 0.99, within / n


def _sd_in(sd, dtype):
    """``sd`` with every parameter that is not BatchNorm's in ``dtype``,
    as a ``param_dtype`` model's state_dict holds it."""
    model = build_model("UNetSP" if "d_blocks.0.block.0.weight" in sd
                        else "UNet4_2IC", dtype)
    model.load_state_dict(sd)
    return model.state_dict()


def test_engines_fold_bf16_parameters_in_f32():
    """A bf16-parameter state_dict serves as its values do in f32, in the
    bf16, f32 and int8 engines and the legacy engine."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.random((1, 16, 16, 16, 2)) > 0.5)
                         .astype(np.float32))
    for mc in ("UNetSP", "UNet4_2IC"):
        sd16 = _sd_in(seeded_state_dict(mc), torch.bfloat16)
        assert sd16[next(k for k in sd16 if k.endswith("0.weight"))
                    ].dtype == torch.bfloat16
        sd32 = {k: v.float() if v.is_floating_point() else v
                for k, v in sd16.items()}
        for dt in (torch.bfloat16, torch.float32):
            a = engine.build_predict(mc, sd16, dt, device="cpu")(x.to(dt))
            b = engine.build_predict(mc, sd32, dt, device="cpu")(x.to(dt))
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(u, v), (mc, dt)
    sd16 = _sd_in(seeded_state_dict("UNetSP"), torch.bfloat16)
    sd32 = {k: v.float() if v.is_floating_point() else v
            for k, v in sd16.items()}
    xb = x.to(torch.bfloat16)
    qa = engine_q.build_predict_q("UNetSP", sd16, xb[0], device="cpu")(xb)
    qb = engine_q.build_predict_q("UNetSP", sd32, xb[0], device="cpu")(xb)
    for u, v in zip(qa, qb):
        assert torch.equal(u, v)


def test_bf16_parameters_serve_as_the_jax_engine():
    """The f32 engine on a bf16-parameter state_dict against the JAX f32
    engine (Pallas in interpret mode) on the same bf16 variables."""
    shape = (16, 16, 16)
    sd16 = _sd_in(checkpoint.load_any(checkpoint.UNETSP_10K), torch.bfloat16)
    params, stats = to_flax(sd16)
    vs = {"params": _jax_params(params, jnp.bfloat16),
          "batch_stats": jax.tree.map(jnp.asarray, stats)}
    # the JAX tree carries the same values back
    back = from_flax(vs["params"], vs["batch_stats"])
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd16[k].float()), k
    x = (np.random.default_rng(9).random((1, *shape, 2)) > 0.5).astype(
        np.float32)
    want = jengine.build_predict("UNetSP", vs, compute_dtype=jnp.float32,
                                 interpret=True)(jnp.asarray(x))
    got = engine.build_predict("UNetSP", sd16, torch.float32,
                               device="cpu")(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-3)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    shape = (16, 16, 32)
    root = tmp_path_factory.mktemp("pdtype")
    csv = make_dataset(str(root / "data"), n=2, shape=shape, seed=11)
    register_atlas(shape, spherical_shell(shape, radius_frac=0.42))
    return root, csv


def _train_params(root, csv, **kw):
    return dict(dict(
        train_flag=True, name="pd", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(root / "ws"), train_files_csv=csv,
        validation_files_csv=csv, n_epochs=1, batch_size=1,
        optimizer="adam", learning_rate=1e-4, ce_lambda=1.0,
        dice_lambda=1.0, conv_impl="chain", compute_dtype="bfloat16",
        n_workers=1), **kw)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_model_trains_saves_resumes_and_serves_in_param_dtype(synth, name):
    root, csv = synth
    tdt = DTYPES[name][0]
    m = Model(params=_train_params(root, csv, name=f"pd_{name}",
                                   param_dtype=name, test_flag=True,
                                   test_files_csv=csv))
    losses = [float(v) for v in m.step_losses]
    # f16 Adam NaNs where a moment underflows (eps is 0 in f16), as in JAX
    assert np.isfinite(losses[0]) and (
        name == "float16" or np.isfinite(losses).all()), losses
    saved = checkpoint.restore_checkpoint(m.params["model_path"])
    dts = {k: v.dtype for k, v in saved["model"].items()}
    assert dts["d_blocks.0.block.0.weight"] == tdt
    assert dts["d_blocks.0.block.1.weight"] == torch.float32
    assert dts["d_blocks.0.block.1.running_var"] == torch.float32
    moments = saved["optimizer"]["state"]
    assert {v["mu"].dtype for v in moments.values()} == {tdt, torch.float32}
    out = os.path.join(os.path.dirname(csv), f"pred_pd_{name}")
    assert len(glob.glob(os.path.join(out, "*_fl.nii.gz"))) == 2
    # resume: parameters, moments and step come back in their dtypes
    r = Model(params=_train_params(root, csv, name=f"pd_{name}_r",
                                   param_dtype=name,
                                   resume_model=m.params["model_path"]))
    # two volumes at batch 1: two steps an epoch, resumed at step 2
    assert r.state.step == 4
    assert next(r.state.model.parameters()).dtype == tdt


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_loaded_f32_weights_are_rounded_to_param_dtype(synth, tmp_path,
                                                       name):
    """Loaded weights keep their own dtype under ``param_dtype``, as the
    JAX trainer merges a loaded tree over the initialised one
    (``ctunet_tpu/trainer.py:452-457``): the f32 ``.npz`` served and
    trained under bf16 or f16 stays f32, each tensor the file's exactly,
    and the optimizer's moments follow (f32); the JAX ``Model``'s loaded
    variables are f32 too. (The test's name is from when the port rounded
    them to ``param_dtype``.)"""
    from ctunet_tpu import Model as JaxModel
    from ctunet_tpu.data.atlas import register_atlas as jax_register_atlas

    root, csv = synth
    want = checkpoint.load_any(checkpoint.UNETSP_10K)
    m = Model(params=dict(
        test_flag=True, name=f"ld_{name}", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(root / "ws"), test_files_csv=csv,
        param_dtype=name, resume_model=checkpoint.UNETSP_10K))
    got = m.models["main"].state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    t = Model(params=_train_params(root, csv, name=f"ldt_{name}",
                                   param_dtype=name,
                                   resume_model=checkpoint.UNETSP_10K))
    assert {p.dtype for p in t.state.model.parameters()} == {torch.float32}
    moments = t.state.optimizer.state.values()
    assert {v["mu"].dtype for v in moments} == {torch.float32}
    # a newly initialised model stays in param_dtype
    fresh = Model(params=_train_params(root, csv, name=f"ldn_{name}",
                                       param_dtype=name))
    conv = fresh.state.model.state_dict()["d_blocks.0.block.0.weight"]
    assert conv.dtype == DTYPES[name][0]
    if name != "bfloat16":
        return  # the JAX merge keeps the loaded dtype whatever param_dtype
    jm = JaxModel(params=dict(
        test_flag=False, name=f"ldj_{name}", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(tmp_path / "jws"), test_files_csv=csv,
        param_dtype=name, resume_model=os.path.join(
            os.path.dirname(os.path.dirname(__file__)), ".ckpts",
            "unetsp_10k")))
    jm.params["test_flag"] = True
    jax_register_atlas((16, 16, 32), spherical_shell((16, 16, 32),
                                                     radius_frac=0.42))
    jm.load_datasets()
    jm.initialize_models()
    jdt = {a.dtype for a in jax.tree.leaves(jm._variables["params"])}
    assert jdt == {jnp.dtype(jnp.float32)}


def test_profile_dir_traces_the_first_epoch_only(synth):
    root, csv = synth
    prof = root / "profile"
    m = Model(params=_train_params(root, csv, name="prof", n_epochs=2,
                                   profile_dir=str(prof)))
    assert m.current_epoch == 2
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"epoch 1 train step 0", "epoch 1 train step 1"} <= names
    assert not any(str(n).startswith("epoch 2") for n in names)
