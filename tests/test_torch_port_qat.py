"""PyTorch port, QAT on the CPU: ``ops/qat.py`` against
``ctunet_tpu/ops/qat.py``, and ``tools/qat_tune_torch.py``.

Seeded weights (``seeded_state_dict``), binary inputs from numpy seeds, f32
on both sides; UNetSP at 16x16x32 and UNetSPSmall at 32^3 (its five pools
need 32). Tolerances:

- ``calibrate_unit_scales``: within 1e-5 of each unit's largest scale
  (f32 rounding of the convs' sums; measured 6e-7 and 1e-6);
- ``QATModel.apply`` with the same scales: a fake-quant level flips where
  ``y / s`` sits on a half and the two packages' f32 convs round it apart.
  The flips are counted at every unit (on both sides' ``_fq_act``) and
  must stay under 1e-4 of the quantized activations (measured: 11 of
  304,640 for UNetSP, 9 of 698,368 for UNetSPSmall); the outputs must
  agree within atol 1e-5 (measured 3.6e-6).

No JAX int8 engine runs here (``tests/test_qat.py`` holds the JAX
fake-quant forward against it, in the slow lane).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import qat as jqat
from ctunet_tpu_torch import checkpoint
from ctunet_tpu_torch.data.synthetic import spherical_shell
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.models.convert import to_flax
from ctunet_tpu_torch.ops import qat as tqat
from test_torch_port_legacy_model import seeded_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"UNetSP": (16, 16, 32), "UNetSPSmall": (32, 32, 32)}


def _case(mc, seed=0):
    sd = seeded_state_dict(mc)
    params, stats = to_flax(sd)
    x = (np.random.default_rng(seed).random((1, *SHAPES[mc], 2))
         > 0.5).astype(np.float32)
    return sd, {"params": params, "batch_stats": stats}, x


def test_configs_are_the_jax_table():
    from ctunet_tpu.models.packed_resident import _CONFIGS

    assert tqat.CONFIGS == _CONFIGS
    assert tqat.supports("UNetSP") and not tqat.supports("UNet4_2IC")
    with pytest.raises(ValueError, match="unsupported"):
        tqat.QATModel("UNet4_2IC")


@pytest.mark.parametrize("mc", sorted(SHAPES))
def test_calibrate_unit_scales_matches_jax(mc):
    sd, vs, x = _case(mc)
    want = jqat.calibrate_unit_scales(mc, vs, x, dtype=jnp.float32)
    got = tqat.calibrate_unit_scales(mc, sd, x, dtype=torch.float32)
    n = 5 if mc == "UNetSPSmall" else 4
    assert set(got) == set(want) == {f"{t}{i}.{j}" for t in "du"
                                     for i in range(n) for j in range(2)}
    for k in want:
        assert got[k].dtype == np.float32
        # near-dead channels' scales carry the f32 sums' absolute error
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * float(want[k].max()),
                                   err_msg=k)


def _levels(module, monkeypatch, store):
    """Record ``round(y / s)`` at every ``_fq_act`` of ``module``."""
    orig = module._fq_act

    def recording(y, s):
        yf = np.asarray(y.detach() if isinstance(y, torch.Tensor) else y,
                        np.float32)
        store.append(np.round(yf / np.asarray(s, np.float32)))
        return orig(y, s)

    monkeypatch.setattr(module, "_fq_act", recording)


@pytest.mark.parametrize("mc", sorted(SHAPES))
def test_qat_apply_matches_jax(mc, monkeypatch):
    sd, vs, x = _case(mc)
    scales = jqat.calibrate_unit_scales(mc, vs, x, dtype=jnp.float32)
    jl, tl = [], []
    _levels(jqat, monkeypatch, jl)
    _levels(tqat, monkeypatch, tl)
    want = jqat.QATModel(mc, scales=scales, dtype=jnp.float32).apply(
        vs, jnp.asarray(x))
    got = tqat.QATModel(mc, scales=scales, dtype=torch.float32).apply(
        sd, torch.from_numpy(x))
    assert len(jl) == len(tl) == len(scales)
    flips = sum(int((a != b).sum()) for a, b in zip(jl, tl))
    total = sum(a.size for a in jl)
    assert flips <= 1e-4 * total, (flips, total)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_qat_capture_names_every_unit():
    sd, _, x = _case("UNetSP")
    got = tqat.calibrate_unit_scales("UNetSP", sd, x, dtype=torch.float32)
    assert set(got) == {f"{t}{i}.{j}" for t in "du" for i in range(4)
                        for j in range(2)}


def test_qat_gradients_flow():
    """The fake-quant points pass gradients straight through: every
    parameter that the standard (eval, f32) forward gives a nonzero
    gradient gets one under QAT too (``tests/test_qat.py:54``)."""
    sd, _, x = _case("UNetSP")
    scales = tqat.calibrate_unit_scales("UNetSP", sd, x, torch.float32)
    model = build_model("UNetSP")
    model.load_state_dict(sd)
    model.eval()
    xt = torch.from_numpy(x)
    qat = tqat.QATModel("UNetSP", scales=scales, dtype=torch.float32)
    live = model.state_dict(keep_vars=True)
    names = [n for n, _ in model.named_parameters()]
    gq = torch.autograd.grad(sum(torch.sum(o ** 2) for o in qat.apply(
        live, xt)), list(model.parameters()), allow_unused=True)
    gs = torch.autograd.grad(sum(torch.sum(o ** 2) for o in model(xt)),
                             list(model.parameters()))
    n_live = 0
    for name, a, b in zip(names, gq, gs):
        if float(b.abs().max()) > 1e-9:
            assert a is not None and float(a.abs().max()) > 0, (
                f"{name} dead under QAT")
            n_live += 1
    assert n_live > 30


def test_fq_act_clipped_ste_saturation():
    """Gradient 1 inside the representable range, 0 where the activation
    saturates past ``255 * s`` (``tests/test_qat.py:91``); the forward
    values are the clamp's."""
    s = np.asarray([0.1], np.float32)
    y = torch.tensor([[5.0], [25.5], [30.0]], requires_grad=True)
    out = tqat._fq_act(y, s)
    (g,) = torch.autograd.grad(out.sum(), (y,))
    np.testing.assert_allclose(g[:, 0].numpy(), [1.0, 1.0, 0.0])
    np.testing.assert_allclose(out.detach()[:, 0].numpy(), [5.0, 25.5, 25.5],
                               atol=1e-5)
    want = np.asarray(jqat._fq_act(jnp.asarray(y.detach().numpy()),
                                   jnp.asarray(s)))
    np.testing.assert_array_equal(out.detach().numpy(), want)


def test_fq_weight_matches_jax():
    """The weight rounding, op for op: ``round(w_s * k)`` clipped, over
    ``k``, over ``s_in``, through the straight-through sum."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 3, 3, 5, 4)) * 0.2).astype(np.float32)
    s_in = rng.uniform(0.001, 0.05, 5).astype(np.float32)
    want = np.asarray(jqat._fq_weight(jnp.asarray(w), jnp.asarray(s_in)))
    got = tqat._fq_weight(torch.from_numpy(w), s_in).numpy()
    np.testing.assert_array_equal(got, want)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "qat_tune_torch", os.path.join(ROOT, "tools", "qat_tune_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# One distillation step of the tool against tools/qat_tune.py's, from the
# committed weights on a broken spherical skull and the atlas.
DISTILL_SHAPE = (16, 32, 32)


def _distill_case(dt: str, grads: bool = True):
    sd = checkpoint.load_any(checkpoint.UNETSP_10K)
    params, stats = to_flax(sd)
    full = spherical_shell(DISTILL_SHAPE, seed=3).astype(np.float32)
    atlas = spherical_shell(DISTILL_SHAPE, radius_frac=0.42).astype(
        np.float32)
    d, h, w = DISTILL_SHAPE
    full[d // 4:3 * d // 4, :h // 3, w // 3:2 * w // 3] = 0  # the hole
    x = np.stack([full, atlas], -1)[None]
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    # the same scales on both sides (their calibration is held above)
    scales = tqat.calibrate_unit_scales("UNetSP", sd, x, dtype=tdt)

    # JAX: the loss_fn and value_and_grad of tools/qat_tune.py's
    # distill_step, at compute dtype ``dt``
    student = jqat.QATModel("UNetSP", scales=scales, dtype=jdt)
    teacher = jax_build_model("UNetSP", compute_dtype=dt,
                              use_checkpoint=False)
    xj = jnp.asarray(x).astype(jdt)
    t_out = jax.lax.stop_gradient(jax.jit(
        lambda v, x: teacher.apply(v, x, False))(
            {"params": params, "batch_stats": stats}, xj))

    def loss_fn(p):
        s_out = student.apply({"params": p, "batch_stats": stats}, xj)
        return sum(jnp.mean(jnp.square(a.astype(jnp.float32)
                                       - b.astype(jnp.float32)))
                   for a, b in zip(jax.tree.leaves(s_out),
                                   jax.tree.leaves(t_out)))

    if grads:
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    else:
        jloss, jgrads = jax.jit(loss_fn)(params), None

    # the port: the tool's distill_loss over the student's parameters
    tool = _tool()
    models = []
    for _ in range(2):
        m = build_model("UNetSP")
        m.load_state_dict(sd)
        models.append(m.eval().configure("xla", tdt))
    student_t, teacher_t = models
    qat = tqat.QATModel("UNetSP", scales=scales, dtype=tdt)
    with torch.set_grad_enabled(grads):
        loss = tool.distill_loss(qat, student_t.state_dict(keep_vars=True),
                                 teacher_t, torch.from_numpy(x).to(tdt))
    names = [n for n, _ in student_t.named_parameters()]
    tgrads = (dict(zip(names, torch.autograd.grad(
        loss, list(student_t.parameters())))) if grads else None)
    return dict(tool=tool, sd=sd, params=params, student=student_t,
                loss=float(loss.detach()), grads=tgrads,
                jloss=float(jloss), jgrads=jgrads)


def test_distill_step_matches_jax():
    """In f32: the distillation loss (rtol 1e-4; measured 1.8e-5), every
    gradient leaf within 2e-4 of its largest entry (measured 3.7e-5: the
    convs' f32 sums), and one Adam step of the tool's optimizer from the
    port's gradients against optax ``adam`` from JAX's: every update
    within 1e-2 lr of JAX's but at most 1e-4 of the entries (measured 5
    of 634,595, gradients near zero)."""
    c = _distill_case("float32")
    np.testing.assert_allclose(c["loss"], c["jloss"], rtol=1e-4)
    sd_g = dict(c["sd"])
    sd_g.update({k: g for k, g in c["grads"].items()})
    got = jax.tree_util.tree_leaves_with_path(to_flax(sd_g)[0])
    want = jax.tree.leaves(c["jgrads"])
    assert len(got) == len(want) == 58
    for (path, g), w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
    lr = c["tool"].LR
    opt = optax.adam(lr)
    up, _ = opt.update(c["jgrads"], opt.init(c["params"]), c["params"])
    want_up = jax.tree.leaves(up)
    model = c["student"]
    topt = c["tool"].adam(model.parameters(), lr)
    for name, p in model.named_parameters():
        p.grad = c["grads"][name]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    topt.step()
    moved = {k: v.detach() - before[k] if k in c["grads"] else v
             for k, v in model.state_dict().items()}
    got_up = jax.tree.leaves(to_flax(moved)[0])
    off = sum(int((np.abs(g - np.asarray(w)) > 1e-2 * lr).sum())
              for g, w in zip(got_up, want_up))
    total = sum(w.size for w in want_up)
    assert off <= 1e-4 * total, (off, total)


def test_distill_loss_matches_jax_in_bf16():
    """At the tool's compute dtype, bf16: the loss within 1e-2 of JAX's
    (measured 7.3e-4: the two packages round their bf16 convs apart, and
    the loss is a mean squared difference of 3.8e-6)."""
    c = _distill_case("bfloat16", grads=False)
    np.testing.assert_allclose(c["loss"], c["jloss"], rtol=1e-2)


def test_tool_adam_matches_optax():
    """The tool's ``torch.optim.Adam`` against optax ``adam`` on the same
    gradients (five steps at the tool's lr, magnitudes from 1e-10 to 1,
    about eps 1e-8 included): step by step, each f32 parameter within two
    ulps of its value plus 1e-4 lr (optax rounds the bias corrections
    ``1 - b ** t`` to f32, up to 2^-24 / (1 - b2) = 6e-5 of the second's,
    where torch keeps them in f64; measured 6.7e-6 lr). A misplaced eps
    (``sqrt(v + eps)``) would be off by about lr where ``|g|`` is near
    eps."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((6, 1000)).astype(np.float32) * 0.1
    scale = 10.0 ** rng.uniform(-10, 0, (6, 1000))
    grads = [(rng.standard_normal((6, 1000)) * scale).astype(np.float32)
             for _ in range(5)]
    lr = _tool().LR
    opt = optax.adam(lr)
    pj, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = _tool().adam([pt], lr)
    for g in grads:
        up, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, up)
        pt.grad = torch.from_numpy(g)
        topt.step()
        want = np.asarray(pj)
        got = pt.detach().numpy()
        np.testing.assert_array_less(
            np.abs(got - want), 2 * np.spacing(np.abs(want)) + 1e-4 * lr)


def test_qat_tool_writes_a_checkpoint_model_serves(tmp_path):
    """The tool on the CPU at a small shape: 2 distillation steps from the
    committed weights, the collapse guard, and a ``.ckpt`` that loads as
    the port's weights (moved by the steps)."""
    out = str(tmp_path / "unetsp_qat.ckpt")
    logs = []
    res = _tool().distill(checkpoint.UNETSP_10K, out, steps=2,
                          shape=(16, 32, 32), device="cpu",
                          log=logs.append)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["saved"] and min(res["guard_dice"].values()) >= 0.9
    tuned = checkpoint.load_any(out)
    base = checkpoint.load_any(checkpoint.UNETSP_10K)
    assert set(tuned) == set(base)
    moved = [k for k in base if not torch.equal(tuned[k], base[k])]
    assert any(k.endswith("block.0.weight") for k in moved)
    assert any("saved" in m for m in logs)
    # the command line: exit 0 and a file, or (the guard, which at this
    # size the model's few foreground voxels can trip) exit 1 and none
    b = str(tmp_path / "b.ckpt")
    rc = _tool().main(["--ckpt", checkpoint.UNETSP_10K, "--out", b,
                       "--steps", "1", "--shape", "16,32,32", "--device",
                       "cpu"])
    assert rc in (0, 1) and os.path.exists(b) == (rc == 0)


def test_qat_tool_imports_only_the_port():
    from test_torch_port_model import _FORBIDDEN, _imports

    mods = list(_imports(os.path.join(ROOT, "tools", "qat_tune_torch.py")))
    assert any(m.startswith("ctunet_tpu_torch") for m in mods)
    assert not [m for m in mods if m.split(".")[0] in _FORBIDDEN], mods
