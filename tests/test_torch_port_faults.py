"""PyTorch port, three faults of the port against ``ctunet_tpu`` repaired:

- ``use_engine = False`` serves the plain model in ``compute_dtype``: with
  ``compute_dtype = bfloat16`` ``Model``'s predict gives the probabilities
  of ``ctunet_tpu.steps.make_predict_fn(model, compute_dtype=bfloat16)``
  on the same weights, for a small ``UNetSP`` (random weights, non-trivial
  BatchNorm statistics) and a small ``UNet4_2IC``. Tolerance: both run
  every layer in bf16 with f32 accumulation but round at their own places
  (XLA fuses where PyTorch does not, the BN fold's ``rsqrt``), so a
  probability may move by a few bf16 ulps through the depth of the net:
  ``BF16_PROB_ATOL`` = 8 ulps at 1.0 (2^-4; measured here: 2^-6 for
  UNetSP, 2^-8 for UNet4_2IC). ``compute_dtype = float32`` still serves
  f32.
- ``debug_nans`` turns autograd's anomaly detection on for the training
  loop, and off after it.
- ``param_dtype``: ``float32``, ``bfloat16`` and ``float16`` are served
  (the parameters are held in that dtype, BatchNorm's in f32;
  ``test_torch_port_param_dtype.py`` holds them against JAX), any other
  name raises ``ValueError``.
- The AdaQuant rounding search runs under ``quant_opt.search_flags``, which
  sets TF32 off and cuDNN's deterministic, non-benchmarked algorithms, and
  restores all four flags, also on an exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import steps as jax_steps
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import quant_opt as topt
from ctunet_tpu_torch import trainer as ttrainer
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.models.convert import from_flax, to_flax
from test_torch_port_legacy_model import seeded_state_dict

torch.set_num_threads(2)

SHAPE = (16, 16, 16)
BF16_PROB_ATOL = 8 * 2.0 ** -7


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _unetsp_weights():
    """JAX variables of a random ``UNetSP`` with non-trivial BatchNorm
    statistics (``tests/test_engine.py::_variables``), and the port's
    state_dict of the same weights."""
    m = jax_build_model("UNetSP", compute_dtype="float32",
                        use_checkpoint=False)
    vs = jax.jit(m.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *SHAPE, 2), jnp.float32), False)
    stats = jax.tree.map(
        lambda s: s * (1.0 + 0.1 * jax.random.uniform(
            jax.random.key(1), s.shape)) + 0.01, vs["batch_stats"])
    vs = {"params": vs["params"], "batch_stats": stats}
    return vs, from_flax(_np_tree(vs["params"]), _np_tree(stats))


def _legacy_weights():
    sd = seeded_state_dict("UNet4_2IC")
    params, stats = to_flax(sd)
    return {"params": params, "batch_stats": stats}, sd


def _serve_plain(tmp_path, model_class, handler, sd, atlas, images,
                 dtype):
    """``Model``'s whole-volume predict with ``use_engine = False``."""
    m = Model(params=dict(
        name="plain", model_class=model_class, problem_handler=handler,
        device="cpu", workspace_path=str(tmp_path / "ws"),
        compute_dtype=dtype, use_engine=False))
    m.state_dict = sd
    predict = m._make_whole_volume_predict(atlas)
    with torch.inference_mode():
        out = predict(torch.from_numpy(images))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("model_class,handler,weights", [
    ("UNetSP", "FlapRecWithShapePriorDoubleOut", _unetsp_weights),
    ("UNet4_2IC", "FlapRecWithShapePrior", _legacy_weights),
])
def test_plain_model_serves_in_compute_dtype(tmp_path, model_class,
                                             handler, weights):
    vs, sd = weights()
    rng = np.random.default_rng(0)
    images = (rng.random((1, *SHAPE)) > 0.6).astype(np.float32)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    jm = jax_build_model(model_class, compute_dtype="bfloat16",
                         use_checkpoint=False)
    want = jax_steps.make_predict_fn(jm, atlas=atlas,
                                     compute_dtype=jnp.bfloat16)(
        vs, jnp.asarray(images))
    want = want if isinstance(want, tuple) else (want,)
    got = _serve_plain(tmp_path, model_class, handler, sd, atlas, images,
                       "bfloat16")
    f32 = _serve_plain(tmp_path, model_class, handler, sd, atlas, images,
                       "float32")
    assert len(got) == len(want)
    for g, w, f in zip(got, want, f32):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.dtype == torch.bfloat16 and f.dtype == torch.float32
        assert g.shape == w.shape and float(w.std()) > 1e-3
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BF16_PROB_ATOL)


def _train_params(tmp_path, **extra):
    csv = make_dataset(str(tmp_path / "data"), n=1, shape=SHAPE, seed=5)
    register_atlas(SHAPE, spherical_shell(SHAPE, radius_frac=0.42))
    return dict(
        train_flag=True, name="dbg", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device="cpu",
        workspace_path=str(tmp_path / "ws"), train_files_csv=csv,
        validation_files_csv=csv, n_epochs=1, batch_size=1,
        optimizer="adam", learning_rate=1e-4, ce_lambda=1.0,
        dice_lambda=1.0, conv_impl="xla", compute_dtype="float32", **extra)


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_turns_anomaly_detection_on_while_training(
        tmp_path, monkeypatch, debug_nans):
    seen = []

    def epochs(self, *args):
        seen.append(torch.is_anomaly_enabled())

    monkeypatch.setattr(ttrainer.Model, "_train_epochs", epochs)
    assert not torch.is_anomaly_enabled()
    Model(params=_train_params(tmp_path, debug_nans=debug_nans))
    assert seen == [debug_nans]
    assert not torch.is_anomaly_enabled()


def test_param_dtype_is_served_or_raises(tmp_path):
    params = dict(name="x", model_class="UNetSP",
                  problem_handler="FlapRecWithShapePriorDoubleOut",
                  device="cpu", workspace_path=str(tmp_path))
    for name, dtype in (("float32", torch.float32), (None, torch.float32),
                        ("bfloat16", torch.bfloat16),
                        ("float16", torch.float16)):
        m = Model(params=dict(params, param_dtype=name))
        assert m.param_dtype == dtype
        m.initialize_models()
        held = {p.dtype for p in m.models["main"].parameters()}
        assert held == {dtype, torch.float32}  # BatchNorm's stay f32
    with pytest.raises(ValueError, match="param_dtype 'float64'"):
        Model(params=dict(params, param_dtype="float64"))


def test_search_flags_set_and_restore_all_four():
    be = torch.backends
    names = [(m, k) for m, k, _ in topt.SEARCH_FLAGS]
    assert set(names) == {("cudnn", "allow_tf32"),
                          ("cuda.matmul", "allow_tf32"),
                          ("cudnn", "deterministic"), ("cudnn", "benchmark")}
    saved = (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
             be.cudnn.deterministic, be.cudnn.benchmark)
    try:
        start = (True, True, False, True)
        (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
         be.cudnn.deterministic, be.cudnn.benchmark) = start
        with topt.search_flags():
            assert (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
                    be.cudnn.deterministic, be.cudnn.benchmark) == (
                        False, False, True, False)
        assert (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
                be.cudnn.deterministic, be.cudnn.benchmark) == start
        with pytest.raises(RuntimeError):
            with topt.search_flags():
                raise RuntimeError("inside the search")
        assert (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
                be.cudnn.deterministic, be.cudnn.benchmark) == start
    finally:
        (be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32,
         be.cudnn.deterministic, be.cudnn.benchmark) = saved


def test_rounding_search_runs_under_the_flags(monkeypatch):
    """Every Adam search of ``optimize_rounding`` sees the deterministic
    flags (steps=0: the search itself is held by
    ``test_torch_port_int8_adaquant.py``)."""
    from ctunet_tpu_torch import engine_q as tq
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from test_torch_port_int8_engine import skull_and_atlas

    sd = load_any(UNETSP_10K)
    x = skull_and_atlas()
    scales = {}
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", export_scales=scales)
    seen = []
    adam = topt._adam_best

    def recording(*args, **kw):
        be = torch.backends
        seen.append((be.cudnn.deterministic, be.cudnn.benchmark,
                     be.cudnn.allow_tf32, be.cuda.matmul.allow_tf32))
        return adam(*args, **kw)

    monkeypatch.setattr(topt, "_adam_best", recording)
    det = torch.backends.cudnn.deterministic
    topt.optimize_rounding("UNetSP", sd, x, scales, steps=0, device="cpu")
    assert len(seen) == 16  # one search per quantized unit
    assert set(seen) == {(True, False, False, False)}
    assert torch.backends.cudnn.deterministic == det
