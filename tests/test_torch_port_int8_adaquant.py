"""PyTorch port, AdaQuant and int8 serving through ``Model``.

- ``quant_opt.optimize_rounding`` against ``ctunet_tpu.quant_opt`` on the
  same weights, calibration volume and scales: at ``steps=0`` both return
  round-to-nearest, exactly; after a few Adam steps (``torch.optim.Adam``
  vs ``optax.adam``, f32 convolutions in different libraries) at least
  ``INT_AGREE`` of the integers agree and every unit's best loss is within
  ``LOSS_RTOL`` of the JAX one.
- The JAX overrides plugged into both engines (``round_opt``, full-tap JAX
  build) give the same outputs (probabilities within 1e-5, masks equal).
- ``Model`` with ``use_int8`` writes the masks of the port's int8 engine,
  and falls back AdaQuant -> plain int8 -> bf16 only on
  ``engine_q.Unsupported``.
"""

import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctunet_tpu import engine_q as jq
from ctunet_tpu import quant_opt as jopt
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu_torch import Model
from ctunet_tpu_torch import engine as tengine
from ctunet_tpu_torch import engine_q as tq
from ctunet_tpu_torch import quant_opt as topt
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import make_dataset, spherical_shell
from ctunet_tpu_torch.data.atlas import register_atlas
from ctunet_tpu_torch.utils import nifti
from test_torch_port_int8_engine import (ROOT, SHAPE, assert_outputs_match,
                                         skull_and_atlas)

torch.set_num_threads(2)

STEPS = 3
INT_AGREE = 0.99
LOSS_RTOL = 0.05
K_RTOL = 1e-6  # a few f32 ulps: the BN fold's rsqrt (XLA vs PyTorch)
_LOSS = re.compile(r"(\S+): loss (\S+) -> (\S+), (\d+)/(\d+) ints changed")


@pytest.fixture(scope="module")
def net():
    vs = jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"), "UNetSP")
    sd = load_any(UNETSP_10K)
    x = skull_and_atlas()
    scales = {}
    tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]), torch.float32,
                       device="cpu", export_scales=scales)
    return vs, sd, x, scales


def _losses(text):
    return {m[1]: (float(m[2]), float(m[3])) for m in _LOSS.finditer(text)}


@pytest.fixture(scope="module")
def optimized(net):
    """``{steps: (jax overrides, port overrides, jax losses, port
    losses)}`` for steps 0 and ``STEPS``; losses from the verbose lines."""
    import contextlib
    import io

    vs, sd, x, scales = net
    out = {}
    for steps in (0, STEPS):
        runs = []
        for fn, args in ((jopt.optimize_rounding, (vs,)),
                         (topt.optimize_rounding, (sd,))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                kw = {} if fn is jopt.optimize_rounding else {"device": "cpu"}
                ov = fn("UNetSP", *args, x, scales, steps=steps,
                        verbose=True, **kw)
            runs.append((ov, _losses(buf.getvalue())))
        out[steps] = (runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    return out


def test_optimize_rounding_is_rtn_at_zero_steps(net, optimized):
    """Round to nearest on the engine's grid, as the JAX package returns
    it. The grid ``k`` folds BN with ``rsqrt(var + eps)`` like
    ``quant_opt._unit_wb``; XLA's and PyTorch's rsqrt may differ in the
    last bit, so ``k`` agrees within a few f32 ulps (``K_RTOL``) and the
    integers exactly."""
    _, sd, _, scales = net
    want, got, _, _ = optimized[0]
    assert set(got) == set(want) and len(want) == 16
    for tag in want:
        np.testing.assert_array_equal(got[tag]["q"], want[tag]["q"],
                                      err_msg=tag)
        np.testing.assert_allclose(got[tag]["k"], want[tag]["k"],
                                   rtol=K_RTOL, err_msg=tag)
        assert not got[tag]["db"].any() and not want[tag]["db"].any()
    # exactly the engine's own round to nearest for a conv unit
    w_eff, _ = topt.unit_wb(sd, "d_blocks.1.block", 3)
    s_in, _ = scales["d1.1"]
    w_s, k = topt._grid(w_eff, s_in[:-1])
    np.testing.assert_array_equal(got["d1.1"]["q"], topt._rtn(w_s, k))


def test_optimize_rounding_close_to_jax(optimized):
    want, got, want_l, got_l = optimized[STEPS]
    rtn = optimized[0][0]
    assert set(got) == set(want) == set(want_l) == set(got_l)
    same = total = changed = 0
    for tag in want:
        np.testing.assert_allclose(got[tag]["k"], want[tag]["k"],
                                   rtol=K_RTOL)
        same += int((got[tag]["q"] == want[tag]["q"]).sum())
        total += want[tag]["q"].size
        changed += int((want[tag]["q"] != rtn[tag]["q"]).sum())
        first_g, best_g = got_l[tag]
        first_w, best_w = want_l[tag]
        assert best_g <= first_g and best_w <= first_w
        np.testing.assert_allclose(best_g, best_w, rtol=LOSS_RTOL,
                                   err_msg=tag)
    assert changed > 0  # the steps moved integers off round-to-nearest
    assert same / total >= INT_AGREE, same / total


@pytest.mark.parametrize("split_taps", [True, False])
def test_engine_with_jax_overrides_matches_jax(net, optimized, split_taps):
    """The JAX AdaQuant overrides in both engines, the JAX one in its split
    and its full-tap (K4a/K4b) form."""
    vs, sd, x, scales = net
    ropt = optimized[STEPS][0]
    want = jq.build_predict_q("UNetSP", vs, jnp.asarray(x[0]),
                              compute_dtype=jnp.float32, interpret=True,
                              import_scales=scales, round_opt=ropt,
                              split_taps=split_taps)(jnp.asarray(x))
    fwd = tq.build_predict_q("UNetSP", sd, torch.from_numpy(x[0]),
                             torch.float32, device="cpu",
                             import_scales=scales, round_opt=ropt)
    assert_outputs_match(fwd(torch.from_numpy(x)),
                         [np.asarray(w, np.float32) for w in want])


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


@pytest.fixture
def dataset(tmp_path):
    csv = make_dataset(str(tmp_path / "data"), n=1, shape=SHAPE, seed=5)
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    register_atlas(SHAPE, atlas)
    return csv, atlas


def _serve(tmp_path, csv, **extra):
    params = dict(test_flag=True, name="q", model_class="UNetSP",
                  problem_handler="FlapRecWithShapePriorDoubleOut",
                  device="cpu", workspace_path=str(tmp_path / "ws"),
                  test_files_csv=csv, resume_model=UNETSP_10K, use_int8=True,
                  int8_adaquant_steps=2)
    params.update(extra)
    m = Model(params=params)
    out = sorted(glob.glob(os.path.join(os.path.dirname(csv), "pred_q",
                                        "*_[sf][kl].nii.gz")))
    return m, {os.path.basename(p)[-9:-7]: nifti.read(p).data for p in out}


def _input(csv, atlas):
    path = sorted(glob.glob(os.path.join(os.path.dirname(csv), "*.nii.gz")))
    vol = nifti.read(path[0]).data.astype(np.float32)
    return torch.from_numpy(np.stack([vol, atlas], -1)[None]).to(
        torch.bfloat16)


def _masks(out):
    return {sfx: torch.argmax(o[0], -1).to(torch.uint8).numpy()
            for sfx, o in zip(("sk", "fl"), out)}


def test_model_serves_int8_adaquant(tmp_path, dataset):
    csv, atlas = dataset
    m, files = _serve(tmp_path, csv)
    assert m.n_served == 1 and m.int8_build_seconds > 0
    x = _input(csv, atlas)
    fwd = tq.build_predict_q_opt("UNetSP", load_any(UNETSP_10K), x[0],
                                 adaquant_steps=2, device="cpu")
    assert m.int8_engines[tuple(x.shape[1:])].round_opt is not None
    want = _masks(fwd(x))
    assert set(files) == {"sk", "fl"} and want["sk"].any()
    for sfx in files:
        np.testing.assert_array_equal(files[sfx], want[sfx])


def test_model_int8_fallback_only_on_unsupported(tmp_path, dataset,
                                                 monkeypatch):
    csv, atlas = dataset

    def unsupported(*a, **k):
        raise tq.Unsupported("planned out")

    # AdaQuant unsupported: the plain int8 engine serves
    monkeypatch.setattr(tq, "build_predict_q_opt", unsupported)
    m, _ = _serve(tmp_path / "a", csv)
    (qfn,) = m.int8_engines.values()
    assert qfn is not None and qfn.round_opt is None
    # both unsupported: the bf16 engine serves, its masks
    orig = tq.build_predict_q
    monkeypatch.setattr(tq, "build_predict_q", unsupported)
    m, files = _serve(tmp_path / "b", csv)
    assert list(m.int8_engines.values()) == [None]
    want = _masks(tengine.build_predict("UNetSP", load_any(UNETSP_10K),
                                        device="cpu")(_input(csv, atlas)))
    for sfx in files:
        np.testing.assert_array_equal(files[sfx], want[sfx])
    # anything else (a kernel build or launch failing) is not caught

    def broken(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(tq, "build_predict_q", orig)
    monkeypatch.setattr(tq, "build_predict_q_opt", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        _serve(tmp_path / "c", csv)
