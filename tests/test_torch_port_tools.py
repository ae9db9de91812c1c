"""PyTorch port, the kernel wrappers' profiler spans, the attribution of a
trace (``utils/profiling.py``) and the int8 and attribution tools
(``tools/*_torch.py``) on the CPU, the tools' measurements against the
JAX tools' sequences of calls.

- Spans: every ``kernels.WRAPPERS`` entry opens one ``record_function``
  span named after its key per call; on a patched card (``meta`` tensors,
  ``build.function`` recording) a wrapper's span holds its kernel
  function's span. The profiler's view of the launches themselves is
  checked on the card (``chip_smoke.py`` phase 13).
- ``quant_sim_eval_torch``: the ``rtn`` Dice from the same volumes and
  weights against ``simulate_scales`` then ``optimize_rounding(tags=set(),
  return_outputs=True)`` in JAX (the port's ``simulate_int8``), within
  1e-6.
- ``int8_sensitivity_torch``: the "all quantized" and "one unit" sweeps
  at 16^3 in f32 on the JAX unit scales, against ``QATModel`` in JAX:
  each Dice within one voxel's weight (``2 / |float mask|``: the two
  packages' f32 convs flip a fake-quant level where ``y / s`` sits on a
  half, ``tests/test_torch_port_qat.py``).
- Each tool's ``main`` with ``--cpu`` at a tiny size prints one JSON line.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctunet_tpu import quant_opt as jqo
from ctunet_tpu.checkpoint import load_any as jax_load_any
from ctunet_tpu.models import build_model as jax_build_model
from ctunet_tpu.ops import qat as jqat
from ctunet_tpu_torch import engine
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.ops import kernels
from ctunet_tpu_torch.ops.kernels import build
from ctunet_tpu_torch.ops.kernels import conv3d as kc
from ctunet_tpu_torch.utils import profiling
from test_torch_port_model import _FORBIDDEN, _imports

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("quant_sim_eval_torch", "adaquant_run_torch",
         "int8_sensitivity_torch", "attr_int8_torch", "attr_train_torch")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    return (jax_load_any(os.path.join(ROOT, ".ckpts", "unetsp_10k"),
                         "UNetSP"), load_any(UNETSP_10K))


def _volumes(shape, cuts):
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    out = []
    for seed, cut in cuts:
        skull = spherical_shell(shape, seed=seed).astype(np.float32)
        skull[:cut, : shape[1] // 2] = 0.0
        out.append(np.stack([skull, atlas], -1))
    return np.stack(out)


def _masks(outputs):
    return tuple(np.argmax(np.asarray(o, np.float32), -1)
                 for o in jax.tree.leaves(outputs))


def _dice(a, b):
    inter = float(((a > 0) & (b > 0)).sum())
    denom = float((a > 0).sum() + (b > 0).sum())
    return 2.0 * inter / denom if denom else 1.0


# --------------------------------------------------------------------------
# the wrappers' spans and the attribution
# --------------------------------------------------------------------------


def _span_counts(prof):
    out = {}
    for e in prof.events():
        if e.name in kernels.WRAPPERS:
            out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_each_wrapper_call_is_one_span_named_after_it(name):
    fn = kernels.WRAPPERS[name]
    assert fn.__name__ == name and hasattr(fn, "__wrapped__")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(Exception):  # noqa: B017  no tensor: it raises
            fn(None, None, None, None, None, None)
    assert _span_counts(prof) == {name: 1}


@pytest.fixture
def card(monkeypatch):
    """A card that launches nothing (``tests/test_torch_port_maxpool_rows``'s
    fixture): ``meta`` tensors pass the device check, ``build.function``
    records each call."""
    asked = []

    def function(lib, symbol, argtypes):
        def call(*args):
            asked.append(symbol)
            return 0
        return call

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(kc, "_require_cuda", lambda t, what: None)
    kernels.reset_launches()
    return asked


@pytest.mark.parametrize("call,dtype,outer", [
    (kc.maxpool2, torch.bfloat16, "maxpool2"),
    (kc.maxpool2_f32, torch.float32, "maxpool2_f32"),
    (kc.maxpool2_q, torch.int8, "maxpool2_q")])
def test_wrapper_span_holds_its_kernel_functions_span(card, call, dtype,
                                                      outer):
    x = torch.empty((6, 10, 16, 7), dtype=dtype, device="meta")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(x)
    assert _span_counts(prof) == {outer: 1, "maxpool2_rows": 1}
    spans = {e.name: e for e in prof.events() if e.name in kernels.WRAPPERS}
    inner, out = spans["maxpool2_rows"].time_range, spans[outer].time_range
    assert out.start <= inner.start and inner.end <= out.end
    assert len(card) == 1 and kernels.launches()[outer] == 1
    assert kernels.launches()["maxpool2_rows"] == 1


def _event(name, cid, t0, device):
    """A stand-in for a profiler ``FunctionEvent`` with the fields
    ``attribute`` reads."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, id=cid, thread=1, self_cpu_time_total=0,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=t0, end=t0 + 1.0))


def test_attribution_counts_the_launches_a_trace_lost():
    """Three launches (runtime and driver calls), two kernel records and a
    memcpy: one launch is counted lost, in the events and in the Chrome
    trace of the same window."""
    ours = "void ctunet::conv3d_tc_kernel<64>(Params)"
    events = [_event("conv3d_bn_relu", 0, 0.0, False),
              _event("cudaLaunchKernel", 1, 0.2, False),
              _event("cudaLaunchKernelExC_v11060", 2, 0.4, False),
              _event("cuLaunchKernel", 3, 0.6, False),
              _event("cudaMemcpyAsync", 4, 0.8, False),
              _event(ours, 1, 2.0, True), _event(ours, 3, 4.0, True),
              _event("Memcpy DtoD (Device -> Device)", 4, 6.0, True)]
    events[0].time_range.end = 1.0
    rows, dropped = profiling.attribute(events)
    assert dropped == 1 and len(rows) == 3
    assert [r["category"] for r in rows[:2]] == ["kernel:conv3d_bn_relu"] * 2
    trace = ([{"cat": "cuda_runtime", "name": e.name,
               "args": {"correlation": e.id}} for e in events[1:3]]
             + [{"cat": "cuda_driver", "name": "cuLaunchKernel",
                 "args": {"correlation": 3}},
                {"cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                 "args": {"correlation": 4}},
                {"cat": "gpu_memcpy", "name": "Memcpy DtoD",
                 "args": {"correlation": 4}}]
             + [{"cat": "kernel", "name": ours, "args": {"correlation": c}}
                for c in (1, 3)])
    assert profiling.dropped_in_trace(trace) == 1
    assert profiling.dropped_in_trace(trace[:3] + trace[5:]) == 1
    assert profiling.dropped_in_trace(trace[5:]) == 0


def test_attribution_of_an_engine_pass_on_the_cpu():
    """A CPU profile of the bf16 engine's plain versions: every op inside
    a wrapper's span is that wrapper's, the rollup sums the rows."""
    sd = load_any(UNETSP_10K)
    x = torch.from_numpy(_volumes((16, 16, 32), [(3, 5)]))
    fwd = engine.build_predict("UNetSP", sd, device="cpu")
    fwd(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd(x)
    rows, dropped = profiling.attribute(prof.events())
    assert dropped == 0  # a CPU profile launches nothing
    roll = profiling.rollup(rows)
    for key in ("kernel:conv3d_bn_relu", "kernel:maxpool2",
                "kernel:upconv_bn_relu", "cuBLAS/cuDNN"):
        assert roll.get(key, 0) > 0, (key, roll)
    assert abs(sum(roll.values()) - sum(r["ms"] for r in rows)) < 1e-6
    conv = [r for r in rows if r["category"] == "kernel:conv3d_bn_relu"]
    assert all(r["spans"][0] == "conv3d_bn_relu" for r in conv)
    assert profiling.category("void (anonymous namespace)::x", ["dw_taps"]
                              ) == "wgrad bmm"
    assert profiling.wrapper_counts(rows) == {}  # no CPU launch counts


def test_hand_written_kernels_are_told_apart():
    """On the card only the csrc/ kernels are a wrapper's; a library or
    elementwise kernel inside a wrapper's span keeps its own category."""
    ours = "void (anonymous namespace)::conv3d_tc_kernel<3, 4, 1>(P)"
    theirs = "void (anonymous namespace)::softmax_warp_forward<float>(float*)"
    spans = ["conv3d_bn_relu", "conv3d_tc"]
    assert profiling.hand_written(ours)
    assert not profiling.hand_written(theirs)
    assert not profiling.hand_written("void x::maxpool2_rows_kernelX<1>()")
    assert profiling.category(ours, spans) == "kernel:conv3d_bn_relu"
    assert profiling.category(ours, []) != "kernel:conv3d_bn_relu"
    assert profiling.category(theirs, spans) == "rest"
    assert profiling.category("sm90_xmma_gemm_bf16", spans) == "cuBLAS/cuDNN"
    assert profiling.category("aten::mul", spans, device=False) == (
        "kernel:conv3d_bn_relu")
    rows = [dict(name=ours, ms=1.0, spans=spans,
                 category=profiling.category(ours, spans))] * 3 + [
        dict(name=theirs, ms=2.0, spans=spans,
             category=profiling.category(theirs, spans))]
    assert profiling.wrapper_counts(rows) == {"conv3d_bn_relu": 3}
    assert profiling.rollup(rows) == {"kernel:conv3d_bn_relu": 3.0,
                                      "rest": 2.0}
    top = profiling.top(rows, 1)[0]
    assert (top["name"], top["count"], top["ms"]) == (ours, 3, 3.0)
    assert profiling.category("Memcpy DtoD (Device -> Device)", []
                              ) == "copies"
    assert profiling.category(
        "void at::native::vectorized_elementwise_kernel<4>", []
    ) == "elementwise"


# --------------------------------------------------------------------------
# the tools' measurements against the JAX tools' calls
# --------------------------------------------------------------------------


def test_quant_sim_eval_rtn_matches_jax(weights):
    vs, sd = weights
    shape = (16, 32, 32)
    calib = _volumes(shape, [(1, 5)])
    tests = _volumes(shape, [(2, 6), (3, 4)])
    scales = jqo.simulate_scales("UNetSP", vs, calib)
    _, out_f, out_q = jqo.optimize_rounding(
        "UNetSP", vs, tests, scales, tags=set(), apply_opt=None,
        return_outputs=True)
    want = [_dice(a, b) for a, b in zip(_masks(out_q), _masks(out_f))]
    got = _tool("quant_sim_eval_torch").evaluate(
        sd, torch.from_numpy(calib), torch.from_numpy(tests),
        modes=("rtn",), device="cpu", log=lambda m: None)["rtn"]
    np.testing.assert_allclose([got["sk"], got["fl"]], want, rtol=0,
                               atol=1e-6)


def test_int8_sensitivity_sweeps_match_jax(weights):
    vs, sd = weights
    shape = (16, 16, 16)
    calib = _volumes(shape, [(1, 5)])
    tests = _volumes(shape, [(2, 6), (3, 4)])
    scales = jqat.calibrate_unit_scales("UNetSP", vs, calib,
                                        dtype=jnp.float32)
    ref = _masks(jax_build_model("UNetSP", compute_dtype="float32").apply(
        vs, jnp.asarray(tests), False))
    tol = [2.0 / max(int((m > 0).sum()), 1) for m in ref]  # one voxel

    def jax_run(sc):
        out = jqat.QATModel("UNetSP", scales=sc, dtype=jnp.float32).apply(
            vs, jnp.asarray(tests))
        return [_dice(a, b) for a, b in zip(_masks(out), ref)]

    got = _tool("int8_sensitivity_torch").sweep(
        sd, torch.from_numpy(calib), torch.from_numpy(tests),
        scales=scales, dtype=torch.float32, log=lambda m: None)
    assert set(got["only"]) == set(scales) and len(scales) == 16
    for label, want, g in [("all", jax_run(scales), got["all"])] + [
            (f"only {t}", jax_run({t: scales[t]}), got["only"][t])
            for t in ("d0.0", "d3.1", "u0.0", "u3.1")]:
        for k, w, t in zip(("sk", "fl"), want, tol):
            assert abs(g[k] - w) <= t, (label, k, g[k], w)


def test_quantizing_restores_the_fake_quantizers():
    from ctunet_tpu_torch.ops import qat

    sens = _tool("int8_sensitivity_torch")
    saved = qat._fq_weight, qat._fq_act
    with pytest.raises(RuntimeError):
        with sens.quantizing(weights=False, activations=False):
            assert qat._fq_weight is not saved[0]
            assert qat._fq_act is not saved[1]
            raise RuntimeError
    assert (qat._fq_weight, qat._fq_act) == saved


# --------------------------------------------------------------------------
# the command lines
# --------------------------------------------------------------------------

ARGS = {
    "quant_sim_eval_torch": ["--shape", "16,32,32", "--steps", "1",
                             "--calib-n", "1", "--modes", "rtn,aq"],
    "adaquant_run_torch": ["--shape", "16,32,32", "--steps", "1",
                           "--calib-n", "1"],
    "int8_sensitivity_torch": ["--shape", "16,32,32"],
    "attr_int8_torch": ["--shape", "16,32,32", "--n", "1"],
    "attr_train_torch": ["--shape", "16,16,32", "--n", "1"],
}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_main_prints_one_json_line(name, tmp_path):
    out = io.StringIO()
    extra = (["--save", str(tmp_path / "ov.npz")]
             if name == "adaquant_run_torch" else [])
    with contextlib.redirect_stdout(out):
        rc = _tool(name).main(["--cpu"] + ARGS[name] + extra)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, lines[:3]
    res = json.loads(lines[0])
    assert res["tool"] == name and res["device"] == "cpu"
    if name.startswith("attr_"):
        assert res["clock"] == "cpu" and res["rollup_ms"]
        assert any(k.startswith("kernel:") for k in res["rollup_ms"])
        assert res["wrapper_launches"] == {}  # launches only on the card
    if name == "adaquant_run_torch":
        assert os.path.exists(res["saved"])
        assert set(res["rtn"]) == set(res["adaquant"]) == {"sk", "fl"}


def test_tools_import_only_the_port():
    for name in TOOLS + ("_torch_tools", "profiler_windows_torch",
                         "patch_serving_time_torch"):
        mods = list(_imports(os.path.join(ROOT, "tools", f"{name}.py")))
        assert any(m.startswith("ctunet_tpu_torch") for m in mods), name
        assert not [m for m in mods if m.split(".")[0] in _FORBIDDEN], name
