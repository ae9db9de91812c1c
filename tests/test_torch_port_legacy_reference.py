"""PyTorch port, the benchmark's legacy k=5 cell ``unet4_2ic.serve`` on the
CPU: the plain f32 reference ``gpubench/reference/legacy.py`` against the
port, the cell's float8 control, its operation count, the legacy engine's
spans, the cell's metric readers, and the cell run whole at a
small canvas.

Weights: ``UNet4_2IC`` at its published widths (``i_size`` 7) from a seed,
BatchNorm moved off its init values, and the 1x1 head scaled by
:data:`HEAD_SCALE` with its bone bias set to the median logit gap, so that
the reference splits a 16x32x32 volume about evenly between the classes
and the float8 control has decisions to lose (the seeded init alone gives
every voxel one class within 0.06 of probability).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ctunet_tpu_torch import checkpoint, engine  # noqa: E402
from ctunet_tpu_torch.models import build_model  # noqa: E402
from ctunet_tpu_torch.utils import profiling  # noqa: E402
from gpubench import control, flops_k5, harness, inputs, systems  # noqa: E402
from gpubench.reference import legacy, precision  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
CELL = "unet4_2ic.serve"
CANVAS = (16, 32, 32)
SPEC = dict(family="legacy", kernel=5, n_blocks=4, i_size=7,
            input_channels=2, out_channels=2, head="softmax")
HEAD_SCALE = 10.0


def seeded_state_dict(seed: int = 0):
    """The model's torch init from ``seed``, BatchNorm scale, shift and
    running statistics moved off their init values, and the head scaled
    and centred on one input (module docstring)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = build_model("UNet4_2IC").state_dict()
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
    sd["last_conv.weight"] = sd["last_conv.weight"] * HEAD_SCALE
    probs = legacy.forward(_f32(sd), _inputs(1, seed)[0])
    gap = torch.log(probs[..., 1]) - torch.log(probs[..., 0])
    sd["last_conv.bias"] = sd["last_conv.bias"] - torch.tensor(
        [0.0, float(gap.median())])
    return sd


def _f32(sd):
    return {k: v.float() for k, v in sd.items()}


def _inputs(n: int, seed: int):
    """``n`` broken skulls with the atlas, each ``(1, D, H, W, 2)`` f32."""
    atlas = torch.as_tensor(inputs.atlas(CANVAS, CPU))
    return [torch.stack([torch.as_tensor(v[0]), atlas], -1)[None]
            for v in inputs.skulls(CANVAS, n, seed, CPU, broken=True)]


@pytest.fixture(scope="module")
def case():
    sd = seeded_state_dict(0)
    xs = _inputs(2, 7)
    with systems.reference_precision():
        refs = [legacy.forward(_f32(sd), x) for x in xs]
    return sd, xs, refs


def _flip_share_worst(refs, answers):
    kind = systems.kind("serve_legacy")
    return kind.compare({i: a[0] for i, a in enumerate(answers)},
                        {i: r[0] for i, r in enumerate(refs)})


def _limit():
    return harness.load_json(os.path.join(
        ROOT, "gpubench", "limits", f"{CELL}.json"))["flip_share_worst"]


def test_reference_matches_the_model_in_f32(case):
    """``models/legacy.UNet4_2IC`` in f32, eval mode. Tolerance 1e-5: f32
    on both sides, the same convolutions; BatchNorm is computed as ``x *
    inv + shift`` there and ``(x - mean) * rsqrt(var) * w + b`` here
    (measured 6e-8)."""
    sd, xs, refs = case
    model = build_model("UNet4_2IC")
    model.load_state_dict(sd)
    model.eval().configure("xla", torch.float32)
    with torch.no_grad():
        for x, ref in zip(xs, refs):
            torch.testing.assert_close(model(x), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrappers"])
def test_reference_matches_the_f32_engine(case, plain):
    """``engine.build_legacy_predict`` in f32 on the CPU: its plain
    versions (``plain=True``) and the kernel wrappers' CPU path. Tolerance
    1e-5: BatchNorm folded into the conv weights and biases in f32, K7a/K7b
    as einsums (measured 1.2e-7)."""
    sd, xs, refs = case
    predict = engine.build_legacy_predict(sd, torch.float32, CPU, plain)
    for x, ref in zip(xs, refs):
        torch.testing.assert_close(predict(x), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrappers"])
def test_bf16_engine_passes_the_cells_comparison(case, plain):
    """The served dtype: probabilities within 2e-2 of the reference (bf16
    operands in each of 18 convs and 4 ConvTransposes, and a bf16 output;
    measured 4.6e-3), and the argmax masks within the cell's limit."""
    sd, xs, refs = case
    predict = engine.build_legacy_predict(sd, torch.bfloat16, CPU, plain)
    outs = [predict(x.to(torch.bfloat16)) for x in xs]
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=0)
    nums = _flip_share_worst(refs, [torch.argmax(o, -1) for o in outs])
    assert nums["flip_share_worst"] <= _limit()
    assert nums["compared"] == 2.0


def test_fp8_control_fails_the_cells_limit(case):
    """The reference with every conv, ConvTranspose and head operand in
    float8 e4m3 (``control.py``'s control for this cell) fails the cell's
    limit, on volumes the reference splits between the classes."""
    sd, xs, refs = case
    with systems.reference_precision():
        fp8 = [legacy.forward(_f32(sd), x, q=precision.fp8) for x in xs]
    nums = _flip_share_worst(refs, fp8)
    assert 0.01 <= nums["bone_share_min"] <= nums["bone_share_max"] <= 0.99
    assert nums["flip_share_worst"] > 10 * _limit()


def test_compare_reads_masks_and_probabilities_alike(case):
    _, _, refs = case
    masks = [torch.argmax(r, -1) for r in refs]
    assert _flip_share_worst(refs, refs) == _flip_share_worst(refs, masks)
    flipped = [1 - m for m in masks]
    assert _flip_share_worst(refs, flipped)["flip_share_worst"] > 0.5


def _count_by_hooks(canvas):
    """FLOPs of every conv and ConvTranspose of the model, counted by
    forward hooks from the shapes they see, plus the 1x1 head."""
    from ctunet_tpu_torch.models.unet import Conv3d, ConvTranspose2x

    model = build_model("UNet4_2IC").eval()
    total = [0]

    def hook(mod, args, out):
        # a ConvTranspose(k2, s2) gives each output voxel one tap's products
        taps = 1 if isinstance(mod, ConvTranspose2x) else 125
        total[0] += (2 * out[..., 0].numel() * taps * args[0].shape[-1]
                     * out.shape[-1])

    for m in model.modules():
        if isinstance(m, (Conv3d, ConvTranspose2x)):
            m.register_forward_hook(hook)
    x = torch.zeros(1, *canvas, 2)
    with torch.no_grad():
        h = model.forward_logits(x)
    head_in = model.last_conv.weight.shape[1]
    return total[0] + 2 * h[..., 0].numel() * head_in * 2


def test_flops_k5_counts_the_published_widths():
    """224x304x304: 3.0556e12 FLOPs a volume, 2.9967e12 of them in the 18
    k=5 convs, whose least time on the H100 is compute-bound."""
    canvas = (224, 304, 304)
    assert math.isclose(flops_k5.forward_flops(SPEC, canvas), 3.0556e12,
                        rel_tol=1e-4)
    rows = flops_k5.layers(SPEC, canvas)
    assert math.isclose(sum(r["ops"] for r in rows if r["kind"] == "k5"),
                        2.9967e12, rel_tol=1e-4)
    kinds = [r["kind"] for r in rows]
    assert (kinds.count("k5"), kinds.count("pool"),
            kinds.count("convt")) == (18, 4, 4)
    least = flops_k5.k5_least_seconds(rows, 989e12, 3.35e12)
    assert 2.9967e12 / 989e12 <= least < 1.02 * 2.9967e12 / 989e12


def test_flops_k5_matches_a_count_by_hooks():
    assert flops_k5.forward_flops(SPEC, CANVAS) == _count_by_hooks(CANVAS)


@pytest.fixture
def clean_recorder():
    profiling.reset()
    yield
    profiling.reset()


def test_engine_spans_and_counters_once_a_volume(case, clean_recorder):
    """Encoder, decoder and heads spans side by side, once a volume, with
    the 18 K5 and 4 ConvTranspose calls of a volume inside them; no
    counter; nothing while off."""
    sd, xs, _ = case
    predict = engine.build_legacy_predict(sd, torch.bfloat16, CPU)
    predict(xs[0].to(torch.bfloat16))
    assert profiling.snapshot()["paths"] == {}
    with profiling.recording():
        predict(torch.cat(xs).to(torch.bfloat16))  # two volumes
    snap = profiling.snapshot()
    assert snap["counters"] == {}
    for name in (engine.ENCODER_SPAN, engine.DECODER_SPAN,
                 engine.HEADS_SPAN):
        assert snap["paths"][name]["count"] == 2, name
        assert snap["spans"][name]["device_ms"] is None  # no device here
    paths = snap["paths"]
    k5 = "conv3d5_bias_act"
    assert paths[f"{engine.ENCODER_SPAN}/{k5}"]["count"] == 20
    assert paths[f"{engine.DECODER_SPAN}/{k5}"]["count"] == 16
    assert paths[f"{engine.DECODER_SPAN}/convt_k2s2"]["count"] == 2
    assert paths[f"{engine.DECODER_SPAN}/convt_k2s2_dual"]["count"] == 6


K5_ROW = "void (anonymous namespace)::conv3d_tc_kernel<5, 2, 4>(" \
         "(anonymous namespace)::Params)"
K3_ROW = K5_ROW.replace("<5,", "<3,")


def _view(rows, units=2, window_s=0.5):
    return types.SimpleNamespace(
        rows=rows, units=units, window_s=window_s, canvas=(224, 304, 304),
        config={"model": SPEC}, peak_flop_per_s=989e12)


def _row(name, ms, spans=("gpubench.window", "gpubench.predict")):
    return dict(name=name, ms=ms, spans=list(spans))


def test_k5_roofline_reads_the_k5_rows_inside_predict():
    """Only the tensor-core conv's k=5 instances inside the predict span
    count; the name the reader matches is the kernel's template's."""
    read = harness.reader("k5_roofline")
    rows = [_row(K5_ROW, 20.0), _row(K5_ROW, 28.0), _row(K3_ROW, 100.0),
            _row(K5_ROW, 100.0, ("gpubench.window", "gpubench.upload"))]
    least_ms = 1e3 * flops_k5.k5_least_seconds(
        flops_k5.layers(SPEC, (224, 304, 304)), 989e12, 3.35e12)
    assert read(_view(rows)) == pytest.approx(100.0 * least_ms / 24.0)
    assert read(_view([_row(K3_ROW, 5.0)])) is None
    src = open(os.path.join(ROOT, "ctunet_tpu_torch", "csrc",
                            "conv3d_tc.cu")).read()
    assert "template <int K, int MF, int NF>\n__global__ void " \
           "__launch_bounds__(TC_THREADS)\nconv3d_tc_kernel(" in src
    assert read.__globals__["KERNEL"] == "conv3d_tc_kernel<5,"


def test_mfu_serve_k5_reads_the_traced_rate():
    read = harness.reader("mfu.serve_k5")
    want = 100.0 * flops_k5.forward_flops(SPEC, (224, 304, 304)) * 4 / 989e12
    assert read(_view([], units=2, window_s=0.5)) == pytest.approx(want)
    assert read(_view([], units=0)) is None


def _snapshot(device_ms, untimed=0):
    span = dict(count=4, host_ms=3.0, self_ms=3.0, device_ms=device_ms)
    return lambda: dict(spans={"ctunet.engine.decoder": span},
                        paths={"ctunet.engine.decoder": span},
                        counters={}, untimed=untimed)


def test_engine_decoder_device_ms_reads_the_recorder(monkeypatch):
    read = harness.reader("engine_decoder_device_ms")
    monkeypatch.setattr(profiling, "snapshot", _snapshot(80.0))
    assert read(_view([], units=4)) == pytest.approx(20.0)
    monkeypatch.setattr(profiling, "snapshot", _snapshot(None))
    assert read(_view([], units=4)) is None
    monkeypatch.setattr(profiling, "snapshot", _snapshot(80.0, untimed=1))
    assert read(_view([], units=4)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_view([], units=4)) is None


def test_committed_weights_load_and_fit():
    """At most 12 MB, conv and ConvTranspose weights at bf16 precision,
    every key of the model, read by the package and by the reference."""
    cfg = harness.load_json(os.path.join(ROOT, "gpubench", "configs",
                                         "unet4_2ic.json"))
    path = os.path.join(ROOT, cfg["weights"])
    assert os.path.getsize(path) <= 12 * 2 ** 20
    sd = checkpoint.load_any(path)
    model = build_model("UNet4_2IC")
    model.load_state_dict(sd)  # strict
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items()
               if k.endswith(".weight") and v.ndim == 5)
    ref = legacy.load(path, CPU)
    assert set(ref) == set(sd)
    assert all(torch.equal(ref[k], sd[k].float()) for k in sd)


def test_the_cell_keeps_to_its_metrics():
    bench = harness.manifest()
    e2e, layer = harness.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"serve_volumes_per_s", "setup_s"}
    names = {m["name"] for m in layer}
    assert {"mfu.serve_k5", "k5_roofline",
            "engine_decoder_device_ms"} <= names
    assert not names & {"engine_roofline", "mfu.serve"}
    cell, cfg, mix, limits = harness.cell_parts(bench, CELL)
    assert cfg["reduced"] == [] and cfg["canvas"] == [224, 304, 304]
    assert cfg["settings"]["model_class"] == "UNet4_2IC"
    assert mix["kind"] == "serve_legacy" and set(limits) == {
        "flip_share_worst"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_whole_on_the_cpu(trace):
    result = harness.run_cell(CELL, 2 ** 31 + 4099, 0.3, bool(trace), CPU,
                              time.perf_counter(), canvas=CANVAS)
    json.dumps(result)
    assert result["correct"] is True
    # a short window on the CPU may serve fewer than the mix's 8 samples
    assert 1.0 <= result["numbers"]["compared"] <= 8.0
    if trace:
        assert "breakdown" in result
        assert "engine_roofline" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"serve_volumes_per_s", "setup_s"}


def test_control_reads_the_program_and_the_fp8_reference():
    for fp8 in (False, True):
        nums = control.readings(CELL, 2 ** 31 + 55, fp8, CPU, CANVAS)
        assert nums["compared"] == 8.0
        assert set(nums) >= {"flip_share_worst", "flip_share", "gap_max",
                             "bone_share_min", "bone_share_max"}


@pytest.mark.parametrize("setting", [
    {"use_int8": True}, {"patch_inference": True}, {"fg_crop": True},
    {"serve_scan": 4}, {"largest_cc": True}])
def test_the_loop_refuses_a_setting_it_does_not_follow(setting):
    cfg = harness.load_json(os.path.join(ROOT, "gpubench", "configs",
                                         "unet4_2ic.json"))
    cfg["settings"].update(setting)
    mix = harness.load_json(os.path.join(ROOT, "gpubench", "mixes",
                                         "serve_legacy.json"))
    with pytest.raises(NotImplementedError, match=sorted(setting)[0]):
        systems.kind("serve_legacy").System(cfg, mix, 1, CPU, CANVAS)


def test_missing_weights_fail_before_set_up(monkeypatch):
    """A checkout without the weights (the parent of the commit that adds
    them) stops at once, before any build or model."""
    cfg = harness.load_json(os.path.join(ROOT, "gpubench", "configs",
                                         "unet4_2ic.json"))
    cfg["weights"] = "ctunet_tpu_torch/assets/no_such_weights.pt"
    mix = harness.load_json(os.path.join(ROOT, "gpubench", "mixes",
                                         "serve_legacy.json"))
    monkeypatch.setattr(systems, "build_kernels", None)  # never reached
    with pytest.raises(FileNotFoundError):
        systems.kind("serve_legacy").System(cfg, mix, 1, CPU, CANVAS)


def _weights_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_legacy_weights_torch",
        os.path.join(ROOT, "tools", "train_legacy_weights_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("share", [0.1, 0.5])
def test_split_head_puts_the_asked_share_in_the_bone_class(case, share):
    """``tools/train_legacy_weights_torch.split_head`` (how the committed
    weights' head was set): only the bone bias moves, and the reference on
    the weights as saved puts ``share`` of the skulls' voxels in the bone
    class, to within one voxel a volume."""
    sd, _, _ = case
    model = build_model("UNet4_2IC")
    model.load_state_dict(sd)
    model.eval()
    tool = _weights_tool()
    before = {k: v.clone() for k, v in tool.stored(model.state_dict()).items()}
    vols = inputs.skulls(CANVAS, 2, 11, CPU, broken=True)
    atlas = inputs.atlas(CANVAS, CPU)
    out = tool.split_head(model, vols, atlas, CPU, share)
    after = tool.stored(model.state_dict())
    assert [k for k in after if not torch.equal(after[k], before[k])] == [
        "last_conv.bias"]
    assert after["last_conv.bias"][0] == before["last_conv.bias"][0]
    ref_sd = _f32(after)
    bone = 0.0
    with systems.reference_precision():
        for vol in vols:
            p = legacy.forward(ref_sd, tool._reference_inputs(vol, atlas,
                                                              CPU))[0]
            bone += float((p[..., 1] > p[..., 0]).float().mean()) / 2
    n = math.prod(CANVAS)
    assert abs(bone - share) <= 1.0 / n + 1e-6
    assert abs(sum(out["bone_share"]) / 2 - bone) <= 1.0 / n + 1e-6
