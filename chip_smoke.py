#!/usr/bin/env python3
"""Drive the PyTorch port (``ctunet_tpu_torch``) once on one CUDA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Card and build: prints the card's name and power limit as ``nvidia-smi``
   gives them, then builds the Hopper kernels from
   ``ctunet_tpu_torch/csrc/`` (one ``nvcc`` per source, in parallel) and
   times it.
2. Kernels: each kernel against its plain PyTorch version on the card at
   the paths' real shapes (224x304x304 and its levels): ``conv3d_tc``, the
   bf16 k=3/k=5 tensor-core conv behind K1, K6 and K5, at every distinct
   shape the paths launch (UNetSP's K1 per volume, K6's forward and input
   gradients per train step, ``UNet4_2IC``'s and ``recAE_v2_fixed``'s K5
   per volume), beside the direct CUDA-core kernel it replaced (same
   inputs, same call); ``upconv_tc``, the bf16 tensor-core stride-2
   upsampling kernel behind K3 and K7a/K7b, at UNetSP's four K3 shapes and
   every K7a/K7b shape of both legacy models, beside the CUDA-core
   kernels it replaced; K2 with the stated tolerance; the int8 kernels
   K1q-K3q exactly (on layers quantized from a calibration on one
   synthetic volume); K6's f32 route (the direct kernel) forward and as
   input gradient, and the autograd function's ``dx``/``dw`` against
   autograd through the plain version. Each with the kernel's time beside
   the plain version's, one PyTorch library call's where one exists, and
   the card's bound.
3. bf16 path: serves synthetic broken skulls (``spherical_shell`` with a
   hole punched; atlas ``spherical_shell(radius_frac=0.42)``) through the
   ``Model`` test path with the committed ``unetsp_10k`` weights, checks
   the written ``pred_<name>/*_{sk,fl,i}.nii.gz`` masks (shape, affine),
   the launch counts (12 K1, 4 K2, 4 K3 per volume; each K1 a
   ``conv3d_tc`` and each K3 an ``upconv_tc`` launch) and the masks against
   the engine run with the plain versions on the card (Dice >= 0.999 over
   the voxels both decide, see ``DECIDED``) and against the plain f32
   model (the kernel engine no further from it than the plain bf16 one).
4. int8 path: the same volumes through ``Model`` with the settings of
   ``examples/UNetSPDO/FlapRecSP2O_serve_int8.ini`` (calibrated int8 with
   AdaQuant, ``ADAQUANT_STEPS``) on whole volumes; checks the files, the
   int8 launch counts (12 K1q, 4 K2q, 4 K3q per volume), masks identical to
   the same int8 engine on the plain versions, and Dice against the plain
   f32 model of at least 0.98 (skull) and 0.95 (flap). Then two AdaQuant
   rounding searches of ``REPRO_STEPS`` steps on the same volume and scales
   must give bit-equal integers (and a third, without cuDNN's
   deterministic algorithms, is timed beside them).
5. Training: ``Model`` with the settings of
   ``examples/UNetSPDO/FlapRecSP2O.ini`` (adam, lr 1e-4, Dice + CE, batch 1,
   bf16) and ``conv_impl = "chain"`` on complete synthetic skulls at
   224x304x304, random weights from the seed: 1 epoch of 4 train steps and
   2 eval steps, the checkpoint saved, then the test path serves one volume
   from the trained weights through the bf16 engine. Checks: finite losses
   with the 4th below the 1st, K6 launches (31 per train step: 16 forward +
   15 input gradients, the network input needs none; 16 per eval step), the
   checkpoint reloading to the same tensors, the masks written, and one
   train step against the same step on the plain versions (loss within 1e-2
   relative, BatchNorm batch statistics within bf16 tolerance). Then the
   step time with ``chain`` and with ``xla`` (cuDNN), the peak memory and a
   ``torch.profiler`` pass over one ``chain`` step.
6. Legacy serving: ``Model`` with the settings of
   ``examples/autoimplant2020/UNetSP/AutoImplant2020_wShapePrior.ini``
   (``UNet4_2IC``, ``FlapRecWithShapePrior``, the atlas as the 2nd channel),
   test only, on the 3 synthetic broken skulls of phase 3 at 224x304x304,
   from seeded weights (the reference's torch init, BatchNorm statistics of
   one train-mode forward of the plain f32 model, the head's class-1 bias
   moved by the median logit gap so both classes hold voxels) saved as a
   reference-named ``.pt``. Checks: the ``pred_<name>/*_{fl,i}`` files,
   launches per volume (18 K5, 4 K2, 1 K7a, 3 K7b; each K5 a ``conv3d_tc``
   and each K7a/K7b an ``upconv_tc`` launch), masks against the same
   engine on the plain versions (Dice >= 0.999 over decided voxels) and
   against the plain f32 model (the kernel engine no further from it than
   the plain bf16 one, less 0.001); the engine's ms per volume, the loop's
   volumes/s, a ``torch.profiler`` table and each kernel launch's time by
   CUDA events. Then one volume of
   ``recAE_v2_fixed`` (``AutoImplant2020_woShapePrior.ini``, ``FlapRec``, 1
   input channel) with the same checks.

The last two lines of output are one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result. Needs a CUDA card and the repo beside this file; it
imports nothing of JAX and nothing of ``ctunet_tpu``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPE = (224, 304, 304)  # examples/UNetSPDO/FlapRecSP2O.ini
N_VOLUMES = 3
# the int8 serving settings (AdaQuant at the INI's default 250 steps)
INT8_INI = os.path.join(ROOT, "examples", "UNetSPDO",
                        "FlapRecSP2O_serve_int8.ini")
ADAQUANT_STEPS = 250
# steps of each of the two rounding searches that phase 4 holds bit-equal
REPRO_STEPS = 10
TRAIN_INI = os.path.join(ROOT, "examples", "UNetSPDO", "FlapRecSP2O.ini")
LEGACY_INIS = {  # AutoImplant 2020: with and without the shape prior
    "UNet4_2IC": os.path.join(ROOT, "examples", "autoimplant2020", "UNetSP",
                              "AutoImplant2020_wShapePrior.ini"),
    "recAE_v2_fixed": os.path.join(ROOT, "examples", "autoimplant2020",
                                   "UNet", "AutoImplant2020_woShapePrior.ini"),
}
# kernel launches per volume of the legacy engine
LEGACY_PER_VOLUME = {"conv3d5_bias_act": 18, "maxpool2": 4, "convt_k2s2": 1,
                     "convt_k2s2_dual": 3, "conv3d_tc": 18, "upconv_tc": 4}
N_TRAIN, N_EVAL = 4, 2  # steps of the training phase (batch 1)
# K6 launches per step of the 16-conv UNetSP: every conv forward, and every
# input gradient but the network input's
K6_PER_TRAIN_STEP, K6_PER_EVAL_STEP = 16 + 15, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12     # H100 SXM dense int8 tensor cores, published
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_EPS = 2.0 ** -7        # bf16 spacing at 1.0 (7 stored mantissa bits)
# A voxel is decided when both engines' class probabilities differ by more
# than 4 bf16 ulps at 0.5. Two bf16 engines that differ only in f32
# summation order flip nearer ties: on this model and these volumes about
# 0.13% of the skull's voxels, so the raw mask Dice between them sits near
# 0.9986 (skull) and 0.998 (flap) while each is 0.9968 / 0.9952 from the
# f32 model (measured on an H100 80GB HBM3, 700 W).
DECIDED = 2.0 ** -7


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn()`` over ``reps`` runs after one warm-up; CUDA
    events on the card, the host clock elsewhere."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOP_PER_S):
    """(least time on the card in ms, "bytes" or "operations") at the
    operations' ``peak`` rate."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def conv_taps(shape, k: int) -> int:
    """(output voxel, in-bounds tap) pairs of a SAME k-conv over ``shape``."""
    p = k // 2
    return math.prod(n * k - p * (p + 1) for n in shape)


def bf16_tol(ref) -> float:
    """2 bf16 ulps at the reference's largest magnitude: kernel and plain
    version sum the same bf16 products in f32 in different orders and each
    rounds once to bf16, so they may land one ulp apart (two for safety)."""
    m = float(ref.float().abs().max())
    return 2.0 * BF16_EPS * 2.0 ** math.floor(math.log2(m)) if m > 0 else 0.0


def relu_normal(shape, gen, device):
    import torch

    return torch.relu(torch.randn(*shape, generator=gen, device=device)
                      ).to(torch.bfloat16)


def record_bf16(entries, failures, name, case, got, ref, ms, plain_ms,
                lib_ms, nbytes, nflops, tol):
    """Log one bf16 kernel case against its plain version and the card's
    bound; the first case of each kernel goes into ``entries``."""
    import torch

    err = float((got.float() - ref.float()).abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    b_ms, b_by = bound_ms(nbytes, nflops)
    ok = finite and err <= tol
    log(f"  {name} [{case}]: max_abs_err {err:.3e} (tol {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.4f} ms"
        f" ({b_by}); {nflops / ms / 1e9:.2f} TFLOP/s, "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    if not ok:
        failures.append(f"{name} [{case}]: err {err} > tol {tol} "
                        f"or non-finite")
    if name not in entries:
        entries[name] = dict(case=case, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)


def check_kernels(sd, device, shape=SHAPE, reps_big: int = 5):
    """K2 against its plain version at the UNetSP path's full-resolution
    pool (K1 is ``conv3d_tc``: :func:`check_conv_tc`; K3 is ``upconv_tc``:
    :func:`check_upconv_tc`). Returns ``(entries, failures)``, ``entries``
    keyed by wrapper name."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    entries, failures = {}, []
    record = functools.partial(record_bf16, entries, failures)

    # K2: the full-resolution pool (d0 output, 7 channels); max is exact
    x = torch.randn(lv[0] + (7,), generator=gen, device=device).to(bf)
    got, ref = kc.maxpool2(x), kc.maxpool2_plain(x)
    ms = time_ms(lambda: kc.maxpool2(x), reps_big * 4, device)
    p_ms = time_ms(lambda: kc.maxpool2_plain(x), reps_big * 4, device)
    x_l = x.permute(3, 0, 1, 2)[None]
    l_ms = time_ms(lambda: F.max_pool3d(x_l, 2), reps_big * 4, device)
    record("maxpool2", f"7ch {'x'.join(map(str, lv[0]))}", got, ref, ms,
           p_ms, l_ms, x.numel() * 2 + got.numel() * 2, 7 * got.numel(), 0.0)
    del x, got, ref

    return entries, failures


def unetsp_convs(widths=(7, 14, 28, 56), cin: int = 2):
    """UNetSP's 16 k=3 convs as ``(ci, co, level, served)``: each encoder
    level's two units, then decoder block j's two at level ``n - 1 - j``;
    ``served`` marks the K1 launches of the bf16 engine (it fuses each
    decoder block's first unit into K3)."""
    n, convs = len(widths), []
    for i, w in enumerate(widths):
        convs += [(cin, w, i, True), (w, w, i, True)]
        cin = w
    for j in range(n):
        w = widths[n - 1 - j]
        convs += [(cin, w, n - 1 - j, False), (w, w, n - 1 - j, True)]
        cin = 2 * w
    return convs


def legacy_convs(i_size: int, cin: int):
    """The 18 k=5 convs of a legacy model as ``(ci, co, level)``: encoder
    levels 0-3, the center at 4, decoder blocks at 3..0 (each upsamples
    ``cat(previous output, skip)``)."""
    f = [i_size * 2 ** n for n in range(5)]
    convs = []
    for i in range(5):
        convs += [(cin, f[i], i), (f[i], f[i], i)]
        cin = f[i]
    for i in range(4):
        convs += [(cin, f[3 - i], 3 - i), (f[3 - i], f[3 - i], 3 - i)]
        cin = 2 * f[3 - i]
    return convs


def conv_tc_shapes():
    """Every distinct bf16 conv the paths launch, ``{(k, ci, co, level):
    {path: launches}}``: K1 per UNetSP volume, K6 per UNetSP train step
    (16 forward + 15 input gradients, ``co -> ci``, the network input's
    left out), K5 per ``UNet4_2IC`` and per ``recAE_v2_fixed`` volume."""
    rows = {}

    def add(key, path):
        rows.setdefault(key, {}).setdefault(path, 0)
        rows[key][path] += 1

    for i, (ci, co, lv, served) in enumerate(unetsp_convs()):
        if served:
            add((3, ci, co, lv), "K1/volume")
        add((3, ci, co, lv), "K6/step")
        if i:
            add((3, co, ci, lv), "K6/step")
    for mc, i_size, cin in (("UNet4_2IC", 7, 2), ("recAE_v2_fixed", 8, 1)):
        for ci, co, lv in legacy_convs(i_size, cin):
            add((5, ci, co, lv), f"{mc}/volume")
    return dict(sorted(rows.items()))


def check_conv_tc(device, shape=SHAPE):
    """``conv3d_tc`` against its plain version within ``bf16_tol`` at every
    shape of :func:`conv_tc_shapes`, called through the wrapper its path
    calls (K1 ``conv3d_bn_relu``, K6 ``conv3d_bias_act`` without ReLU, K5
    ``conv3d5_bias_act``); beside it the direct CUDA-core kernel's time
    (the kernel these wrappers launched before, same inputs, same call),
    the plain version's (one run), cuDNN's bf16 ``F.conv3d`` and the bound.
    Random normal weights scaled by
    their fan-in, f32 biases, ReLU'd normal inputs from a seed. Logs one
    ``TC`` line per shape and each path's sums (time x launches). Returns
    ``(entries, failures)``."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(4)
    bf = torch.bfloat16
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    entries, failures, sums = {}, [], {}
    for (k, ci, co, level), paths in conv_tc_shapes().items():
        shp = lv[level]
        if k == 5:
            name, relu = "conv3d5_bias_act", True
            run = functools.partial(kc.conv3d5_bias_act, relu=True)
            direct = kc.conv3d5_bias_act_direct
        elif "K1/volume" in paths:
            name, relu = "conv3d_bn_relu", True
            run, direct = kc.conv3d_bn_relu, kc.conv3d_bias_act_direct
        else:
            name, relu = "conv3d_bias_act", False
            run = functools.partial(kc.conv3d_bias_act, relu=False)
            direct = kc.conv3d_bias_act_direct
        wt = (torch.randn(k, k, k, ci, co, generator=gen, device=device)
              * (k ** 3 * ci) ** -0.5).to(bf)
        b = torch.randn(co, generator=gen, device=device) * 0.1
        x = relu_normal(shp + (ci,), gen, device)
        big = level < 2
        got = run(x, wt, b)
        ref = kc.conv3d_tc_plain(x, wt, b, relu)
        ms = time_ms(lambda: run(x, wt, b), 2 if big else 20, device)
        d_ms = time_ms(lambda: direct(x, wt, b, relu), 1 if big else 5,
                       device)
        x_l = x.permute(3, 0, 1, 2)[None]
        w_l = wt.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        l_ms = time_ms(lambda: F.conv3d(x_l, w_l, b.to(bf), padding=k // 2),
                       2 if big else 20, device)
        first = name not in entries
        largest = (k, ci, co, level) == (5, 56, 14, 1)
        p_ms = time_ms(lambda: kc.conv3d_tc_plain(x, wt, b, relu), 1, device)
        nbytes = 2 * math.prod(shp) * (ci + co) + 2 * wt.numel() + 4 * co
        nflops = 2 * ci * co * conv_taps(shp, k)
        b_ms, b_by = bound_ms(nbytes, nflops)
        err = float((got.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        case = f"k{k} {ci}->{co} {'x'.join(map(str, shp))}"
        per = ", ".join(f"{n} {p}" for p, n in paths.items())
        log(f"  TC {case}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}; conv3d_tc {ms:.3f} ms "
            f"({nflops / ms / 1e9:.1f} TFLOP/s), direct {d_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, cuDNN {l_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); launches {per}; "
            f"via {name}")
        if not ok:
            failures.append(f"conv3d_tc [{case}]: err {err} > tol {tol} or "
                            "non-finite")
        for p, n in paths.items():
            t = sums.setdefault(p, [0.0, 0.0, 0.0, 0])
            t[0] += n * ms
            t[1] += n * d_ms
            t[2] += n * l_ms
            t[3] += n
        entry = dict(case=case, max_abs_err=err, ms=ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        if first:
            entries[name] = entry
        if largest:
            entries["conv3d_tc"] = entry
        del x, got, ref, x_l
    for p, (t, t_d, t_l, n) in sums.items():
        log(f"  TC sum {p}: {n} launches, conv3d_tc {t:.3f} ms, direct "
            f"{t_d:.3f} ms, cuDNN {t_l:.3f} ms")
    return entries, failures


def upconv_tc_shapes():
    """Every bf16 stride-2 upsampling launch of the paths, as ``(wrapper,
    ca, cb, co, level, path)``: UNetSP's four K3 (decoder block j at
    half-resolution level 4 - j; the trained weights of block j), and
    ``UNet4_2IC``'s and ``recAE_v2_fixed``'s K7a (the center output) and
    three K7b (``cat(block output, skip)``), one launch each per volume."""
    rows = [("upconv_bn_relu", j, None, None, 4 - j, "UNetSP")
            for j in (3, 2, 1, 0)]  # ca holds j: the weights fix the widths
    for mc, f in (("UNet4_2IC", 7), ("recAE_v2_fixed", 8)):
        rows.append(("convt_k2s2", 16 * f, 0, 16 * f, 4, mc))
        for lv in (3, 2, 1):
            c = f * 2 ** lv
            rows.append(("convt_k2s2_dual", c, c, 2 * c, lv, mc))
    return rows


def check_upconv_tc(sd, device, shape=SHAPE, reps_big: int = 3,
                    reps_small: int = 20):
    """``upconv_tc`` against the plain versions within ``bf16_tol`` at
    every shape of :func:`upconv_tc_shapes`, through the wrapper its path
    calls (K3 ``upconv_bn_relu`` with UNetSP's trained decoder weights, K7a
    ``convt_k2s2`` and K7b ``convt_k2s2_dual`` with random normal weights
    scaled by their fan-in); ReLU'd normal inputs from a seed. Beside it
    the direct CUDA-core kernel's time (the kernel these wrappers launched
    before, same inputs, same call), the plain version's, cuDNN's bf16
    ``F.conv_transpose3d`` of the same function (K3: the k4/s2/p1
    transposed conv of ``cat(a, ones, b)``) and the bound. Logs one ``UTC``
    line per shape and each path's sums (time x launches). Returns
    ``(entries, failures)``: each wrapper's first shape, and under
    ``upconv_tc`` its largest launch (K7b (14+14)->28)."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch import engine
    from ctunet_tpu_torch.ops.kernels import convt as kt
    from ctunet_tpu_torch.ops.kernels import upconv as ku
    from ctunet_tpu_torch.ops.kernels import upsample_tc as ut

    gen = torch.Generator(device=device).manual_seed(3)
    bf = torch.bfloat16
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    entries, failures, sums = {}, [], {}

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=device)

    for name, ca, cb, co, level, path in upconv_tc_shapes():
        shp2 = lv[level]
        if name == "upconv_bn_relu":
            j = ca
            ca = None if j == 0 else int(
                sd[f"u_blocks.{j - 1}.block.4.weight"].shape[0])
            wa, wb, wone, bias = engine.upconv_operands(sd, j, ca, bf, device)
            ca, co = wa.shape[3], wa.shape[4]
            cb = 0 if wb is None else wb.shape[3]
            k3 = True
            run, direct = ku.upconv_bn_relu, ku.upconv_bn_relu_direct
            plain = ku.upconv_bn_relu_plain
            args = lambda: (a, b, wa, wb, wone, bias)  # noqa: E731
            w_lib = torch.cat([wa, wone[..., None, :]]
                              + ([] if wb is None else [wb]), 3)
            w_lib = w_lib.permute(3, 4, 0, 1, 2).contiguous()
        else:
            k3 = False
            wt = randn(ca + cb, co, 2, 2, 2) * (ca + cb) ** -0.5
            bias0 = randn(co) * 0.1
            wa, wb, bias = kt.convt_weights(wt, bias0, ca if cb else None)
            wone = None
            plain = kt.convt_k2s2_plain
            if cb:
                run, direct = kt.convt_k2s2_dual, kt.convt_k2s2_dual_direct
                args = lambda: (a, b, wa, wb, bias)  # noqa: E731
            else:
                run, direct = kt.convt_k2s2, kt.convt_k2s2_direct
                args = lambda: (a, wa, bias)  # noqa: E731
            w_lib = wt.to(bf)
        a = relu_normal(shp2 + (ca,), gen, device)
        b = relu_normal(shp2 + (cb,), gen, device) if cb else None
        big = level < 2
        before = ut.upconv_tc.launches
        got = run(*args())
        if ut.upconv_tc.launches != before + 1:
            failures.append(f"{name}: did not launch upconv_tc")
        ref = (plain(a, b, wa, wb, wone, bias) if k3
               else plain(a, b, wa, wb, bias))
        reps = reps_big if big else reps_small
        ms = time_ms(lambda: run(*args()), reps, device)
        d_ms = time_ms(lambda: direct(*args()), reps, device)
        p_ms = time_ms(lambda: plain(a, b, wa, wb, wone, bias) if k3
                       else plain(a, b, wa, wb, bias), 1 if big else reps,
                       device)
        parts = [a] + ([torch.ones_like(a[..., :1])] if k3 else []) + (
            [] if b is None else [b])
        x_l = torch.cat(parts, -1).permute(3, 0, 1, 2)[None]
        b_l = (bias if k3 else bias0).to(bf)
        l_ms = time_ms(lambda: F.conv_transpose3d(
            x_l, w_lib, b_l, stride=2, padding=1 if k3 else 0), reps, device)
        nbytes, nflops = ut.upconv_tc_work(shp2, ca, cb, co, k3)
        b_ms, b_by = bound_ms(nbytes, nflops)
        err = float((got.float() - ref.float()).abs().max())
        tol = bf16_tol(ref)
        ok = (bool(torch.isfinite(got.float()).all()) and err <= tol
              and tuple(got.shape) == tuple(2 * s for s in shp2) + (co,))
        out_shp = "x".join(str(2 * s) for s in shp2)
        case = (f"({ca}+{cb})->{co} to {out_shp}" if cb
                else f"{ca}->{co} to {out_shp}")
        plan = ut.uptc_plan(shp2, ca, cb, co, k3)
        log(f"  UTC {name} [{case}] {path}: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {'ok' if ok else 'FAIL'}; upconv_tc {ms:.3f} ms "
            f"({nflops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} "
            f"GB/s), direct {d_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN "
            f"{l_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); plan np={plan.np}"
            f" mf={plan.mf} nf={plan.nf} tx={1 << plan.tx_log2} "
            f"cc={plan.cc}")
        if not ok:
            failures.append(f"upconv_tc {name} [{case}]: err {err} > tol "
                            f"{tol}, non-finite or wrong shape")
        t = sums.setdefault(path, [0.0, 0.0, 0.0, 0])
        t[0] += ms
        t[1] += d_ms
        t[2] += l_ms
        t[3] += 1
        entry = dict(case=case, max_abs_err=err, ms=ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                     direct_ms=d_ms)
        if name not in entries:
            entries[name] = entry
        if (name, ca, cb, co, level, path) == (
                "convt_k2s2_dual", 14, 14, 28, 1, "UNet4_2IC"):
            entries["upconv_tc"] = entry
        del a, b, got, ref, x_l
    for p, (t, t_d, t_l, n) in sums.items():
        log(f"  UTC sum {p}: {n} launches per volume, upconv_tc {t:.3f} ms, "
            f"direct {t_d:.3f} ms, cuDNN {t_l:.3f} ms")
    return entries, failures


def f32_tol(ref, n_terms: int) -> float:
    """Kernel and plain version add the same ``n_terms`` f32 products per
    output in different orders, so each carries a rounding error that grows
    as ``eps * sqrt(n_terms)`` of the sums' magnitude: 4 times that at the
    reference's largest magnitude (the largest of ~10^7 outputs is compared).
    A dropped tap would show as ~1e-1."""
    return 4.0 * 2.0 ** -23 * math.sqrt(n_terms) * float(
        ref.float().abs().max())


def check_kernel_train(device, shape=SHAPE, reps: int = 3):
    """K6's f32 route (the direct kernel) against its plain version at the
    layers training launches: forward and as input gradient (the reverse
    layer's flipped, channel-swapped weights); then the autograd function's
    bf16 ``dx`` and ``dw`` against autograd through the plain version at the
    full-resolution 7->7 layer, and the library's forward / dgrad / wgrad
    times there. Random normal inputs and weights from a seed. Returns
    ``(entries, failures)``.
    """
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops import chain_conv_train as cct
    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(2)
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    entries, failures = {}, []

    def randn(*shp, dtype):
        return torch.randn(*shp, generator=gen, device=device).to(dtype)

    # f32: the direct kernel (bf16 is conv3d_tc: check_conv_tc)
    f32 = torch.float32
    for ci, co, level in ((2, 7, 0), (7, 7, 0), (28, 7, 0), (7, 28, 0),
                          (112, 28, 2)):
        shp = lv[level]
        wt = randn(3, 3, 3, ci, co, dtype=f32) * (27 * ci) ** -0.5
        zero = torch.zeros(co, device=device)
        for mode in ("fwd", "dgrad"):
            x = randn(*shp, ci, dtype=f32)
            k = wt if mode == "fwd" else cct.flip_swap(  # a co->ci layer's
                randn(3, 3, 3, co, ci, dtype=f32) * (27 * co) ** -0.5)
            got = kc.conv3d_bias_act(x, k, zero, False)
            ref = kc.conv3d_bias_act_plain(x, k, zero, False)
            sync(device)
            tol = f32_tol(ref, 27 * k.shape[3])
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= tol
            ms = time_ms(lambda: kc.conv3d_bias_act(x, k, zero, False), reps,
                         device)
            p_ms = time_ms(lambda: kc.conv3d_bias_act_plain(x, k, zero,
                                                            False), 1, device)
            x_l = x.permute(3, 0, 1, 2)[None]
            k_l = k.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            l_ms = time_ms(lambda: F.conv3d(x_l, k_l, padding=1), reps,
                           device)
            nbytes = 4 * (math.prod(shp) * (ci + co) + k.numel()) + 4 * co
            nflops = 2 * ci * co * conv_taps(shp, 3)
            b_ms, b_by = bound_ms(nbytes, nflops, F32_FLOP_PER_S)
            case = f"{ci}->{co} {'x'.join(map(str, shp))} f32 {mode}"
            log(f"  conv3d_bias_act [{case}]: max_abs_err {err:.3e} (tol "
                f"{tol:.3e}) {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, "
                f"plain {p_ms:.3f} ms, library {l_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); {nflops / ms / 1e9:.2f} TFLOP/s")
            if not ok:
                failures.append(f"conv3d_bias_act [{case}]: err {err} > tol "
                                f"{tol} or non-finite")
            del x, k, got, ref, x_l, k_l

    # the autograd function at the full-resolution 7->7 layer, bf16
    bf = torch.bfloat16
    x = randn(1, *lv[0], 7, dtype=bf).requires_grad_()
    wt = (randn(3, 3, 3, 7, 7, dtype=bf) * (27 * 7) ** -0.5).requires_grad_()
    g = randn(1, *lv[0], 7, dtype=bf)
    zero = torch.zeros(7, device=device)
    dx, dw = torch.autograd.grad(cct.conv3d_chain_train(x, wt), (x, wt), g)
    y_ref = kc.conv3d_bias_act_plain(x[0], wt, zero, False)[None]
    dx_r, dw_r = torch.autograd.grad(y_ref, (x, wt), g)
    for name, got, ref, ulps in (("dx", dx, dx_r, 1.0), ("dw", dw, dw_r, 2.0)):
        # dw: each depth plane's partial sum is rounded to bf16 before the
        # f32 sum over planes, then the sum is rounded: twice K1's tolerance
        tol = ulps * bf16_tol(ref)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        log(f"  conv3d_chain_train {name} [7->7 full size bf16] vs autograd "
            f"through the plain version: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}, max |ref| {float(ref.float().abs().max()):.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"conv3d_chain_train {name}: err {err} > {tol}")
    xd, wd = x.detach(), wt.detach()
    dgrad_ms = time_ms(lambda: kc.conv3d_bias_act(
        g[0], cct.flip_swap(wd), zero, False), reps, device)
    wgrad_ms = time_ms(lambda: cct.dw_taps(xd[0], g[0]), reps, device)
    x_l = x.detach().permute(0, 4, 1, 2, 3).requires_grad_()
    w_l = wd.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d).requires_grad_()
    g_l = g.permute(0, 4, 1, 2, 3)
    y_l = F.conv3d(x_l, w_l, padding=1)
    lib = {}
    for name, inp in (("dgrad", x_l), ("wgrad", w_l)):
        lib[name] = time_ms(lambda: torch.autograd.grad(
            y_l, inp, g_l, retain_graph=True), reps, device)
    log(f"  7->7 full size bf16 backward: kernel dgrad {dgrad_ms:.3f} ms, "
        f"27 tap-shifted matmuls wgrad {wgrad_ms:.3f} ms; library (cuDNN "
        f"through torch.autograd.grad) dgrad {lib['dgrad']:.3f} ms, wgrad "
        f"{lib['wgrad']:.3f} ms")
    return entries, failures


def check_kernels_q(sd, device, shape=SHAPE, reps_big: int = 5,
                    reps_small: int = 50, reps_plain: int = 1):
    """K1q, K2q and K3q against their plain versions at the int8 path's
    shapes, with the layers the int8 engine quantizes (round to nearest)
    from a calibration on one synthetic volume, on uniform random int8
    inputs. Exact equality. Returns ``(entries, failures)``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch import engine_q
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import upconv as ku

    gen = torch.Generator(device=device).manual_seed(1)
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    x_cal = np.stack([punched_shell(shape, 800),
                      spherical_shell(shape, radius_frac=0.42)], -1)
    x_cal = torch.from_numpy(x_cal.astype(np.float32)).to(device)
    t0 = time.perf_counter()
    pq = engine_q.build_predict_q("UNetSP", sd, x_cal, device=device)
    layers = pq.layers
    log(f"  calibration + quantization of the layers: "
        f"{time.perf_counter() - t0:.1f} s")
    # where the int8 engine's time goes, on this round-to-nearest build
    # (the same kernels at the same shapes as the AdaQuant build served
    # later; a profile taken after AdaQuant's autograd lost kernel events)
    profile_device(lambda: pq(x_cal[None]), device)
    entries, failures = {}, []

    def rand_q(shp):
        return torch.randint(-128, 128, shp, generator=gen, device=device,
                             dtype=torch.int8)

    def record(name, case, got, ref, ms, plain_ms, lib_ms, nbytes, nops):
        err = float((got.int() - ref.int()).abs().max())
        b_ms, b_by = bound_ms(nbytes, nops, INT8_OP_PER_S)
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        log(f"  {name} [{case}]: max_abs_err {err:.0f} (exact required) "
            f"{'ok' if err == 0 else 'FAIL'}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib}, bound {b_ms:.4f} ms "
            f"({b_by}); {nops / ms / 1e9:.2f} TOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        if err != 0 or got.dtype != torch.int8:
            failures.append(f"{name} [{case}]: max_abs_err {err} != 0")
        if name not in entries:
            entries[name] = dict(case=case, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms)

    # K1q: the full-resolution 7->7 conv (d0 unit1) and the 28x38x38
    # 56->56 conv (d3 unit1); out-of-volume taps read the zero point
    for blk, shp in ((0, lv[0]), (3, lv[3])):
        w_, s_, b_ = layers[f"d{blk}.1"]
        ci, co = w_.shape[3], w_.shape[4]
        x = rand_q(shp + (ci,))
        reps = reps_big if blk == 0 else reps_small
        got = kc.conv3d_q_requant(x, w_, s_, b_)
        ref = kc.conv3d_q_requant_plain(x, w_, s_, b_)
        ms = time_ms(lambda: kc.conv3d_q_requant(x, w_, s_, b_), reps, device)
        p_ms = time_ms(lambda: kc.conv3d_q_requant_plain(x, w_, s_, b_),
                       reps_plain if blk == 0 else reps, device)
        nbytes = math.prod(shp) * (ci + co) + w_.numel() + 8 * co
        record("conv3d_q_requant", f"{ci}->{co} {'x'.join(map(str, shp))}",
               got, ref, ms, p_ms, None, nbytes,
               2 * 27 * ci * co * math.prod(shp))
        del x, got, ref

    # K2q: the full-resolution pool (d0 output, 7 channels)
    x = rand_q(lv[0] + (7,))
    got, ref = kc.maxpool2_q(x), kc.maxpool2_q_plain(x)
    ms = time_ms(lambda: kc.maxpool2_q(x), reps_big * 4, device)
    p_ms = time_ms(lambda: kc.maxpool2_q_plain(x), reps_big * 4, device)
    x_l = x.permute(3, 0, 1, 2)[None]
    try:  # PyTorch's max pool may refuse int8 on the card
        l_ms = time_ms(lambda: F.max_pool3d(x_l, 2), reps_big * 4, device)
    except RuntimeError as e:
        log(f"  F.max_pool3d on int8: refused ({str(e).splitlines()[0]})")
        l_ms = None
    record("maxpool2_q", f"7ch {'x'.join(map(str, lv[0]))}", got, ref, ms,
           p_ms, l_ms, x.numel() + got.numel(), 7 * got.numel())
    del x, got, ref

    # K3q: u3 (14+14 -> 7, out 224x304x304) and u0 (56 -> 56, out 28x38x38)
    for j, shp2 in ((3, lv[1]), (0, lv[4])):
        wa, wb, wone, s_, b_ = layers[f"u{j}.0"]
        a = rand_q(shp2 + (wa.shape[3],))
        b = None if wb is None else rand_q(shp2 + (wb.shape[3],))
        co = wa.shape[4]
        cin = wa.shape[3] + (0 if wb is None else wb.shape[3])
        reps = reps_big if j == 3 else reps_small
        args = (a, b, wa, wb, wone, s_, b_)
        got = ku.upconv_q_requant(*args)
        ref = ku.upconv_q_requant_plain(*args)
        ms = time_ms(lambda: ku.upconv_q_requant(*args), reps, device)
        p_ms = time_ms(lambda: ku.upconv_q_requant_plain(*args),
                       reps_plain if j == 3 else reps, device)
        out_shape = tuple(2 * s for s in shp2)
        nbytes = (math.prod(shp2) * cin + math.prod(out_shape) * co
                  + wa.numel() + wone.numel() + 36 * co
                  + (0 if wb is None else wb.numel()))
        record("upconv_q_requant",
               f"{cin}->{co} {'x'.join(map(str, out_shape))}", got, ref, ms,
               p_ms, None, nbytes, 2 * 8 * (cin + 1) * co * math.prod(
                   out_shape))
        del a, b, got, ref
    return entries, failures


def punched_shell(shape, seed: int):
    """A synthetic broken skull: a shell with one spherical cap removed."""
    import numpy as np

    from ctunet_tpu_torch.data import spherical_shell

    full = spherical_shell(shape, seed=seed)
    rng = np.random.default_rng(seed)
    r = 0.38 * min(shape)
    v = rng.normal(size=3)
    v[0] = -abs(v[0])  # the cap sits on the upper half
    c = np.asarray(shape, np.float64) / 2 + r * v / np.linalg.norm(v)
    zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in shape)]
    hole = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
            <= (0.35 * r) ** 2)
    return np.where(hole, 0, full).astype(np.uint8)


def profile_device(fn, device, rows: int = 12, what: str = "one volume"):
    """Print the device time of one ``fn()`` by kernel name
    (``torch.profiler``), or "not measured" when it sees none. Returns
    ``{kernel name: (count, ms)}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (e.count, e.self_device_time_total / 1e3)
    total = sum(ms for _, ms in by_name.values())
    if not total:
        log("  device profile: not measured (no device time recorded)")
        return by_name
    log(f"  device profile of {what}: {total:.2f} ms of kernels")
    for key, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                               )[:rows]:
        log(f"    {ms:8.3f} ms {100 * ms / total:5.1f}% x{n:<3d} {key[:70]}")
    return by_name


def launch_breakdown(model_class: str, sd, x, device):
    """Each kernel launch of one pass of a legacy engine over ``x``, in
    launch order, timed by CUDA events recorded around its wrapper call
    (the host clock off the card); the rest of the pass (head, softmax,
    casts) is the pass's time less the launches'. A fresh engine is built
    and run, after a warm-up pass, with the wrappers wrapped. Logs the
    launches and returns ``{wrapper name: ms}`` with ``"rest"`` and
    ``"engine"``."""
    import torch

    from ctunet_tpu_torch import engine
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import convt as kt

    cuda = device.type == "cuda"

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(t0, t1) -> float:
        return t0.elapsed_time(t1) if cuda else 1e3 * (t1 - t0)

    calls = []

    def timed(name, fn):
        def call(*args):
            t0 = stamp()
            out = fn(*args)
            t1 = stamp()
            cin = "+".join(str(a.shape[-1]) for a in args[:2 if "dual" in name
                                                          else 1])
            calls.append((f"{name} {cin}->{out.shape[-1]} "
                          f"{'x'.join(map(str, out.shape[:3]))}", name, t0,
                          t1))
            return out
        # a wrapper counts its launches on its module-level name, which is
        # this function while it is wrapped; WRAPPERS keeps the real counts
        call.launches = 0
        return call

    wrapped = [(m, n, getattr(m, n)) for m, n in (
        (kc, "conv3d5_bias_act"), (kc, "maxpool2"), (kt, "convt_k2s2"),
        (kt, "convt_k2s2_dual"))]
    try:
        for m, n, fn in wrapped:
            setattr(m, n, timed(n, fn))
        pred = engine.build_predict(model_class, sd, device=device)
        pred(x)
        calls.clear()
        t0 = stamp()
        pred(x)
        t1 = stamp()
        sync(device)
    finally:
        for m, n, fn in wrapped:
            setattr(m, n, fn)
    by_name = {}
    log(f"  {model_class}: each kernel launch of one volume, in order "
        "(CUDA events around the wrapper call), ms:")
    for label, name, a, b in calls:
        ms = span(a, b)
        by_name[name] = by_name.get(name, 0.0) + ms
        log(f"    {ms:9.3f}  {label}")
    by_name["engine"] = span(t0, t1)
    by_name["rest"] = by_name["engine"] - sum(
        v for k, v in by_name.items() if k != "engine")
    log("  by wrapper, ms: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in by_name.items()))
    return by_name


def dice(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    s = int(a.sum()) + int(b.sum())
    return 1.0 if s == 0 else 2.0 * int((a & b).sum()) / s


def write_volumes(work: str, shape, n_volumes: int):
    """``n_volumes`` synthetic broken skulls as NIfTI files, their CSV, and
    the registered atlas. Returns ``(data_dir, paths, csv, atlas, affine)``.
    """
    import numpy as np

    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.data.atlas import register_atlas
    from ctunet_tpu_torch.utils import nifti

    data = os.path.join(work, "data")
    os.makedirs(data)
    paths = []
    affine = np.diag([0.5, 0.45, 0.45, 1.0])
    affine[:3, 3] = (-10.0, 20.0, 5.0)
    for i in range(n_volumes):
        p = os.path.join(data, f"skull_{i:03d}.nii.gz")
        nifti.write(p, nifti.NiftiImage(punched_shell(shape, 900 + i), affine))
        paths.append(p)
    csv = os.path.join(data, "files.csv")
    with open(csv, "w") as f:
        f.write("image,mask\n" + "".join(f"{p},\n" for p in paths))
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    register_atlas(shape, atlas)
    return data, paths, csv, atlas, affine


def read_masks(out_dir: str, paths, shape, affine, failures,
               sfxs=("sk", "fl", "i")):
    """The ``<file>_<sfx>`` files ``Model`` wrote for ``paths``, checked
    for shape and affine: ``{(base, sfx): array}``."""
    import numpy as np

    from ctunet_tpu_torch.utils import nifti

    masks = {}
    for p in paths:
        base = os.path.basename(p).replace(".nii.gz", "")
        for sfx in sfxs:
            q = os.path.join(out_dir, f"{base}_{sfx}.nii.gz")
            if not os.path.exists(q):
                failures.append(f"missing {q}")
                continue
            img = nifti.read(q)
            if img.data.shape != shape or not np.allclose(img.affine, affine):
                failures.append(f"{q}: shape {img.data.shape} / affine "
                                "differ from the input")
            masks[(base, sfx)] = img.data
    log(f"  wrote {len(masks)} files in {out_dir}")
    return masks


def check_adaquant_repro(sd, x, device, steps: int = REPRO_STEPS):
    """Two AdaQuant rounding searches (``quant_opt.optimize_rounding``,
    ``steps`` Adam steps per unit) on the same calibration volume ``x``
    ``(D, H, W, 2)`` and the same exported scales must give bit-equal
    integer weights, scales and bias deltas. A third search runs as the
    search ran before its flags asked for cuDNN's deterministic algorithms
    (TF32 off only), for its time and whether it lands on the same
    integers (logged, not checked). Returns ``(seconds of each search,
    failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import engine_q, quant_opt

    scales = {}
    engine_q.build_predict_q("UNetSP", sd, x, device=device,
                             export_scales=scales)
    deterministic = quant_opt.SEARCH_FLAGS
    before = tuple(f for f in deterministic if f[1] == "allow_tf32")
    runs, secs = [], []
    for flags in (deterministic, deterministic, before):
        quant_opt.SEARCH_FLAGS = flags
        try:
            sync(device)
            t0 = time.perf_counter()
            with torch.inference_mode(False), torch.enable_grad():
                runs.append(quant_opt.optimize_rounding(
                    "UNetSP", sd, x.float()[None], scales, steps=steps,
                    device=device))
            sync(device)
            secs.append(time.perf_counter() - t0)
        finally:
            quant_opt.SEARCH_FLAGS = deterministic

    def differ(r0, r1):
        return [f"{tag}.{key}" for tag in r0 for key in r0[tag]
                if not np.array_equal(np.asarray(r0[tag][key]),
                                      np.asarray(r1[tag][key]))]

    diff, diff_before = differ(runs[0], runs[1]), differ(runs[0], runs[2])
    n_ints = sum(np.asarray(r["q"]).size for r in runs[0].values())
    verdict = "bit-equal" if not diff else "DIFFER in " + ", ".join(diff)
    log(f"  AdaQuant reproducibility: two rounding searches of {steps} steps "
        f"on the same volume and scales: {len(runs[0])} units, {n_ints} "
        f"integer weights, {verdict}; {secs[0]:.1f} s and {secs[1]:.1f} s. "
        f"Without cuDNN's deterministic algorithms: {secs[2]:.1f} s, "
        f"{len(diff_before)} of {sum(map(len, runs[0].values()))} arrays "
        f"differ from the first search ({', '.join(diff_before[:6])})")
    if diff:
        failures = [f"AdaQuant searches differ between runs: {diff}"]
    else:
        failures = []
    return secs, failures


def serve_int8(device, work: str, shape=SHAPE, n_volumes: int = N_VOLUMES,
               adaquant_steps: int = ADAQUANT_STEPS):
    """Serve ``n_volumes`` synthetic volumes through ``Model`` with the
    settings of ``examples/UNetSPDO/FlapRecSP2O_serve_int8.ini`` (int8,
    AdaQuant) but whole volumes (``fg_crop`` off, ``serve_scan`` 1). Checks
    the files, the int8 launch counts, the masks against the same int8
    engine on the plain versions (identical), and against the plain f32
    model (Dice floors). Returns ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, default_params, engine, engine_q,
                                  load_params)
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels

    failures = []
    data, paths, csv, atlas, affine = write_volumes(work, shape, n_volumes)
    params = load_params(INT8_INI, default_params())
    params.update(
        name="chip_smoke_int8", fg_crop=False, serve_scan=1,
        workspace_path=os.path.join(work, "ws"), test_files_csv=csv,
        resume_model=UNETSP_10K, int8_adaquant_steps=adaquant_steps)
    if device.type != "cuda":
        params["device"] = device.type
    want = {"conv3d_q_requant": 12 * n_volumes, "maxpool2_q": 4 * n_volumes,
            "upconv_q_requant": 4 * n_volumes}
    kernels.reset_launches()
    m = Model(params=params)  # ends with the masks fetched to the host
    counts = kernels.launches()
    launches = {k: v for k, v in counts.items() if k in want}
    log(f"  launches over {n_volumes} volumes: {counts} (int8 want {want}; "
        "the bf16 ones are the calibration forward)")
    if launches != want:
        failures.append(f"int8 launch counts {launches} != {want}")
    build_s = m.int8_build_seconds
    stats = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                 build_s=build_s, adaquant_steps=adaquant_steps,
                 vol_per_s=m.n_served / m.serve_seconds,
                 vol_per_s_after_build=m.n_served / (m.serve_seconds
                                                     - build_s))
    log(f"  Model test loop: {m.n_served} volumes in {m.serve_seconds:.3f} s"
        f" = {stats['vol_per_s']:.3f} volumes/s, of which the int8 build "
        f"(calibration + AdaQuant, {adaquant_steps} steps) {build_s:.3f} s; "
        f"without the build {stats['vol_per_s_after_build']:.3f} volumes/s")
    masks = read_masks(os.path.join(data, "pred_chip_smoke_int8"), paths,
                       shape, affine, failures)

    qfn = m.int8_engines.get(shape + (2,))
    if qfn is None:
        failures.append(f"no int8 engine was built: {m.int8_engines}")
        return launches, stats, failures
    sd = load_any(UNETSP_10K)
    x = np.stack([nifti_data(paths[0]), atlas], -1)
    xt = torch.from_numpy(x[None]).to(device, torch.bfloat16)
    plain_q = engine_q.build_predict_q(
        "UNetSP", sd, xt[0], device=device, plain=True,
        import_scales=qfn.scales, round_opt=qfn.round_opt)
    k_pred = engine.build_predict("UNetSP", sd, device=device)
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        outs = {"int8": qfn(xt), "bf16": k_pred(xt),
                "f32": model(xt.float())}
        t0 = time.perf_counter()
        outs["int8_plain"] = plain_q(xt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["plain_engine_ms"] = 1e3 * (time.perf_counter() - t0)
    base = os.path.basename(paths[0]).replace(".nii.gz", "")
    floors = {"sk": 0.98, "fl": 0.95}
    for i, sfx in enumerate(("sk", "fl")):
        prob = {k: v[i][0].float() for k, v in outs.items()}
        mask = {k: torch.argmax(v, -1).to(torch.uint8).cpu().numpy()
                for k, v in prob.items()}
        if not bool(torch.isfinite(prob["int8"]).all()) or tuple(
                prob["int8"].shape) != shape + (2,):
            failures.append(f"int8 {sfx}: non-finite or shape "
                            f"{tuple(prob['int8'].shape)}")
        got = masks.get((base, sfx))
        if got is None or not np.array_equal(got, mask["int8"]):
            failures.append(f"int8 {sfx}: Model's file differs from the "
                            "engine")
        same = np.array_equal(mask["int8"], mask["int8_plain"])
        perr = float((prob["int8"] - prob["int8_plain"]).abs().max())
        d = dict(f32=dice(mask["int8"], mask["f32"]),
                 bf16=dice(mask["int8"], mask["bf16"]),
                 bf16_f32=dice(mask["bf16"], mask["f32"]))
        log(f"  int8 {sfx}: {int(mask['f32'].sum())} fg voxels (f32 model);"
            f" masks identical to the plain-version int8 engine: {same} "
            f"(max |p - p_plain| {perr:.3e}); Dice vs the f32 model "
            f"{d['f32']:.6f} (floor {floors[sfx]}), vs the bf16 kernel "
            f"engine {d['bf16']:.6f}; bf16 engine vs f32 {d['bf16_f32']:.6f}")
        stats.update({f"dice_{sfx}_int8_{k}": v for k, v in d.items()})
        stats[f"{sfx}_identical_to_plain"] = same
        if not same:
            failures.append(f"int8 {sfx}: masks differ from the plain-version "
                            "int8 engine")
        if not d["f32"] >= floors[sfx]:
            failures.append(f"int8 {sfx}: Dice vs the f32 model {d['f32']} < "
                            f"{floors[sfx]}")
    stats["engine_ms"] = time_ms(lambda: qfn(xt), 3, device)
    log(f"  int8 engine on the card: kernels {stats['engine_ms']:.2f} "
        f"ms/volume, plain versions {stats['plain_engine_ms']:.2f} ms (one "
        "run)")
    stats["busy_share"] = (stats["engine_ms"] * m.n_served
                           / (1e3 * (m.serve_seconds - build_s)))
    log(f"  device busy share of the Model loop without the build (engine "
        f"ms x volumes / loop time): {stats['busy_share']:.3f}")
    secs, errs = check_adaquant_repro(sd, xt[0], device)
    stats["adaquant_repro_s"] = secs
    failures += errs
    return launches, stats, failures


def nifti_data(path: str):
    import numpy as np

    from ctunet_tpu_torch.utils import nifti

    return nifti.read(path).data.astype(np.float32)


def serve(device, work: str, shape=SHAPE, n_volumes: int = N_VOLUMES):
    """Serve ``n_volumes`` synthetic volumes through ``Model``; check the
    files, the launch counts and the masks against the plain engine.
    Returns ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, engine
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels

    failures = []
    data, paths, csv, atlas, affine = write_volumes(work, shape, n_volumes)
    params = dict(
        test_flag=True, name="chip_smoke", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut",
        device=device.type, workspace_path=os.path.join(work, "ws"),
        test_files_csv=csv, resume_model=UNETSP_10K, n_workers=2,
        prefetch_depth=2,
    )
    kernels.reset_launches()
    m = Model(params=params)  # ends with the masks fetched to the host
    want = {"conv3d_bn_relu": 12 * n_volumes, "maxpool2": 4 * n_volumes,
            "upconv_bn_relu": 4 * n_volumes, "conv3d_tc": 12 * n_volumes,
            "upconv_tc": 4 * n_volumes}
    launches = {k: v for k, v in kernels.launches().items() if k in want}
    log(f"  launches over {n_volumes} volumes: {launches} (want {want})")
    if launches != want:
        failures.append(f"launch counts {launches} != {want}")
    stats = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                 vol_per_s=m.n_served / m.serve_seconds,
                 ms_per_vol=1e3 * m.serve_seconds / m.n_served)
    log(f"  Model test loop: {m.n_served} volumes in {m.serve_seconds:.3f} s "
        f"= {stats['vol_per_s']:.3f} volumes/s, {stats['ms_per_vol']:.1f} "
        "ms/volume (decode, upload, engine, argmax, fetch, NIfTI writes)")

    masks = read_masks(os.path.join(data, "pred_chip_smoke"), paths, shape,
                       affine, failures)

    # references on the card, on the first volume: the same engine with the
    # plain versions (bf16, same roundings) and the plain f32 model
    sd = load_any(UNETSP_10K)
    x = np.stack([nifti_data(paths[0]), atlas], -1)
    xt = torch.from_numpy(x[None]).to(device)
    k_pred = engine.build_predict("UNetSP", sd, device=device)
    p_pred = engine.build_predict("UNetSP", sd, device=device, plain=True)
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        outs = {"kernel": k_pred(xt), "plain": p_pred(xt), "f32": model(xt)}
    base = os.path.basename(paths[0]).replace(".nii.gz", "")
    for i, sfx in enumerate(("sk", "fl")):
        prob = {k: v[i][0].float() for k, v in outs.items()}
        mask = {k: torch.argmax(v, -1).to(torch.uint8).cpu().numpy()
                for k, v in prob.items()}
        if not bool(torch.isfinite(prob["kernel"]).all()) or tuple(
                prob["kernel"].shape) != shape + (2,):
            failures.append(f"{sfx}: non-finite or shape "
                            f"{tuple(prob['kernel'].shape)}")
        got = masks.get((base, sfx))
        if got is None or not np.array_equal(got, mask["kernel"]):
            failures.append(f"{sfx}: Model's file differs from the engine")
        # voxels both bf16 engines decide by more than DECIDED (4 bf16 ulps
        # at 0.5): nearer ties flip under 1-ulp rounding differences
        decided = torch.ones(shape, dtype=torch.bool, device=device)
        for k in ("kernel", "plain"):
            decided &= (prob[k][..., 1] - prob[k][..., 0]).abs() > DECIDED
        dec = decided.cpu().numpy()
        d = dict(
            raw=dice(mask["kernel"], mask["plain"]),
            decided=dice(mask["kernel"][dec], mask["plain"][dec]),
            kernel_f32=dice(mask["kernel"], mask["f32"]),
            plain_f32=dice(mask["plain"], mask["f32"]))
        perr = float((prob["kernel"] - prob["plain"]).abs().max())
        log(f"  {sfx}: {int(mask['plain'].sum())} fg voxels; Dice kernel vs "
            f"plain engine {d['raw']:.6f} (all voxels), {d['decided']:.6f} "
            f"(the {int(dec.sum())} decided, {int((~dec).sum())} near-ties "
            f"left out); vs the f32 model: kernel {d['kernel_f32']:.6f}, "
            f"plain bf16 {d['plain_f32']:.6f}; max |p_kernel - p_plain| "
            f"{perr:.3e}")
        stats.update({f"dice_{sfx}_{k}": v for k, v in d.items()})
        if mask["plain"].any() or sfx == "sk":
            if not d["decided"] >= 0.999:
                failures.append(f"{sfx}: Dice on decided voxels "
                                f"{d['decided']} < 0.999")
            if not d["kernel_f32"] >= d["plain_f32"] - 1e-3:
                failures.append(f"{sfx}: kernel engine further from the f32 "
                                f"model ({d['kernel_f32']}) than the plain "
                                f"bf16 engine ({d['plain_f32']})")
    stats["engine_ms"] = time_ms(lambda: k_pred(xt), 3, device)
    stats["plain_engine_ms"] = time_ms(lambda: p_pred(xt), 1, device)
    log(f"  engine on the card: kernels {stats['engine_ms']:.2f} ms/volume, "
        f"plain versions {stats['plain_engine_ms']:.2f} ms/volume")
    stats["busy_share"] = (stats["engine_ms"] * m.n_served
                           / (1e3 * m.serve_seconds))
    log(f"  device busy share of the Model loop (engine ms x volumes / loop "
        f"time): {stats['busy_share']:.3f}")
    profile_device(lambda: k_pred(xt), device)
    return launches, stats, failures


def train(device, work: str, shape=SHAPE, n_train: int = N_TRAIN,
          n_eval: int = N_EVAL, time_steps: int = 3):
    """Train UNetSP through ``Model`` with ``conv_impl = "chain"`` at the
    settings of ``examples/UNetSPDO/FlapRecSP2O.ini`` on complete synthetic
    skulls, evaluate, save, and serve one volume from the trained weights;
    then hold one train step against the plain versions and time the step.
    Returns ``(launches, stats, failures)``."""
    import copy

    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, checkpoint, default_params,
                                  load_params, steps)
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut

    failures = []
    data, paths, csv, atlas, affine = write_volumes(work, shape, 1)
    train_csv = make_dataset(os.path.join(work, "train"), n=n_train,
                             shape=shape, seed=40)
    val_csv = make_dataset(os.path.join(work, "val"), n=n_eval, shape=shape,
                           seed=80)
    params = load_params(TRAIN_INI, default_params())
    # the INI's settings but: one epoch, no per-epoch autosave + test (the
    # final save and test run once), whole synthetic volumes
    params.update(
        name="chip_smoke_train", conv_impl="chain", n_epochs=1,
        autosave_epochs=0, workspace_path=os.path.join(work, "ws"),
        train_files_csv=train_csv, validation_files_csv=val_csv,
        test_files_csv=csv, resume_model="", log_every=1)
    if device.type != "cuda":
        params["device"] = device.type
    kernels.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    m = Model(params=params)  # train, eval, save, then test one volume
    sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    k6 = n_train * K6_PER_TRAIN_STEP + n_eval * K6_PER_EVAL_STEP
    want = {"conv3d_bias_act": k6, "conv3d_bn_relu": 12, "maxpool2": 4,
            "upconv_bn_relu": 4, "conv3d_tc": k6 + 12, "upconv_tc": 4}
    launches = {k: counts[k] for k in want}
    log(f"  launches: {launches} (want {want}: {n_train} train steps x "
        f"{K6_PER_TRAIN_STEP} + {n_eval} eval steps x {K6_PER_EVAL_STEP} of "
        "K6, then one served volume; each bf16 K6/K1 launch is a "
        "conv3d_tc launch, each K3 launch an upconv_tc launch)")
    if launches != want:
        failures.append(f"training launch counts {launches} != {want}")
    losses = [float(v) for v in m.step_losses]
    hist = {k: v[-1][1] for k, v in m.writer.history.items()}
    log(f"  train losses per step: {losses}; epoch scalars: "
        f"{json.dumps(hist)}")
    if len(losses) != n_train or not all(map(math.isfinite, losses)) or not \
            all(math.isfinite(v) for v in hist.values()):
        failures.append(f"training: losses not finite: {losses} {hist}")
    elif not losses[-1] < losses[0]:
        failures.append(f"training: loss {losses[-1]} after {n_train} steps "
                        f"is not below the first {losses[0]}")
    stats = dict(train_steps=n_train, eval_steps=n_eval,
                 train_loop_s=m.train_seconds, model_wall_s=wall,
                 first_loss=losses[0] if losses else None,
                 last_loss=losses[-1] if losses else None)
    if device.type == "cuda":
        stats["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
        log(f"  peak device memory over Model's train + test: "
            f"{stats['peak_mem_gb']:.2f} GiB")

    # the checkpoint reloads to the tensors just trained; the masks exist
    saved = checkpoint.restore_checkpoint(m.params["model_path"])
    live = m.state.model.state_dict()
    bad = [k for k in live if not torch.equal(saved["model"][k],
                                              live[k].cpu())]
    if bad or set(saved["model"]) != set(live) or saved["step"] != n_train:
        failures.append(f"checkpoint differs from the trained state: {bad}, "
                        f"step {saved['step']}")
    log(f"  checkpoint {os.path.basename(m.params['model_path'])}: "
        f"{len(live)} tensors reload equal, step {saved['step']}, optimizer "
        f"count {saved['optimizer']['param_groups'][0]['count']}")
    read_masks(os.path.join(data, "pred_chip_smoke_train"), paths, shape,
               affine, failures)

    # one train step on the kernels against the same step on the plain
    # versions: same initial weights, volume and synthesis draws
    handler = FlapRecWithShapePriorDoubleOut()
    loss_cfg = {k: params.get(k) for k in ("ce_lambda", "dice_lambda")}
    vol = torch.from_numpy(nifti_data(
        os.path.join(work, "train", "skull_000.nii.gz"))[None]).to(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        base = build_model("UNetSP").to(device)

    def one_step(impl, n=1):
        model = copy.deepcopy(base).configure(impl, torch.bfloat16)
        state = steps.TrainState(model, steps.make_optimizer(
            params, model.parameters()))
        step = steps.make_train_step(model, handler, loss_cfg, atlas=atlas,
                                     compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=device).manual_seed(5)
        out = []
        for _ in range(n):
            sync(device)
            t = time.perf_counter()
            _, terms = step(state, {"image": vol}, gen)
            sync(device)
            out.append((1e3 * (time.perf_counter() - t),
                        float(terms["epoch_loss"])))
        return model, state, step, gen, out

    kernels.reset_launches()
    mk, state_k, step_k, gen_k, out_k = one_step("chain")
    per_train = kernels.launches()["conv3d_bias_act"]
    ev = steps.make_eval_step(mk, handler, loss_cfg, atlas=atlas,
                              compute_dtype=torch.bfloat16)
    kernels.reset_launches()
    ev(state_k, {"image": vol}, gen_k)
    per_eval = kernels.launches()["conv3d_bias_act"]
    log(f"  K6 launches: {per_train} per train step (want "
        f"{K6_PER_TRAIN_STEP}), {per_eval} per eval step (want "
        f"{K6_PER_EVAL_STEP})")
    if (per_train, per_eval) != (K6_PER_TRAIN_STEP, K6_PER_EVAL_STEP):
        failures.append(f"K6 launches per step {per_train}/{per_eval}")
    mp, _, _, _, out_p = one_step("plain")
    loss_k, loss_p = out_k[0][1], out_p[0][1]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = 0.0
    init = base.state_dict()
    for name, buf in mk.state_dict().items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        # batch statistic = (running - 0.9 * initial) / 0.1
        bk = (buf - 0.9 * init[name]) / 0.1
        bp = (mp.state_dict()[name] - 0.9 * init[name]) / 0.1
        # bf16 activations: 2 bf16 ulps at the statistic's magnitude, and
        # as much again for what earlier layers' roundings move it
        tol = 4 * BF16_EPS * float(bp.abs().max().clamp_min(1e-3))
        err = float((bk - bp).abs().max())
        worst = max(worst, err / tol)
        if not err <= tol:
            failures.append(f"BN batch statistic {name}: {err} > {tol}")
    log(f"  step 1 kernels vs plain versions: loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (relative {rel:.2e}, limit 1e-2); BN batch "
        f"statistics worst error / tolerance {worst:.3f}")
    if not rel <= 1e-2:
        failures.append(f"step loss {loss_k} vs plain {loss_p}: {rel} > 1e-2")
    del mp

    # step time: chain (kernels) and xla (cuDNN), the first step left out
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(time_steps):
        sync(device)
        t = time.perf_counter()
        step_k(state_k, {"image": vol}, gen_k)
        sync(device)
        out_k.append((1e3 * (time.perf_counter() - t), 0.0))
    stats["chain_ms_per_step"] = float(np.mean([t for t, _ in out_k[1:]]))
    if device.type == "cuda":
        stats["step_peak_mem_gb"] = (
            torch.cuda.max_memory_allocated(device) / 2**30)
    prof = profile_device(lambda: step_k(state_k, {"image": vol}, gen_k),
                          device, rows=16, what="one chain train step")
    total = sum(ms for _, ms in prof.values())
    k6 = sum(ms for key, (_, ms) in prof.items() if "conv3d_tc" in key)
    stats["k6_share_of_device_time"] = k6 / total if total else None
    del mk, state_k, step_k
    _, _, _, _, out_x = one_step("xla", n=time_steps + 1)
    stats["xla_ms_per_step"] = float(np.mean([t for t, _ in out_x[1:]]))
    log(f"  ms/step at batch 1 (host clock around a synchronized step, first"
        f" step left out): chain {stats['chain_ms_per_step']:.1f}, xla "
        f"(cuDNN) {stats['xla_ms_per_step']:.1f}; K6 kernels "
        f"{k6:.1f} ms of {total:.1f} ms device time in the profiled step; "
        f"peak memory of a chain step "
        f"{stats.get('step_peak_mem_gb', float('nan')):.2f} GiB; xla losses "
        f"{[round(v, 6) for _, v in out_x]}")
    return launches, stats, failures


def legacy_weights(model_class: str, x, seed: int):
    """Seeded weights of a legacy model for serving checks: the reference's
    torch init from ``seed``; BatchNorm running statistics set to the batch
    statistics of one train-mode forward of the plain f32 model on ``x``
    ``(1, D, H, W, C)``; then ``last_conv``'s class-1 bias lowered by the
    median logit gap on ``x``, so that both classes hold voxels. Returns
    ``(state_dict on the CPU, the f32 model in eval mode on x's device,
    class-1 share of the f32 model's mask on x)``."""
    import torch

    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.models.unet import BatchNorm

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(model_class)
    model = model.to(x.device)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 1.0  # running statistics := this batch's
    with torch.no_grad():
        model.train()(x)
        for m in bns:
            m.momentum = 0.1
        gap = model.eval().forward_logits(x)[0].diff(dim=-1)[..., 0]
        model.last_conv.bias[1] -= gap.median()
        share = float((model(x)[0].argmax(-1) == 1).float().mean())
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return sd, model, share


def serve_legacy(device, work: str, shape=SHAPE, n_volumes: int = N_VOLUMES):
    """Serve the legacy family through ``Model`` with the AutoImplant 2020
    INIs' settings, test only: ``n_volumes`` synthetic broken skulls through
    ``UNet4_2IC`` (shape prior), then the first through ``recAE_v2_fixed``.
    Checks the ``_fl``/``_i`` files, the launch counts and the masks against
    the engine on the plain versions and against the plain f32 model.
    Returns ``(launches of the UNet4_2IC run, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, default_params, engine, load_params
    from ctunet_tpu_torch.ops import kernels

    failures = []
    data, paths, csv, atlas, affine = write_volumes(work, shape, n_volumes)
    csv1 = os.path.join(data, "first.csv")
    with open(csv1, "w") as f:
        f.write(f"image,mask\n{paths[0]},\n")
    vol0 = nifti_data(paths[0])
    stats, main_launches = {}, {}
    for mc, n, files in (("UNet4_2IC", n_volumes, csv),
                         ("recAE_v2_fixed", 1, csv1)):
        t0 = time.perf_counter()
        cin = 2 if mc == "UNet4_2IC" else 1
        xt = torch.from_numpy(np.stack([vol0, atlas][:cin], -1)[None]).to(
            device)
        sd, model, share = legacy_weights(mc, xt, seed=17)
        log(f"  {mc}: seeded weights, BN statistics from one train-mode "
            f"forward, class-1 share of the f32 mask {share:.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not 0.01 <= share <= 0.99:
            failures.append(f"{mc}: vacuous weights, class-1 share {share}")
        pt = os.path.join(work, f"{mc}.pt")
        torch.save(sd, pt)
        name = f"chip_smoke_{mc}"
        params = load_params(LEGACY_INIS[mc], default_params())
        params.update(train_flag=False, test_flag=True, name=name,
                      workspace_path=os.path.join(work, "ws"),
                      test_files_csv=files, resume_model=pt, n_workers=2)
        if device.type != "cuda":
            params["device"] = device.type
        kernels.reset_launches()
        m = Model(params=params)  # ends with the masks fetched to the host
        counts = kernels.launches()
        want = {k: v * n for k, v in LEGACY_PER_VOLUME.items()}
        got = {k: counts[k] for k in want}
        log(f"  {mc} launches over {n} volume(s): {got} (want {want})")
        if got != want:
            failures.append(f"{mc} launch counts {got} != {want}")
        if mc == "UNet4_2IC":
            main_launches = got
        st = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                  vol_per_s=m.n_served / m.serve_seconds)
        log(f"  {mc} Model test loop: {m.n_served} volume(s) in "
            f"{m.serve_seconds:.3f} s = {st['vol_per_s']:.3f} volumes/s")
        masks = read_masks(os.path.join(data, f"pred_{name}"), paths[:n],
                           shape, affine, failures, sfxs=("fl", "i"))

        # references on the card, on the first volume
        k_pred = engine.build_predict(mc, sd, device=device)
        p_pred = engine.build_predict(mc, sd, device=device, plain=True)
        with torch.inference_mode():
            prob = {"kernel": k_pred(xt)[0].float(),
                    "plain": p_pred(xt)[0].float(), "f32": model(xt)[0]}
        mask = {k: torch.argmax(v, -1).to(torch.uint8).cpu().numpy()
                for k, v in prob.items()}
        if not bool(torch.isfinite(prob["kernel"]).all()) or tuple(
                prob["kernel"].shape) != shape + (2,):
            failures.append(f"{mc}: non-finite or shape "
                            f"{tuple(prob['kernel'].shape)}")
        base = os.path.basename(paths[0]).replace(".nii.gz", "")
        got_file = masks.get((base, "fl"))
        if got_file is None or not np.array_equal(got_file, mask["kernel"]):
            failures.append(f"{mc}: Model's file differs from the engine")
        decided = torch.ones(shape, dtype=torch.bool, device=device)
        for k in ("kernel", "plain"):
            decided &= (prob[k][..., 1] - prob[k][..., 0]).abs() > DECIDED
        dec = decided.cpu().numpy()
        d = dict(raw=dice(mask["kernel"], mask["plain"]),
                 decided=dice(mask["kernel"][dec], mask["plain"][dec]),
                 kernel_f32=dice(mask["kernel"], mask["f32"]),
                 plain_f32=dice(mask["plain"], mask["f32"]))
        perr = float((prob["kernel"] - prob["plain"]).abs().max())
        log(f"  {mc} fl: {int(mask['f32'].sum())} class-1 voxels (f32 "
            f"model); Dice kernel vs plain engine {d['raw']:.6f} (all), "
            f"{d['decided']:.6f} (the {int(dec.sum())} decided, "
            f"{int((~dec).sum())} near-ties left out); vs the f32 model: "
            f"kernel {d['kernel_f32']:.6f}, plain bf16 {d['plain_f32']:.6f};"
            f" max |p_kernel - p_plain| {perr:.3e}")
        st.update({f"dice_{k}": v for k, v in d.items()})
        if not d["decided"] >= 0.999:
            failures.append(f"{mc}: Dice on decided voxels {d['decided']} "
                            "< 0.999")
        if not d["kernel_f32"] >= d["plain_f32"] - 1e-3:
            failures.append(f"{mc}: kernel engine further from the f32 "
                            f"model ({d['kernel_f32']}) than the plain bf16 "
                            f"engine ({d['plain_f32']})")
        st["engine_ms"] = time_ms(lambda: k_pred(xt), 3, device)
        st["plain_engine_ms"] = time_ms(lambda: p_pred(xt), 1, device)
        log(f"  {mc} engine on the card: kernels {st['engine_ms']:.2f} "
            f"ms/volume, plain versions {st['plain_engine_ms']:.2f} ms/volume")
        if mc == "UNet4_2IC":
            st["busy_share"] = (st["engine_ms"] * m.n_served
                                / (1e3 * m.serve_seconds))
            log(f"  device busy share of the Model loop (engine ms x volumes"
                f" / loop time): {st['busy_share']:.3f}")
        prof = profile_device(lambda: k_pred(xt), device, rows=8,
                              what=f"one {mc} volume")
        if not any("conv3d_tc" in key for key in prof):
            log("  (the profile holds no K5 launch: the breakdown below is "
                "taken with CUDA events)")
        st["breakdown_ms"] = launch_breakdown(mc, sd, xt, device)
        stats[mc] = st
        del model, k_pred, p_pred, prob
        log(f"  {mc}: {time.perf_counter() - t0:.1f} s")
    return main_launches, stats, failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
        from ctunet_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the ctunet_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    failures = []
    t_all = time.perf_counter()

    log("== phase 1: card and build")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    times = build.build()
    log(f"  nvcc: {', '.join(f'{k} {v:.1f} s' for k, v in times.items())}; "
        f"all built in {time.perf_counter() - t0:.1f} s (parallel)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"  ptxas {name}: {line.strip()}")

    sd = load_any(UNETSP_10K)
    log("== phase 2: kernels vs plain versions (trained layer weights, "
        "TF32 off)")
    t0 = time.perf_counter()
    entries = {}
    for label, check in (
            ("bf16 inputs", lambda: check_kernels(sd, device)),
            ("int8 inputs, exact", lambda: check_kernels_q(sd, device)),
            ("bf16 conv3d_tc (K1, K6, K5) at every shape of the paths, "
             "random weights", lambda: check_conv_tc(device)),
            ("training conv K6 f32 and autograd, random weights",
             lambda: check_kernel_train(device)),
            ("bf16 upconv_tc (K3, K7a, K7b) at every shape of the paths",
             lambda: check_upconv_tc(sd, device))):
        log(f"  -- {label}")
        try:
            got, errs = check()
            entries.update(got)
            failures += errs
        except Exception:  # noqa: BLE001  report, then fail the run below
            traceback.print_exc()
            failures.append(f"phase 2 ({label}) raised")
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    launches, shared = {}, {"conv3d_tc": 0, "upconv_tc": 0}
    size = "x".join(map(str, SHAPE))
    for phase, label, fn in (
            (3, f"bf16, {N_VOLUMES} UNetSP volumes {size}", serve),
            (4, f"int8 + AdaQuant ({ADAQUANT_STEPS} steps), {N_VOLUMES} "
                f"UNetSP volumes {size}", serve_int8),
            (5, f"training, UNetSP {size} bf16 conv_impl=chain, {N_TRAIN} "
                f"train + {N_EVAL} eval steps, save, serve 1 volume", train),
            (6, f"legacy k=5 serving, {N_VOLUMES} UNet4_2IC volumes {size} "
                "+ 1 recAE_v2_fixed volume", serve_legacy)):
        log(f"== phase {phase}: main path, {label}, through Model")
        t0 = time.perf_counter()
        got = {}
        try:
            with tempfile.TemporaryDirectory(prefix=".smoke_",
                                             dir=ROOT) as work:
                got, stats, errs = fn(device, work)
            failures += errs
            log("  stats: " + json.dumps(stats))
        except Exception:  # noqa: BLE001  report, then fail the run below
            traceback.print_exc()
            failures.append(f"phase {phase} raised")
        log(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")
        if not got or min(got.values()) == 0:
            failures.append(f"phase {phase}: a kernel of the path was never "
                            f"launched: {got}")
        # a later phase's count of an earlier kernel (phase 5 serves one
        # volume on K1-K3) does not replace the phase that owns it; the
        # bf16 convs of phases 3, 5 and 6 all launch conv3d_tc, their K3,
        # K7a and K7b upconv_tc
        for k in shared:
            shared[k] += got.pop(k, 0)
        launches.update({k: v for k, v in got.items() if k not in launches})
    launches.update(shared)

    log(f"== total {time.perf_counter() - t_all:.1f} s")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1

    sources = {
        "conv3d_tc": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                      "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "conv3d_bn_relu": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                           "ctunet_tpu/ops/pallas/conv3d.py:1031"),
        "maxpool2": ("ctunet_tpu_torch/csrc/maxpool.cu",
                     "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_tc": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                      "ctunet_tpu/ops/pallas/convt.py:146"),
        "upconv_bn_relu": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                           "ctunet_tpu/ops/pallas/upconv.py:464"),
        "conv3d_q_requant": ("ctunet_tpu_torch/csrc/conv3d_q.cu",
                             "ctunet_tpu/ops/pallas/conv3d.py:1677"),
        "maxpool2_q": ("ctunet_tpu_torch/csrc/maxpool.cu",
                       "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_q_requant": ("ctunet_tpu_torch/csrc/upconv_q.cu",
                             "ctunet_tpu/ops/pallas/upconv.py:1015"),
        "conv3d_bias_act": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                            "ctunet_tpu/ops/pallas/conv3d.py:453"),
        "conv3d5_bias_act": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                             "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "convt_k2s2": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                       "ctunet_tpu/ops/pallas/convt.py:78"),
        "convt_k2s2_dual": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                            "ctunet_tpu/ops/pallas/convt.py:146"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        e = entries[name]
        kernels.append(dict(
            name=f"{name} [{e['case']}]", route="cuda", source=src,
            replaces=repl, launches=launches.get(name, 0),
            max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=e["bound_by"],
            library_ms=e["library_ms"]))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
