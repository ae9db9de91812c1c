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
   kernels it replaced; ``maxpool2_rows``, the row-streaming pool behind
   K2 (bf16, f32) and K2q (int8), at all 20 K2/K2q launch shapes of the
   paths (``pool_shapes``), equal by value to the plain version and beside
   the direct kernel it replaced and under every plan of ``pool_plans``,
   with one NaN-seeded volume each in bf16 and f32; the int8 kernels K1q and K3q exactly (on layers quantized from a calibration on one
   synthetic volume): ``conv3d_tc_q`` and ``upconv_tc_q``, the int8
   tensor-core kernels behind K1q and K3q, at every K1q and K3q shape of
   the int8 path in zp mode and one each in symmetric mode, beside the
   CUDA-core kernels they replaced and PyTorch's refusal of int8
   convolutions; K6's f32 route (``conv3d_tc_f32``, the f32
   tensor-core conv) at every K6 shape of the f32 training run, forward
   and as input gradient, beside the direct CUDA-core kernel it replaced,
   and the autograd function's ``dx``/``dw`` against autograd through the
   plain version; ``conv3d_tc`` at the 16 K5 shapes only legacy training
   launches (its input gradients, ``conv3d5_train``), and the k=5 autograd
   function's ``dx``/``dw`` at 28->7 full size against autograd through
   the plain version, with the 125-tap weight gradient's time beside
   cuDNN's;
   the f32 conv and upsampling kernels of the f32 paths (``conv3d_tc_f32``
   behind K1 and K5, also at the 16 K5 input-gradient shapes of f32 legacy
   training, ``upconv_tc_f32``, the f32 tensor-core stride-2 upsampling
   kernel, behind K3 (``upconv_f32``) and K7a/K7b (``convt_f32``)) within
   ``f32_tol`` at every f32 shape of the paths (``f32_shapes``), beside the
   direct CUDA-core kernels they replaced. Each with the kernel's time beside the
   plain version's, one PyTorch library call's where one exists (cuDNN,
   TF32 off), and the card's bound (f32 products at the 3xTF32 rate,
   ``F32_TC_FLOP_PER_S``). Then the kernels at the launch shapes of phase
   9's windows (:func:`check_windows`): K1q, K2q, K3q and the bf16 K1, K2,
   K3 of the int8 engine's calibration forward at the serving window, K6
   forward and input gradients at the fg-crop training window. Then every
   launch shape of phase 10 (:func:`check_512`, UNetSPSmall at
   224x512x512, 4-64 channels): K2 / K2q, the bf16 K1, K6 and K3, K1q and
   K3q, the f32 K1 and K3, the same way.
3. bf16 path: serves synthetic broken skulls (``spherical_shell`` with a
   hole punched; atlas ``spherical_shell(radius_frac=0.42)``) through the
   ``Model`` test path with the committed ``unetsp_10k`` weights, checks
   the written ``pred_<name>/*_{sk,fl,i}.nii.gz`` masks (shape, affine),
   the launch counts (12 K1, 4 K2, 4 K3 per volume; each K1 a
   ``conv3d_tc``, each K2 a ``maxpool2_rows`` and each K3 an ``upconv_tc``
   launch) and the masks against
   the engine run with the plain versions on the card (Dice >= 0.999 over
   the voxels both decide, see ``DECIDED``) and against the plain f32
   model (the kernel engine no further from it than the plain bf16 one).
4. int8 path: the same volumes through ``Model`` with the settings of
   ``examples/UNetSPDO/FlapRecSP2O_serve_int8.ini`` (calibrated int8 with
   AdaQuant, ``ADAQUANT_STEPS``) on whole volumes; checks the files, the
   int8 launch counts (12 K1q, 4 K2q, 4 K3q per volume; each K1q a
   ``conv3d_tc_q``, each K2q a ``maxpool2_rows`` and each K3q an
   ``upconv_tc_q`` launch), masks identical
   to the same int8 engine on the plain versions, and Dice against the plain
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
7. f32 serving: ``Model`` with ``compute_dtype = float32`` through every
   entry point that serves: phase 3's volumes through UNetSP, one
   ``UNet4_2IC`` and one ``recAE_v2_fixed`` volume from phase 6's seeded
   weights, one int8 volume with the first encoder block in f32
   (``int8_bf16_head = 1``, round to nearest), and an f32 training run
   (``conv_impl = chain``, ``N_TRAIN_F32`` train steps and one eval step
   at full size) that then serves one volume from its weights. Checks:
   every float launch on the f32 kernels (``conv3d_tc_f32`` launches equal
   to the f32 K1, K6 and K5 launches, ``upconv_tc_f32`` launches to the f32
   K3, K7a and K7b launches), ``conv3d_tc`` and ``upconv_tc`` at
   0 (the int8 engine's calibration forward, bf16 as in the JAX package,
   aside); the f32 engines' probabilities within atol 5e-4 /
   rtol 1e-3 of the plain f32 model over the whole volume and their masks
   equal to its masks wherever it decides by more than ``2 * F32_ATOL``;
   the int8 masks against the same engine on the plain versions (Dice >=
   0.999 over decided voxels); finite losses, the checkpoint and the
   files; each engine's ms per volume and loop's volumes/s beside phases 3
   and 6, the legacy f32 launches timed by CUDA events, the training
   run's peak memory and the ``conv3d_tc_f32`` weight packing one f32
   train step makes.
8. Legacy training: ``Model`` with the settings of both AutoImplant 2020
   INIs (adam, lr 1e-4, Dice + CE, batch 1, bf16) and ``conv_impl =
   "pallas"`` on complete synthetic skulls at 224x304x304, random weights
   from the seed, the INIs' synthesis on the card (``UNet4_2IC`` +
   ``FlapRecWithShapePrior``: ``cranioplasty_transform``;
   ``recAE_v2_fixed`` + ``FlapRec``: hole and noise): ``LEGACY_TRAIN``
   train steps (3 and 2) and 1 eval step each, the checkpoint saved, one
   volume served from it by the bf16 legacy engine. Checks: finite losses,
   K5 launches (35 per train step: 18 forward + 17 input gradients; 18 per
   eval step; each a ``conv3d_tc`` launch), the checkpoint reloading to
   the same tensors, the masks written, and one train step against the
   same step on the plain versions (loss within 1e-2 relative, BatchNorm
   batch statistics within 4 bf16 ulps). Then the step time on
   ``pallas`` and on ``xla`` (cuDNN), the weight gradients' time by CUDA
   events, a ``torch.profiler`` pass, the synthesis ms per volume and the
   peak memory.
9. Foreground-crop serving: ``Model`` with
   ``examples/UNetSPDO/FlapRecSP2O_serve_int8.ini`` as written (int8 +
   AdaQuant, ``b_fg_crop`` at margin 24, ``i_serve_scan = 4``) plus
   ``b_serve_profile`` on 8 synthetic broken skulls (:data:`FG_SKULLS`,
   an atlas registered to them), whose windows, K-batches (3 and 4) and
   single int8 build :func:`fg_expect` predicts and the phase asserts;
   12 K1q, 4 K2q and 4 K3q per volume on their kernels; the files equal
   to the same int8 engine on the plain versions and to per-volume
   dispatch at the same windows, pasted the loop's way; Dice against the
   plain f32 model on the whole volume (phase 4's floors, on the
   calibration volume and pooled); the profile, volumes/s and the engine
   ms at the window. Then fg-crop training (``FlapRecSP2O.ini``,
   ``conv_impl = chain``, ``b_fg_crop_train``): 2 train + 1 eval steps,
   finite losses, ``fg_lost_voxels`` 0, K6 31 / 16 a step, the
   checkpoint, and ms per step at the window.
10. The 5-block family: ``examples/UNetSPDO/FlapRecSP2O_512.ini``
   (UNetSPSmall, the committed ``unetspsmall_3k`` weights) through
   ``Model`` at 224x512x512 on synthetic broken skulls with a registered
   atlas: bf16 whole volumes as written (15 K1, 5 K2, 5 K3 a volume; the
   masks against the plain-version engine and the plain f32 model), f32
   (within atol 5e-4 / rtol 1e-3 of the plain f32 model, TF32 off), int8
   PTQ (equal to the same engine on the plain versions; Dice against the
   f32 model printed), ``b_patch_inference`` (147 patches of 128^3 at
   overlap 0.5, the blend against the same window over the plain-version
   engine, ms per volume beside whole-volume serving), then ``conv_impl =
   chain`` training (39 K6 a train step, 20 an eval step, asserted; ms per
   step beside ``xla``, peak memory) and one volume served from the
   trained weights. Where the 3k model draws no flap on these skulls the
   phase says so and holds the flap's probabilities instead of its Dice.
11. The port's last single-device features, UNetSP at 224x304x304 on
   ``unetsp_10k`` with a registered atlas (:func:`pickled_ops_qat`): the
   weights saved as pickled ``nn.Module`` trees whose classes claim
   ``ctunet.pytorch.models`` (zip format, and inside ``nn.DataParallel``
   in torch's legacy format) and served through ``Model`` by the bf16
   engine (12 K1, 4 K2, 4 K3 each), the masks bit-equal to the
   ``.npz``-served ones; ``hu_window`` -> ``resample_to_spacing`` ->
   ``pad_to_multiple(16)`` of a synthetic 180x512x512 CT at (1.25, 0.6,
   0.6) mm on the card against the same functions on the CPU (atol
   ``PRE_ATOL``, ms printed) and ``largest_cc_device`` on a served mask
   equal to the host ``largest_cc``; ``Model.train`` with ``param_dtype =
   bfloat16``, ``conv_impl = chain`` and ``profile_dir`` for 2 epochs of 1
   train + 1 eval step (31 K6 a train step; parameters and moments bf16,
   BatchNorm's f32; one trace, of epoch 1; the checkpoint served), its ms
   a step beside phase 5's; ``tools/qat_tune_torch.py``'s distillation
   (``QAT_STEPS`` at 64x128x128 and ``QAT_LR``; its collapse guard must
   pass) and the tuned checkpoint
   served through ``Model`` in int8 without AdaQuant (12 K1q, 4 K2q, 4
   K3q), the masks equal to the same engine on the plain versions,
   the int8-vs-f32 Dice before and after QAT printed (not gated).
12. Several ranks (:func:`multi_device`): ``N_RANKS`` processes started
   by ``parallel.spawn``, all on the one card over gloo. UNetSP from
   ``unetsp_10k`` serves one 224x304x304 volume depth-sharded (two slabs
   of 112 planes, 12 K1, 4 K2, 4 K3 and 16 halo exchanges a rank) in bf16
   (phase 3's gates against the single-rank engine and the plain f32
   model, and every probability within one bf16 ulp of the single-rank
   engine's) and f32 (phase 7's against the plain f32
   model); 2 volumes data-parallel in bf16 and int8 (the same calibration
   volume), each identical to the single-rank engine; and ``Model``
   trains data-parallel (``b_distributed``, ``i_mesh_data = 2``, batch 2,
   ``chain``, 2 + 1 steps, 31 K6 a train step a rank): step 1's loss and
   BatchNorm statistics against the one-process batch-2 run (phase 5's
   gates), the parameters bit-equal across the ranks, rank 0's checkpoint
   and events only; a rank's synthesis draws on the card (the Philox jump)
   equal to one process's. Its times are of ranks sharing one card; a
   rank's train step is split into its all-reduces and its synthesis.
13. The profiler, the ``UNet`` options and the tools
   (:func:`surface_tools`): a ``utils/profiling.trace`` window over one
   bf16 UNetSP engine pass lists its 12 ``conv3d_tc``, 4 ``maxpool2_rows``
   and 4 ``upconv_tc`` launches by kernel name, each inside its wrapper's
   spans, with at least ``P13_COVERAGE`` of the same launches' own device
   time (``device_ms``), and over one ``chain`` train step the 31 K6
   launches, each trace with no launch whose kernel record it lost
   (``profiling.attribute``'s count; phase 11 checks its ``profile_dir``
   trace file the same way); the generic ``UNet`` with ``residual``, ``cat=False`` and no
   skips at 224x304x304 and with ``fc_layer`` at ``P13_FC_SHAPE``, one
   bf16 ``chain`` step each against the plain versions (phase 5's gates,
   31 K6); ``tools/adaquant_run_torch.py`` (``P13_ADAQUANT_STEPS`` at
   ``P13_TOOL_SHAPE``: the optimised rounding's agreement no more than
   0.002 below round-to-nearest's, K1q, K2q and K3q launched),
   ``quant_sim_eval_torch.py`` (``rtn``), ``int8_sensitivity_torch.py``,
   ``attr_int8_torch.py`` (one pass, 12/4/4 int8 launches attributed) and
   ``attr_train_torch.py`` (one ``chain`` step, 31 K6 attributed, none
   lost), each through its command line and its one JSON line. Every
   profile of the earlier phases (``profile_device``) prints the
   hand-written kernels' share of the device time and the launches the
   trace lost.

The last two lines of output are one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result. Needs a CUDA card and the repo beside this file; it
imports nothing of JAX and nothing of ``ctunet_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
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
UNETSP_WIDTHS = (7, 14, 28, 56)  # UNetSP's encoder widths (i_size 7)
# phase 10: examples/UNetSPDO/FlapRecSP2O_512.ini, UNetSPSmall (5 blocks,
# i_size 4) on its 224x512x512 canvas
INI_512 = os.path.join(ROOT, "examples", "UNetSPDO", "FlapRecSP2O_512.ini")
SHAPE_512 = (224, 512, 512)
SMALL_WIDTHS = (4, 8, 16, 32, 64)
# phase 10's rows of the kernel line: keys ``name + AT_512``, apart from the
# UNetSP canvas's rows of the same kernels
AT_512 = "@512"
# each kernel function's row in phase 10 takes the shape of a wrapper that
# launches it
KERNEL_OF = {"conv3d_tc": "conv3d_bn_relu", "upconv_tc": "upconv_bn_relu",
             "maxpool2_rows": "maxpool2", "conv3d_tc_q": "conv3d_q_requant",
             "upconv_tc_q": "upconv_q_requant",
             "conv3d_tc_f32": "conv3d_bn_relu_f32",
             "upconv_tc_f32": "upconv_bn_relu_f32"}
N_512 = 2  # volumes served whole in bf16 (f32, int8, patches: the first)
SEED_512 = 1000  # the caps' seeds: SEED_512 + volume index
N_TRAIN_512 = 2  # train steps of phase 10's training run (1 eval step)
# K6 launches per step of UNetSPSmall's 20 convs: every forward, every
# input gradient but the network input's
K6_PER_TRAIN_STEP_5, K6_PER_EVAL_STEP_5 = 20 + 19, 20
N_VOLUMES = 3
# the int8 serving settings (AdaQuant at the INI's default 250 steps)
INT8_INI = os.path.join(ROOT, "examples", "UNetSPDO",
                        "FlapRecSP2O_serve_int8.ini")
ADAQUANT_STEPS = 250
# steps of each of the two rounding searches that phase 4 holds bit-equal
# (10 until phase 8 joined the script; 5 keep its time near 690 s)
REPRO_STEPS = 5
TRAIN_INI = os.path.join(ROOT, "examples", "UNetSPDO", "FlapRecSP2O.ini")
LEGACY_INIS = {  # AutoImplant 2020: with and without the shape prior
    "UNet4_2IC": os.path.join(ROOT, "examples", "autoimplant2020", "UNetSP",
                              "AutoImplant2020_wShapePrior.ini"),
    "recAE_v2_fixed": os.path.join(ROOT, "examples", "autoimplant2020",
                                   "UNet", "AutoImplant2020_woShapePrior.ini"),
}
# kernel launches per volume of the legacy engine
LEGACY_PER_VOLUME = {"conv3d5_bias_act": 18, "maxpool2": 4, "convt_k2s2": 1,
                     "convt_k2s2_dual": 3, "conv3d_tc": 18, "upconv_tc": 4,
                     "maxpool2_rows": 4}
N_TRAIN, N_EVAL = 4, 2  # steps of the training phase (batch 1)
# train steps of each legacy model in phase 8 (1 eval step each)
LEGACY_TRAIN = (("UNet4_2IC", 3), ("recAE_v2_fixed", 2))
# K5 launches per legacy step under conv_impl = "pallas": 18 forward and 17
# input gradients (the network input needs none) a train step, 18 an eval
# step; each one a conv3d_tc launch in bf16
K5_PER_TRAIN_STEP, K5_PER_EVAL_STEP = 18 + 17, 18
N_TRAIN_F32 = 2  # train steps of phase 7's f32 training run (1 eval step)
# phase 9's skulls: (radius as a share of the shortest side, centre). Every
# margin-24 plan shrinks H and W, the offsets differ, and volumes 4-7 plan
# inside the window of 0-3: one warm-up dispatch, a K = 3 and a K = 4
# batch, one int8 build. Volumes 0-2 complete train fg-crop training.
FG_SKULLS = ((0.30, (112, 150, 156)), (0.29, (108, 158, 148)),
             (0.28, (116, 146, 160)), (0.30, (110, 154, 150)),
             (0.27, (114, 152, 154)), (0.26, (106, 146, 150)),
             (0.28, (112, 160, 156)), (0.25, (118, 150, 144)))
FG_SEED = 700  # the caps' seeds: FG_SEED + volume index
FG_TRAIN_STEPS = 2  # train steps of phase 9's fg-crop training (1 eval)
# f32 engine vs the plain f32 model: the JAX engine tests' tolerance
# (tests/test_engine.py: atol 5e-4, rtol 1e-3)
F32_ATOL, F32_RTOL = 5e-4, 1e-3
# K6 launches per step of the 16-conv UNetSP: every conv forward, and every
# input gradient but the network input's
K6_PER_TRAIN_STEP, K6_PER_EVAL_STEP = 16 + 15, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12     # H100 SXM dense int8 tensor cores, published
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
# f32-accurate products through 3xTF32: the dense TF32 rate (495 TFLOP/s)
# over the three tf32 products each f32 product takes
F32_TC_FLOP_PER_S = 495e12 / 3
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


def device_ms(fn, reps: int, device) -> float:
    """Device time of ``fn()`` per run, over ``reps`` runs queued behind a
    sleep kernel so that the host's time per call (tens of microseconds of
    Python for a small launch) leaves no gaps between them; the host clock
    off the card."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e6 + 2e5 * reps))  # ~0.1 ms a run at ~2 GHz
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


def pool_shapes():
    """Every K2 / K2q launch of the paths, ``{(dtype, c, level): {path:
    launches per volume}}`` (``c`` channels of the pooled input at
    ``level``): bf16 and f32 per UNetSP, ``UNet4_2IC`` and ``recAE_v2_fixed``
    volume, int8 per UNetSP volume of the int8 engine."""
    rows = {}
    for dt in ("bf16", "f32", "int8"):
        models = ((("UNetSP", 7),) if dt == "int8" else
                  (("UNetSP", 7), ("UNet4_2IC", 7), ("recAE_v2_fixed", 8)))
        for mc, i_size in models:
            for lv in range(4):
                rows.setdefault((dt, i_size << lv, lv), {})[mc] = 1
    return rows


def check_pool(device, shape=SHAPE, reps_big: int = 20,
               reps_small: int = 100, rows=None, extras: bool = True):
    """K2 and K2q, the row-streaming pool ``maxpool2_rows``, against their
    plain versions at every launch shape of :func:`pool_shapes`, through the
    wrapper each path calls (``maxpool2`` in bf16 and f32, ``maxpool2_q`` in
    int8): equal by value, each call counted once on its wrapper (f32 also
    on ``maxpool2_f32``) and on ``maxpool2_rows``. Beside each: the direct
    kernel it replaced (``*_direct``, ``csrc/maxpool.cu``, same inputs, same
    call; it counts nothing and must agree too), the plain version, the
    library call (``F.max_pool3d`` in bf16 and f32; in int8, which
    ``F.max_pool3d`` refuses on the card, ``amax`` over the window axes of
    a view), all timed on the device (:func:`device_ms`: the small
    launches take less than the host's time per call), and the bound (the
    input read once and an eighth of it written at the HBM rate; the 7
    comparisons per output at ``F32_FLOP_PER_S``). Each shape's ``PLANS``
    line times the kernel under every plan of ``pool_plans`` (ring depth x
    grid), the one ``pool_plan`` picks marked. Then small odd volumes in
    each dtype that take the scalar path and the vector path with an odd W,
    and one NaN-seeded full-resolution volume each in bf16 and f32, whose
    NaN positions and other values must equal the plain version's. Random
    normal (float) or uniform (int8) inputs from a seed. Logs one ``POOL``
    line per shape and each path's sums (time x launches). Returns
    ``(entries, failures)``:
    ``maxpool2``, ``maxpool2_f32`` and ``maxpool2_q`` at their first shape,
    ``maxpool2_rows`` at its largest launch (f32, 8 channels at full
    resolution). ``rows`` (default all of :func:`pool_shapes`) and
    ``extras`` (the small odd volumes and the NaN-seeded ones) narrow the
    check to other launches, such as a crop window's."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(2)
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    kinds = {  # dtype, wrapper, its f32 counter, direct, plain, entry
        "bf16": (torch.bfloat16, "maxpool2", None, kc.maxpool2_direct,
                 kc.maxpool2_plain, "maxpool2"),
        "f32": (torch.float32, "maxpool2", "maxpool2_f32",
                kc.maxpool2_f32_direct, kc.maxpool2_plain, "maxpool2_f32"),
        "int8": (torch.int8, "maxpool2_q", None, kc.maxpool2_q_direct,
                 kc.maxpool2_q_plain, "maxpool2_q"),
    }
    entries, failures, sums = {}, [], {}

    def library(x, reps):
        """The one PyTorch call of the pool, timed: ``F.max_pool3d`` on the
        channels-last volume; in int8 ``amax`` over the window axes of a
        view (every path shape is even)."""
        if x.dtype == torch.int8:
            d_, h_, w_ = (n // 2 for n in x.shape[:3])
            x_v = x.view(d_, 2, h_, 2, w_, 2, x.shape[3])
            return device_ms(lambda: x_v.amax((1, 3, 5)), reps, device)
        x_l = x.permute(3, 0, 1, 2)[None]
        return device_ms(lambda: F.max_pool3d(x_l, 2), reps, device)

    for (dt, c, level), paths in (rows or pool_shapes()).items():
        dtype, wrapper, f32_counter, direct, plain, name = kinds[dt]
        run = getattr(kc, wrapper)
        shp = lv[level] + (c,)
        if dtype == torch.int8:
            x = torch.randint(-128, 128, shp, generator=gen, device=device,
                              dtype=torch.int8)
        else:
            x = torch.randn(shp, generator=gen, device=device).to(dtype)
        kernels.reset_launches()
        got = run(x)
        counts = kernels.launches()
        want = {wrapper: 1, "maxpool2_rows": 1}
        if f32_counter:
            want[f32_counter] = 1
        launched = {k: v for k, v in counts.items() if v} == want
        ref, ref_d = plain(x), direct(x)
        launched = launched and kernels.launches() == counts
        sync(device)
        ok = (launched and got.dtype == dtype and torch.equal(got, ref)
              and torch.equal(ref_d, ref))
        err = float((got.float() - ref.float()).abs().max())
        big = level < 2
        reps = reps_big if big else reps_small
        ms = device_ms(lambda: run(x), reps, device)
        d_ms = device_ms(lambda: direct(x), reps, device)
        p_ms = device_ms(lambda: plain(x), 3 if big else reps, device)
        l_ms = library(x, reps)
        nbytes = x.element_size() * (x.numel() + got.numel())
        b_ms, b_by = bound_ms(nbytes, 7 * got.numel(), F32_FLOP_PER_S)
        plan = kc.pool_plan(*shp, x.element_size())
        case = f"{dt} {c}ch {'x'.join(map(str, lv[level]))}"
        per = ", ".join(f"{n} {p}" for p, n in paths.items())
        lib = "amax" if dtype == torch.int8 else "F.max_pool3d"
        log(f"  POOL {name} [{case}]: {'equal' if ok else 'FAIL'} "
            f"(max_abs_err {err:.0f}); maxpool2_rows {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.2f} of the bound), "
            f"direct {d_ms:.4f} ms, plain {p_ms:.4f} ms, {lib} "
            f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); plan "
            f"stages={plan.stages} grid={plan.grid} out_vec={plan.out_vec}; "
            f"launches {per}")
        sweep = []
        for alt in kc.pool_plans(*shp, x.element_size()):
            t = device_ms(lambda: kc.maxpool2_rows(x, alt), reps, device)
            sweep.append(f"{alt.stages}x{alt.grid}"
                         f"{'*' if alt == plan else ''} {t:.4f}")
        log(f"    PLANS (stages x grid ms, * launched): {', '.join(sweep)}")
        if not ok:
            failures.append(f"maxpool2_rows [{case}] via {wrapper}: not equal "
                            f"to the plain version (err {err}), wrong dtype, "
                            f"or counts "
                            f"{ {k: v for k, v in counts.items() if v} } != "
                            f"{want}")
        for slower, t in (("the direct kernel", d_ms), (lib, l_ms)):
            if ms >= t:  # kept with its numbers (PERF.md)
                log(f"    SLOWER than {slower} at this shape")
        for p in paths:
            t = sums.setdefault((dt, p), [0.0, 0.0, 0.0, 0.0, 0])
            t[0] += paths[p] * ms
            t[1] += paths[p] * d_ms
            t[2] += paths[p] * l_ms
            t[3] += paths[p] * b_ms
            t[4] += paths[p]
        entry = dict(case=case, max_abs_err=err, ms=ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                     direct_ms=d_ms)
        entries.setdefault(name, entry)
        if (dt, c, level) == ("f32", 8, 0):
            entries["maxpool2_rows"] = entry
        del x, got, ref, ref_d
    for (dt, p), (t, t_d, t_l, t_b, n) in sums.items():
        log(f"  POOL sum {dt} {p}: {n} launches per volume, maxpool2_rows "
            f"{t:.4f} ms, direct {t_d:.4f} ms, library {t_l:.4f} ms, "
            f"bound {t_b:.4f} ms")
    if not extras:
        return entries, failures

    # no path shape takes the scalar path (rows of bytes not a multiple of
    # 16) or an odd W on the vector path: one small volume of each, per dtype
    # (17 x 16 values a row: 272 bytes in int8)
    for dt, (dtype, wrapper, _, _, plain, _) in kinds.items():
        for shp, vec in (((9, 11, 13, 7), False), ((5, 7, 17, 16), True)):
            if dtype == torch.int8:
                x = torch.randint(-128, 128, shp, generator=gen,
                                  device=device, dtype=dtype)
            else:
                x = torch.randn(shp, generator=gen, device=device).to(dtype)
            plan = kc.pool_plan(*shp, x.element_size())
            got, ref = getattr(kc, wrapper)(x), plain(x)
            ok = torch.equal(got, ref) and (plan.stages > 0) == vec
            log(f"  POOL {dt} {'x'.join(map(str, shp))} (stages "
                f"{plan.stages}, out_vec {plan.out_vec}): "
                f"{'equal' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"maxpool2_rows [{dt} {shp}]: not equal to "
                                "the plain version, or not on the "
                                f"{'vector' if vec else 'scalar'} path")

    # a NaN in a window gives NaN, as F.max_pool3d does
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(lv[0] + (7,), generator=gen, device=device).to(dtype)
        flat = x.view(-1)
        flat[torch.randint(0, flat.numel(), (4096,), generator=gen,
                           device=device)] = float("nan")
        got, ref = kc.maxpool2(x), kc.maxpool2_plain(x)
        nan = torch.isnan(got)
        ok = (torch.equal(nan, torch.isnan(ref)) and bool(nan.any())
              and torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0)))
        log(f"  POOL NaN-seeded {dtype} 7ch {'x'.join(map(str, lv[0]))}: "
            f"{int(nan.sum())} NaN outputs, positions and values "
            f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            failures.append(f"maxpool2_rows NaN-seeded {dtype}: NaN "
                            "positions or values differ from the plain "
                            "version")
        del x, flat, got, ref, nan
    return entries, failures


def unetsp_convs(widths=UNETSP_WIDTHS, cin: int = 2):
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
    left out), K5 per ``UNet4_2IC`` and per ``recAE_v2_fixed`` volume, and
    K5 per legacy train step (18 forward, ``<model>/step``, and 17 input
    gradients, ``<model>/dgrad``)."""
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
        for i, (ci, co, lv) in enumerate(legacy_convs(i_size, cin)):
            add((5, ci, co, lv), f"{mc}/volume")
            add((5, ci, co, lv), f"{mc}/step")
            if i:
                add((5, co, ci, lv), f"{mc}/dgrad")
    return dict(sorted(rows.items()))


def check_conv_tc(device, shape=SHAPE, rows=None):
    """``conv3d_tc`` against its plain version within ``bf16_tol`` at every
    shape of :func:`conv_tc_shapes`, called through the wrapper its path
    calls (K1 ``conv3d_bn_relu``, K6 ``conv3d_bias_act`` without ReLU, K5
    ``conv3d5_bias_act``); beside it the direct CUDA-core kernel's time
    (the kernel these wrappers launched before, same inputs, same call),
    the plain version's (one run), cuDNN's bf16 ``F.conv3d`` and the bound.
    Random normal weights scaled by
    their fan-in, f32 biases, ReLU'd normal inputs from a seed. Logs one
    ``TC`` line per shape and each path's sums (time x launches). ``rows``
    (default :func:`conv_tc_shapes`) narrows it to other launches. Returns
    ``(entries, failures)``."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(4)
    bf = torch.bfloat16
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    entries, failures, sums = {}, [], {}
    for (k, ci, co, level), paths in (rows or conv_tc_shapes()).items():
        shp = lv[level]
        if k == 5 and not any(p.endswith("/volume") for p in paths):
            # a shape only an input gradient of legacy training launches
            name, relu = "conv3d5_train", False
            run = functools.partial(kc.conv3d5_bias_act, relu=False)
            direct = kc.conv3d5_bias_act_direct
        elif k == 5:
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
                    reps_small: int = 20, rows=None):
    """``upconv_tc`` against the plain versions within ``bf16_tol`` at
    every shape of :func:`upconv_tc_shapes`, through the wrapper its path
    calls (K3 ``upconv_bn_relu`` with UNetSP's trained decoder weights, K7a
    ``convt_k2s2`` and K7b ``convt_k2s2_dual`` with random normal weights
    scaled by their fan-in); ReLU'd normal inputs from a seed. Beside it
    the direct CUDA-core kernel's time (the kernel these wrappers launched
    before, same inputs, same call), the plain version's, cuDNN's bf16
    ``F.conv_transpose3d`` of the same function (K3: the k4/s2/p1
    transposed conv of ``cat(a, ones, b)``) and the bound. Logs one ``UTC``
    line per shape and each path's sums (time x launches); ``rows`` (default
    :func:`upconv_tc_shapes`) narrows it to other launches. Returns
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
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    entries, failures, sums = {}, [], {}

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=device)

    for name, ca, cb, co, level, path in rows or upconv_tc_shapes():
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
    """K6's f32 route (``conv3d_tc_f32``, the f32 tensor-core conv)
    against its plain version within ``f32_tol`` at every K6 shape of
    :func:`conv_tc_shapes` (the layers an f32 train step launches), in the
    layouts the step launches it: forward, and as input gradient (the
    reverse layer's flipped, channel-swapped weights); each call must count
    once on ``conv3d_tc_f32`` and on ``conv3d_f32``. Beside it the direct
    CUDA-core kernel it replaced ("earlier", same inputs, same call), the
    plain version, cuDNN f32 and the bound at ``F32_TC_FLOP_PER_S``, and
    the sums per f32 train step (time x launches). Then the autograd
    function's bf16 ``dx`` and ``dw`` against autograd through the plain
    version at the full-resolution 7->7 layer, and the library's forward /
    dgrad / wgrad times there. Random normal inputs and weights from a
    seed. Returns ``(entries, failures)``.
    """
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops import chain_conv_train as cct
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(2)
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    entries, failures = {}, []

    def randn(*shp, dtype):
        return torch.randn(*shp, generator=gen, device=device).to(dtype)

    # f32: conv3d_tc_f32 (bf16 is conv3d_tc: check_conv_tc); launches per
    # train step of each (ci, co, level) as forward and as input gradient
    f32 = torch.float32
    convs = unetsp_convs()
    per_mode = {"fwd": collections.Counter(c[:3] for c in convs),
                "dgrad": collections.Counter((co, ci, lv)
                                             for ci, co, lv, _ in convs[1:])}
    sums = [0.0, 0.0, 0.0, 0.0, 0]  # kernel, direct, cuDNN, bound, launches
    for (k, ci, co, level), paths in conv_tc_shapes().items():
        if "K6/step" not in paths:
            continue
        shp = lv[level]
        for mode, per_step in per_mode.items():
            n = per_step[ci, co, level]
            if not n:
                continue
            x = randn(*shp, ci, dtype=f32)
            wt = (randn(3, 3, 3, ci, co, dtype=f32) * (27 * ci) ** -0.5
                  if mode == "fwd" else cct.flip_swap(  # a co->ci layer's
                      randn(3, 3, 3, co, ci, dtype=f32) * (27 * co) ** -0.5))
            zero = torch.zeros(co, device=device)
            before = kernels.launches()
            got = kc.conv3d_bias_act(x, wt, zero, False)
            after = kernels.launches()
            launched = all(after[c] == before[c] + 1
                           for c in ("conv3d_tc_f32", "conv3d_f32"))
            ref = kc.conv3d_bias_act_plain(x, wt, zero, False)
            sync(device)
            tol = f32_tol(ref, 27 * ci)
            err = float((got - ref).abs().max())
            ok = launched and bool(torch.isfinite(got).all()) and err <= tol
            ms = time_ms(lambda: kc.conv3d_bias_act(x, wt, zero, False),
                         reps, device)
            d_ms = time_ms(lambda: kc.conv3d_bias_act_direct(x, wt, zero,
                                                             False), reps,
                           device)
            p_ms = time_ms(lambda: kc.conv3d_bias_act_plain(x, wt, zero,
                                                            False), 1, device)
            x_l = x.permute(3, 0, 1, 2)[None]
            w_l = wt.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            l_ms = time_ms(lambda: F.conv3d(x_l, w_l, padding=1), reps,
                           device)
            nbytes = 4 * (math.prod(shp) * (ci + co) + wt.numel()) + 4 * co
            nflops = 2 * ci * co * conv_taps(shp, 3)
            b_ms, b_by = bound_ms(nbytes, nflops, F32_TC_FLOP_PER_S)
            case = f"{ci}->{co} {'x'.join(map(str, shp))} f32 {mode}"
            log(f"  conv3d_bias_act [{case}]: max_abs_err {err:.3e} (tol "
                f"{tol:.3e}) {'ok' if ok else 'FAIL'}; conv3d_tc_f32 "
                f"{ms:.3f} ms ({nflops / ms / 1e9:.2f} TFLOP/s), earlier "
                f"(direct) {d_ms:.3f} ms, plain {p_ms:.3f} ms, cuDNN f32 "
                f"{l_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, at 165 TFLOP/s "
                f"3xTF32); launches {n} per f32 train step")
            if not ok:
                failures.append(f"conv3d_bias_act [{case}]: err {err} > tol "
                                f"{tol}, non-finite or not launched on "
                                "conv3d_tc_f32")
            for i, v in enumerate((ms, d_ms, l_ms, b_ms, 1)):
                sums[i] += n * v
            entries.setdefault("conv3d_bias_act_f32", dict(
                case=case, max_abs_err=err, ms=ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=l_ms))
            del x, wt, got, ref, x_l, w_l
    t, t_d, t_l, t_b, n = sums
    log(f"  K6 f32 sum per train step: {n} launches, conv3d_tc_f32 {t:.3f} "
        f"ms, earlier (direct) {t_d:.3f} ms, cuDNN f32 {t_l:.3f} ms, bound "
        f"{t_b:.4f} ms")
    if n != K6_PER_TRAIN_STEP:
        failures.append(f"K6 f32 check: {n} launches per train step, "
                        f"expected {K6_PER_TRAIN_STEP}")

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
    del x, wt, g, xd, wd, x_l, w_l, g_l, y_l
    failures += check_k5_train(device, lv[0], reps)
    return entries, failures


def check_k5_train(device, shp, reps: int):
    """The k=5 training conv (``conv_impl = "pallas"``): the autograd
    function's bf16 ``dx`` and ``dw`` against autograd through the plain
    version at the full-resolution 28->7 layer of ``UNet4_2IC``
    (``ublock4``'s first conv unit), and the times of its K5 dgrad, its 125
    tap-shifted matmuls wgrad and cuDNN's bf16 dgrad and wgrad there.
    Returns the failures."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch.ops import chain_conv_train as cct
    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    gen = torch.Generator(device=device).manual_seed(3)
    bf = torch.bfloat16
    ci, co = 28, 7
    failures = []

    def randn(*s):
        return torch.randn(*s, generator=gen, device=device).to(bf)

    x = torch.relu(randn(1, *shp, ci)).requires_grad_()
    wt = (randn(5, 5, 5, ci, co).float() * (125 * ci) ** -0.5).to(bf)
    wt.requires_grad_()
    g = randn(1, *shp, co)
    zero = torch.zeros(co, device=device)
    dx, dw = torch.autograd.grad(cct.conv3d_chain_train(x, wt), (x, wt), g)
    y_ref = kc.conv3d5_bias_act_plain(x[0], wt, zero, False)[None]
    dx_r, dw_r = torch.autograd.grad(y_ref, (x, wt), g)
    del y_ref
    for name, got, ref, ulps in (("dx", dx, dx_r, 1.0), ("dw", dw, dw_r, 2.0)):
        # dw: each depth plane's partial sum is rounded to bf16 before the
        # f32 sum over planes, then the sum is rounded: twice K5's tolerance
        tol = ulps * bf16_tol(ref)
        err = float((got.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        log(f"  conv3d_chain_train k=5 {name} [28->7 full size bf16] vs "
            f"autograd through the plain version: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}, max |ref| {float(ref.float().abs().max()):.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"conv3d_chain_train k=5 {name}: err {err} > "
                            f"{tol}")
    del dx, dw, dx_r, dw_r
    xd, wd = x.detach(), wt.detach()
    zero_ci = torch.zeros(ci, device=device)
    dgrad_ms = time_ms(lambda: kc.conv3d5_bias_act(
        g[0], cct.flip_swap(wd), zero_ci, False), reps, device)
    wgrad_ms = time_ms(lambda: cct.dw_taps(xd[0], g[0], 5), reps, device)
    x_l = xd.permute(0, 4, 1, 2, 3).requires_grad_()
    w_l = wd.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d).requires_grad_()
    y_l = F.conv3d(x_l, w_l, padding=2)
    g_l = g.permute(0, 4, 1, 2, 3)
    lib = {}
    for name, inp in (("dgrad", x_l), ("wgrad", w_l)):
        lib[name] = time_ms(lambda: torch.autograd.grad(
            y_l, inp, g_l, retain_graph=True), reps, device)
    nbytes = 2 * (xd.numel() + g.numel()) + 4 * wd.numel()
    w_bound, w_by = bound_ms(nbytes, 2 * ci * co * conv_taps(shp, 5))
    log(f"  28->7 full size bf16 k=5 backward: kernel dgrad {dgrad_ms:.3f} "
        f"ms, 125 tap-shifted matmuls wgrad {wgrad_ms:.3f} ms (bound "
        f"{w_bound:.4f} ms, {w_by}); library (cuDNN through "
        f"torch.autograd.grad) dgrad {lib['dgrad']:.3f} ms, wgrad "
        f"{lib['wgrad']:.3f} ms")
    return failures


def f32_shapes():
    """Every f32 conv and upsampling launch of the f32 serving paths (K2:
    :func:`pool_shapes`), ``{(wrapper, *shape key): {path: launches}}``: K1
    per UNetSP volume (``(ci, co, level)``), K5 per legacy volume, K3 / K7a
    / K7b as :func:`upconv_tc_shapes` lists them, and, keyed
    ``conv3d5_train``, the 16 K5 input gradients of f32 legacy training
    that no serving path launches (per train step, as
    :func:`conv_tc_shapes` lists them)."""
    rows = {}

    def add(key, path, n=1):
        rows.setdefault(key, {}).setdefault(path, 0)
        rows[key][path] += n

    for ci, co, lv, served in unetsp_convs():
        if served:
            add(("conv3d_bn_relu", ci, co, lv), "UNetSP")
    for mc, i_size, cin in (("UNetSP", 7, 2), ("UNet4_2IC", 7, 2),
                            ("recAE_v2_fixed", 8, 1)):
        if mc != "UNetSP":
            for ci, co, lv in legacy_convs(i_size, cin):
                add(("conv3d5_bias_act", ci, co, lv), mc)
    for name, ca, cb, co, lv, path in upconv_tc_shapes():
        add((name, ca, cb, co, lv), path)
    for (k, ci, co, lv), paths in conv_tc_shapes().items():
        if k == 5 and not any(p.endswith("/volume") for p in paths):
            for p, n in paths.items():
                add(("conv3d5_train", ci, co, lv), p, n)
    return rows


def check_kernels_f32(sd, device, shape=SHAPE, reps_big: int = 2,
                      reps_small: int = 10, rows=None):
    """The f32 kernels of the f32 paths against their plain versions,
    within ``f32_tol``, at every shape of :func:`f32_shapes`, through the
    wrapper each path calls: K1 ``conv3d_bn_relu`` and K5
    ``conv3d5_bias_act`` (the kernel functions ``conv3d_f32`` /
    ``conv3d5_f32``; K5 without ReLU at the input-gradient shapes of
    legacy training, ``conv3d5_train``, on signed normal inputs), K3
    ``upconv_bn_relu`` with UNetSP's trained decoder weights
    (``upconv_f32``), K7a ``convt_k2s2`` and K7b ``convt_k2s2_dual``
    (``convt_f32``); each call must count on its f32 kernel function (K1
    and K5 also on ``conv3d_tc_f32``, the f32 tensor-core conv they
    launch; K3, K7a and K7b on ``upconv_tc_f32``, the f32 tensor-core
    upsampling) and on neither bf16 tensor-core kernel. Random normal
    weights scaled by their fan-in, f32 biases, ReLU'd normal inputs from a
    seed. Beside each: for K1, K5, K3, K7a and K7b the direct CUDA-core
    kernel they launched before ("earlier", same inputs, same call), the
    plain version's time, one
    cuDNN call of the same function in f32 with TF32 off (K3: ConvT, then
    the folded conv and the ReLU) and the bound (bytes / HBM rate or flops
    / ``F32_TC_FLOP_PER_S``, the f32-accurate 3xTF32 rate); no direct kernel
    at the input-gradient shapes (the CUDA-core k=5 kernel takes tens of ms
    there). Logs one ``F32`` line per shape and
    each path's sums (time x launches). Returns ``(entries, failures)``,
    entries keyed ``<wrapper>_f32`` (its first shape), ``conv3d_tc_f32``
    (K5 64->16 at 112x152x152) and ``upconv_tc_f32`` (its largest launch,
    K7b (14+14)->28 to 224x304x304). ``rows`` (default :func:`f32_shapes`)
    narrows it to other launches (K3 rows then take ``sd``'s decoder)."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch import engine
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import convt as kt
    from ctunet_tpu_torch.ops.kernels import upconv as ku
    from ctunet_tpu_torch.ops.kernels.upsample_tc import upconv_tc_work

    gen = torch.Generator(device=device).manual_seed(6)
    f32 = torch.float32
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    entries, failures, sums = {}, [], {}
    kernel_of = {"conv3d_bn_relu": "conv3d_f32",
                 "conv3d5_bias_act": "conv3d5_f32",
                 "conv3d5_train": "conv3d5_f32",
                 "upconv_bn_relu": "upconv_f32",
                 "convt_k2s2": "convt_f32", "convt_k2s2_dual": "convt_f32"}

    def randn(*shp):
        return torch.randn(*shp, generator=gen, device=device)

    def relu_in(*shp):
        return torch.relu(randn(*shp))

    def cl(t):  # channels-last (..., C) -> NCDHW view for cuDNN
        return t.permute(3, 0, 1, 2)[None]

    for key, paths in (rows or f32_shapes()).items():
        name = key[0]
        direct, peak = None, F32_TC_FLOP_PER_S
        if name in ("conv3d_bn_relu", "conv3d5_bias_act", "conv3d5_train"):
            _, ci, co, level = key
            k = 3 if name == "conv3d_bn_relu" else 5
            relu = name != "conv3d5_train"
            shp = lv[level]
            wt = randn(k, k, k, ci, co) * (k ** 3 * ci) ** -0.5
            b = randn(co) * 0.1
            x = relu_in(*shp, ci) if relu else randn(*shp, ci)
            args = (x, wt, b)
            if relu:
                run = getattr(kc, name)
                direct = functools.partial(
                    kc.conv3d_bias_act_direct if k == 3
                    else kc.conv3d5_bias_act_direct, relu=True)
            else:
                run = functools.partial(kc.conv3d5_bias_act, relu=False)
            plain = functools.partial(kc.conv3d_tc_plain, relu=relu)
            w_l = wt.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            lib = functools.partial(F.conv3d, cl(x), w_l, b, padding=k // 2)
            n_terms = k ** 3 * ci
            nbytes = 4 * (math.prod(shp) * (ci + co) + wt.numel() + co)
            nflops = 2 * ci * co * conv_taps(shp, k)
            case = f"k{k} {ci}->{co} {'x'.join(map(str, shp))}"
        elif name == "upconv_bn_relu":
            _, j, _, _, level = key
            shp = lv[level]
            ca = None if j == 0 else int(
                sd[f"u_blocks.{j - 1}.block.4.weight"].shape[0])
            wa, wb, wone, bias = engine.upconv_operands(sd, j, ca, f32,
                                                        device)
            ca, co = wa.shape[3], wa.shape[4]
            cb = 0 if wb is None else wb.shape[3]
            a = relu_in(*shp, ca)
            bb = relu_in(*shp, cb) if cb else None
            args = (a, bb, wa, wb, wone, bias)
            run, plain = ku.upconv_bn_relu, ku.upconv_bn_relu_plain
            direct = ku.upconv_bn_relu_direct
            p = f"u_blocks.{j}.block"
            w1, b1 = kc.fold_conv_unit(
                sd[f"{p}.1.weight"], sd.get(f"{p}.1.bias"),
                sd[f"{p}.2.weight"], sd[f"{p}.2.bias"],
                sd[f"{p}.2.running_mean"], sd[f"{p}.2.running_var"], f32)
            up_w = sd[f"{p}.0.weight"].to(device, f32)
            up_b = sd[f"{p}.0.bias"].to(device, f32)
            w1 = w1.permute(4, 3, 0, 1, 2).to(device).contiguous(
                memory_format=torch.channels_last_3d)
            b1 = b1.to(device)
            x_l = cl(a if bb is None else torch.cat([a, bb], -1))

            def lib(x_l=x_l, up_w=up_w, up_b=up_b, w1=w1, b1=b1):
                up = F.conv_transpose3d(x_l, up_w, up_b, stride=2)
                return torch.relu(F.conv3d(up, w1, b1, padding=1))

            n_terms = 8 * (ca + cb + 1)
            nb16, nflops = upconv_tc_work(shp, ca, cb, co, True)
            nbytes = 2 * nb16 - 4 * co  # every bf16 term twice, f32 bias
            out_shp = tuple(2 * s for s in shp)
            case = (f"({ca}+{cb})->{co}" if cb else f"{ca}->{co}") + (
                f" to {'x'.join(map(str, out_shp))}")
        else:  # convt_k2s2(_dual)
            _, ca, cb, co, level = key
            shp = lv[level]
            wt = randn(ca + cb, co, 2, 2, 2) * (ca + cb) ** -0.5
            bias0 = randn(co) * 0.1
            wa, wb, bias = kt.convt_weights(wt, bias0, ca if cb else None,
                                            f32)
            a = relu_in(*shp, ca)
            bb = relu_in(*shp, cb) if cb else None
            if cb:
                args = (a, bb, wa, wb, bias)
                run, direct = kt.convt_k2s2_dual, kt.convt_k2s2_dual_direct
            else:
                args = (a, wa, bias)
                run, direct = kt.convt_k2s2, kt.convt_k2s2_direct
            plain = (lambda a, *r: kt.convt_k2s2_plain(a, None, r[0], None,
                                                       r[1])) if not cb \
                else kt.convt_k2s2_plain
            x_l = cl(a if bb is None else torch.cat([a, bb], -1))
            lib = functools.partial(F.conv_transpose3d, x_l, wt, bias0,
                                    stride=2)
            n_terms = ca + cb
            nb16, nflops = upconv_tc_work(shp, ca, cb, co, False)
            nbytes = 2 * nb16 - 4 * co
            out_shp = tuple(2 * s for s in shp)
            case = (f"({ca}+{cb})->{co}" if cb else f"{ca}->{co}") + (
                f" to {'x'.join(map(str, out_shp))}")
        big = key[-1] < 2
        counter = kernel_of[name]
        before = kernels.launches()
        got = run(*args)
        after = kernels.launches()
        # K1, K5 launch conv3d_tc_f32; K3, K7a, K7b upconv_tc_f32
        tc = ("upconv_tc_f32" if counter in ("upconv_f32", "convt_f32")
              else "conv3d_tc_f32")
        launched = (after[counter] == before[counter] + 1
                    and all(after[k] == before[k] + (k == tc) for k in (
                        "conv3d_tc_f32", "upconv_tc_f32", "conv3d_tc",
                        "upconv_tc")))
        ref = plain(*args)
        sync(device)
        tol = f32_tol(ref, n_terms) if n_terms else 0.0
        err = float((got - ref).abs().max())
        ok = (launched and got.dtype == f32 and err <= tol
              and bool(torch.isfinite(got).all()))
        reps = reps_big if big else reps_small
        ms = time_ms(lambda: run(*args), reps, device)
        d_ms = (time_ms(lambda: direct(*args), 1 if big else reps, device)
                if direct else float("nan"))
        p_ms = time_ms(lambda: plain(*args), 1 if big else reps, device)
        l_ms = time_ms(lib, reps, device)
        b_ms, b_by = bound_ms(nbytes, nflops, peak)
        per = ", ".join(f"{n} {p}" for p, n in paths.items())
        via = f"{tc} via {counter}" if tc else counter
        earlier = f"earlier (direct) {d_ms:.3f} ms, " if direct else ""
        log(f"  F32 {name} [{case}]: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}; {via} {ms:.3f} ms "
            f"({nflops / ms / 1e9:.2f} TFLOP/s, {nbytes / ms / 1e6:.1f} "
            f"GB/s), {earlier}plain {p_ms:.3f} ms, cuDNN f32 {l_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}, at {peak / 1e12:.0f} "
            f"TFLOP/s), {ms / b_ms:.1f}x it; launches {per}")
        if not ok:
            failures.append(f"{via} [{case}] (wrapper {name}): err {err} > "
                            f"tol {tol}, non-finite, not f32, or not "
                            "launched on its kernels alone")
        for p, n in paths.items():
            t = sums.setdefault((p, name), [0.0, 0.0, 0.0, 0.0, 0])
            t[0] += n * ms
            t[1] += n * b_ms
            t[2] += n * l_ms
            t[3] += n * d_ms
            t[4] += n
        entry = dict(case=case, max_abs_err=err, ms=ms, plain_ms=p_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        entries.setdefault(f"{name}_f32", entry)
        if key == ("conv3d5_bias_act", 64, 16, 1):
            entries["conv3d_tc_f32"] = entry
        if key == ("convt_k2s2_dual", 14, 14, 28, 1):
            entries["upconv_tc_f32"] = entry
        del args, got, ref
    for (p, name), (t, t_b, t_l, t_d, n) in sums.items():
        earlier = ("" if math.isnan(t_d)
                   else f", earlier (direct) {t_d:.3f} ms")
        log(f"  F32 sum {p} {name}: {n} launches per volume, {t:.3f} ms "
            f"(bound {t_b:.4f} ms, cuDNN f32 {t_l:.3f} ms{earlier})")
    return entries, failures


def k1q_shapes(widths=UNETSP_WIDTHS, cin: int = 2):
    """The int8 engine's K1q launches per volume as ``{(ci, co, level):
    (unit tag of its weights, launches)}``: each encoder level's two units,
    and each decoder block's unit 1 (its unit 0 is fused into K3q), which
    repeats its level's second encoder shape."""
    rows = {}
    for i, w in enumerate(widths):
        rows[(cin, w, i)] = [f"d{i}.0", 1]
        rows[(w, w, i)] = [f"d{i}.1", 2]
        cin = w
    return rows


def check_kernels_q(sd, device, shape=SHAPE, reps_big: int = 5,
                    reps_small: int = 50, reps_plain: int = 1,
                    model_class: str = "UNetSP", widths=UNETSP_WIDTHS):
    """K1q and K3q against their plain versions at every shape of the
    int8 path (K1q's 8 distinct shapes, K3q's 4), in zp mode, plus one
    symmetric-mode shape each; with the layers the int8 engine quantizes
    (round to nearest) from a calibration on one synthetic volume, on
    uniform random int8 inputs. Exact equality. Each K1q/K3q shape runs
    through its wrapper (``conv3d_q_requant`` / ``upconv_q_requant``, which
    launch the tensor-core kernels ``conv3d_tc_q`` / ``upconv_tc_q``) and is
    timed beside the CUDA-core kernel the wrapper launched before
    (``*_direct``, same inputs, same call), the plain version and the
    bound; PyTorch's ``F.conv3d`` / ``F.conv_transpose3d`` are tried on the
    int8 tensors and their refusal recorded. Logs one ``TCQ``/``UTCQ``
    line per shape and the per-volume sums (time x launches). Returns
    ``(entries, failures)``: each wrapper's first shape, and under
    ``conv3d_tc_q`` / ``upconv_tc_q`` their largest launch (7->7 and
    (14+14)->7 at full resolution). ``model_class`` and its encoder
    ``widths`` select the engine (UNetSPSmall: 15 K1q and 5 K3q shapes,
    the first K3q from level 5)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch import engine_q
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import upconv as ku
    from ctunet_tpu_torch.ops.kernels import upsample_tc as ut

    gen = torch.Generator(device=device).manual_seed(1)
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(6)]
    x_cal = np.stack([punched_shell(shape, 800),
                      spherical_shell(shape, radius_frac=0.42)], -1)
    x_cal = torch.from_numpy(x_cal.astype(np.float32)).to(device)
    t0 = time.perf_counter()
    pq = engine_q.build_predict_q(model_class, sd, x_cal, device=device)
    layers = pq.layers
    log(f"  calibration + quantization of the layers: "
        f"{time.perf_counter() - t0:.1f} s")
    # where the int8 engine's time goes, on this round-to-nearest build
    # (the same kernels at the same shapes as the AdaQuant build served
    # later; a profile taken after AdaQuant's autograd lost kernel events)
    profile_device(lambda: pq(x_cal[None]), device)
    del x_cal
    entries, failures = {}, []

    def rand_q(shp, zp=True):
        return torch.randint(-128 if zp else 0, 128, shp, generator=gen,
                             device=device, dtype=torch.int8)

    def library(what, fn):
        """PyTorch's one-call counterpart on the int8 tensors, timed, or
        None where it refuses int8 (recorded as "refused")."""
        try:
            return time_ms(fn, 2, device)
        except (RuntimeError, NotImplementedError) as e:
            log(f"  {what} on int8: refused ({str(e).splitlines()[0][:90]})")
            return None

    def record(name, tc, case, got, ref, ms, d_ms, plain_ms, lib_ms, nbytes,
               nops, launched, largest):
        err = float((got.int() - ref.int()).abs().max())
        b_ms, b_by = bound_ms(nbytes, nops, INT8_OP_PER_S)
        lib = "refused" if lib_ms is None else f"{lib_ms:.3f} ms"
        ok = err == 0 and got.dtype == torch.int8 and launched
        log(f"  {'TCQ' if tc == 'conv3d_tc_q' else 'UTCQ'} {name} [{case}]: "
            f"max_abs_err {err:.0f} (exact required) {'ok' if ok else 'FAIL'}"
            f"; {tc} {ms:.3f} ms ({nops / ms / 1e9:.2f} TOP/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s), direct {d_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib}, bound {b_ms:.4f} ms "
            f"({b_by}); {d_ms / ms:.2f}x the direct kernel")
        if not ok:
            failures.append(f"{name} [{case}]: max_abs_err {err} != 0, not "
                            f"int8, or {tc} not launched")
        if ms >= d_ms:  # kept with its numbers (PERF.md), not a failure
            log("    SLOWER than the direct kernel at this shape")
        entry = dict(case=case, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     direct_ms=d_ms)
        if name not in entries:
            entries[name] = entry
        if largest:
            entries[tc] = entry
        return b_ms

    # K1q: every distinct shape, zp mode, then 7->7 at full resolution in
    # symmetric mode (inputs 0..127, the same weights and requant)
    n_lv, w0 = len(widths), widths[0]
    k1q = [(ci, co, lvl, tag, n, True)
           for (ci, co, lvl), (tag, n) in k1q_shapes(widths).items()]
    k1q.append((w0, w0, 0, "d0.1", 0, False))
    sums = [0.0, 0.0, 0.0]
    for ci, co, lvl, tag, n, zp in k1q:
        shp = lv[lvl]
        w_, s_, b_ = layers[tag]
        assert tuple(w_.shape[3:]) == (ci, co), (tag, w_.shape)
        x = rand_q(shp + (ci,), zp)
        big = lvl == 0
        before = kc.conv3d_tc_q.launches
        got = kc.conv3d_q_requant(x, w_, s_, b_, zp)
        launched = kc.conv3d_tc_q.launches == before + 1
        ref = kc.conv3d_q_requant_plain(x, w_, s_, b_, zp)
        reps = reps_big if big else reps_small
        ms = time_ms(lambda: kc.conv3d_q_requant(x, w_, s_, b_, zp), reps,
                     device)
        d_ms = time_ms(lambda: kc.conv3d_q_requant_direct(x, w_, s_, b_, zp),
                       reps, device)
        p_ms = time_ms(lambda: kc.conv3d_q_requant_plain(x, w_, s_, b_, zp),
                       reps_plain if big else reps, device)
        x_l = x.permute(3, 0, 1, 2)[None]
        w_l = w_.permute(4, 3, 0, 1, 2).contiguous()
        l_ms = library("F.conv3d", lambda: F.conv3d(x_l, w_l, padding=1))
        nbytes = math.prod(shp) * (ci + co) + w_.numel() + 8 * co
        nops = 2 * 27 * ci * co * math.prod(shp)
        plan = kc.tcq_plan(shp, ci, co)
        case = (f"{ci}->{co} {'x'.join(map(str, shp))}"
                f"{'' if zp else ' symmetric'}")
        b_ms = record("conv3d_q_requant", "conv3d_tc_q", case, got, ref, ms,
                      d_ms, p_ms, l_ms, nbytes, nops, launched,
                      (ci, co, lvl, zp) == (w0, w0, 0, True))
        log(f"    plan mf={plan.mf} nf={plan.nf} tx={1 << plan.tx_log2} "
            f"u={plan.u} cc={plan.cc} chunks={plan.chunks}; {n} launches "
            "per volume")
        sums[0] += n * ms
        sums[1] += n * d_ms
        sums[2] += n * b_ms
        del x, got, ref, x_l
    log(f"  TCQ sum: {3 * n_lv} K1q launches per volume, conv3d_tc_q "
        f"{sums[0]:.3f} "
        f"ms, direct {sums[1]:.3f} ms, bound {sums[2]:.4f} ms")

    # K3q: decoder block j from half-resolution level 4 - j, zp mode, then
    # (14+14)->7 in symmetric mode
    sums = [0.0, 0.0, 0.0]
    for j, zp in [(j, True) for j in range(n_lv)] + [(n_lv - 1, False)]:
        shp2 = lv[n_lv - j]
        wa, wb, wone, s_, b_ = layers[f"u{j}.0"]
        a = rand_q(shp2 + (wa.shape[3],), zp)
        b = None if wb is None else rand_q(shp2 + (wb.shape[3],), zp)
        ca, co = wa.shape[3], wa.shape[4]
        cb = 0 if wb is None else wb.shape[3]
        big = j == n_lv - 1
        reps = reps_big if big else reps_small
        args = (a, b, wa, wb, wone, s_, b_, zp)
        before = ut.upconv_tc_q.launches
        got = ku.upconv_q_requant(*args)
        launched = ut.upconv_tc_q.launches == before + 1
        ref = ku.upconv_q_requant_plain(*args)
        ms = time_ms(lambda: ku.upconv_q_requant(*args), reps, device)
        d_ms = time_ms(lambda: ku.upconv_q_requant_direct(*args), reps,
                       device)
        p_ms = time_ms(lambda: ku.upconv_q_requant_plain(*args),
                       reps_plain if big else reps, device)
        parts = [a, torch.full_like(a[..., :1], 127)] + (
            [] if b is None else [b])
        x_l = torch.cat(parts, -1).permute(3, 0, 1, 2)[None]
        w_l = torch.cat([wa, wone[..., None, :]] + ([] if wb is None
                                                     else [wb]), 3)
        w_l = w_l.permute(3, 4, 0, 1, 2).contiguous()
        l_ms = library("F.conv_transpose3d", lambda: F.conv_transpose3d(
            x_l, w_l, stride=2, padding=1))
        out_shape = tuple(2 * s for s in shp2)
        cin = ca + cb
        nbytes = (math.prod(shp2) * cin + math.prod(out_shape) * co
                  + wa.numel() + wone.numel() + 36 * co
                  + (0 if wb is None else wb.numel()))
        nops = 2 * 8 * (cin + 1) * co * math.prod(out_shape)
        plan = ut.uptcq_plan(shp2, ca, cb, co)
        case = (f"({ca}+{cb})->{co}" if cb else f"{ca}->{co}") + (
            f" to {'x'.join(map(str, out_shape))}"
            f"{'' if zp else ' symmetric'}")
        b_ms = record("upconv_q_requant", "upconv_tc_q", case, got, ref, ms,
                      d_ms, p_ms, l_ms, nbytes, nops, launched,
                      (j, zp) == (n_lv - 1, True))
        log(f"    plan np={plan.np} mf={plan.mf} nf={plan.nf} "
            f"tx={1 << plan.tx_log2} cg={plan.cg} chunks={plan.chunks}")
        if zp:
            sums[0] += ms
            sums[1] += d_ms
            sums[2] += b_ms
        del a, b, got, ref, x_l
    log(f"  UTCQ sum: {n_lv} K3q launches per volume, upconv_tc_q "
        f"{sums[0]:.3f} "
        f"ms, direct {sums[1]:.3f} ms, bound {sums[2]:.4f} ms")
    return entries, failures


def punched_shell(shape, seed: int, radius_frac: float = 0.38, center=None):
    """A synthetic broken skull: a shell (radius ``radius_frac`` of the
    shortest side, centred at ``center`` or, jittered by ``seed``, at the
    canvas centre) with one spherical cap removed."""
    import numpy as np

    from ctunet_tpu_torch.data import spherical_shell

    full = spherical_shell(shape, seed=seed, radius_frac=radius_frac,
                           center=center)
    rng = np.random.default_rng(seed)
    r = radius_frac * min(shape)
    v = rng.normal(size=3)
    v[0] = -abs(v[0])  # the cap sits on the upper half
    c = (np.asarray(shape, np.float64) / 2 if center is None
         else np.asarray(center, np.float64)) + r * v / np.linalg.norm(v)
    zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in shape)]
    hole = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
            <= (0.35 * r) ** 2)
    return np.where(hole, 0, full).astype(np.uint8)


def profile_device(fn, device, rows: int = 12, what: str = "one volume"):
    """Print the device time of one ``fn()`` by kernel name, each kernel
    with the wrappers' spans around its launch, and the hand-written
    kernels' share (``utils/profiling.py``: ``trace`` pads the window so
    that it holds every kernel of the pass), and how many launches the
    trace lost. Returns ``{kernel name: (count, ms)}``."""
    import torch

    from ctunet_tpu_torch.utils import profiling

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profiling.trace(device) as prof:
        fn()
    got, dropped = profiling.attribute(prof.events())
    by_name = {}
    for r in got:
        n, ms = by_name.get(r["name"], (0, 0.0))
        by_name[r["name"]] = (n + 1, ms + r["ms"])
    total = sum(r["ms"] for r in got)
    hand = sum(r["ms"] for r in got if r["category"].startswith("kernel:"))
    log(f"  device profile of {what}: {total:.2f} ms of kernels, "
        f"{hand:.2f} ms ({100 * hand / max(total, 1e-9):.1f}%) in the "
        f"hand-written kernels ({sum(profiling.wrapper_counts(got).values())}"
        f" launches); {dropped} launches lost by the trace")
    for t in profiling.top(got, rows):
        log(f"    {t['ms']:8.3f} ms {100 * t['ms'] / max(total, 1e-9):5.1f}% "
            f"x{t['count']:<3d} {t['name'][:58]:<58s} {t['spans']}")
    return by_name


def launch_breakdown(model_class: str, sd, x, device, dtype=None):
    """Each kernel launch of one pass of a legacy engine over ``x``, in
    launch order, timed by CUDA events recorded around its wrapper call
    (the host clock off the card); the rest of the pass (head, softmax,
    casts) is the pass's time less the launches'. A fresh engine (in
    ``dtype``, bf16 by default) is built and run, after a warm-up pass, with
    the wrappers wrapped. Logs the launches and returns ``{wrapper name:
    ms}`` with ``"rest"`` and ``"engine"``."""
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
        pred_dtype = dtype or torch.bfloat16
        pred = engine.build_predict(model_class, sd, pred_dtype, device)
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
    log(f"  {model_class} ({str(pred_dtype)[6:]}): each kernel launch of "
        "one volume, in order "
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
    AdaQuant, its rounding search on the first volume's margin-16
    foreground window) but whole volumes (``fg_crop`` off, ``serve_scan``
    1). Checks
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
    # every K1q and K3q launch runs on the int8 tensor-core kernels
    want = {"conv3d_q_requant": 12 * n_volumes, "maxpool2_q": 4 * n_volumes,
            "upconv_q_requant": 4 * n_volumes,
            "conv3d_tc_q": 12 * n_volumes, "upconv_tc_q": 4 * n_volumes}
    kernels.reset_launches()
    m = Model(params=params)  # ends with the masks fetched to the host
    counts = kernels.launches()
    launches = {k: v for k, v in counts.items() if k in want}
    log(f"  launches over {n_volumes} volumes: {counts} (int8 want {want}; "
        "the bf16 ones are the calibration forward)")
    if launches != want:
        failures.append(f"int8 launch counts {launches} != {want}")
    for tc, wrapper in (("conv3d_tc_q", "conv3d_q_requant"),
                        ("upconv_tc_q", "upconv_q_requant")):
        if counts[tc] != counts[wrapper]:
            failures.append(f"{tc} launched {counts[tc]} times, "
                            f"{wrapper} {counts[wrapper]}")
    # every K2q launch and the calibration forward's bf16 K2 launches run
    # on the row-streaming pool
    launches["maxpool2_rows"] = counts["maxpool2_rows"]
    if counts["maxpool2_rows"] != counts["maxpool2_q"] + counts["maxpool2"]:
        failures.append(f"maxpool2_rows launched {counts['maxpool2_rows']} "
                        f"times, maxpool2_q {counts['maxpool2_q']} + "
                        f"maxpool2 {counts['maxpool2']}")
    build_s = m.int8_build_seconds
    log(f"  int8 build for {sorted(m.int8_engines)}: AdaQuant's rounding "
        f"searched on {m.int8_hint_shapes} (the first volume's margin-16 "
        f"window), {build_s:.1f} s (470.7 s when it searched the whole "
        "volume, on an H100 80GB HBM3 at 700 W)")
    stats = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                 hint=list(m.int8_hint_shapes.values()),
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
            "upconv_tc": 4 * n_volumes, "maxpool2_rows": 4 * n_volumes}
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


def batch_stat_check(init, got, ref, failures, label: str = "") -> float:
    """Hold the BatchNorm batch statistics of one train step on the kernels
    (state_dict ``got``) against the same step on the plain versions
    (``ref``), both from ``init``; returns the worst error / tolerance."""
    worst = 0.0
    for name, buf in got.items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        # batch statistic = (running - 0.9 * initial) / 0.1
        bk = (buf - 0.9 * init[name]) / 0.1
        bp = (ref[name] - 0.9 * init[name]) / 0.1
        # bf16 activations: 2 bf16 ulps at the statistic's magnitude, and
        # as much again for what earlier layers' roundings move it
        tol = 4 * BF16_EPS * float(bp.abs().max().clamp_min(1e-3))
        err = float((bk - bp).abs().max())
        worst = max(worst, err / tol)
        if not err <= tol:
            failures.append(f"{label}BN batch statistic {name}: {err} > "
                            f"{tol}")
    return worst


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
            "upconv_bn_relu": 4, "conv3d_tc": k6 + 12, "upconv_tc": 4,
            "maxpool2_rows": 4,
            "adam_mt": n_train * adam_launches("UNetSP")}
    launches = {k: counts[k] for k in want}
    log(f"  launches: {launches} (want {want}: {n_train} train steps x "
        f"{K6_PER_TRAIN_STEP} + {n_eval} eval steps x {K6_PER_EVAL_STEP} of "
        "K6, then one served volume; each bf16 K6/K1 launch is a "
        "conv3d_tc launch, each K3 launch an upconv_tc launch, and the "
        "f32 Adam update of a train step takes adam_mt launches)")
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
    worst = batch_stat_check(base.state_dict(), mk.state_dict(),
                             mp.state_dict(), failures)
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
        profile_device(lambda: k_pred(xt), device, rows=8,
                       what=f"one {mc} volume")
        st["breakdown_ms"] = launch_breakdown(mc, sd, xt, device)
        stats[mc] = st
        del model, k_pred, p_pred, prob
        log(f"  {mc}: {time.perf_counter() - t0:.1f} s")
    return main_launches, stats, failures


def wgrad_ms(step, device) -> float:
    """Milliseconds of one ``step()`` spent in the training conv's weight
    gradients (``chain_conv_train.dw_taps``): CUDA events around each call
    on the card, the host clock elsewhere."""
    import torch

    from ctunet_tpu_torch.ops import chain_conv_train as cct

    spans = []
    orig = cct.dw_taps

    def timed(x, g, k=3):
        if device.type != "cuda":
            t = time.perf_counter()
            out = orig(x, g, k)
            spans.append(1e3 * (time.perf_counter() - t))
            return out
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(x, g, k)
        b.record()
        spans.append((a, b))
        return out

    cct.dw_taps = timed
    try:
        step()
        sync(device)
    finally:
        cct.dw_taps = orig
    return sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
               for s in spans)


def train_legacy(device, work: str, shape=SHAPE, time_steps: int = 2):
    """Train both legacy models through ``Model`` with their AutoImplant
    2020 INIs' settings and ``conv_impl = "pallas"`` on complete synthetic
    skulls (``LEGACY_TRAIN`` steps, 1 eval step, the INIs' synthesis on the
    card), save, and serve one volume from each trained checkpoint through
    the bf16 legacy engine. Then, per model, one train and one eval step
    counted alone, one train step held against the same step on the plain
    versions (loss and BatchNorm batch statistics; every parameter's
    gradient against the plain f32 step), the step time on ``pallas`` and
    on ``xla`` (cuDNN), the weight gradient's share from a
    ``torch.profiler`` pass, the synthesis ms a volume and the peak memory.
    Returns ``(launches, stats, failures)``."""
    import copy

    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, checkpoint, default_params,
                                  load_params, registry, steps)
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.models.unet import Conv3d
    from ctunet_tpu_torch.ops import kernels

    failures, stats = [], {}
    data, paths, csv, atlas, affine = write_volumes(work, shape, 1)
    n_max = max(n for _, n in LEGACY_TRAIN)
    train_csv = make_dataset(os.path.join(work, "train"), n=n_max,
                             shape=shape, seed=60)
    val_csv = make_dataset(os.path.join(work, "val"), n=1, shape=shape,
                           seed=90)
    with open(train_csv) as f:
        rows = f.read().splitlines()
    k5_total = 0
    for mc, n_train in LEGACY_TRAIN:
        t0 = time.perf_counter()
        csv_n = os.path.join(work, "train", f"first{n_train}.csv")
        with open(csv_n, "w") as f:
            f.write("\n".join(rows[:n_train + 1]) + "\n")
        name = f"chip_smoke_train_{mc}"
        params = load_params(LEGACY_INIS[mc], default_params())
        # the INI's settings but: conv_impl = pallas, one epoch, no
        # per-epoch autosave + test (the final save and test run once),
        # whole synthetic volumes
        params.update(
            name=name, conv_impl="pallas", n_epochs=1, autosave_epochs=0,
            workspace_path=os.path.join(work, "ws"), train_files_csv=csv_n,
            validation_files_csv=val_csv, test_files_csv=csv,
            resume_model="", log_every=1)
        if device.type != "cuda":
            params["device"] = device.type
        kernels.reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        m = Model(params=params)  # train, eval, save, then test one volume
        sync(device)
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        k5 = n_train * K5_PER_TRAIN_STEP + K5_PER_EVAL_STEP + 18
        want = {"conv3d5_bias_act": k5, "conv3d_tc": k5, "maxpool2": 4,
                "convt_k2s2": 1, "convt_k2s2_dual": 3, "upconv_tc": 4,
                "maxpool2_rows": 4}
        got = {k: counts[k] for k in want}
        log(f"  {mc} launches: {got} (want {want}: {n_train} train steps x "
            f"{K5_PER_TRAIN_STEP} + 1 eval step x {K5_PER_EVAL_STEP} of K5, "
            "then one volume served; each K5 launch a conv3d_tc launch)")
        if got != want:
            failures.append(f"{mc} training launch counts {got} != {want}")
        k5_total += got["conv3d5_bias_act"]
        losses = [float(v) for v in m.step_losses]
        hist = {k: v[-1][1] for k, v in m.writer.history.items()}
        log(f"  {mc} train losses per step: {losses}; epoch scalars: "
            f"{json.dumps(hist)}")
        # the Dice coefficient is NaN when neither the prediction nor the
        # target holds a flap (the hole is drawn at p = 0.9; both packages'
        # monai semantics): it is not a loss
        if len(losses) != n_train or not all(map(math.isfinite, losses)) \
                or not all(math.isfinite(v) for k, v in hist.items()
                           if not k.endswith("dice_coef")):
            failures.append(f"{mc} training: losses not finite: {losses} "
                            f"{hist}")
        st = dict(train_steps=n_train, eval_steps=1,
                  train_loop_s=m.train_seconds, model_wall_s=wall,
                  losses=losses)
        if device.type == "cuda":
            st["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device)
                                 / 2**30)
            log(f"  {mc} peak device memory over Model's train + test: "
                f"{st['peak_mem_gb']:.2f} GiB")
        saved = checkpoint.restore_checkpoint(m.params["model_path"])
        live = m.state.model.state_dict()
        bad = [k for k in live if not torch.equal(saved["model"][k],
                                                  live[k].cpu())]
        if bad or set(saved["model"]) != set(live) or \
                saved["step"] != n_train:
            failures.append(f"{mc} checkpoint differs from the trained "
                            f"state: {bad}, step {saved['step']}")
        log(f"  {mc} checkpoint {os.path.basename(m.params['model_path'])}:"
            f" {len(live)} tensors reload equal, step {saved['step']}")
        read_masks(os.path.join(data, f"pred_{name}"), paths, shape, affine,
                   failures, sfxs=("fl", "i"))
        del m

        # one train and one eval step counted alone, then the same train
        # step on the plain versions: same initial weights, volume and
        # synthesis draws
        handler = registry.get_problem(params["problem_handler"])()
        at = atlas if handler.append_atlas else None
        loss_cfg = {k: params.get(k) for k in ("ce_lambda", "dice_lambda")}
        vol = torch.from_numpy(nifti_data(os.path.join(
            work, "train", "skull_000.nii.gz"))[None]).to(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            base = build_model(mc).to(device)

        def one_step(impl, n=1, dtype=torch.bfloat16):
            model = copy.deepcopy(base).configure(impl, dtype)
            state = steps.TrainState(model, steps.make_optimizer(
                params, model.parameters()))
            step = steps.make_train_step(model, handler, loss_cfg, atlas=at,
                                         compute_dtype=dtype)
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
        mk, state_k, step_k, gen_k, out_k = one_step("pallas")
        c = kernels.launches()
        grads_k = {n: p.grad.detach().clone()
                   for n, p in mk.named_parameters()}
        per_train = (c["conv3d5_bias_act"], c["conv3d_tc"])
        ev = steps.make_eval_step(mk, handler, loss_cfg, atlas=at,
                                  compute_dtype=torch.bfloat16)
        kernels.reset_launches()
        ev(state_k, {"image": vol}, gen_k)
        c = kernels.launches()
        per_eval = (c["conv3d5_bias_act"], c["conv3d_tc"])
        log(f"  {mc} K5 / conv3d_tc launches: {per_train} per train step "
            f"(want {K5_PER_TRAIN_STEP}), {per_eval} per eval step (want "
            f"{K5_PER_EVAL_STEP})")
        if per_train != (K5_PER_TRAIN_STEP,) * 2 or \
                per_eval != (K5_PER_EVAL_STEP,) * 2:
            failures.append(f"{mc} K5 launches per step {per_train} / "
                            f"{per_eval}")
        mp, _, _, _, out_p = one_step("plain")
        loss_k, loss_p = out_k[0][1], out_p[0][1]
        rel = abs(loss_k - loss_p) / abs(loss_p)
        worst = 0.0
        init = base.state_dict()
        for bname, buf in mk.state_dict().items():
            if not bname.endswith(("running_mean", "running_var")):
                continue
            # batch statistic = (running - 0.9 * initial) / 0.1
            bk = (buf - 0.9 * init[bname]) / 0.1
            bp = (mp.state_dict()[bname] - 0.9 * init[bname]) / 0.1
            tol = 4 * BF16_EPS * float(bp.abs().max().clamp_min(1e-3))
            err = float((bk - bp).abs().max())
            worst = max(worst, err / tol)
            if not err <= tol:
                failures.append(f"{mc} BN batch statistic {bname}: {err} > "
                                f"{tol}")
        # step 1's gradients, leaf by leaf: each K5 dgrad (flip_swap) and
        # each 125-tap weight gradient of the full-size layers lies on some
        # leaf's path. A bf16 step's gradients part from the f32 ones by up
        # to tens of percent at the low-resolution layers (BatchNorm's
        # backward cancels), and two bf16 steps part as far from each
        # other; so the kernel step is held against the plain f32 step, no
        # further from it than twice the plain bf16 step (or 4 bf16 ulps).
        # A conv bias ahead of a train-mode BatchNorm has the exact
        # gradient 0 (the batch mean is subtracted): both sides hold
        # rounding noise there, and it is left out.
        # The cuDNN (xla) bf16 step is measured beside it, not gated.
        mf, _, _, _, _ = one_step("plain", dtype=torch.float32)
        mx, _, _, _, _ = one_step("xla")
        noise = {f"{n}.bias" for n, mod in mp.named_modules()
                 if isinstance(mod, Conv3d) and mod.bias is not None}
        g_worst, g_name, g_kp, x_worst = 0.0, "", 0.0, 0.0
        grads_p = dict(mp.named_parameters())
        grads_x = dict(mx.named_parameters())
        for n, p in mf.named_parameters():
            if n in noise:
                continue
            gf = p.grad.double()
            gk, gp = grads_k[n].double(), grads_p[n].grad.double()
            scale = gf.norm().clamp_min(1e-30)
            ek = float((gk - gf).norm() / scale)
            ep = float((gp - gf).norm() / scale)
            ex = float((grads_x[n].grad.double() - gf).norm() / scale)
            limit = max(2.0 * ep, 4 * BF16_EPS)
            g_kp = max(g_kp, float((gk - gp).norm() / scale))
            x_worst = max(x_worst, ex / limit)
            if ek / limit > g_worst:
                g_worst, g_name = ek / limit, (f"{n} ({ek:.2e} vs {ep:.2e}, "
                                               f"xla {ex:.2e})")
            if not ek <= limit:
                failures.append(f"{mc} step 1 gradient of {n}: relative L2 "
                                f"error to the f32 step {ek} > {limit} "
                                f"(plain bf16 step {ep})")
        log(f"  {mc} step 1 kernels vs plain versions: loss {loss_k:.6f} vs "
            f"{loss_p:.6f} (relative {rel:.2e}, limit 1e-2); BN batch "
            f"statistics worst error / tolerance {worst:.3f}; gradients of "
            f"{len(grads_k) - len(noise)} leaves (the {len(noise)} conv "
            f"biases ahead of a BatchNorm left out) against the plain f32 "
            f"step: worst error / limit {g_worst:.3f} at {g_name} (kernel vs "
            f"plain bf16 step; limit max(2x plain, {4 * BF16_EPS:.2e})); "
            f"kernel vs plain bf16 step at most {g_kp:.2e}; the xla (cuDNN) "
            f"bf16 step's worst error / the same limit {x_worst:.3f}")
        if not rel <= 1e-2:
            failures.append(f"{mc} step loss {loss_k} vs plain {loss_p}: "
                            f"{rel} > 1e-2")
        del mp, mf, mx, grads_k, grads_p, grads_x

        # step time: pallas (K5) and xla (cuDNN), the first step left out
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(time_steps):
            sync(device)
            t = time.perf_counter()
            step_k(state_k, {"image": vol}, gen_k)
            sync(device)
            out_k.append((1e3 * (time.perf_counter() - t), 0.0))
        st["pallas_ms_per_step"] = float(np.mean([t for t, _ in out_k[1:]]))
        if device.type == "cuda":
            st["step_peak_mem_gb"] = (
                torch.cuda.max_memory_allocated(device) / 2**30)
        prof = profile_device(lambda: step_k(state_k, {"image": vol}, gen_k),
                              device, rows=12,
                              what=f"one {mc} pallas train step")
        total = sum(ms for _, ms in prof.values())
        bmm = wgrad_ms(lambda: step_k(state_k, {"image": vol}, gen_k), device)
        st["wgrad_bmm_ms"] = bmm
        st["wgrad_share_of_step"] = bmm / st["pallas_ms_per_step"]
        st["profiled_device_ms"] = total
        synth_ms = time_ms(lambda: handler.synthesize(gen_k, vol[0]), 3,
                           device)
        st["synthesis_ms_per_volume"] = synth_ms
        del mk, state_k, step_k
        _, _, _, _, out_x = one_step("xla", n=time_steps + 1)
        st["xla_ms_per_step"] = float(np.mean([t for t, _ in out_x[1:]]))
        log(f"  {mc} ms/step at batch 1 (host clock around a synchronized "
            f"step, first step left out): pallas "
            f"{st['pallas_ms_per_step']:.1f}, xla (cuDNN) "
            f"{st['xla_ms_per_step']:.1f}; the 18 weight gradients (125 "
            f"tap-shifted bmm each) {bmm:.1f} ms by CUDA events = "
            f"{100 * st['wgrad_share_of_step']:.1f}% of the pallas step "
            f"({total:.1f} ms of device time in the profile); synthesis "
            f"{synth_ms:.1f} ms a volume; peak memory of a pallas step "
            f"{st.get('step_peak_mem_gb', float('nan')):.2f} GiB; xla "
            f"losses {[round(v, 6) for _, v in out_x]}")
        stats[mc] = st
        del base
        log(f"  {mc}: {time.perf_counter() - t0:.1f} s")
    return {"conv3d5_train": k5_total, "conv3d_tc": k5_total}, stats, \
        failures


def prob_check(what, got, ref, failures):
    """The f32 engine's probabilities ``got`` against the plain f32 model's
    ``ref`` over the whole volume: ``|got - ref| <= F32_ATOL + F32_RTOL *
    |ref|`` everywhere (the JAX engine tests' tolerance). Returns
    ``(max |got - ref|, worst error over its allowance)``."""
    import torch

    diff = (got - ref).abs()
    err = float(diff.max())
    worst = float((diff / (F32_ATOL + F32_RTOL * ref.abs())).max())
    if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
        failures.append(f"{what}: f32 engine vs plain f32 model: max abs "
                        f"err {err}, worst err / (atol + rtol |ref|) {worst}")
    return err, worst


def mask_check(what, p_got, p_ref, file_mask, failures):
    """Masks (argmax of two class probabilities ``(..., 2)``) of the f32
    engine against the plain f32 model's at every voxel whose reference
    probabilities lie more than ``F32_ATOL`` from the tie (``|p1 - p0| > 2
    F32_ATOL``), and the engine's mask against the file ``Model`` wrote.
    Returns ``(voxels differing among the decided, undecided voxels)``."""
    import numpy as np
    import torch

    m_got = torch.argmax(p_got, -1)
    m_ref = torch.argmax(p_ref, -1)
    decided = (p_ref[..., 1] - p_ref[..., 0]).abs() > 2 * F32_ATOL
    n_diff = int(((m_got != m_ref) & decided).sum())
    n_open = int((~decided).sum())
    if n_diff:
        failures.append(f"{what}: {n_diff} decided voxels differ from the "
                        "plain f32 model's mask")
    if file_mask is not None and not np.array_equal(
            file_mask, m_got.to(torch.uint8).cpu().numpy()):
        failures.append(f"{what}: Model's file differs from the engine")
    return n_diff, n_open


def serve_f32(device, work: str, shape=SHAPE, n_volumes: int = N_VOLUMES,
              n_train: int = N_TRAIN_F32, bf16=None):
    """Phase 7, f32 serving through ``Model`` (``compute_dtype =
    float32``): UNetSP on ``n_volumes`` volumes, one ``UNet4_2IC`` and one
    ``recAE_v2_fixed`` volume from phase 6's seeded weights, one int8 volume
    with the first encoder block in f32 (``int8_bf16_head = 1``, round to
    nearest), and an f32 training run (``conv_impl = chain``, ``n_train``
    train steps and one eval step) serving one volume from the trained
    weights. Checks the files, the launch counts (every float launch on the
    f32 kernels, none on ``conv3d_tc`` / ``upconv_tc`` outside the int8
    engine's bf16 calibration forward), the f32 engines' probabilities and
    masks against the plain f32 model (TF32 off), the int8 masks against the
    same engine on the plain versions, finite losses. ``bf16``: phases 3
    and 6's stats, printed beside. Returns ``(launches, stats,
    failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, default_params, engine, engine_q,
                                  load_params)
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import chain_conv_train as cct
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import conv3d as kc

    f32 = torch.float32
    bf16 = bf16 or {}
    failures, stats = [], {}
    data, paths, csv, atlas, affine = write_volumes(work, shape, n_volumes)
    csv1 = os.path.join(data, "first.csv")
    with open(csv1, "w") as f:
        f.write(f"image,mask\n{paths[0]},\n")
    vol0 = nifti_data(paths[0])
    base = os.path.basename(paths[0]).replace(".nii.gz", "")
    xt = torch.from_numpy(np.stack([vol0, atlas], -1)[None]).to(device)
    runs = {}  # each Model run's launch counts

    def run_model(params, want, label, n):
        """``Model`` on ``params``; the launch counts against ``want`` (per
        volume, times ``n``)."""
        if device.type != "cuda":
            params["device"] = device.type
        kernels.reset_launches()
        m = Model(params=params)  # ends with the masks fetched to the host
        counts = kernels.launches()
        want = {k: v * n for k, v in want.items()}
        got = {k: counts[k] for k in want}
        log(f"  {label} launches over {n} volume(s): {got} (want {want})")
        if got != want:
            failures.append(f"{label} launch counts {got} != {want}")
        return m, counts

    def loop_stats(m, label, engine_ms, bf16_st):
        st = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                  vol_per_s=m.n_served / m.serve_seconds, engine_ms=engine_ms)
        log(f"  {label} f32: engine {engine_ms:.2f} ms/volume (CUDA events), "
            f"Model loop {st['vol_per_s']:.3f} volumes/s; bf16 "
            f"(this run's phases 3/6): engine "
            f"{bf16_st.get('engine_ms', float('nan')):.2f} ms, loop "
            f"{bf16_st.get('vol_per_s', float('nan')):.3f} volumes/s")
        return st

    # ---- UNetSP, n_volumes volumes ---------------------------------------
    per_vol = {"conv3d_bn_relu": 12, "maxpool2": 4, "upconv_bn_relu": 4,
               "conv3d_f32": 12, "conv3d_tc_f32": 12, "maxpool2_f32": 4,
               "upconv_f32": 4, "upconv_tc_f32": 4, "conv3d_tc": 0,
               "upconv_tc": 0, "maxpool2_rows": 4}
    m, counts = run_model(dict(
        test_flag=True, name="chip_smoke_f32", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut", device=device.type,
        workspace_path=os.path.join(work, "ws"), test_files_csv=csv,
        resume_model=UNETSP_10K, n_workers=2, prefetch_depth=2,
        compute_dtype="float32"), per_vol, "UNetSP f32", n_volumes)
    runs["UNetSP"] = counts
    masks = read_masks(os.path.join(data, "pred_chip_smoke_f32"), paths,
                       shape, affine, failures)
    sd = load_any(UNETSP_10K)
    k_pred = engine.build_predict("UNetSP", sd, f32, device)
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    model.configure("xla", f32)
    with torch.inference_mode():
        got, ref = k_pred(xt), model(xt)
    st = {}
    for i, sfx in enumerate(("sk", "fl")):
        g, r = got[i][0], ref[i][0]
        err, worst = prob_check(f"UNetSP {sfx}", g, r, failures)
        n_diff, n_open = mask_check(f"UNetSP {sfx}", g, r,
                                    masks.get((base, sfx)), failures)
        log(f"  UNetSP f32 {sfx}: max |p - p_plain f32 model| {err:.3e} "
            f"(worst / allowance {worst:.3f}); masks: {n_diff} decided "
            f"voxels differ, {n_open} within {2 * F32_ATOL:g} of the tie "
            "left out")
        st.update({f"{sfx}_max_err": err, f"{sfx}_worst": worst,
                   f"{sfx}_undecided": n_open})
    del got, ref, model
    st.update(loop_stats(m, "UNetSP", time_ms(lambda: k_pred(xt), 3, device),
                         bf16.get(3, {})))
    profile_device(lambda: k_pred(xt), device, what="one UNetSP f32 volume")
    stats["UNetSP"] = st
    del k_pred

    # ---- the legacy models, one volume each -------------------------------
    for mc in ("UNet4_2IC", "recAE_v2_fixed"):
        cin = 2 if mc == "UNet4_2IC" else 1
        x = xt[..., :cin].contiguous()
        w, model, share = legacy_weights(mc, x, seed=17)
        model.configure("xla", f32)
        pt = os.path.join(work, f"{mc}.pt")
        torch.save(w, pt)
        params = load_params(LEGACY_INIS[mc], default_params())
        params.update(train_flag=False, test_flag=True,
                      name=f"chip_smoke_f32_{mc}",
                      workspace_path=os.path.join(work, "ws"),
                      test_files_csv=csv1, resume_model=pt, n_workers=2,
                      compute_dtype="float32")
        want = {"conv3d5_bias_act": 18, "maxpool2": 4, "convt_k2s2": 1,
                "convt_k2s2_dual": 3, "conv3d5_f32": 18,
                "conv3d_tc_f32": 18, "maxpool2_f32": 4, "convt_f32": 4,
                "upconv_tc_f32": 4, "conv3d_tc": 0, "upconv_tc": 0,
                "maxpool2_rows": 4}
        m, counts = run_model(params, want, f"{mc} f32", 1)
        runs[mc] = counts
        masks = read_masks(os.path.join(data, f"pred_chip_smoke_f32_{mc}"),
                           paths[:1], shape, affine, failures,
                           sfxs=("fl", "i"))
        k_pred = engine.build_predict(mc, w, f32, device)
        with torch.inference_mode():
            g, r = k_pred(x)[0], model(x)[0]
        err, worst = prob_check(mc, g, r, failures)
        n_diff, n_open = mask_check(mc, g, r, masks.get((base, "fl")),
                                    failures)
        log(f"  {mc} f32 (class-1 share {share:.4f}): max |p - p_plain f32 "
            f"model| {err:.3e} (worst / allowance {worst:.3f}); masks: "
            f"{n_diff} decided voxels differ, {n_open} within "
            f"{2 * F32_ATOL:g} of the tie left out")
        st = dict(max_err=err, worst=worst, undecided=n_open)
        del g, r, model
        st.update(loop_stats(m, mc, time_ms(lambda: k_pred(x), 3, device),
                             bf16.get(6, {}).get(mc, {})))
        st["breakdown_ms"] = launch_breakdown(mc, w, x, device, f32)
        stats[mc] = st
        del k_pred

    # ---- int8 with its first encoder block in f32, one volume -------------
    params = load_params(INT8_INI, default_params())
    params.update(name="chip_smoke_f32_int8", fg_crop=False, serve_scan=1,
                  workspace_path=os.path.join(work, "ws"),
                  test_files_csv=csv1, resume_model=UNETSP_10K,
                  int8_adaquant=False, int8_bf16_head=1,
                  compute_dtype="float32")
    # the calibration forward runs the bf16 engine, as the JAX package's
    # does: 12 conv3d_tc, 4 maxpool2 and 4 upconv_tc launches, then the
    # served volume
    want = {"conv3d_f32": 2, "conv3d_tc_f32": 2, "maxpool2_f32": 0,
            "upconv_f32": 0, "upconv_tc_f32": 0, "conv3d_q_requant": 10,
            "maxpool2_q": 4,
            "upconv_q_requant": 4, "conv3d_tc_q": 10, "upconv_tc_q": 4,
            "conv3d_tc": 12, "upconv_tc": 4, "maxpool2_rows": 8}
    m, counts = run_model(params, want, "int8 f32 head", 1)
    runs["int8"] = counts
    masks = read_masks(os.path.join(data, "pred_chip_smoke_f32_int8"),
                       paths[:1], shape, affine, failures)
    qfn = m.int8_engines.get(shape + (2,))
    st = {}
    if qfn is None:
        failures.append(f"no int8 engine was built: {m.int8_engines}")
    else:
        plain_q = engine_q.build_predict_q(
            "UNetSP", sd, xt[0], f32, device, plain=True, bf16_head=1,
            import_scales=qfn.scales, round_opt=qfn.round_opt)
        with torch.inference_mode():
            got, ref = qfn(xt), plain_q(xt)
        for i, sfx in enumerate(("sk", "fl")):
            g, r = got[i][0].float(), ref[i][0].float()
            decided = (((g[..., 1] - g[..., 0]).abs() > DECIDED)
                       & ((r[..., 1] - r[..., 0]).abs() > DECIDED))
            mg = torch.argmax(g, -1).to(torch.uint8).cpu().numpy()
            mr = torch.argmax(r, -1).to(torch.uint8).cpu().numpy()
            dec = decided.cpu().numpy()
            d = dice(mg[dec], mr[dec])
            file_mask = masks.get((base, sfx))
            if file_mask is None or not np.array_equal(file_mask, mg):
                failures.append(f"int8 f32 {sfx}: Model's file differs from "
                                "the engine")
            if not (bool(torch.isfinite(g).all()) and d >= 0.999):
                failures.append(f"int8 f32 {sfx}: Dice on decided voxels "
                                f"{d} < 0.999 or non-finite")
            log(f"  int8 f32 head {sfx}: Dice vs the same engine on the "
                f"plain versions {d:.6f} over the {int(dec.sum())} voxels "
                f"both decide ({int((~dec).sum())} left out), raw "
                f"{dice(mg, mr):.6f}; max |p - p_plain| "
                f"{float((g - r).abs().max()):.3e}")
            st[f"dice_{sfx}"] = d
        # the int8 codes at the f32 -> int8 switch (the first block's f32
        # output at its scale) that each f32 conv moves against the plain
        # version: what moves the Dice above
        l0, l1 = qfn.layers["d0.0"], qfn.layers["d0.1"]
        s_sw = np.asarray(qfn.scales["d0.1"][1], np.float32)  # as to_int8
        inv = torch.tensor((1.0 / s_sw[:l1[0].shape[-1]]).astype(np.float32),
                           device=device)

        def f64_conv(x, w, b):
            y = torch.nn.functional.conv3d(
                x.double().permute(3, 0, 1, 2)[None],
                w.double().permute(4, 3, 0, 1, 2), padding=1)[0]
            return torch.relu(y.permute(1, 2, 3, 0) + b.double()).float()

        def codes(conv):
            with torch.inference_mode():
                h = conv(conv(xt[0], *l0).contiguous(), *l1)
                return torch.round(torch.clamp(h * inv, 0.0, 255.0))

        ref_codes = codes(kc.conv3d_bn_relu_plain)
        moved = {name: int((codes(fn) != ref_codes).sum()) for name, fn in (
            ("conv3d_tc_f32", kc.conv3d_bn_relu),
            ("direct", lambda x, w, b: kc.conv3d_bias_act_direct(x, w, b,
                                                                 True)),
            ("f64", f64_conv))}
        log(f"  int8 f32 head: int8 codes at the switch moved against the "
            f"plain version (of {ref_codes.numel()}): {moved}")
        st["codes_moved"] = moved
        del ref_codes
        st["engine_ms"] = time_ms(lambda: qfn(xt), 3, device)
        log(f"  int8 f32 head engine {st['engine_ms']:.2f} ms/volume")
        del got, ref, plain_q
    stats["int8_f32_head"] = st
    del qfn, m

    # ---- f32 training, then one volume served from it ---------------------
    train_csv = make_dataset(os.path.join(work, "train"), n=n_train,
                             shape=shape, seed=40)
    val_csv = make_dataset(os.path.join(work, "val"), n=1, shape=shape,
                           seed=80)
    params = load_params(TRAIN_INI, default_params())
    params.update(
        name="chip_smoke_f32_train", conv_impl="chain", n_epochs=1,
        autosave_epochs=0, workspace_path=os.path.join(work, "ws"),
        train_files_csv=train_csv, validation_files_csv=val_csv,
        test_files_csv=csv1, resume_model="", log_every=1,
        compute_dtype="float32")
    k6 = n_train * K6_PER_TRAIN_STEP + K6_PER_EVAL_STEP
    want = {"conv3d_bias_act": k6, "conv3d_f32": k6 + 12,
            "conv3d_tc_f32": k6 + 12, "conv3d_bn_relu": 12, "maxpool2": 4,
            "maxpool2_f32": 4, "upconv_bn_relu": 4, "upconv_f32": 4,
            "upconv_tc_f32": 4, "conv3d_tc": 0, "upconv_tc": 0,
            "maxpool2_rows": 4}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    m, counts = run_model(params, want, "f32 training", 1)
    wall = time.perf_counter() - t0
    runs["train"] = counts
    losses = [float(v) for v in m.step_losses]
    hist = {k: v[-1][1] for k, v in m.writer.history.items()}
    if len(losses) != n_train or not all(map(math.isfinite, losses)) or not \
            all(math.isfinite(v) for v in hist.values()):
        failures.append(f"f32 training: losses not finite: {losses} {hist}")
    if not os.path.isfile(m.params["model_path"]):
        failures.append("f32 training: no checkpoint "
                        f"{m.params['model_path']}")
    read_masks(os.path.join(data, "pred_chip_smoke_f32_train"), paths[:1],
               shape, affine, failures)
    st = dict(losses=losses, model_wall_s=wall, train_loop_s=m.train_seconds)
    if device.type == "cuda":
        st["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"  f32 training: losses {losses}, epoch scalars {json.dumps(hist)}; "
        f"Model train + eval + test {wall:.1f} s; peak device memory "
        f"{st.get('peak_mem_gb', float('nan')):.2f} GiB")
    # the weight packing of conv3d_tc_f32 that one f32 train step makes: the
    # 16 forward kernels (written by every optimizer step) and the 15
    # flipped, channel-swapped input-gradient kernels (a new tensor each
    # call), at their layers' plans
    lv = [tuple(n >> i for n in shape) for i in range(5)]
    packs = []
    for i, (ci, co, level, _) in enumerate(unetsp_convs()):
        wt = torch.randn(3, 3, 3, ci, co, device=device)
        packs.append((wt, kc.tcf_plan(lv[level], ci, co, 3)))
        if i:
            packs.append((cct.flip_swap(wt), kc.tcf_plan(lv[level], co, ci,
                                                         3)))
    st["pack_ms_per_step"] = time_ms(
        lambda: [kc.pack_tcf_weights(wt, p) for wt, p in packs], 5, device)
    st["train_s_per_step"] = m.train_seconds / n_train
    log(f"  f32 training: conv3d_tc_f32 weight packing {len(packs)} tensors "
        f"a step, {st['pack_ms_per_step']:.3f} ms (CUDA events), beside "
        f"{1e3 * st['train_s_per_step']:.1f} ms a train step (host clock "
        "over the Model's train loop)")
    del packs
    stats["train_f32"] = st

    def total(key):
        return sum(c[key] for c in runs.values())

    # per wrapper in f32 (K1 and K6 share conv3d_f32; only training runs K6;
    # K1, K6 and K5 all launch conv3d_tc_f32, K3, K7a and K7b upconv_tc_f32)
    launches = {
        "conv3d_tc_f32": total("conv3d_tc_f32"),
        "upconv_tc_f32": total("upconv_tc_f32"),
        "conv3d_bn_relu_f32": total("conv3d_f32") - total("conv3d_bias_act"),
        "conv3d_bias_act_f32": total("conv3d_bias_act"),
        "maxpool2_f32": total("maxpool2_f32"),
        "maxpool2_rows": total("maxpool2_rows"),
        "upconv_bn_relu_f32": total("upconv_f32"),
        "conv3d5_bias_act_f32": total("conv3d5_f32"),
        "convt_k2s2_f32": total("convt_k2s2"),
        "convt_k2s2_dual_f32": total("convt_k2s2_dual"),
    }
    log(f"  f32 launches of phase 7 by wrapper: {launches}")
    return launches, stats, failures


@functools.lru_cache(maxsize=None)
def fg_skulls(shape=SHAPE, complete: bool = False):
    """Phase 9's skulls (:data:`FG_SKULLS`) at ``shape``: broken (a cap
    removed) or complete, uint8."""
    from ctunet_tpu_torch.data import spherical_shell

    # the centres scale with the canvas (a smaller one rehearses the phase)
    skulls = [(r, tuple(c * n / m for c, n, m in zip(cen, shape, SHAPE)))
              for r, cen in FG_SKULLS]
    if complete:
        return tuple(spherical_shell(shape, radius_frac=r, center=c)
                     for r, c in skulls)
    return tuple(punched_shell(shape, FG_SEED + i, r, c)
                 for i, (r, c) in enumerate(skulls))


def fg_expect(vols, margin: int, multiple: int, scan: int):
    """Where the serving loop must serve ``vols`` under ``b_fg_crop`` and
    ``i_serve_scan`` = ``scan``, worked out here from ``ops.foreground``'s
    planner alone: groups of ``scan`` volumes share the running maximum of
    their plans' sizes, each volume cut at its plan's offsets clamped into
    the canvas; a new window's first volume is served alone (and builds
    its engine), the rest of the group in one batch. Returns ``([(offsets,
    size)] per volume, [batch sizes], [window sizes built])``."""
    from ctunet_tpu_torch.ops import foreground

    plans = [foreground.plan_crop(v, margin=margin, multiple=multiple)
             for v in vols]
    assert len(vols) % scan == 0 and all(plans), plans
    canvas = vols[0].shape
    size, wins, batches, built = (0, 0, 0), [], [], []
    for g in range(0, len(vols), scan):
        group = plans[g:g + scan]
        new = tuple(min(c, max([size[a]] + [p[1][a] for p in group]))
                    for a, c in enumerate(canvas))
        if new != size:
            built.append(new)
        batches.append(scan - (new != size))
        size = new
        wins += [(tuple(min(o, c - s) for o, c, s in zip(p[0], canvas, size)),
                  size) for p in group]
    return wins, batches, built


def fg_atlas(shape=SHAPE):
    """Phase 9's atlas: a shell registered to its skulls (their mean
    radius and centre), as a dataset is registered to its atlas. The
    canvas-centred 0.42 shell of the other phases lies outside these
    skulls' windows, and the whole-volume model follows it there."""
    import numpy as np

    from ctunet_tpu_torch.data import spherical_shell

    r = float(np.mean([r for r, _ in FG_SKULLS]))
    c = np.mean([c for _, c in FG_SKULLS], 0) * np.asarray(shape) / SHAPE
    return spherical_shell(shape, radius_frac=r, center=tuple(c)).astype(
        np.float32)


def fg_windows(shape=SHAPE):
    """(phase 9's int8 serving window, its fg-crop training window)."""
    from ctunet_tpu_torch import default_params, load_params, steps

    ini = load_params(INT8_INI, default_params())
    _, _, built = fg_expect(fg_skulls(shape), int(ini["fg_margin"]), 16,
                            int(ini["serve_scan"]))
    margin = int(load_params(TRAIN_INI, default_params())["fg_margin"])
    train = steps.fg_crop_size_for(
        fg_skulls(shape, True)[:FG_TRAIN_STEPS + 1], shape, margin=margin,
        multiple=16)
    return built[0], train


def check_windows(sd, device, shape=SHAPE):
    """The kernels at the launch shapes of phase 9's windows (both from
    :func:`fg_windows`): K1q and K3q (:func:`check_kernels_q`, exact), K2
    in bf16 and K2q (exact), the bf16 K1 and K3 of the int8 engine's
    calibration forward at the serving window, and K6 (forward and input
    gradients, within ``bf16_tol``) at the training window; each with its
    time, the direct kernel's, the plain version's, cuDNN's where it takes
    the dtype, and the bound. Returns ``({}, failures)``: the kernel line's
    rows stay those of the full canvas."""
    serve_w, train_w = fg_windows(shape)
    log(f"  phase 9's windows: int8 serving {serve_w}, fg-crop training "
        f"{train_w}")
    failures = []
    pools = {k: v for k, v in pool_shapes().items()
             if k[0] in ("bf16", "int8") and "UNetSP" in v}
    k1 = {k: {"K1/volume": v["K1/volume"]} for k, v in
          conv_tc_shapes().items() if "K1/volume" in v}
    k6 = {k: {"K6/step": v["K6/step"]} for k, v in conv_tc_shapes().items()
          if "K6/step" in v}
    k3 = [r for r in upconv_tc_shapes() if r[0] == "upconv_bn_relu"]
    for check in (lambda: check_kernels_q(sd, device, serve_w),
                  lambda: check_pool(device, serve_w, rows=pools,
                                     extras=False),
                  lambda: check_conv_tc(device, serve_w, rows=k1),
                  lambda: check_upconv_tc(sd, device, serve_w, rows=k3),
                  lambda: check_conv_tc(device, train_w, rows=k6)):
        failures += check()[1]
    return {}, failures


def fg_crop(device, work: str, shape=SHAPE, before=None):
    """Phase 9: ``Model`` with the settings of
    ``examples/UNetSPDO/FlapRecSP2O_serve_int8.ini`` as written (int8 with
    AdaQuant, ``b_fg_crop``, ``i_fg_margin`` 24, ``i_serve_scan`` 4) and
    ``b_serve_profile`` on the 8 broken skulls of :data:`FG_SKULLS`, then
    fg-crop training (:func:`train_fg`). Serving checks: the windows, batches
    and builds that :func:`fg_expect` predicts; the files; 12 K1q, 4 K2q
    and 4 K3q per volume, each on its kernel; the masks against the same
    int8 engine on the plain versions and against the same engine called
    volume by volume at the same window, pasted the loop's way; Dice
    against the plain f32 model on the whole volume, on the calibration
    volume (as phase 4) and pooled over the volumes. The atlas is
    registered to these skulls (:func:`fg_atlas`). ``before``: the
    earlier phases' stats, for phase 4's engine time. Returns ``(launches,
    stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, default_params, engine_q,
                                  load_params)
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data.atlas import register_atlas
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import foreground, kernels
    from ctunet_tpu_torch.trainer import paste_window
    from ctunet_tpu_torch.utils import nifti

    failures = []
    vols = fg_skulls(shape)
    n = len(vols)
    data = os.path.join(work, "data")
    os.makedirs(data)
    affine = np.diag([0.5, 0.45, 0.45, 1.0])
    paths = []
    for i, v in enumerate(vols):
        paths.append(os.path.join(data, f"skull_{i:03d}.nii.gz"))
        nifti.write(paths[-1], nifti.NiftiImage(v, affine))
    csv = os.path.join(data, "files.csv")
    with open(csv, "w") as f:
        f.write("image,mask\n" + "".join(f"{p},\n" for p in paths))
    atlas = fg_atlas(shape)
    register_atlas(shape, atlas)
    params = load_params(INT8_INI, default_params())
    ini = {k: params[k] for k in ("use_int8", "int8_adaquant", "fg_crop",
                                  "fg_margin", "serve_scan")}
    if ini != dict(use_int8=True, int8_adaquant=True, fg_crop=True,
                   fg_margin=24, serve_scan=4):
        failures.append(f"{INT8_INI} no longer sets {ini}")
    wins, batches, built = fg_expect(vols, ini["fg_margin"], 16,
                                     ini["serve_scan"])
    log(f"  expected: windows {sorted(set(w[1] for w in wins))}, offsets "
        f"{[w[0] for w in wins]}, K-batches {batches}, int8 builds {built}")
    params.update(
        name="chip_smoke_fg", workspace_path=os.path.join(work, "ws"),
        test_files_csv=csv, resume_model=UNETSP_10K,
        int8_adaquant_steps=ADAQUANT_STEPS, serve_profile=True)
    if device.type != "cuda":
        params["device"] = device.type
    want = {"conv3d_q_requant": 12 * n, "maxpool2_q": 4 * n,
            "upconv_q_requant": 4 * n, "conv3d_tc_q": 12 * n,
            "upconv_tc_q": 4 * n}
    kernels.reset_launches()
    m = Model(params=params)
    counts = kernels.launches()
    launches = {k: counts[k] for k in want}
    log(f"  launches over {n} volumes: {counts} (int8 want {want}; the bf16 "
        "ones are the calibration forward)")
    if launches != want:
        failures.append(f"fg int8 launch counts {launches} != {want}")
    launches["maxpool2_rows"] = counts["maxpool2_rows"]
    if counts["maxpool2_rows"] != counts["maxpool2_q"] + counts["maxpool2"]:
        failures.append("fg: maxpool2_rows launches are not K2q + K2's")
    shapes = sorted(m.int8_engines)
    log(f"  int8 engines built for {shapes} (AdaQuant searched on "
        f"{m.int8_hint_shapes}) in {m.int8_build_seconds:.1f} s; K-batches "
        f"{m.scan_batches}")
    if shapes != [b + (2,) for b in built] or m.scan_batches != batches:
        failures.append(f"fg: engines {shapes} / batches {m.scan_batches}, "
                        f"want {built} / {batches}")
    build_s = m.int8_build_seconds
    stats = dict(volumes=m.n_served, loop_s=m.serve_seconds, build_s=build_s,
                 window=list(built[0]) if built else None,
                 hint=m.int8_hint_shapes.get(shapes[0]) if shapes else None,
                 batches=m.scan_batches, profile_s=m.serve_profile_s,
                 vol_per_s=m.n_served / m.serve_seconds,
                 vol_per_s_after_build=m.n_served / (m.serve_seconds
                                                     - build_s))
    log(f"  Model test loop: {m.n_served} volumes in {m.serve_seconds:.3f} s "
        f"= {stats['vol_per_s']:.3f} volumes/s, of which the int8 build "
        f"{build_s:.3f} s; without it {stats['vol_per_s_after_build']:.3f} "
        f"volumes/s; serving profile (s): {json.dumps(m.serve_profile_s)}")
    masks = read_masks(os.path.join(data, "pred_chip_smoke_fg"), paths,
                       shape, affine, failures)
    qfn = m.int8_engines.get(shapes[0]) if shapes else None
    if qfn is None:
        failures.append(f"fg: no int8 engine was built: {m.int8_engines}")
        return launches, stats, failures

    # the references: the same int8 engine on the plain versions and called
    # volume by volume, at each volume's window, pasted as the loop pastes;
    # the plain f32 model on the whole volume
    sd = load_any(UNETSP_10K)
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    at = torch.from_numpy(atlas).to(device)
    plain_q = None
    floors = {"sk": 0.98, "fl": 0.95}
    dices = {"sk": [], "fl": []}
    pooled = {"sk": [0, 0], "fl": [0, 0]}  # 2 |a & b|, |a| + |b|
    crop_only = {"sk": [], "fl": []}  # the f32 model on the window
    outside = 0
    same = {"plain": True, "single": True}
    for i, (p, v, (offs, size)) in enumerate(zip(paths, vols, wins)):
        base = os.path.basename(p).replace(".nii.gz", "")
        sl = foreground.crop_slices(offs, size)
        full = torch.from_numpy(v).to(device, torch.float32)
        x = torch.stack([full[sl], at[sl]], -1)[None].to(torch.bfloat16)
        if plain_q is None:
            plain_q = engine_q.build_predict_q(
                "UNetSP", sd, x[0], device=device, plain=True,
                import_scales=qfn.scales, round_opt=qfn.round_opt)
        x32 = torch.stack([full, at], -1)[None]
        with torch.inference_mode():
            outs = {"plain": plain_q(x), "single": qfn(x), "f32": model(x32),
                    "f32_window": model(x32[0][sl][None].contiguous())}
        for j, sfx in enumerate(("sk", "fl")):
            got = masks.get((base, sfx))
            ref = torch.argmax(outs["f32"][j][0], -1).to(torch.uint8)
            ref = ref.cpu().numpy()
            for k in ("plain", "single"):
                win = torch.argmax(outs[k][j], -1).to(torch.uint8)
                pasted = paste_window(win.cpu().numpy(), v[None], offs,
                                      shape)[0]
                if got is None or not np.array_equal(got, pasted):
                    same[k] = False
                    failures.append(f"fg {base} {sfx}: Model's file differs "
                                    f"from the {k} engine's window")
            win32 = torch.argmax(outs["f32_window"][j], -1).to(torch.uint8)
            crop_only[sfx].append(dice(paste_window(
                win32.cpu().numpy(), v[None], offs, shape)[0], ref))
            if got is not None:
                dices[sfx].append(dice(got, ref))
                pooled[sfx][0] += 2 * int(((got > 0) & (ref > 0)).sum())
                pooled[sfx][1] += int((got > 0).sum()) + int((ref > 0).sum())
                out = np.ones(shape, bool)
                out[sl] = False
                outside += int((ref[out] != got[out]).sum())
        del full, x, x32, outs
    # phase 4's floors, held as phase 4 holds them (on the volume the
    # engine was calibrated on) and over all the volumes served (pooled);
    # each volume's Dice is logged
    for sfx, floor in floors.items():
        calib = dices[sfx][0] if dices[sfx] else float("nan")
        over = pooled[sfx][0] / max(pooled[sfx][1], 1)
        stats.update({f"dice_{sfx}_calib": calib, f"dice_{sfx}_pooled": over,
                      f"dice_{sfx}_min": min(dices[sfx], default=None),
                      f"dice_{sfx}_f32_window_min": min(crop_only[sfx])})
        log(f"  fg {sfx}: Dice vs the plain f32 model on the whole volume: "
            f"calibration volume {calib:.6f}, all {n} pooled {over:.6f} "
            f"(floor {floor} for both); per volume "
            f"{[round(d, 6) for d in dices[sfx]]}; the f32 model on the same "
            f"windows, pasted the same way: "
            f"{[round(d, 6) for d in crop_only[sfx]]}")
        for what, d in (("calibration volume", calib), ("pooled", over)):
            if not d >= floor:
                failures.append(f"fg {sfx}: Dice vs the f32 model ({what}) "
                                f"{d} < {floor}")
    log(f"  files identical to the plain-version int8 engine: "
        f"{same['plain']}; K-batch masks identical to per-volume dispatch: "
        f"{same['single']}; voxels outside the windows where the f32 model "
        f"disagrees with the fill class: {outside} (of "
        f"{2 * n * math.prod(shape)})")
    stats["outside_disagree"] = outside
    x0 = torch.stack([torch.from_numpy(vols[0]).to(device, torch.float32)[
        foreground.crop_slices(*wins[0])], at[foreground.crop_slices(
            *wins[0])]], -1)[None].to(torch.bfloat16)
    stats["engine_ms"] = time_ms(lambda: qfn(x0), 3, device)
    whole = (before or {}).get(4, {}).get("engine_ms")
    log(f"  int8 engine at the window {wins[0][1]}: {stats['engine_ms']:.2f} "
        f"ms/volume (phase 4, whole 224x304x304: "
        f"{'not run' if whole is None else f'{whole:.2f} ms'}); "
        f"{card_line() if device.type == 'cuda' else 'no card'}")
    stats["busy_share"] = (stats["engine_ms"] * m.n_served
                           / (1e3 * (m.serve_seconds - build_s)))
    del plain_q, model, x0

    got, tstats, errs = train_fg(device, work, shape, before)
    failures += errs
    stats["train"] = tstats
    launches.update(got)
    return launches, stats, failures


def train_fg(device, work: str, shape=SHAPE, before=None,
             n_train: int = FG_TRAIN_STEPS, time_steps: int = 3):
    """Phase 9's fg-crop training: ``Model`` with the training settings of
    ``examples/UNetSPDO/FlapRecSP2O.ini``, ``conv_impl = "chain"`` and
    ``b_fg_crop_train`` on complete skulls of :data:`FG_SKULLS` (``n_train``
    train volumes, 1 validation volume): ``n_train`` train steps and 1 eval
    step on the window it plans. Checks: finite losses, ``fg_lost_voxels``
    0, K6 launches 31 a train step and 16 an eval step (each a
    ``conv3d_tc`` launch), the checkpoint written; then the ms per step at
    the window beside phase 5's whole-canvas ``chain`` step. Returns
    ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, default_params, load_params, steps
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
    from ctunet_tpu_torch.utils import nifti

    failures = []
    vols = fg_skulls(shape, complete=True)
    csvs = []
    for sub, idx in (("fg_train", range(n_train)), ("fg_val", [n_train])):
        folder = os.path.join(work, sub)
        os.makedirs(folder)
        rows = []
        for i in idx:
            rows.append(os.path.join(folder, f"skull_{i:03d}.nii.gz"))
            nifti.write(rows[-1], nifti.NiftiImage(vols[i], np.eye(4)))
        csvs.append(os.path.join(folder, "files.csv"))
        with open(csvs[-1], "w") as f:
            f.write("image,mask\n" + "".join(f"{p},\n" for p in rows))
    params = load_params(TRAIN_INI, default_params())
    params.update(
        name="chip_smoke_fg_train", conv_impl="chain", n_epochs=1,
        autosave_epochs=0, test_flag=False, fg_crop_train=True,
        workspace_path=os.path.join(work, "ws_train"),
        train_files_csv=csvs[0], validation_files_csv=csvs[1],
        resume_model="", log_every=1)
    if device.type != "cuda":
        params["device"] = device.type
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = Model(params=params)
    sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    k6 = n_train * K6_PER_TRAIN_STEP + K6_PER_EVAL_STEP
    want = {"conv3d_bias_act": k6, "conv3d_tc": k6}
    launches = {k: counts[k] for k in want}
    losses = [float(v) for v in m.step_losses]
    hist = {k: v[-1][1] for k, v in m.writer.history.items()}
    log(f"  fg-crop training on {m.fg_train_size}: launches {launches} (want "
        f"{want}); losses {losses}; epoch scalars {json.dumps(hist)}")
    if launches != want:
        failures.append(f"fg training launch counts {launches} != {want}")
    if len(losses) != n_train or not all(
            math.isfinite(v) for v in losses + list(hist.values())):
        failures.append(f"fg training: losses not finite {losses} {hist}")
    lost = [hist.get(f"{ph}/epoch/fg_lost_voxels") for ph in ("train", "val")]
    if lost != [0, 0]:
        failures.append(f"fg training: fg_lost_voxels {lost} != 0")
    if not os.path.exists(m.params["model_path"]):
        failures.append(f"fg training: no checkpoint {m.params['model_path']}")
    stats = dict(window=list(m.fg_train_size or ()),
                 train_loop_s=m.train_seconds, model_wall_s=wall,
                 losses=losses, fg_lost=lost)

    # ms per step at the window, as phase 5 times its whole-canvas step
    handler = FlapRecWithShapePriorDoubleOut()
    step = steps.make_train_step(
        m.state.model, handler,
        {k: params.get(k) for k in ("ce_lambda", "dice_lambda")},
        atlas=m._atlas, compute_dtype=torch.bfloat16,
        fg_crop_size=m.fg_train_size, fg_margin=int(params["fg_margin"]))
    vol = torch.from_numpy(vols[0][None].astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    times = []
    for _ in range(time_steps + 1):
        sync(device)
        t = time.perf_counter()
        step(m.state, {"image": vol}, gen)
        sync(device)
        times.append(1e3 * (time.perf_counter() - t))
    stats["chain_ms_per_step"] = float(np.mean(times[1:]))
    whole = (before or {}).get(5, {}).get("chain_ms_per_step")
    log(f"  fg-crop chain step at {m.fg_train_size}: "
        f"{stats['chain_ms_per_step']:.1f} ms (phase 5, whole 224x304x304: "
        f"{'not run' if whole is None else f'{whole:.1f} ms'}; host clock "
        "around a synchronized step, first left out)")
    return launches, stats, failures


def small_rows():
    """Every launch shape of phase 10's UNetSPSmall (``SMALL_WIDTHS``) for
    the phase-2 checks: ``(pools, convs, k3, f32)``: K2 (bf16, f32) and K2q
    per volume; the bf16 k=3 convs, K1 per volume (15) and K6 per train
    step (20 forward + 19 input gradients); K3 per volume (decoder block j
    from level 5 - j); the f32 K1 and K3 per f32 volume."""
    pools = {(dt, c, lv): {"UNetSPSmall": 1}
             for dt in ("bf16", "f32", "int8")
             for lv, c in enumerate(SMALL_WIDTHS)}
    convs, f32 = {}, {}

    def add(rows, key, path):
        rows.setdefault(key, {}).setdefault(path, 0)
        rows[key][path] += 1

    for i, (ci, co, lv, served) in enumerate(unetsp_convs(SMALL_WIDTHS)):
        if served:
            add(convs, (3, ci, co, lv), "K1/volume")
            add(f32, ("conv3d_bn_relu", ci, co, lv), "UNetSPSmall")
        add(convs, (3, ci, co, lv), "K6/step")
        if i:
            add(convs, (3, co, ci, lv), "K6/step")
    n = len(SMALL_WIDTHS)
    k3 = [("upconv_bn_relu", j, None, None, n - j, "UNetSPSmall")
          for j in range(n)]
    for name, j, _, _, lv, path in k3:
        add(f32, (name, j, None, None, lv), path)
    return pools, dict(sorted(convs.items())), k3, f32


def check_512(device, shape=SHAPE_512):
    """The kernels at every launch shape of phase 10 (:func:`small_rows`,
    UNetSPSmall at ``shape``): K2 / K2q (equal by value), the bf16 K1 and
    K6 forward and input gradients and K3 (within ``bf16_tol``), K1q and
    K3q (exact, on layers quantized from a calibration of UNetSPSmall on
    one synthetic volume), the f32 K1 and K3 (within ``f32_tol``), with the
    trained ``unetspsmall_3k`` decoder in every K3; each timed beside the
    direct kernel, the plain version, the library call where it takes the
    dtype, and the bound. Returns ``(entries, failures)``, each entry
    keyed ``name + AT_512`` (the kernel line gives phase 10 rows of their
    own): every wrapper at its first shape, and each kernel function at
    the first shape of the wrapper that launches it (:data:`KERNEL_OF`)."""
    from ctunet_tpu_torch.checkpoint import UNETSPSMALL_3K, load_any

    sd = load_any(UNETSPSMALL_3K)
    pools, convs, k3, f32 = small_rows()
    entries, failures = {}, []
    for check in (
            lambda: check_pool(device, shape, rows=pools, extras=False),
            lambda: check_conv_tc(device, shape, rows=convs),
            lambda: check_upconv_tc(sd, device, shape, rows=k3),
            lambda: check_kernels_q(sd, device, shape,
                                    model_class="UNetSPSmall",
                                    widths=SMALL_WIDTHS),
            lambda: check_kernels_f32(sd, device, shape, rows=f32)):
        got, errs = check()
        for k, v in got.items():
            entries.setdefault(k, v)
        failures += errs
    for kernel, wrapper in KERNEL_OF.items():
        if wrapper in entries:
            entries.setdefault(kernel, entries[wrapper])
    return {k + AT_512: v for k, v in entries.items()}, failures


def adam_leaves(model_class: str, param_dtype=None):
    """The element counts of ``model_class``'s f32 leaves, in order, with
    its parameters in ``param_dtype`` (BatchNorm's stay f32)."""
    import torch

    from ctunet_tpu_torch.models import build_model

    model = build_model(model_class, param_dtype or torch.float32)
    return [p.numel() for p in model.parameters()
            if p.dtype == torch.float32]


def adam_launches(model_class: str, param_dtype=None) -> int:
    """``adam_mt`` launches in one ``adam`` train step of ``model_class``
    on the card: one per table of ``adam.pack`` over its f32 leaves."""
    from ctunet_tpu_torch.ops.kernels import adam

    return len(adam.pack(adam_leaves(model_class, param_dtype)))


def check_adam(device, reps: int = 200, reps_plain: int = 10,
               n_steps: int = 3):
    """``adam.adam_mt``, the multi-tensor Adam kernel, at the f32 leaves of
    UNetSP (row ``adam_mt``) and UNetSPSmall (``adam_mt`` + AT_512) from
    seeded parameters and gradients: ``n_steps`` steps of
    ``steps.Optimizer`` under ``adam`` at the INIs' learning rate, and under
    ``adamw`` with decay and a plateau scale of 0.1, against its plain
    version, the per-leaf ``Optimizer._update`` on the same card: equal bit
    for bit, moments too. Then a step's device time (the kernel rows of a
    profiler window over ``reps`` steps, ``reps_plain`` for the per-leaf
    path's ~15 launches a leaf) beside the per-leaf path's, the library's
    (``torch.optim.Adam(amsgrad=True, fused=True)``: the same bytes, but
    its maximum is of the raw second moment, so not the same numbers) and
    the bound, 36 bytes an element at 3.35 TB/s; and ``Optimizer.step``'s
    host time a step alone. Returns ``(entries, failures)``."""
    import torch

    from ctunet_tpu_torch import steps
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import adam
    from ctunet_tpu_torch.utils import profiling

    cases = (("adam lr 1e-4", dict(name="adam", lr=1e-4), 1.0),
             ("adamw lr 1e-3, decay 0.01, scale 0.1",
              dict(name="adamw", lr=1e-3, weight_decay=0.01,
                   scheduler=True), 0.1))
    entries, failures = {}, []
    for key, mc in (("adam_mt", "UNetSP"), ("adam_mt" + AT_512,
                                            "UNetSPSmall")):
        sizes = adam_leaves(mc)
        n_el = sum(sizes)
        gen = torch.Generator(device=device).manual_seed(21)
        init = [0.1 * torch.randn(n, generator=gen, device=device)
                for n in sizes]
        grads = [[10.0 ** -(i % 4) * torch.randn(n, generator=gen,
                                                 device=device)
                  for i, n in enumerate(sizes)] for _ in range(n_steps)]

        def run(cfg, scale, route):
            p = [torch.nn.Parameter(t.clone()) for t in init]
            opt = steps.Optimizer(p, **cfg)
            if scale != 1.0:
                opt.param_groups[0]["plateau"]["scale"] = scale
            for g in grads:
                for t, gi in zip(p, g):
                    t.grad = gi.clone()
                if route == "kernel":
                    opt.step(value=1.0)
                    continue
                group = opt.param_groups[0]
                group["count"] += 1
                sc = (opt._plateau_scale(group["plateau"], 1.0)
                      if group["plateau"] is not None else 1.0)
                with torch.no_grad():
                    for t in p:
                        opt._update(t, group, group["count"], group["name"],
                                    sc)
            return p, opt

        err, per_step = 0.0, adam_launches(mc)
        for label, cfg, scale in cases:
            kernels.reset_launches()
            p_k, opt_k = run(cfg, scale, "kernel")
            n_launch = kernels.launches()["adam_mt"]
            p_p, opt_p = run(cfg, scale, "plain")
            bad = []
            for i, (a, b) in enumerate(zip(p_k, p_p)):
                err = max(err, float((a - b).detach().abs().max()))
                bad += [f"{kind} of leaf {i}"
                        for kind in ("mu", "nu", "nu_max")
                        if not torch.equal(opt_k.state[a][kind],
                                           opt_p.state[b][kind])]
                if not torch.equal(a, b):
                    bad.append(f"param of leaf {i}")
            log(f"  ADAM {mc} ({len(sizes)} leaves, {n_el} elements), "
                f"{label}: {n_steps} steps, {n_launch} launches (want "
                f"{n_steps * per_step}); against the per-leaf path "
                f"{'equal bit for bit' if not bad else 'DIFFERENT'} "
                f"(max abs error {err:.3g})")
            if bad or n_launch != n_steps * per_step:
                failures.append(f"adam_mt {mc} {label}: {n_launch} launches"
                                f", differs at {bad[:6]}")
            del p_k, p_p, opt_k, opt_p

        # a step's device time: the kernel, the per-leaf path, the library
        p, opt = run(cases[0][1], 1.0, "kernel")
        group = opt.param_groups[0]
        k = adam.constants("adam", group["lr"], group["b1"], group["b2"],
                           group["eps"], 0.0, 0.5, 0.01, 1.0)
        args = (p, [t.grad for t in p], [opt.state[t]["mu"] for t in p],
                [opt.state[t]["nu"] for t in p],
                [opt.state[t]["nu_max"] for t in p])

        def timed(fn, n, name=""):
            fn()
            sync(device)
            with profiling.trace(device) as prof:
                for _ in range(n):
                    fn()
            rows, dropped = profiling.attribute(prof.events())
            if dropped:
                failures.append(f"adam_mt {mc}: the trace lost {dropped} "
                                "launches")
            return sum(r["ms"] for r in rows if name in r["name"]) / n

        def per_leaf():
            with torch.no_grad():
                for t in p:
                    opt._update(t, group, 2, "adam", 1.0)

        ms = timed(lambda: adam.adam_mt(*args, k), reps, "adam_mt_kernel")
        plain = timed(per_leaf, reps_plain)
        lib_p = [torch.nn.Parameter(t.detach().clone()) for t in p]
        for a, t in zip(lib_p, p):
            a.grad = t.grad.clone()
        lib = torch.optim.Adam(lib_p, lr=1e-4, amsgrad=True, fused=True)
        lib_ms = timed(lib.step, reps)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            opt.step()
        host = 1e3 * (time.perf_counter() - t0) / reps
        sync(device)
        b_ms, b_by = bound_ms(36.0 * n_el, 0.0)
        log(f"  ADAM {mc}: a step {ms:.4f} ms of device time in "
            f"{per_step} launches ({100 * b_ms / max(ms, 1e-9):.0f}% of its "
            f"bound {b_ms:.4f} ms); the per-leaf path {plain:.3f} ms, "
            f"torch.optim.Adam(amsgrad, fused) {lib_ms:.4f} ms; "
            f"Optimizer.step's host {host:.3f} ms a step alone")
        entries[key] = dict(
            case=f"{mc}: {len(sizes)} f32 leaves, {n_el} elements, adam",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, host_ms=host)
        del p, opt, lib_p, lib, args, init, grads
    return entries, failures


def small_skulls(shape, n: int, seed: int = SEED_512):
    """Phase 10's broken skulls (a cap removed from a 0.42 shell whose
    centre ``spherical_shell`` jitters by up to 1.5 voxels) and their
    registered atlas, the complete canvas-centred 0.42 shell."""
    import numpy as np

    from ctunet_tpu_torch.data import spherical_shell

    vols = [punched_shell(shape, seed + i, 0.42) for i in range(n)]
    return vols, spherical_shell(shape, radius_frac=0.42).astype(np.float32)


def spsmall(device, work: str, shape=SHAPE_512, n_volumes: int = N_512,
            n_train: int = N_TRAIN_512, time_steps: int = 2, before=None):
    """Phase 10, the 5-block family: ``examples/UNetSPDO/
    FlapRecSP2O_512.ini`` (UNetSPSmall, ``unetspsmall_3k``) through
    ``Model`` at ``shape``: bf16 whole volumes as written, f32, int8 (PTQ,
    no AdaQuant), sliding windows (``b_patch_inference``: 128^3 patches at
    0.5 overlap, the default ``patch_batch``), then training
    (``conv_impl = chain``) and serving from the trained weights. Checks
    the files, every run's launch counts (15 K1 / K1q, 5 K2 / K2q, 5 K3 /
    K3q a volume or a patch; K6 39 a train step and 20 an eval step), the
    bf16 masks against the plain-version engine (Dice >= 0.999 on decided
    voxels) and the plain f32 model (no further than the plain bf16
    engine), the f32 engine within atol 5e-4 / rtol 1e-3 of the plain f32
    model, the int8 engine equal to itself on the plain versions, the
    patch blend against the same window over the plain-version engine, and
    finite training losses. Where the f32 model draws no flap on these
    skulls the flap is held by its probabilities (the kernel engine's mean
    distance from the f32 model no larger than the plain bf16 engine's)
    instead of its Dice; the patch blend holds both heads so, against the
    same window over the plain f32 model. ``before``: the earlier phases'
    stats, printed beside. Returns ``(launches, stats, failures)``, the
    launches under the kernel line's row names (the f32 K1 and K3 as
    ``conv3d_bn_relu_f32`` / ``upconv_bn_relu_f32``)."""
    import copy

    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, default_params, engine, engine_q,
                                  load_params, steps)
    from ctunet_tpu_torch.checkpoint import UNETSPSMALL_3K, load_any
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.data.atlas import register_atlas
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.sliding_window import (grid_starts,
                                                     make_sliding_window_fn)
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
    from ctunet_tpu_torch.utils import nifti

    mc, f32, bf = "UNetSPSmall", torch.float32, torch.bfloat16
    failures, stats, launches = [], {}, collections.Counter()
    cuda = device.type == "cuda"
    vols, atlas = small_skulls(shape, n_volumes)
    data = os.path.join(work, "data")
    os.makedirs(data)
    affine = np.diag([0.45, 0.45, 0.45, 1.0])
    paths = []
    for i, v in enumerate(vols):
        paths.append(os.path.join(data, f"skull_{i:03d}.nii.gz"))
        nifti.write(paths[-1], nifti.NiftiImage(v, affine))
    csv, csv1 = (os.path.join(data, f) for f in ("files.csv", "first.csv"))
    for f, ps in ((csv, paths), (csv1, paths[:1])):
        with open(f, "w") as fh:
            fh.write("image,mask\n" + "".join(f"{p},\n" for p in ps))
    register_atlas(shape, atlas)
    ini = load_params(INI_512, default_params())
    log(f"  {INI_512}: {ini['model_class']}, {ini['compute_dtype'] or 'bf16'}"
        f", b_patch_inference {ini['patch_inference']}, patch "
        f"{ini['patch_size']} at overlap {ini['patch_overlap']}, "
        f"patch_batch {ini['patch_batch']} (default)")
    base = dict(ini, workspace_path=os.path.join(work, "ws"),
                test_files_csv=csv, resume_model=UNETSPSMALL_3K, n_workers=2)
    if not cuda:
        base["device"] = device.type
    per_vol = {"conv3d_bn_relu": 15, "maxpool2": 5, "upconv_bn_relu": 5,
               "conv3d_tc": 15, "upconv_tc": 5, "maxpool2_rows": 5}

    def run(label, want, n, **extra):
        """``Model`` on the INI with ``extra``; its launch counts against
        ``want`` (per volume, times ``n``), its files."""
        name = f"sp512_{label}"
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = Model(params=dict(base, name=name, **extra))
        sync(device)
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        want = {k: v * n for k, v in want.items()}
        got = {k: counts[k] for k in want}
        log(f"  {label}: {m.n_served} volume(s) in {wall:.1f} s (loop "
            f"{m.serve_seconds:.2f} s); launches {got} (want {want})")
        if got != want:
            failures.append(f"{label} launch counts {got} != {want}")
        launches.update({k: v for k, v in got.items() if v})
        ps = paths if extra.get("test_files_csv") != csv1 else paths[:1]
        masks = read_masks(os.path.join(data, f"pred_{name}"), ps, shape,
                           affine, failures)
        return m, masks

    sd = load_any(UNETSPSMALL_3K)
    x0 = torch.from_numpy(np.stack([vols[0].astype(np.float32), atlas],
                                   -1)[None]).to(device)
    key = os.path.basename(paths[0]).replace(".nii.gz", "")
    model = build_model(mc).to(device).eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        ref = [t[0] for t in model(x0)]  # the plain f32 model, TF32 off
    ref_mask = [torch.argmax(r, -1).to(torch.uint8) for r in ref]
    flap_drawn = bool(ref_mask[1].any())
    log(f"  plain f32 model on volume 0: skull {int(ref_mask[0].sum())} "
        f"voxels, flap {int(ref_mask[1].sum())} voxels"
        + ("" if flap_drawn else " -- the 3k model draws no flap on these "
           "skulls: the flap is held by its probabilities, not its Dice"))
    stats["flap_drawn"] = flap_drawn

    # ---- bf16, whole volumes, the INI as written -------------------------
    m, masks = run("bf16", per_vol, n_volumes)
    st = dict(vol_per_s=m.n_served / m.serve_seconds)
    k_pred = engine.build_predict(mc, sd, bf, device)
    p_pred = engine.build_predict(mc, sd, bf, device, plain=True)
    with torch.inference_mode():
        outs = {"kernel": k_pred(x0), "plain": p_pred(x0)}
    for i, sfx in enumerate(("sk", "fl")):
        prob = {k: v[i][0] for k, v in outs.items()}
        mask = {k: torch.argmax(v, -1).to(torch.uint8)
                for k, v in prob.items()}
        if prob["kernel"].dtype != f32 or not bool(
                torch.isfinite(prob["kernel"]).all()):
            failures.append(f"bf16 {sfx}: the double_softmax head is not "
                            "finite f32")
        got = masks.get((key, sfx))
        if got is None or not np.array_equal(got,
                                             mask["kernel"].cpu().numpy()):
            failures.append(f"bf16 {sfx}: Model's file differs from the "
                            "engine")
        decided = torch.ones(shape, dtype=torch.bool, device=device)
        for k in ("kernel", "plain"):
            decided &= (prob[k][..., 1] - prob[k][..., 0]).abs() > DECIDED
        dec = decided.cpu().numpy()
        mk, mp = mask["kernel"].cpu().numpy(), mask["plain"].cpu().numpy()
        mf = ref_mask[i].cpu().numpy()
        d = dict(decided=dice(mk[dec], mp[dec]), kernel_f32=dice(mk, mf),
                 plain_f32=dice(mp, mf),
                 kernel_f32_mean_abs=float((prob["kernel"] - ref[i]).abs()
                                           .mean()),
                 plain_f32_mean_abs=float((prob["plain"] - ref[i]).abs()
                                          .mean()),
                 max_abs_kernel_plain=float((prob["kernel"] - prob["plain"])
                                            .abs().max()))
        log(f"  bf16 {sfx}: {int(mp.sum())} fg voxels; Dice kernel vs plain "
            f"engine {d['decided']:.6f} (the {int(dec.sum())} decided); vs "
            f"the f32 model: kernel {d['kernel_f32']:.6f}, plain bf16 "
            f"{d['plain_f32']:.6f}; mean |p - p_f32| kernel "
            f"{d['kernel_f32_mean_abs']:.3e}, plain bf16 "
            f"{d['plain_f32_mean_abs']:.3e}; max |p_kernel - p_plain| "
            f"{d['max_abs_kernel_plain']:.3e}")
        st.update({f"{sfx}_{k}": v for k, v in d.items()})
        if sfx == "sk" or flap_drawn:
            if not d["decided"] >= 0.999:
                failures.append(f"bf16 {sfx}: Dice on decided voxels "
                                f"{d['decided']} < 0.999")
            if not d["kernel_f32"] >= d["plain_f32"] - 1e-3:
                failures.append(f"bf16 {sfx}: kernel engine further from "
                                f"the f32 model ({d['kernel_f32']}) than the "
                                f"plain bf16 engine ({d['plain_f32']})")
        elif not (d["kernel_f32_mean_abs"]
                  <= d["plain_f32_mean_abs"] * 1.01 + 1e-6):
            failures.append(f"bf16 {sfx} (no flap drawn): kernel engine's "
                            "probabilities further from the f32 model than "
                            "the plain bf16 engine's")
    del outs
    st["engine_ms"] = time_ms(lambda: k_pred(x0), 3, device)
    st["plain_engine_ms"] = time_ms(lambda: p_pred(x0), 1, device)
    log(f"  bf16 engine {st['engine_ms']:.2f} ms/volume (plain versions "
        f"{st['plain_engine_ms']:.2f}); Model loop {st['vol_per_s']:.3f} "
        f"volumes/s over {m.n_served} volumes, the first's set-up included "
        f"(not a steady rate); UNetSP at "
        f"224x304x304 (phase 3): "
        f"{(before or {}).get(3, {}).get('engine_ms', float('nan')):.2f} ms")
    profile_device(lambda: k_pred(x0), device, what="one UNetSPSmall volume")
    stats["bf16"] = st

    # ---- f32, one volume -------------------------------------------------
    m, masks = run("f32", {
        "conv3d_bn_relu": 15, "maxpool2": 5, "upconv_bn_relu": 5,
        "conv3d_f32": 15, "conv3d_tc_f32": 15, "maxpool2_f32": 5,
        "upconv_f32": 5, "upconv_tc_f32": 5, "conv3d_tc": 0, "upconv_tc": 0,
        "maxpool2_rows": 5}, 1, test_files_csv=csv1,
        compute_dtype="float32")
    f_pred = engine.build_predict(mc, sd, f32, device)
    with torch.inference_mode():
        got = f_pred(x0)
    st = {}
    for i, sfx in enumerate(("sk", "fl")):
        err, worst = prob_check(f"f32 {sfx}", got[i][0], ref[i], failures)
        n_diff, n_open = mask_check(f"f32 {sfx}", got[i][0], ref[i],
                                    masks.get((key, sfx)), failures)
        log(f"  f32 {sfx}: max |p - p_plain f32 model| {err:.3e} (worst / "
            f"allowance {worst:.3f}); {n_diff} decided voxels differ, "
            f"{n_open} near-ties left out")
        st.update({f"{sfx}_max_err": err, f"{sfx}_worst": worst})
    del got
    st["engine_ms"] = time_ms(lambda: f_pred(x0), 3, device)
    log(f"  f32 engine {st['engine_ms']:.2f} ms/volume")
    stats["f32"] = st
    del f_pred

    # ---- int8 (PTQ, round to nearest), one volume -----------------------
    q_vol = {"conv3d_q_requant": 15, "maxpool2_q": 5, "upconv_q_requant": 5,
             "conv3d_tc_q": 15, "upconv_tc_q": 5}
    # the calibration forward is the bf16 engine's, as in the JAX package
    want = dict(per_vol, **q_vol, maxpool2_rows=10)
    m, masks = run("int8", want, 1, test_files_csv=csv1, use_int8=True,
                   int8_adaquant=False)
    (shp_q, qfn), = m.int8_engines.items()
    st = dict(build_s=m.int8_build_seconds)
    if qfn is None:
        failures.append("int8: Model served the float engine")
    else:
        q_plain = engine_q.build_predict_q(mc, sd, x0[0], device=device,
                                           plain=True,
                                           import_scales=qfn.scales)
        with torch.inference_mode():
            got, want_q = qfn(x0), q_plain(x0)
        same = all(torch.equal(a, b) for a, b in zip(got, want_q))
        if not same:
            failures.append("int8: the kernels' outputs differ from the "
                            "same engine on the plain versions")
        for i, sfx in enumerate(("sk", "fl")):
            mq = torch.argmax(got[i][0], -1).to(torch.uint8).cpu().numpy()
            if not np.array_equal(masks.get((key, sfx)), mq):
                failures.append(f"int8 {sfx}: Model's file differs from the "
                                "engine")
            st[f"dice_{sfx}_f32"] = dice(mq, ref_mask[i].cpu().numpy())
            st[f"{sfx}_mean_abs_f32"] = float((got[i][0] - ref[i]).abs()
                                              .mean())
        log(f"  int8: built in {st['build_s']:.1f} s; outputs "
            f"{'equal' if same else 'DIFFER'} to the plain-version engine "
            f"on the same scales; Dice vs the f32 model: skull "
            f"{st['dice_sk_f32']:.6f}, flap {st['dice_fl_f32']:.6f}; mean "
            f"|p - p_f32| {st['sk_mean_abs_f32']:.3e} / "
            f"{st['fl_mean_abs_f32']:.3e}")
        del got, want_q, q_plain
        st["engine_ms"] = time_ms(lambda: qfn(x0), 3, device)
        log(f"  int8 engine {st['engine_ms']:.2f} ms/volume")
    stats["int8"] = st
    del m, qfn

    # ---- sliding windows (b_patch_inference), one volume ----------------
    ps = int(ini["patch_size"])
    n_patch = len(grid_starts(shape, (ps,) * 3, float(ini["patch_overlap"])))
    m, masks = run("patch", per_vol, n_patch, test_files_csv=csv1,
                   patch_inference=True)
    sw = {}
    # the same window over the kernel engine, the plain-version engine and
    # the plain f32 model (the probabilities' reference)
    for label, fwd, dt in (("kernel", k_pred, bf), ("plain", p_pred, bf),
                           ("f32", model, f32)):
        sw[label] = make_sliding_window_fn(
            fwd, patch_size=ps, overlap=float(ini["patch_overlap"]),
            atlas=atlas, compute_dtype=dt,
            patch_batch=int(ini["patch_batch"]))
    with torch.inference_mode():
        blends = {k: fn(x0[..., 0]) for k, fn in sw.items()}
    st = dict(patches=n_patch)
    for i, sfx in enumerate(("sk", "fl")):
        prob = {k: v[i][0] for k, v in blends.items()}
        mk = torch.argmax(prob["kernel"], -1).to(torch.uint8)
        mp = torch.argmax(prob["plain"], -1).to(torch.uint8)
        if not np.array_equal(masks.get((key, sfx)), mk.cpu().numpy()):
            failures.append(f"patch {sfx}: Model's file differs from the "
                            "kernel engine's sliding window")
        decided = ((prob["kernel"][..., 1] - prob["kernel"][..., 0]).abs()
                   > DECIDED) & ((prob["plain"][..., 1]
                                  - prob["plain"][..., 0]).abs() > DECIDED)
        dec = decided.cpu().numpy()
        mk, mp = mk.cpu().numpy(), mp.cpu().numpy()
        err = float((prob["kernel"] - prob["plain"]).abs().max())
        d = dice(mk[dec], mp[dec])
        k_abs, p_abs = (float((prob[k] - prob["f32"]).abs().mean())
                        for k in ("kernel", "plain"))
        st.update({f"{sfx}_dice_decided": d, f"{sfx}_max_abs": err,
                   f"{sfx}_kernel_f32_mean_abs": k_abs,
                   f"{sfx}_plain_f32_mean_abs": p_abs,
                   f"{sfx}_dice_whole_f32": dice(mk, ref_mask[i].cpu()
                                                 .numpy())})
        log(f"  patch {sfx}: blend vs the plain-version window: Dice "
            f"{d:.6f} on the {int(dec.sum())} decided voxels, max |dp| "
            f"{err:.3e}; mean |p - p_f32| against the f32 model's window: "
            f"kernel {k_abs:.3e}, plain bf16 {p_abs:.3e}; Dice vs the "
            f"whole-volume f32 model {st[f'{sfx}_dice_whole_f32']:.6f}")
        if (sfx == "sk" or mp.any()) and not d >= 0.999:
            failures.append(f"patch {sfx}: Dice on decided voxels {d} < "
                            "0.999")
        # both heads, flap drawn or not: a wrong blend or head moves the
        # kernel window away from the f32 model's
        if not k_abs <= p_abs * 1.01 + 1e-6:
            failures.append(f"patch {sfx}: kernel window's probabilities "
                            f"further from the f32 model's window ({k_abs})"
                            f" than the plain bf16 window's ({p_abs})")
    del blends
    st["ms_per_volume"] = time_ms(lambda: sw["kernel"](x0[..., 0]), 1,
                                  device)
    log(f"  patch serving {st['ms_per_volume']:.1f} ms/volume ({n_patch} "
        f"patches of {ps}^3, engine and f32 blend) vs whole-volume "
        f"{stats['bf16']['engine_ms']:.2f} ms")
    stats["patch"] = st
    del sw, k_pred, p_pred, m

    # ---- training, chain, then serving from the trained weights ---------
    train_csv = make_dataset(os.path.join(work, "train"), n=n_train,
                             shape=shape, seed=60)
    val_csv = make_dataset(os.path.join(work, "val"), n=1, shape=shape,
                           seed=90)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    k6 = n_train * K6_PER_TRAIN_STEP_5 + K6_PER_EVAL_STEP_5
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = Model(params=dict(
        base, name="sp512_train", test_files_csv=csv1, train_flag=True,
        conv_impl="chain", n_epochs=1, autosave_epochs=0,
        train_files_csv=train_csv, validation_files_csv=val_csv,
        resume_model="", log_every=1,
        # the INI's Hausdorff plots: a host distance transform per eval
        # volume (tens of seconds at this size), no device work
        save_hd_plots=False))
    sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    want = dict(per_vol, conv3d_bias_act=k6,
                adam_mt=n_train * adam_launches(mc))
    want["conv3d_tc"] += k6
    got = {k: counts[k] for k in want}
    log(f"  training: {n_train} train + 1 eval steps, then 1 volume "
        f"served, in {wall:.1f} s; launches {got} (want {want}: K6 "
        f"{K6_PER_TRAIN_STEP_5} a train step, {K6_PER_EVAL_STEP_5} an eval "
        "step)")
    if got != want:
        failures.append(f"training launch counts {got} != {want}")
    launches.update({k: v for k, v in got.items() if v})
    losses = [float(v) for v in m.step_losses]
    hist = {k: v[-1][1] for k, v in m.writer.history.items()}
    if len(losses) != n_train or not all(map(math.isfinite, losses)) or \
            not all(math.isfinite(v) for v in hist.values()):
        failures.append(f"training: losses not finite: {losses} {hist}")
    if not os.path.exists(m.params["model_path"]):
        failures.append(f"training: no checkpoint {m.params['model_path']}")
    read_masks(os.path.join(data, "pred_sp512_train"), paths[:1], shape,
               affine, failures)
    st = dict(losses=losses, model_wall_s=wall)
    if cuda:
        st["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"  train losses {losses}; epoch scalars {json.dumps(hist)}; peak "
        f"memory {st.get('peak_mem_gb', float('nan')):.2f} GiB")

    # ms per step: chain (K6) and xla (cuDNN), from the same weights
    handler = FlapRecWithShapePriorDoubleOut()
    loss_cfg = {k: ini.get(k) for k in ("ce_lambda", "dice_lambda")}
    vol = torch.from_numpy(nifti_data(
        os.path.join(work, "train", "skull_000.nii.gz"))[None]).to(device)
    start = m.state.model.state_dict()
    del m
    for impl in ("chain", "xla"):
        net = build_model(mc).to(device)
        net.load_state_dict(copy.deepcopy(start))
        net.configure(impl, bf)
        state = steps.TrainState(net, steps.make_optimizer(
            ini, net.parameters()))
        step = steps.make_train_step(net, handler, loss_cfg, atlas=atlas,
                                     compute_dtype=bf)
        gen = torch.Generator(device=device).manual_seed(5)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        kernels.reset_launches()
        for _ in range(time_steps + 1):
            sync(device)
            t = time.perf_counter()
            step(state, {"image": vol}, gen)
            sync(device)
            times.append(1e3 * (time.perf_counter() - t))
        n_k6 = kernels.launches()["conv3d_bias_act"]
        if impl == "chain" and n_k6 != (time_steps + 1) * K6_PER_TRAIN_STEP_5:
            failures.append(f"chain step: {n_k6} K6 launches over "
                            f"{time_steps + 1} steps")
        st[f"{impl}_ms_per_step"] = float(np.mean(times[1:]))
        if cuda:
            st[f"{impl}_step_peak_mem_gb"] = (
                torch.cuda.max_memory_allocated(device) / 2**30)
        del net, state, step
    whole = (before or {}).get(5, {}).get("chain_ms_per_step", float("nan"))
    log(f"  ms/step at batch 1 (host clock around a synchronized step, first "
        f"left out): chain {st['chain_ms_per_step']:.1f} (K6 "
        f"{K6_PER_TRAIN_STEP_5} a step, asserted), xla (cuDNN) "
        f"{st['xla_ms_per_step']:.1f}; peak memory chain "
        f"{st.get('chain_step_peak_mem_gb', float('nan')):.2f} GiB, xla "
        f"{st.get('xla_step_peak_mem_gb', float('nan')):.2f} GiB; UNetSP "
        f"224x304x304 chain (phase 5): {whole:.1f} ms")
    stats["train"] = st
    rows = {"conv3d_f32": "conv3d_bn_relu_f32",
            "upconv_f32": "upconv_bn_relu_f32"}
    return ({rows.get(k, k): v for k, v in launches.items()}, stats,
            failures)


# ---- phase 11: pickled-module checkpoints, preprocessing, bf16 parameters
# and QAT -----------------------------------------------------------------

# the reference's own module path, which no installed package provides
REF_MODULE = "ctunet.pytorch.models"
# phase 11's synthetic CT: 180 slices of 512x512 at (1.25, 0.6, 0.6) mm,
# resampled to 1 mm and padded to a multiple of 16 on the card
CT_SHAPE, CT_SPACING = (180, 512, 512), (1.25, 0.6, 0.6)
# device vs CPU preprocessing: f32 sums of at most four weighted [0, 1]
# values per axis in another order (TF32 off)
PRE_ATOL = 1e-5
QAT_STEPS = 20  # distillation steps of tools/qat_tune_torch.py
# not the tool's 1e-4: twenty steps at 1e-4 from unetsp_10k fail the
# collapse guard in tools/qat_tune.py itself (flap Dice 0.89 on the CPU,
# 0.996 at 1e-5), and the port's distillation step is held to that tool's
# in tests/test_torch_port_qat.py
QAT_LR = 1e-5
QAT_SHAPE = (64, 128, 128)  # the tool's own size


@contextlib.contextmanager
def reference_classes(model):
    """While active, :data:`REF_MODULE` (and its parents) exist in
    ``sys.modules``, holding a subclass under the same name of every class
    of the port's that ``model`` uses, and ``model``'s modules are of
    those classes: what a pickle of the reference's own model names."""
    import types

    parts = REF_MODULE.split(".")
    added = [n for n in (".".join(parts[:i + 1]) for i in range(len(parts)))
             if n not in sys.modules]
    for n in added:
        sys.modules[n] = types.ModuleType(n)
    swapped = []
    try:
        mod = sys.modules[REF_MODULE]
        for m in model.modules():
            cls = type(m)
            if not cls.__module__.startswith("ctunet_tpu_torch"):
                continue
            fake = getattr(mod, cls.__name__, None)
            if fake is None:
                fake = type(cls.__name__, (cls,), {"__module__": REF_MODULE})
                setattr(mod, cls.__name__, fake)
            swapped.append((m, cls))
            m.__class__ = fake
        yield model
    finally:
        for m, cls in swapped:
            m.__class__ = cls
        for n in added:
            del sys.modules[n]


def save_reference_pt(model, path: str, legacy: bool = False,
                      data_parallel: bool = False) -> None:
    """``torch.save(model)`` as the reference pickles its modules
    (:func:`reference_classes`), optionally inside ``nn.DataParallel`` and
    in torch's legacy (non-zip) format."""
    import torch
    from torch import nn

    with reference_classes(model):
        obj = nn.DataParallel(model) if data_parallel else model
        torch.save(obj, path, _use_new_zipfile_serialization=not legacy)


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        if v:
            total[k] = total.get(k, 0) + v


def pickled_ops_qat(device, work: str, shape=SHAPE, before=None,
                    qat_steps: int = QAT_STEPS, qat_shape=QAT_SHAPE,
                    ct_shape=CT_SHAPE):
    """Phase 11 (UNetSP at full width on ``unetsp_10k`` with a registered
    atlas): a pickled-module ``.pt`` (zip) and the same tree in
    ``nn.DataParallel`` (legacy format) served through ``Model`` against
    the ``.npz``; ``hu_window``, ``resample_to_spacing`` and
    ``pad_to_multiple`` on a synthetic CT on the card against the CPU, and
    ``largest_cc_device`` against the host ``largest_cc``; ``Model.train``
    with ``param_dtype = bfloat16`` and ``profile_dir`` (2 epochs of one
    step, then one volume served); ``tools/qat_tune_torch.py``'s
    distillation and the tuned weights served in int8 against the same
    engine on the plain versions. Returns ``(launches, stats, failures)``.
    """
    import glob
    import importlib.util

    import numpy as np
    import torch

    from ctunet_tpu_torch import (Model, checkpoint, default_params, engine_q,
                                  load_params, steps)
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.data.synthetic import spherical_shell
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import (hu_window, kernels, largest_cc,
                                      largest_cc_device, pad_to_multiple,
                                      resample_to_spacing)
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
    from ctunet_tpu_torch.utils import profiling

    failures, launches, stats = [], {}, {}
    cuda = device.type == "cuda"
    data, paths, csv, atlas, affine = write_volumes(work, shape, 1)
    base = dict(test_flag=True, model_class="UNetSP",
                problem_handler="FlapRecWithShapePriorDoubleOut",
                device=device.type, workspace_path=os.path.join(work, "ws"),
                test_files_csv=csv, n_workers=2)
    per_vol = {"conv3d_bn_relu": 12, "maxpool2": 4, "upconv_bn_relu": 4,
               "conv3d_tc": 12, "upconv_tc": 4, "maxpool2_rows": 4}

    # ---- pickled-module checkpoints ----------------------------------------
    sd = load_any(UNETSP_10K)
    net = build_model("UNetSP")
    net.load_state_dict(sd)
    pts = {"module_zip": (False, False), "module_dp_legacy": (True, True)}
    weights = {"npz": UNETSP_10K}
    for name, (legacy, dp) in pts.items():
        weights[name] = os.path.join(work, f"unetsp_10k_{name}.pt")
        save_reference_pt(net, weights[name], legacy, dp)
    if "ctunet" in sys.modules:
        failures.append("the reference module stayed importable")
    masks = {}
    for name, path in weights.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        Model(params=dict(base, name=f"p11_{name}", resume_model=path))
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        got = {k: counts[k] for k in per_vol}
        log(f"  {name}: served 1 volume in {wall:.2f} s (Model, load "
            f"included), launches {got}")
        if got != per_vol:
            failures.append(f"pickled .pt {name}: launches {got} != "
                            f"{per_vol}")
        if name != "npz":
            add_counts(launches, got)
        masks[name] = read_masks(os.path.join(data, f"pred_p11_{name}"),
                                 paths, shape, affine, failures)
    for name in pts:
        same = (masks[name].keys() == masks["npz"].keys() and all(
            np.array_equal(masks[name][k], masks["npz"][k])
            for k in masks["npz"]))
        log(f"  {name}: masks bit-equal to the .npz-served ones: {same}")
        if not same:
            failures.append(f"pickled .pt {name}: masks differ from the "
                            ".npz-served ones")
    if "ctunet" in sys.modules:
        failures.append("loading the pickled modules imported their module")

    # ---- preprocessing on the card -----------------------------------------
    rng = np.random.default_rng(11)
    shell = spherical_shell(ct_shape, thickness=6.0, radius_frac=0.4)
    hu = (rng.normal(40.0, 60.0, ct_shape).astype(np.float32)
          + 1400.0 * shell.astype(np.float32))
    host = torch.from_numpy(hu)
    on_card = host.to(device)

    def ingest(v):
        w = hu_window(v)
        r = resample_to_spacing(w, CT_SPACING)
        return pad_to_multiple(r, 16)[0]

    t0 = time.perf_counter()
    want = ingest(host)
    cpu_s = time.perf_counter() - t0
    got = ingest(on_card)
    err = float((got.cpu() - want).abs().max())
    ms = time_ms(lambda: ingest(on_card), 3, device)
    stats["preprocess"] = dict(shape=list(ct_shape), out=list(got.shape),
                               ms=ms, cpu_s=cpu_s, max_abs_err=err)
    log(f"  preprocessing {ct_shape} at {CT_SPACING} mm -> 1 mm, padded to "
        f"{tuple(got.shape)}: {ms:.2f} ms on the card ({cpu_s:.2f} s on the "
        f"host's CPU); max |card - CPU| {err:.3e} (atol {PRE_ATOL})")
    if tuple(got.shape) != tuple(want.shape) or not err <= PRE_ATOL:
        failures.append(f"preprocessing: card vs CPU {err} / shapes "
                        f"{tuple(got.shape)} {tuple(want.shape)}")
    del host, on_card, got, want
    base_name = os.path.basename(paths[0]).replace(".nii.gz", "")
    mask = masks["npz"].get((base_name, "sk"))
    if mask is None:
        failures.append("largest_cc_device: no served skull mask")
    else:
        mt = torch.from_numpy(np.ascontiguousarray(mask)).to(device)
        t0 = time.perf_counter()
        dev_cc = largest_cc_device(mt)
        sync(device)
        cc_s = time.perf_counter() - t0
        host_cc = largest_cc(mask)
        same = np.array_equal(dev_cc.cpu().numpy(), host_cc)
        stats["largest_cc"] = dict(s=cc_s, equal=same,
                                   voxels=int(host_cc.sum()))
        log(f"  largest_cc_device on the served skull mask ({int(mask.sum())}"
            f" voxels, {int(host_cc.sum())} kept): {cc_s:.3f} s on the card, "
            f"equal to the host largest_cc: {same}")
        if not same:
            failures.append("largest_cc_device differs from largest_cc")

    # ---- bf16 parameters, with a first-epoch trace --------------------------
    train_csv = make_dataset(os.path.join(work, "train"), n=1, shape=shape,
                             seed=41)
    val_csv = make_dataset(os.path.join(work, "val"), n=1, shape=shape,
                           seed=81)
    prof = os.path.join(work, "profile")
    params = load_params(TRAIN_INI, default_params())
    params.update(
        name="p11_bf16", conv_impl="chain", n_epochs=2, autosave_epochs=0,
        param_dtype="bfloat16", profile_dir=prof, device=device.type,
        workspace_path=os.path.join(work, "ws"), train_files_csv=train_csv,
        validation_files_csv=val_csv, test_files_csv=csv, resume_model="",
        log_every=1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = Model(params=params)  # 2 x (1 train + 1 eval step), then 1 volume
    sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    k6 = 2 * (K6_PER_TRAIN_STEP + K6_PER_EVAL_STEP)
    # the kernel updates the f32 BatchNorm leaves, the rest go one by one
    want = dict(per_vol, conv3d_bias_act=k6,
                adam_mt=2 * adam_launches("UNetSP", torch.bfloat16))
    want["conv3d_tc"] += k6
    got = {k: counts[k] for k in want}
    log(f"  bf16 parameters: 2 epochs of 1 train + 1 eval step, then 1 "
        f"volume served, in {wall:.1f} s; launches {got} (want {want}: "
        f"K6 {K6_PER_TRAIN_STEP} a train step)")
    if got != want:
        failures.append(f"bf16-parameter training launches {got} != {want}")
    add_counts(launches, got)
    model = m.state.model
    bad = []  # BatchNorm's parameters f32, every other bf16
    for mod in model.modules():
        is_bn = isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)
        bad += [n for n, p in mod.named_parameters(recurse=False)
                if p.dtype != (torch.float32 if is_bn else torch.bfloat16)]
    bn_f32 = all(b.dtype == torch.float32 for n, b in model.named_buffers()
                 if "running" in n)
    mom = {}
    for p in model.parameters():
        for v in m.state.optimizer.state[p].values():
            mom.setdefault(str(p.dtype), set()).add(str(v.dtype))
    log(f"  parameters off their dtype: {bad}; BN statistics f32: "
        f"{bn_f32}; moment dtypes by parameter dtype: {mom}")
    if bad or not bn_f32 or mom != {"torch.bfloat16": {"torch.bfloat16"},
                                    "torch.float32": {"torch.float32"}}:
        failures.append(f"bf16 parameters: dtypes {bad}, BN {bn_f32}, "
                        f"moments {mom}")
    losses = [float(v) for v in m.step_losses]  # the last epoch's
    hist = {k: [v for _, v in h] for k, h in m.writer.history.items()}
    log(f"  bf16 parameters: epoch scalars {json.dumps(hist)}")
    if not losses or not all(map(math.isfinite, losses)) or not all(
            math.isfinite(v) for h in hist.values() for v in h):
        failures.append(f"bf16 parameters: losses {losses} {hist}")
    traces = sorted(glob.glob(os.path.join(prof, "*.pt.trace.json")))
    names, traced_k6, lost = set(), 0, 0
    for t in traces:
        with open(t) as f:
            events = json.load(f)["traceEvents"]
        names |= {e.get("name") for e in events}
        lost += profiling.dropped_in_trace(events)
        # the one train step's K6 launches, by kernel name
        traced_k6 += sum(e.get("cat") == "kernel"
                         and "conv3d_tc_kernel" in str(e.get("name"))
                         for e in events)
    epochs = sorted({str(n).split(" train step")[0] for n in names
                     if " train step " in str(n)})
    log(f"  profile_dir: {len(traces)} trace file(s), "
        f"{sum(os.path.getsize(t) for t in traces) / 2**20:.1f} MiB, step "
        f"spans of {epochs}, {traced_k6} conv3d_tc kernels (want "
        f"{K6_PER_TRAIN_STEP}: epoch 1's one train step), {lost} launches "
        "lost by the trace")
    if len(traces) != 1 or epochs != ["epoch 1"] or \
            traced_k6 != K6_PER_TRAIN_STEP or lost:
        failures.append(f"profile_dir: traces {traces}, spans {epochs}, "
                        f"{traced_k6} K6 kernels, {lost} launches lost")
    saved = checkpoint.restore_checkpoint(m.params["model_path"])
    if saved["model"]["d_blocks.0.block.0.weight"].dtype != torch.bfloat16:
        failures.append("bf16 parameters: the checkpoint is not bf16")
    read_masks(os.path.join(data, "pred_p11_bf16"), paths, shape, affine,
               failures)
    # ms a step, as phase 5 times its f32-parameter step
    handler = FlapRecWithShapePriorDoubleOut()
    loss_cfg = {k: params.get(k) for k in ("ce_lambda", "dice_lambda")}
    vol = torch.from_numpy(nifti_data(
        os.path.join(work, "train", "skull_000.nii.gz"))[None]).to(device)
    state = steps.TrainState(model, steps.make_optimizer(
        params, model.parameters()))
    step = steps.make_train_step(model.configure("chain", torch.bfloat16),
                                 handler, loss_cfg, atlas=atlas,
                                 compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(5)
    times = []
    for _ in range(4):
        sync(device)
        t = time.perf_counter()
        step(state, {"image": vol}, gen)
        sync(device)
        times.append(1e3 * (time.perf_counter() - t))
    f32_ms = (before or {}).get(5, {}).get("chain_ms_per_step", float("nan"))
    stats["bf16_params"] = dict(losses=losses, model_wall_s=wall,
                                ms_per_step=float(np.mean(times[1:])),
                                f32_params_ms_per_step=f32_ms)
    log(f"  ms/step at batch 1, chain, bf16 parameters: "
        f"{stats['bf16_params']['ms_per_step']:.1f} (first step left out); "
        f"f32 parameters (phase 5): {f32_ms:.1f}")
    del m, model, state, step

    # ---- QAT: the tool's distillation, then int8 serving -------------------
    spec = importlib.util.spec_from_file_location(
        "qat_tune_torch", os.path.join(ROOT, "tools", "qat_tune_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tuned_path = os.path.join(work, "unetsp_10k_qat.ckpt")
    res = tool.distill(UNETSP_10K, tuned_path, steps=qat_steps, lr=QAT_LR,
                       shape=qat_shape, device=device.type,
                       log=lambda s: log("  " + s))
    if not res["saved"]:
        failures.append(f"QAT at lr {QAT_LR}: the collapse guard failed "
                        f"({res['guard_dice']})")
        return launches, stats, failures
    stats["qat"] = dict(steps=qat_steps, lr=QAT_LR, seconds=res["seconds"],
                        ms_per_step=1e3 * res["seconds"] / qat_steps,
                        first_loss=res["losses"][0],
                        last_loss=res["losses"][-1],
                        guard_dice=res["guard_dice"])
    kernels.reset_launches()
    qm = Model(params=dict(base, name="p11_qat", resume_model=tuned_path,
                           use_int8=True, int8_adaquant=False))
    counts = kernels.launches()
    want = {"conv3d_q_requant": 12, "maxpool2_q": 4, "upconv_q_requant": 4,
            "conv3d_tc_q": 12, "upconv_tc_q": 4}
    got = {k: counts[k] for k in want}
    log(f"  QAT-tuned int8 serving: launches {counts} (int8 want {want}; "
        "the bf16 ones are the calibration forward)")
    if got != want:
        failures.append(f"QAT int8 launches {got} != {want}")
    add_counts(launches, got)
    add_counts(launches, {k: counts[k] for k in ("maxpool2_rows",)})
    qmasks = read_masks(os.path.join(data, "pred_p11_qat"), paths, shape,
                        affine, failures)
    qfn = qm.int8_engines.get(shape + (2,))
    if qfn is None:
        failures.append(f"QAT: no int8 engine was built: {qm.int8_engines}")
        return launches, stats, failures
    tuned = load_any(tuned_path)
    x = np.stack([nifti_data(paths[0]), atlas], -1)
    xt = torch.from_numpy(x[None]).to(device, torch.bfloat16)
    plain_q = engine_q.build_predict_q(
        "UNetSP", tuned, xt[0], device=device, plain=True,
        import_scales=qfn.scales)
    ptq = engine_q.build_predict_q("UNetSP", sd, xt[0], device=device)
    f32 = {}
    for key, w in (("base", sd), ("tuned", tuned)):
        f = build_model("UNetSP").to(device).eval()
        f.load_state_dict(w)
        f32[key] = f
    with torch.inference_mode():
        outs = {"qat": qfn(xt), "qat_plain": plain_q(xt), "ptq": ptq(xt),
                "f32": f32["base"](xt.float()),
                "f32_tuned": f32["tuned"](xt.float())}
    for i, sfx in enumerate(("sk", "fl")):
        mk = {k: torch.argmax(v[i][0].float(), -1).to(torch.uint8).cpu()
              .numpy() for k, v in outs.items()}
        same = np.array_equal(mk["qat"], mk["qat_plain"])
        filed = np.array_equal(qmasks.get((base_name, sfx)), mk["qat"])
        d = dict(before=dice(mk["ptq"], mk["f32"]),
                 after=dice(mk["qat"], mk["f32"]),
                 after_own_f32=dice(mk["qat"], mk["f32_tuned"]))
        stats["qat"].update({f"{sfx}_identical_to_plain": same,
                             **{f"{sfx}_dice_{k}": v for k, v in d.items()}})
        log(f"  QAT int8 {sfx}: identical to the plain-version engine: "
            f"{same}; Model's file equal to the engine: {filed}; int8 vs "
            f"f32 Dice before QAT (PTQ, round to nearest) {d['before']:.6f}, "
            f"after {d['after']:.6f} (vs the tuned f32 model "
            f"{d['after_own_f32']:.6f})")
        if not same:
            failures.append(f"QAT int8 {sfx}: masks differ from the "
                            "plain-version engine")
        if not filed:
            failures.append(f"QAT int8 {sfx}: Model's file differs from "
                            "the engine")
    return launches, stats, failures


# ---- phase 12: several ranks on the one card ------------------------------

N_RANKS = 2  # phase 12's ranks, each on the one card (gloo: they share it)
MD_TRAIN_STEPS = 2  # phase 12's data-parallel train steps (batch 2; 1 eval)


@contextlib.contextmanager
def first_step_stats(out: dict):
    """While open, ``Model``'s train step records into ``out``, after its
    first step, the model's BatchNorm running statistics (on the host)."""
    from ctunet_tpu_torch import steps

    make = steps.make_train_step

    def recording(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def first(state, batch, gen):
            res = step(state, batch, gen)
            if not out:
                out.update({k: v.detach().float().cpu().clone()
                            for k, v in model.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))})
            return res
        return first

    steps.make_train_step = recording
    try:
        yield out
    finally:
        steps.make_train_step = make


@contextlib.contextmanager
def timed_calls(spent: dict, device):
    """While open, every ``torch.distributed.all_reduce`` and every
    synthesis of a step built then (``steps.make_synth_fn``) adds its host
    time, between two synchronizations of ``device``, to ``spent``
    (seconds, with the number of calls under ``n_<key>``)."""
    import torch.distributed as dist

    from ctunet_tpu_torch import steps

    def timed(key, fn):
        def call(*args, **kwargs):
            sync(device)
            t = time.perf_counter()
            res = fn(*args, **kwargs)
            sync(device)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            spent["n_" + key] = spent.get("n_" + key, 0) + 1
            return res
        return call

    reduce_, make = dist.all_reduce, steps.make_synth_fn
    dist.all_reduce = timed("all_reduce", reduce_)
    steps.make_synth_fn = lambda *a, **k: timed("synthesis", make(*a, **k))
    try:
        yield spent
    finally:
        dist.all_reduce, steps.make_synth_fn = reduce_, make


def bf16_ulp(x):
    """One bf16 unit in the last place at each ``|x|`` (the smallest normal
    number's where ``x`` is 0)."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def md_train_params(work: str, train_csv: str, val_csv: str, device,
                    name: str):
    """``FlapRecSP2O.ini``'s training settings at batch 2 (phase 5's, but
    for the batch): one epoch of ``MD_TRAIN_STEPS`` steps, then one eval
    step; each run in a workspace of its own."""
    from ctunet_tpu_torch import default_params, load_params

    params = load_params(TRAIN_INI, default_params())
    params.update(
        name=name, conv_impl="chain", n_epochs=1, batch_size=N_RANKS,
        autosave_epochs=0, workspace_path=os.path.join(work, "ws_" + name),
        train_files_csv=train_csv, validation_files_csv=val_csv,
        test_flag=False, resume_model="", log_every=1, n_workers=2)
    if device.type != "cuda":
        params["device"] = device.type
    return params


def md_rank(rank: int, work: str, shape, paths, train_csv: str,
            val_csv: str, device_type: str):
    """One rank of phase 12 (``parallel.spawn``): depth-sharded serving of
    ``paths[0]`` (bf16, f32), data-parallel serving of ``paths[0:2]`` (bf16;
    int8 calibrated on ``paths[2]``) and a data-parallel ``Model`` run. Each
    path's launch counts are set to 0 just before it and read just after.
    Returns the outputs (on the host), the counts and the times."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, engine, parallel
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.data.atlas import register_atlas
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.parallel import halo as halo_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank_, world = parallel.initialize_from_params(dict(
        distributed=True, device=device_type))
    device = parallel.rank_device(torch.device(
        "cuda", 0) if device_type == "cuda" else torch.device("cpu"))
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    register_atlas(shape, atlas)
    sd = load_any(UNETSP_10K)
    vols = torch.from_numpy(np.stack([np.stack([nifti_data(p), atlas], -1)
                                      for p in paths])).to(device)
    out = dict(rank=rank_, world=world, device=str(device), counts={},
               ms={}, backend=torch.distributed.get_backend())

    def run(key, fn):
        sync(device)
        kernels.reset_launches()
        res = fn()
        sync(device)
        out["counts"][key] = {k: v for k, v in kernels.launches().items()
                              if v}
        return res

    def host(res):
        return tuple(t.cpu() for t in res)

    spatial = parallel.make_mesh(1, N_RANKS)
    exchange = halo_mod.halo_exchange_many
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd = engine.build_sharded_predict("UNetSP", sd, spatial, dtype,
                                           device)
        out[f"sharded_{name}"] = host(run(f"sharded_{name}",
                                          lambda: fwd(vols[:1])))
        out["ms"][f"sharded_{name}"] = time_ms(lambda: fwd(vols[:1]), 3,
                                               device)
        # the same engine, each halo exchange timed alone (host clock
        # between two synchronizations)
        spent = []

        def timed(*args):
            sync(device)
            t = time.perf_counter()
            res = exchange(*args)
            sync(device)
            spent.append(time.perf_counter() - t)
            return res

        halo_mod.halo_exchange_many = timed
        try:
            fwd = engine.build_sharded_predict("UNetSP", sd, spatial, dtype,
                                               device)
        finally:
            halo_mod.halo_exchange_many = exchange
        fwd(vols[:1])
        spent.clear()
        for _ in range(3):
            fwd(vols[:1])
        out["ms"][f"halo_{name}"] = 1e3 * sum(spent) / 3
        out[f"exchanges_{name}"] = len(spent) // 3
    data = parallel.make_mesh(N_RANKS, 1)
    fwd = engine.build_dp_predict("UNetSP", sd, data, torch.bfloat16,
                                  device)
    out["dp_bf16"] = host(run("dp_bf16", lambda: fwd(vols[:N_RANKS])))
    out["ms"]["dp_bf16"] = time_ms(lambda: fwd(vols[:N_RANKS]), 3, device)
    fwd = engine.build_dp_predict("UNetSP", sd, data, device=device,
                                  int8_calib=vols[N_RANKS])
    out["dp_int8"] = host(run("dp_int8", lambda: fwd(vols[:N_RANKS])))
    out["ms"]["dp_int8"] = time_ms(lambda: fwd(vols[:N_RANKS]), 3, device)
    del fwd, vols
    if device.type == "cuda":
        torch.cuda.empty_cache()

    params = md_train_params(work, train_csv, val_csv, device,
                             f"md_rank{rank}")
    params.update(distributed=True, mesh_data=N_RANKS)
    first, spent = {}, {}
    with first_step_stats(first), timed_calls(spent, device):
        m = run("train", lambda: Model(params=params))
    out.update(
        losses=[float(v) for v in m.step_losses], first_stats=first,
        history={k: [v for _, v in vals]
                 for k, vals in m.writer.history.items()},
        state={k: v.detach().cpu() for k, v in
               m.state.model.state_dict().items()},
        ckpt=os.path.exists(m.params["model_path"]),
        events=bool(glob.glob(os.path.join(params["workspace_path"],
                                           "runs", "*", "*"))))
    steps_run = MD_TRAIN_STEPS + 1
    out["ms"]["train_step"] = 1e3 * m.train_seconds / steps_run
    out["ms"]["train_all_reduce"] = 1e3 * spent["all_reduce"] / steps_run
    out["ms"]["train_synthesis"] = 1e3 * spent["synthesis"] / steps_run
    out["all_reduces_a_step"] = spent["n_all_reduce"] / steps_run
    return out


def multi_device(device, work: str, shape=SHAPE, before=None):
    """Phase 12: ``N_RANKS`` ranks (``parallel.spawn``, gloo) on the one
    card, at full width:

    - depth-sharded serving (``engine.build_sharded_predict``): UNetSP from
      ``unetsp_10k`` on a phase-3 volume, two slabs of D / 2 planes, in bf16
      (phase 3's gates against the single-rank engine and the plain f32
      model, and each probability within one bf16 ulp of the single-rank
      engine's) and f32 (phase 7's, against the plain f32 model); 12 K1,
      4 K2, 4 K3 per rank;
    - data-parallel serving (``engine.build_dp_predict``) of 2 volumes in
      bf16 and in int8 (the same calibration volume on each rank): each
      rank's volume identical to the single-rank engine's;
    - data-parallel training through ``Model`` (``b_distributed``,
      ``i_mesh_data = 2``, batch 2, ``chain``, ``MD_TRAIN_STEPS`` + 1
      steps): 31 K6 a train step per rank, step 1's loss within 1e-2
      relative and its BatchNorm batch statistics within 4 bf16 ulps of the
      single-process batch-2 run's (phase 5's gates), the parameters
      bit-equal across the ranks, one checkpoint (rank 0's).

    Its times are of ranks sharing one card: they claim nothing about
    scaling. Returns ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, engine, engine_q, parallel, steps
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import make_dataset
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut

    failures, stats = [], {}
    data, paths, csv, atlas, affine = write_volumes(work, shape, N_RANKS + 1)
    # 2 complete skulls, each listed twice: 2 batches of 2 an epoch
    made = make_dataset(os.path.join(work, "train"), n=N_RANKS, shape=shape,
                        seed=40)
    with open(made) as f:
        rows = f.read().splitlines()
    train_csv = os.path.join(work, "train", "twice.csv")
    with open(train_csv, "w") as f:
        f.write("\n".join([rows[0]] + rows[1:] * MD_TRAIN_STEPS) + "\n")

    # ---- references in this process, freed before the ranks start -------
    sd = load_any(UNETSP_10K)
    vols = torch.from_numpy(np.stack([np.stack([nifti_data(p), atlas], -1)
                                      for p in paths])).to(device)
    k_pred = engine.build_predict("UNetSP", sd, device=device)
    p_pred = engine.build_predict("UNetSP", sd, device=device, plain=True)
    model = build_model("UNetSP").to(device).eval()
    model.load_state_dict(sd)
    q_pred = engine_q.build_predict_q("UNetSP", sd, vols[N_RANKS],
                                      device=device)
    with torch.inference_mode():
        ref = {"kernel": k_pred(vols[:1]), "plain": p_pred(vols[:1]),
               "f32": model(vols[:1].float()),
               "dp_bf16": k_pred(vols[:N_RANKS]),
               "dp_int8": q_pred(vols[:N_RANKS])}
        ref = {k: tuple(t.cpu() for t in v) for k, v in ref.items()}
    stats["single_engine_ms"] = time_ms(lambda: k_pred(vols[:1]), 3, device)
    # a data rank's synthesis draws on the card (the Philox offset jump past
    # the other ranks' samples): each rank's samples and the draw after the
    # batch equal one process's, bit for bit
    skulls = (vols[:N_RANKS, ..., 0] > 0).float()
    handler = FlapRecWithShapePriorDoubleOut()

    def draws(synth, images):
        gen = torch.Generator(device=device).manual_seed(5)
        x, t = synth(gen, {"image": images})
        return (x, *t), torch.rand(4, generator=gen, device=device)

    # a step's synthesis function measures a sample's offset advance at its
    # first call and keeps it; the times are of later calls
    synths = [steps.make_synth_fn(handler, shard=steps.DataShard(
        None, N_RANKS, index)) for index in range(N_RANKS)]
    one = steps.make_synth_fn(handler)
    want, want_next = draws(one, skulls)
    for index, synth in enumerate(synths):
        got, got_next = draws(synth, skulls[index:index + 1])
        if not (all(torch.equal(a, b[index:index + 1])
                    for a, b in zip(got, want))
                and torch.equal(got_next, want_next)):
            failures.append(f"phase 12: data rank {index}'s synthesis "
                            "draws differ from one process's")
    stats["synth_batch_ms"] = time_ms(lambda: draws(one, skulls), 3, device)
    stats["synth_rank_ms"] = time_ms(lambda: draws(synths[-1], skulls[-1:]),
                                     3, device)
    log(f"  synthesis on the card: {N_RANKS} ranks' draws equal one "
        f"process's; one process's batch of {N_RANKS} "
        f"{stats['synth_batch_ms']:.2f} ms, a rank's share "
        f"{stats['synth_rank_ms']:.2f} ms")
    del k_pred, p_pred, model, q_pred, vols, skulls, want
    first_ref, spent = {}, {}
    ref_params = md_train_params(work, train_csv, made, device, "md_single")
    with first_step_stats(first_ref), timed_calls(spent, device):
        single = Model(params=ref_params)
    ref_losses = [float(v) for v in single.step_losses]
    stats["single_train_step_ms"] = (1e3 * single.train_seconds
                                     / (MD_TRAIN_STEPS + 1))
    stats["single_train_synthesis_ms"] = (1e3 * spent["synthesis"]
                                          / (MD_TRAIN_STEPS + 1))
    del single
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = parallel.spawn(md_rank, N_RANKS, (work, shape, paths, train_csv,
                                              made, device.type))
    stats["ranks_wall_s"] = time.perf_counter() - t0
    log(f"  {N_RANKS} ranks ({ranks[0]['backend']}, on "
        f"{[r['device'] for r in ranks]}) in {stats['ranks_wall_s']:.1f} s "
        "from spawn to their last result")

    # ---- launches: per rank and path --------------------------------------
    k6 = MD_TRAIN_STEPS * K6_PER_TRAIN_STEP + K6_PER_EVAL_STEP
    want = {
        "sharded_bf16": {"conv3d_bn_relu": 12, "maxpool2": 4,
                         "upconv_bn_relu": 4, "conv3d_tc": 12,
                         "upconv_tc": 4, "maxpool2_rows": 4},
        "sharded_f32": {"conv3d_bn_relu": 12, "maxpool2": 4,
                        "upconv_bn_relu": 4, "conv3d_f32": 12,
                        "conv3d_tc_f32": 12, "maxpool2_f32": 4,
                        "upconv_f32": 4, "upconv_tc_f32": 4,
                        "maxpool2_rows": 4},
        "dp_bf16": {"conv3d_bn_relu": 12, "maxpool2": 4,
                    "upconv_bn_relu": 4, "conv3d_tc": 12, "upconv_tc": 4,
                    "maxpool2_rows": 4},
        "dp_int8": {"conv3d_q_requant": 12, "maxpool2_q": 4,
                    "upconv_q_requant": 4, "conv3d_tc_q": 12,
                    "upconv_tc_q": 4, "maxpool2_rows": 4},
        "train": {"conv3d_bias_act": k6, "conv3d_tc": k6,
                  "adam_mt": MD_TRAIN_STEPS * adam_launches("UNetSP")},
    }
    launches = collections.Counter()
    for r, res in enumerate(ranks):
        for key, w in want.items():
            got = res["counts"].get(key, {})
            log(f"  rank {r} {key}: launches {got}")
            if got != w:
                failures.append(f"phase 12 rank {r} {key}: launches {got} "
                                f"!= {w}")
            launches.update(got)
    launches = dict(launches)

    # ---- depth-sharded serving --------------------------------------------
    for i, sfx in enumerate(("sk", "fl")):
        bf = torch.cat([res["sharded_bf16"][i] for res in ranks], 1)
        f32 = torch.cat([res["sharded_f32"][i] for res in ranks], 1)
        prob = {"sharded": bf[0].float(),
                **{k: ref[k][i][0].float() for k in ("kernel", "plain",
                                                     "f32")}}
        mask = {k: torch.argmax(v, -1).to(torch.uint8).numpy()
                for k, v in prob.items()}
        decided = torch.ones(shape, dtype=torch.bool)
        for k in ("sharded", "kernel"):
            decided &= (prob[k][..., 1] - prob[k][..., 0]).abs() > DECIDED
        dec = decided.numpy()
        d = dict(decided=dice(mask["sharded"][dec], mask["kernel"][dec]),
                 sharded_f32=dice(mask["sharded"], mask["f32"]),
                 plain_f32=dice(mask["plain"], mask["f32"]))
        delta = (prob["sharded"] - prob["kernel"]).abs()
        dp = float(delta.max())
        # beyond a bf16 ulp of the probability: a seam fault (a stale,
        # shifted or swapped halo plane) shows here before it moves Dice
        off_ulp = int((delta > bf16_ulp(prob["kernel"])).sum())
        err, worst = prob_check(f"phase 12 sharded f32 {sfx}",
                                f32[0].float(), prob["f32"], failures)
        log(f"  sharded {sfx}: bf16 vs the single-rank engine: max |dp| "
            f"{dp:.3e} ({off_ulp} values beyond one bf16 ulp), Dice on "
            f"the {int(dec.sum())} decided voxels "
            f"{d['decided']:.6f}; vs the f32 model: sharded "
            f"{d['sharded_f32']:.6f}, plain bf16 {d['plain_f32']:.6f}; f32 "
            f"vs the plain f32 model: max |dp| {err:.3e} (worst / allowance "
            f"{worst:.3f})")
        stats.update({f"sharded_{sfx}_{k}": v for k, v in d.items()})
        stats.update({f"sharded_{sfx}_max_dp_bf16": dp,
                      f"sharded_{sfx}_max_dp_f32": err})
        if not bool(torch.isfinite(prob["sharded"]).all()):
            failures.append(f"phase 12 sharded bf16 {sfx}: not finite")
        if off_ulp:
            failures.append(f"phase 12 sharded bf16 {sfx}: {off_ulp} "
                            "probabilities more than one bf16 ulp from the "
                            f"single-rank engine's (max |dp| {dp})")
        if mask["kernel"].any() or sfx == "sk":
            if not d["decided"] >= 0.999:
                failures.append(f"phase 12 sharded bf16 {sfx}: Dice on "
                                f"decided voxels {d['decided']} < 0.999")
            if not d["sharded_f32"] >= d["plain_f32"] - 1e-3:
                failures.append(f"phase 12 sharded bf16 {sfx}: "
                                f"{d['sharded_f32']} from the f32 model, "
                                f"plain bf16 {d['plain_f32']}")

    # ---- data-parallel serving --------------------------------------------
    for key in ("dp_bf16", "dp_int8"):
        same = all(torch.equal(res[key][i][0], ref[key][i][r])
                   for r, res in enumerate(ranks) for i in range(2))
        stats[f"{key}_identical"] = same
        log(f"  {key}: each rank's volume identical to the single-rank "
            f"engine's: {same}")
        if not same:
            failures.append(f"phase 12 {key}: a rank's volume differs from "
                            "the single-rank engine")

    # ---- data-parallel training -------------------------------------------
    init = build_model("UNetSP").state_dict()
    rel = abs(ranks[0]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    worst = 0.0
    for name, rbuf in first_ref.items():
        bp = (rbuf - 0.9 * init[name]) / 0.1
        tol = 4 * BF16_EPS * float(bp.abs().max().clamp_min(1e-3))
        for res in ranks:
            bk = (res["first_stats"][name] - 0.9 * init[name]) / 0.1
            err = float((bk - bp).abs().max())
            worst = max(worst, err / tol)
            if not err <= tol:
                failures.append(f"phase 12 BN batch statistic {name}: "
                                f"{err} > {tol}")
    equal = all(torch.equal(v, ranks[1]["state"][k])
                for k, v in ranks[0]["state"].items())
    written = [(res["ckpt"], res["events"]) for res in ranks]
    log(f"  training: losses per step {[r['losses'] for r in ranks]} vs one "
        f"process {ref_losses}; step 1 relative {rel:.2e} (limit 1e-2); BN "
        f"batch statistics worst error / tolerance {worst:.3f}; parameters "
        f"bit-equal across ranks: {equal}; (checkpoint, events) by rank: "
        f"{written}")
    stats.update(step1_loss_rel=rel, bn_worst=worst, params_equal=equal,
                 losses=ranks[0]["losses"], single_losses=ref_losses)
    if not rel <= 1e-2:
        failures.append(f"phase 12 step 1 loss {ranks[0]['losses'][0]} vs "
                        f"{ref_losses[0]}: {rel} > 1e-2")
    if not all(math.isfinite(v) for r in ranks for v in r["losses"]):
        failures.append("phase 12 training: losses not finite")
    if not equal:
        failures.append("phase 12: parameters differ across the ranks")
    if written != [(True, True)] + [(False, False)] * (N_RANKS - 1):
        failures.append(f"phase 12: checkpoints and events by rank "
                        f"{written}, want rank 0's only")
    for r, res in enumerate(ranks):
        stats[f"rank{r}_ms"] = res["ms"]
        if res["exchanges_bf16"] != 16:  # before each K1 and each K3
            failures.append(f"phase 12 rank {r}: {res['exchanges_bf16']} "
                            "halo exchanges a volume, want 16")
    log(f"  ms (CUDA events, halo_* the sharded engine's 16 exchanges on "
        f"the host clock; {N_RANKS} ranks share the card, so these say "
        f"nothing of scaling): single-rank engine "
        f"{stats['single_engine_ms']:.2f} per volume; by rank "
        f"{[r['ms'] for r in ranks]}; one-process batch-2 train step "
        f"{stats['single_train_step_ms']:.1f} (host clock over the Model "
        "run, the eval step counted as a step), its synthesis "
        f"{stats['single_train_synthesis_ms']:.1f}; a rank's train_step "
        "holds train_all_reduce (every all-reduce, the wait for the other "
        "rank included) and train_synthesis, each timed between two "
        "synchronizations")
    return launches, stats, failures


# phase 13: the profiler's view of the kernels, the generic UNet's options
# at full width, the int8 and attribution tools
P13_OPTIONS = {"residual": dict(residual=True), "cat=False": dict(cat=False),
               "no skips": dict(use_skip_connections=False)}
P13_FC_SHAPE = (64, 64, 64)  # fc_layer's Dense grows with the volume
P13_FC_WIDTH = 64  # fc_layer's cfc; its ifc is the pooled volume's size
P13_TOOL_SHAPE = (64, 128, 128)  # the JAX int8 tools' SHAPE
P13_ADAQUANT_STEPS = 20
P13_COVERAGE = 0.9  # profiled share of the launches' own device time
# the hand-written kernels of one bf16 UNetSP engine pass by kernel name,
# with the wrapper spans each must sit in
P13_PASS = {"conv3d_tc_kernel": (12, ["conv3d_bn_relu", "conv3d_tc"]),
            "maxpool2_rows_kernel": (4, ["maxpool2", "maxpool2_rows"]),
            "upconv_tc_kernel": (4, ["upconv_bn_relu", "upconv_tc"])}


def run_tool(name: str, argv):
    """``tools/<name>.py``'s ``main(argv)`` in this process; its one JSON
    line parsed (its progress goes to stderr)."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(list(argv))
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise RuntimeError(f"{name}: exit {rc}, stdout {lines[:3]}")
    return json.loads(lines[0])


def recorded_launches(device, fn):
    """``fn()`` once with the bf16 kernel functions (``conv3d_tc``,
    ``maxpool2_rows``, ``upconv_tc``) recording their calls; returns
    ``[(kernel function, args)]`` in launch order."""
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import upconv as ku

    calls, saved = [], []
    for mod, name in ((kc, "conv3d_tc"), (kc, "maxpool2_rows"),
                      (ku, "upconv_tc")):
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, **kw):
            calls.append((_orig, a, kw))
            return _orig(*a, **kw)

        # a kernel function counts on the name its own module calls it by,
        # here the recorder's where that is the module patched
        rec.launches = 0
        saved.append((mod, name, orig, rec))
        setattr(mod, name, rec)
    try:
        fn()
        sync(device)
    finally:
        for mod, name, orig, rec in saved:
            orig.launches += rec.launches
            setattr(mod, name, orig)
    return calls


def options_step(device, name: str, shape, failures, **unet_kw):
    """One bf16 ``chain`` train step of ``UNet(input_channels=2,
    out_channels=3, i_size=7, n_blocks=4, **unet_kw)`` with the
    double-output head (UNetSP's), on a broken skull, against the same
    step with ``conv_impl = plain``: phase 5's loss and BatchNorm gates and
    its K6 count. Returns the step's stats."""
    import copy

    import numpy as np
    import torch

    from ctunet_tpu_torch import steps
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.models import double_out_head
    from ctunet_tpu_torch.models.unet import UNet
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut

    class Options(UNet):
        def forward(self, x):
            return double_out_head(super().forward(x))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        base = Options(input_channels=2, out_channels=3, i_size=7,
                       n_blocks=4, **unet_kw).to(device)
    init = copy.deepcopy(base.state_dict())
    vol = torch.from_numpy(spherical_shell(shape, seed=13).astype(
        np.float32))[None].to(device)
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    handler = FlapRecWithShapePriorDoubleOut()
    loss_cfg = {"ce_lambda": 1.0, "dice_lambda": 1.0}
    out = {}
    for impl in ("chain", "plain"):
        model = copy.deepcopy(base).configure(impl, torch.bfloat16)
        state = steps.TrainState(model, steps.make_optimizer(
            {"optimizer": "adam", "learning_rate": 1e-4},
            model.parameters()))
        step = steps.make_train_step(model, handler, loss_cfg, atlas=atlas,
                                     compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=device).manual_seed(5)
        kernels.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        _, terms = step(state, {"image": vol}, gen)
        sync(device)
        out[impl] = (float(terms["epoch_loss"]), 1e3 * (time.perf_counter()
                                                       - t0),
                     kernels.launches()["conv3d_bias_act"], model)
    (lk, ms_k, k6, mk), (lp, ms_p, _, mp) = out["chain"], out["plain"]
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    worst = batch_stat_check(init, mk.state_dict(), mp.state_dict(),
                             failures, f"UNet {name}: ")
    log(f"  UNet {name} {'x'.join(map(str, shape))}: chain step loss "
        f"{lk:.6f} vs plain {lp:.6f} (relative {rel:.2e}, limit 1e-2), BN "
        f"batch statistics worst error / tolerance {worst:.3f}, K6 {k6} a "
        f"train step (want {K6_PER_TRAIN_STEP}); first steps {ms_k:.1f} / "
        f"{ms_p:.1f} ms (chain / plain, compile-free but cold)")
    if not (math.isfinite(lk) and rel <= 1e-2):
        failures.append(f"UNet {name}: step loss {lk} vs plain {lp}")
    if k6 != K6_PER_TRAIN_STEP:
        failures.append(f"UNet {name}: {k6} K6 launches a train step")
    return dict(loss=lk, plain_loss=lp, rel=rel, bn_worst=worst, k6=k6)


def span_cost(device, sd, shape=(64, 64, 64), reps: int = 20) -> dict:
    """What the wrappers' profiler spans cost the host: one
    ``record_function`` span and one check of the profiler's state (what a
    wrapper call pays with no profiler running), in microseconds, and a
    bf16 UNetSP engine call on 4 volumes of ``shape`` (host-bound: 80
    wrapper calls, 160 spans) with the spans forced on and off, in turns
    (off, on, on, off)."""
    import torch

    from ctunet_tpu_torch import engine

    def per_call_us(fn, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def span():
        with torch.profiler.record_function("x"):
            pass

    out = {"span_us": per_call_us(span),
           "check_us": per_call_us(torch._C._autograd._profiler_enabled)}
    fwd = engine.build_predict("UNetSP", sd, device=device)
    x = (torch.rand((4, *shape, 2), device=device) > 0.5).float()
    check = torch._C._autograd._profiler_enabled
    try:
        for label in ("off", "on", "on", "off"):
            torch._C._autograd._profiler_enabled = (
                check if label == "off" else (lambda: True))
            fwd(x)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fwd(x)
            sync(device)
            out.setdefault(f"engine_ms_spans_{label}", []).append(
                1e3 * (time.perf_counter() - t0) / reps)
    finally:
        torch._C._autograd._profiler_enabled = check
    return out


def surface_tools(device, work: str, shape=SHAPE, before=None,
                  fc_shape=P13_FC_SHAPE, tool_shape=P13_TOOL_SHAPE):
    """Phase 13: (1) a ``torch.profiler`` window over one bf16 UNetSP engine
    pass lists every hand-written launch by kernel name inside its
    wrapper's span, and their profiled device time covers the same
    launches' own (``device_ms``); over one ``chain`` train step it lists
    the 31 K6 launches; neither trace lost a kernel record; (2) the generic ``UNet``'s options at full width,
    one ``chain`` step each against the plain versions; (3) the int8 tools
    and the attribution tools through their command lines. Returns
    ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import engine, steps
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
    from ctunet_tpu_torch.utils import profiling

    failures, stats, launches = [], {}, {}
    card = card_line() if device.type == "cuda" else "cpu"
    sd = load_any(UNETSP_10K)
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    x = torch.from_numpy(np.stack([punched_shell(shape, 1).astype(
        np.float32), atlas], -1)[None]).to(device)

    # (1a) the engine pass
    k_pred = engine.build_predict("UNetSP", sd, device=device)
    k_pred(x)
    sync(device)
    kernels.reset_launches()
    calls = recorded_launches(device, lambda: k_pred(x))
    add_counts(launches, kernels.launches())
    own = [device_ms(lambda f=f, a=a, kw=kw: f(*a, **kw), 5, device)
           for f, a, kw in calls]
    kernels.reset_launches()
    with profiling.trace(device) as prof:
        k_pred(x)
    add_counts(launches, kernels.launches())
    rows, dropped = profiling.attribute(prof.events())
    log(f"  launches lost by the trace of the engine pass: {dropped}")
    if dropped:
        failures.append(f"profiler: the engine pass's trace lost {dropped} "
                        "kernel records")
    profiled = 0.0
    for key, (want, spans) in P13_PASS.items():
        got = [r for r in rows if key in r["name"]]
        inside = sum(r["spans"] == spans for r in got)
        profiled += sum(r["ms"] for r in got)
        log(f"  profile of one bf16 UNetSP pass {'x'.join(map(str, shape))}"
            f": {len(got)} {key} launches by name (want {want}), {inside} "
            f"inside {'/'.join(spans)}")
        if len(got) != want or inside != want:
            failures.append(f"profiler: {len(got)} {key} ({inside} in their "
                            f"spans), want {want}")
    total = sum(r["ms"] for r in rows)
    cover = profiled / max(sum(own), 1e-9)
    stats["engine_pass"] = dict(
        profiled_hand_ms=profiled, launches_device_ms=sum(own),
        coverage=cover, pass_kernel_ms=total, hand_share=profiled / total
        if total else None, rollup=profiling.rollup(rows))
    log(f"  the 20 launches: {profiled:.3f} ms profiled, {sum(own):.3f} ms "
        f"by device_ms one at a time (coverage {cover:.3f}, want >= "
        f"{P13_COVERAGE}); the pass's kernels {total:.3f} ms, hand-written "
        f"{100 * profiled / max(total, 1e-9):.1f}% [{card}]")
    for cat, ms in profiling.rollup(rows).items():
        log(f"    {ms:9.3f} ms  {cat}")
    if len(calls) != 20 or not cover >= P13_COVERAGE:
        failures.append(f"profiler: {len(calls)} launches recorded, "
                        f"coverage {cover:.3f} < {P13_COVERAGE}")
    del k_pred

    # (1b) one chain train step
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("UNetSP").to(device).configure(
            "chain", torch.bfloat16)
    state = steps.TrainState(model, steps.make_optimizer(
        {"optimizer": "adam", "learning_rate": 1e-4}, model.parameters()))
    step = steps.make_train_step(
        model, FlapRecWithShapePriorDoubleOut(),
        {"ce_lambda": 1.0, "dice_lambda": 1.0}, atlas=atlas,
        compute_dtype=torch.bfloat16)
    vol = torch.from_numpy(spherical_shell(shape, seed=2).astype(
        np.float32))[None].to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    step(state, {"image": vol}, gen)
    sync(device)
    kernels.reset_launches()
    with profiling.trace(device) as prof:
        step(state, {"image": vol}, gen)
    add_counts(launches, kernels.launches())
    rows, dropped = profiling.attribute(prof.events())
    if dropped:
        failures.append(f"profiler: the train step's trace lost {dropped} "
                        "kernel records")
    # the wrappers' spans, inside the step's own ctunet.train.* spans
    k6 = [r for r in rows if "conv3d_tc_kernel" in r["name"]
          and [s for s in r["spans"] if not s.startswith(
              profiling.SPAN_PREFIX)][:2] == ["conv3d_bias_act", "conv3d_tc"]]
    total = sum(r["ms"] for r in rows)
    log(f"  profile of one chain train step: {len(k6)} K6 launches by name "
        f"inside conv3d_bias_act/conv3d_tc (want {K6_PER_TRAIN_STEP}), "
        f"{sum(r['ms'] for r in k6):.2f} of {total:.2f} ms, {dropped} "
        f"launches lost by the trace [{card}]")
    for cat, ms in profiling.rollup(rows).items():
        log(f"    {ms:9.3f} ms  {cat}")
    for t in profiling.top(rows, 10):
        log(f"    {t['ms']:8.3f} ms x{t['count']:<4d} {t['name'][:56]:<56s} "
            f"{t['spans']}")
    stats["chain_step"] = dict(k6=len(k6), step_kernel_ms=total,
                               rollup=profiling.rollup(rows))
    if len(k6) != K6_PER_TRAIN_STEP:
        failures.append(f"profiler: {len(k6)} K6 launches in a train step")
    del model, state, step
    cost = span_cost(device, sd)
    stats["span_cost"] = cost
    log(f"  the spans' host cost: {cost['span_us']:.2f} us a span, "
        f"{cost['check_us']:.3f} us a check with no profiler running; a "
        f"bf16 UNetSP engine call on 4 x 64^3 (160 spans) "
        f"{cost['engine_ms_spans_off']} ms with the spans off, "
        f"{cost['engine_ms_spans_on']} ms forced on [{card}]")

    # (2) the UNet options
    opts = {}
    for name, kw in P13_OPTIONS.items():
        opts[name] = options_step(device, name, shape, failures, **kw)
        add_counts(launches, kernels.launches())
    ifc = int(np.prod(fc_shape)) // 16 ** 3 * 56  # the last pool's, 56 wide
    opts["fc_layer"] = options_step(device, "fc_layer", fc_shape, failures,
                                    fc_layer=(ifc, P13_FC_WIDTH))
    add_counts(launches, kernels.launches())
    stats["unet_options"] = opts

    # (3) the tools
    tools = {}
    tshape = ",".join(map(str, tool_shape))
    full = ",".join(map(str, shape))
    cpu = [] if device.type == "cuda" else ["--cpu"]
    for name, argv in (
            ("adaquant_run_torch", ["--shape", tshape, "--steps",
                                    str(P13_ADAQUANT_STEPS)]),
            ("quant_sim_eval_torch", ["--shape", tshape, "--modes", "rtn"]),
            ("int8_sensitivity_torch", ["--shape", tshape]),
            ("attr_int8_torch", ["--shape", full, "--n", "1"]),
            ("attr_train_torch", ["--shape", full, "--impl", "chain",
                                  "--n", "1"])):
        t0 = time.perf_counter()
        try:
            res = run_tool(name, argv + cpu)
        except Exception:  # noqa: BLE001  report, then fail the phase
            traceback.print_exc()
            failures.append(f"tool {name} raised")
            continue
        res["wall_s"] = time.perf_counter() - t0
        tools[name] = res
        brief = {k: v for k, v in res.items()
                 if k not in ("top", "only", "round_opt")}
        log(f"  {name} ({res['wall_s']:.1f} s) [{card}]: "
            f"{json.dumps(brief)}")
        for t in res.get("top", [])[:8]:
            log(f"    {t['ms']:8.3f} ms x{t['count']:<5g} "
                f"{t['name'][:56]:<56s} {t['spans']}")
    stats["tools"] = tools
    aq = tools.get("adaquant_run_torch")
    if aq is not None:
        for head in ("sk", "fl"):
            if not aq["adaquant"][head] >= aq["rtn"][head] - 0.002:
                failures.append(f"adaquant_run_torch: {head} agreement "
                                f"{aq['adaquant'][head]} < rtn "
                                f"{aq['rtn'][head]} - 0.002")
        for k in ("conv3d_q_requant", "maxpool2_q", "upconv_q_requant"):
            if not aq["launches"].get(k):
                failures.append(f"adaquant_run_torch: no {k} launch")
            launches[k] = launches.get(k, 0) + aq["launches"].get(k, 0)
    at8 = tools.get("attr_int8_torch")
    if at8 is not None and at8["wrapper_launches"] != {
            "conv3d_q_requant": 12, "maxpool2_q": 4, "upconv_q_requant": 4}:
        failures.append(f"attr_int8_torch: {at8['wrapper_launches']}")
    att = tools.get("attr_train_torch")
    if att is not None and att["wrapper_launches"].get(
            "conv3d_bias_act") != K6_PER_TRAIN_STEP:
        failures.append(f"attr_train_torch: {att['wrapper_launches']}")
    for res in (at8, att):
        if res is not None and res["dropped"]:
            failures.append(f"{res['tool']}: the trace lost "
                            f"{res['dropped']} kernel records")
    for name in ("quant_sim_eval_torch", "int8_sensitivity_torch"):
        res = tools.get(name, {})
        d = res.get("rtn") or res.get("all")
        if d is None or not all(0.0 <= d[h] <= 1.0 for h in ("sk", "fl")):
            failures.append(f"{name}: no Dice in [0, 1]: {d}")
    log(f"  phase 13 launches: {launches} [{card}]")
    return launches, stats, failures


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
            ("K2 and K2q (maxpool2_rows) at every launch shape of the paths, "
             "bf16, f32 and int8, exact", lambda: check_pool(device)),
            ("int8 inputs, exact", lambda: check_kernels_q(sd, device)),
            ("bf16 conv3d_tc (K1, K6, K5) at every shape of the paths, "
             "random weights", lambda: check_conv_tc(device)),
            ("training conv K6 f32 and autograd, random weights",
             lambda: check_kernel_train(device)),
            ("bf16 upconv_tc (K3, K7a, K7b) at every shape of the paths",
             lambda: check_upconv_tc(sd, device)),
            ("f32 kernels (K1, K2, K3, K5, K7a, K7b) at every f32 shape of "
             "the paths", lambda: check_kernels_f32(sd, device)),
            ("K1q, K2q, K3q and the bf16 K1, K2, K3 at phase 9's int8 "
             "serving window, K6 at its training window",
             lambda: check_windows(sd, device)),
            ("phase 10's UNetSPSmall at 224x512x512: K2 and K2q, the bf16 "
             "K1, K6 and K3, K1q and K3q, the f32 K1 and K3",
             lambda: check_512(device)),
            ("the multi-tensor Adam kernel at UNetSP's and UNetSPSmall's "
             "leaves against the per-leaf update, exact",
             lambda: check_adam(device))):
        log(f"  -- {label}")
        try:
            got, errs = check()
            entries.update(got)
            failures += errs
        except Exception:  # noqa: BLE001  report, then fail the run below
            traceback.print_exc()
            failures.append(f"phase 2 ({label}) raised")
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    launches, shared = {}, {"conv3d_tc": 0, "upconv_tc": 0,
                            "maxpool2_rows": 0}
    size = "x".join(map(str, SHAPE))
    phase_stats = {}
    for phase, label, fn in (
            (3, f"bf16, {N_VOLUMES} UNetSP volumes {size}", serve),
            (4, f"int8 + AdaQuant ({ADAQUANT_STEPS} steps), {N_VOLUMES} "
                f"UNetSP volumes {size}", serve_int8),
            (5, f"training, UNetSP {size} bf16 conv_impl=chain, {N_TRAIN} "
                f"train + {N_EVAL} eval steps, save, serve 1 volume", train),
            (6, f"legacy k=5 serving, {N_VOLUMES} UNet4_2IC volumes {size} "
                "+ 1 recAE_v2_fixed volume", serve_legacy),
            (7, f"f32 serving, {N_VOLUMES} UNetSP volumes {size}, 1 "
                "UNet4_2IC + 1 recAE_v2_fixed volume, 1 int8 volume with an "
                f"f32 head, f32 training ({N_TRAIN_F32} + 1 steps) and 1 "
                "volume served from it",
             lambda device, work: serve_f32(device, work, bf16=phase_stats)),
            (8, f"legacy training, UNet4_2IC ({LEGACY_TRAIN[0][1]} steps) "
                f"and recAE_v2_fixed ({LEGACY_TRAIN[1][1]} steps) {size} "
                "bf16 conv_impl=pallas + 1 eval step each, save, serve 1 "
                "volume each", train_legacy),
            (9, f"fg-crop int8 serving, {len(FG_SKULLS)} UNetSP volumes "
                f"{size} with FlapRecSP2O_serve_int8.ini as written (crop, "
                "K-volume batches of 4, the serving profile), then fg-crop "
                f"training ({FG_TRAIN_STEPS} + 1 steps)",
             lambda device, work: fg_crop(device, work, before=phase_stats)),
            (10, f"the 5-block family, FlapRecSP2O_512.ini (UNetSPSmall, "
                 f"unetspsmall_3k) at {'x'.join(map(str, SHAPE_512))}: bf16 "
                 f"whole volumes ({N_512}), f32, int8, sliding windows, "
                 f"training ({N_TRAIN_512} + 1 steps) and 1 volume served",
             lambda device, work: spsmall(device, work, before=phase_stats)),
            (11, f"pickled-module .pt files (zip, and nn.DataParallel in the "
                 f"legacy format) served against the .npz, preprocessing of "
                 f"a {'x'.join(map(str, CT_SHAPE))} CT on the card, "
                 f"largest_cc_device, param_dtype = bfloat16 training with "
                 f"profile_dir (2 epochs of 1 step), QAT ({QAT_STEPS} steps "
                 f"at {'x'.join(map(str, QAT_SHAPE))}, lr {QAT_LR}) and its "
                 f"int8 engine "
                 f"at {size}",
             lambda device, work: pickled_ops_qat(device, work,
                                                  before=phase_stats)),
            (12, f"{N_RANKS} ranks on the one card (gloo): UNetSP depth-"
                 f"sharded serving of a {size} volume in bf16 and f32, "
                 f"data-parallel serving of {N_RANKS} volumes in bf16 and "
                 f"int8, data-parallel training (batch {N_RANKS}, "
                 f"{MD_TRAIN_STEPS} + 1 steps)", multi_device),
            (13, f"the profiler over a bf16 engine pass and a chain train "
                 f"step at {size}, the generic UNet's options ("
                 f"{', '.join(P13_OPTIONS)} at {size}, fc_layer at "
                 f"{'x'.join(map(str, P13_FC_SHAPE))}), the int8 tools at "
                 f"{'x'.join(map(str, P13_TOOL_SHAPE))} and the attribution "
                 f"tools at {size}", surface_tools)):
        log(f"== phase {phase}: main path, {label}, through Model")
        t0 = time.perf_counter()
        got = {}
        try:
            with tempfile.TemporaryDirectory(prefix=".smoke_",
                                             dir=ROOT) as work:
                got, stats, errs = fn(device, work)
            phase_stats[phase] = stats
            failures += errs
            log("  stats: " + json.dumps(stats))
        except Exception:  # noqa: BLE001  report, then fail the run below
            traceback.print_exc()
            failures.append(f"phase {phase} raised")
        log(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")
        if not got or min(got.values()) == 0:
            failures.append(f"phase {phase}: a kernel of the path was never "
                            f"launched: {got}")
        if phase == 10:  # the 5-block family's launches: rows of their own
            launches.update({k + AT_512: v for k, v in got.items()})
            continue
        # a later phase's count of an earlier kernel (phase 5 serves one
        # volume on K1-K3) does not replace the phase that owns it; the
        # bf16 convs of phases 3, 5 and 6 all launch conv3d_tc, their K3,
        # K7a and K7b upconv_tc, and every phase's K2 and K2q
        # maxpool2_rows
        for k in shared:
            shared[k] += got.pop(k, 0)
        launches.update({k: v for k, v in got.items() if k not in launches})
    launches.update(shared)

    log(f"== total {time.perf_counter() - t_all:.1f} s")

    sources = {
        "conv3d_tc": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                      "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "conv3d_bn_relu": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                           "ctunet_tpu/ops/pallas/conv3d.py:1031"),
        "maxpool2": ("ctunet_tpu_torch/csrc/maxpool_rows.cu",
                     "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        # the pool's kernel under K2 (bf16, f32) and K2q (int8); launches
        # over every phase
        "maxpool2_rows": ("ctunet_tpu_torch/csrc/maxpool_rows.cu",
                          "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_tc": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                      "ctunet_tpu/ops/pallas/convt.py:146"),
        "upconv_bn_relu": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                           "ctunet_tpu/ops/pallas/upconv.py:464"),
        "conv3d_q_requant": ("ctunet_tpu_torch/csrc/conv3d_tc_q.cu",
                             "ctunet_tpu/ops/pallas/conv3d.py:1677"),
        "maxpool2_q": ("ctunet_tpu_torch/csrc/maxpool_rows.cu",
                       "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_q_requant": ("ctunet_tpu_torch/csrc/upconv_tc_q.cu",
                             "ctunet_tpu/ops/pallas/upconv.py:1015"),
        "conv3d_tc_q": ("ctunet_tpu_torch/csrc/conv3d_tc_q.cu",
                        "ctunet_tpu/ops/pallas/conv3d.py:1031"),
        "upconv_tc_q": ("ctunet_tpu_torch/csrc/upconv_tc_q.cu",
                        "ctunet_tpu/ops/pallas/upconv.py:464"),
        "conv3d_bias_act": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                            "ctunet_tpu/ops/pallas/conv3d.py:453"),
        "conv3d5_bias_act": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                             "ctunet_tpu/ops/pallas/conv3d.py:136"),
        # K5 as the legacy training conv (phase 8): forward and input
        # gradient, the row's case one of the new input-gradient shapes
        "conv3d5_train": ("ctunet_tpu_torch/csrc/conv3d_tc.cu",
                          "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "convt_k2s2": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                       "ctunet_tpu/ops/pallas/convt.py:78"),
        "convt_k2s2_dual": ("ctunet_tpu_torch/csrc/upconv_tc.cu",
                            "ctunet_tpu/ops/pallas/convt.py:146"),
        # the f32 paths (phase 7): the convs and the upsamplings on the f32
        # tensor-core kernels, the max pool on the row-streaming kernel
        "conv3d_tc_f32": ("ctunet_tpu_torch/csrc/conv3d_tc_f32.cu",
                          "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "upconv_tc_f32": ("ctunet_tpu_torch/csrc/upconv_tc_f32.cu",
                          "ctunet_tpu/ops/pallas/convt.py:146"),
        "conv3d_bn_relu_f32": ("ctunet_tpu_torch/csrc/conv3d_tc_f32.cu",
                               "ctunet_tpu/ops/pallas/conv3d.py:1031"),
        "conv3d_bias_act_f32": ("ctunet_tpu_torch/csrc/conv3d_tc_f32.cu",
                                "ctunet_tpu/ops/pallas/conv3d.py:453"),
        "conv3d5_bias_act_f32": ("ctunet_tpu_torch/csrc/conv3d_tc_f32.cu",
                                 "ctunet_tpu/ops/pallas/conv3d.py:136"),
        "maxpool2_f32": ("ctunet_tpu_torch/csrc/maxpool_rows.cu",
                         "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_bn_relu_f32": ("ctunet_tpu_torch/csrc/upconv_tc_f32.cu",
                               "ctunet_tpu/ops/pallas/upconv.py:464"),
        "convt_k2s2_f32": ("ctunet_tpu_torch/csrc/upconv_tc_f32.cu",
                           "ctunet_tpu/ops/pallas/convt.py:78"),
        "convt_k2s2_dual_f32": ("ctunet_tpu_torch/csrc/upconv_tc_f32.cu",
                                "ctunet_tpu/ops/pallas/convt.py:146"),
        # the optimizer of phases 5 and 10's training: no TPU kernel, the
        # JAX step leaves optax's amsgrad to XLA
        "adam_mt": ("ctunet_tpu_torch/csrc/adam_mt.cu",
                    "ctunet_tpu/steps.py:414"),
    }
    kernels = []
    for name, (src, repl) in sources.items():
        # the UNetSP canvas's row, then phase 10's where it launched the
        # kernel; each row's launches are its own path's
        for key in (name, name + AT_512):
            if key != name and key not in launches:
                continue
            e = entries.get(key)
            if e is None:
                failures.append(f"kernel line: no phase-2 check of {key}")
                continue
            kernels.append(dict(
                name=f"{name} [{e['case']}]", route="cuda", source=src,
                replaces=repl, launches=launches.get(key, 0),
                max_abs_err=e["max_abs_err"], ms=e["ms"],
                plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                bound_by=e["bound_by"], library_ms=e["library_ms"]))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
