#!/usr/bin/env python3
"""Drive the PyTorch port (``ctunet_tpu_torch``) once on one CUDA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Card and build: prints the card's name and power limit as ``nvidia-smi``
   gives them, then builds the three Hopper kernels from
   ``ctunet_tpu_torch/csrc/`` (one ``nvcc`` each, in parallel) and times it.
2. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's real shapes (UNetSP, 224x304x304), with the stated
   tolerance; the kernel's time beside the plain version's, one PyTorch
   library call's (cuDNN for the convolutions) and the card's bound.
3. Main path: serves synthetic broken skulls (``spherical_shell`` with a
   hole punched; atlas ``spherical_shell(radius_frac=0.42)``) through the
   ``Model`` test path with the committed ``unetsp_10k`` weights, checks
   the written ``pred_<name>/*_{sk,fl,i}.nii.gz`` masks (shape, affine),
   the launch counts (12 K1, 4 K2, 4 K3 per volume) and the masks against
   the engine run with the plain versions on the card (Dice >= 0.999 over
   the voxels both decide, see ``DECIDED``) and against the plain f32
   model (the kernel engine no further from it than the plain bf16 one).

The last two lines of output are one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result. Needs a CUDA card and the repo beside this file; it
imports nothing of JAX and nothing of ``ctunet_tpu``.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16, published
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


def bound_ms(n_bytes: float, n_flops: float):
    """(least time on the card in ms, "bytes" or "operations")."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def conv_taps(shape, k: int) -> int:
    """(output voxel, in-bounds tap) pairs of a SAME k-conv over ``shape``."""
    p = k // 2
    return math.prod(n * k - p * (p + 1) for n in shape)


def upconv_taps(shape2) -> int:
    """(output voxel, in-bounds tap) pairs of K3 from half-res ``shape2``:
    2 taps per dimension except one at each face, 4n-2 per dimension."""
    return math.prod(4 * n - 2 for n in shape2)


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


def check_kernels(sd, device, shape=SHAPE, reps_big: int = 5,
                  reps_small: int = 50):
    """Each kernel against its plain version at the path's shapes, with the
    trained weights of the layer that runs at that shape. Returns
    ``(entries, failures)``, ``entries`` keyed by wrapper name."""
    import torch
    import torch.nn.functional as F

    from ctunet_tpu_torch import engine
    from ctunet_tpu_torch.ops.kernels import conv3d as kc
    from ctunet_tpu_torch.ops.kernels import upconv as ku

    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    d, h, w = shape
    lv = [(d >> i, h >> i, w >> i) for i in range(5)]
    entries, failures = {}, []

    def record(name, case, got, ref, ms, plain_ms, lib_ms, nbytes, nflops,
               tol):
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

    # K1: the full-resolution 7->7 conv (d0 unit1) and the 28x38x38 56->56
    # conv (d3 unit1)
    for blk, shp in ((0, lv[0]), (3, lv[3])):
        w_, b_ = engine.conv_operands(sd, f"d_blocks.{blk}.block", 3, bf,
                                      device)
        ci, co = w_.shape[3], w_.shape[4]
        x = relu_normal(shp + (ci,), gen, device)
        reps = reps_big if blk == 0 else reps_small
        got = kc.conv3d_bn_relu(x, w_, b_)
        ref = kc.conv3d_bn_relu_plain(x, w_, b_)
        ms = time_ms(lambda: kc.conv3d_bn_relu(x, w_, b_), reps, device)
        p_ms = time_ms(lambda: kc.conv3d_bn_relu_plain(x, w_, b_), reps,
                       device)
        x_l = x.permute(3, 0, 1, 2)[None]
        w_l = w_.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        b_l = b_.to(bf)
        l_ms = time_ms(lambda: F.conv3d(x_l, w_l, b_l, padding=1), reps,
                       device)
        nbytes = 2 * math.prod(shp) * (ci + co) + w_.numel() * 2 + co * 4
        record("conv3d_bn_relu", f"{ci}->{co} {'x'.join(map(str, shp))}",
               got, ref, ms, p_ms, l_ms, nbytes,
               2 * ci * co * conv_taps(shp, 3), bf16_tol(ref))
        del x, got, ref

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

    # K3: u3 (14+14 -> 7, out 224x304x304) and u0 (56 -> 56, out 28x38x38)
    for j, shp2 in ((3, lv[1]), (0, lv[4])):
        ca = None if j == 0 else int(
            sd[f"u_blocks.{j - 1}.block.4.weight"].shape[0])
        wa, wb, wone, bu = engine.upconv_operands(sd, j, ca, bf, device)
        a = relu_normal(shp2 + (wa.shape[3],), gen, device)
        b = None if wb is None else relu_normal(shp2 + (wb.shape[3],), gen,
                                                device)
        co = wa.shape[4]
        cin = wa.shape[3] + (0 if wb is None else wb.shape[3])
        reps = reps_big if j == 3 else reps_small
        got = ku.upconv_bn_relu(a, b, wa, wb, wone, bu)
        ref = ku.upconv_bn_relu_plain(a, b, wa, wb, wone, bu)
        ms = time_ms(lambda: ku.upconv_bn_relu(a, b, wa, wb, wone, bu), reps,
                     device)
        p_ms = time_ms(
            lambda: ku.upconv_bn_relu_plain(a, b, wa, wb, wone, bu), reps,
            device)
        parts = [a, torch.ones_like(a[..., :1])] + ([] if b is None else [b])
        x_l = torch.cat(parts, -1).permute(3, 0, 1, 2)[None]
        r_l = torch.cat([wa, wone[..., None, :]] + ([] if wb is None
                                                    else [wb]), 3)
        r_l = r_l.permute(3, 4, 0, 1, 2).contiguous()
        b_l = bu.to(bf)
        l_ms = time_ms(lambda: F.conv_transpose3d(x_l, r_l, b_l, stride=2,
                                                  padding=1), reps, device)
        out_shape = tuple(2 * s for s in shp2)
        nbytes = (2 * math.prod(shp2) * cin + 2 * math.prod(out_shape) * co
                  + 2 * (wa.numel() + wone.numel()
                         + (0 if wb is None else wb.numel())))
        record("upconv_bn_relu",
               f"{cin}->{co} {'x'.join(map(str, out_shape))}", got, ref, ms,
               p_ms, l_ms, nbytes, 2 * (cin + 1) * co * upconv_taps(shp2),
               bf16_tol(ref))
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


def profile_device(fn, device, rows: int = 12) -> None:
    """Print the device time of one ``fn()`` by kernel name
    (``torch.profiler``), or "not measured" when it sees none."""
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
        return
    log(f"  device profile of one volume: {total:.2f} ms of kernels")
    for key, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]
                               )[:rows]:
        log(f"    {ms:8.3f} ms {100 * ms / total:5.1f}% x{n:<3d} {key[:70]}")


def dice(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a) > 0, np.asarray(b) > 0
    s = int(a.sum()) + int(b.sum())
    return 1.0 if s == 0 else 2.0 * int((a & b).sum()) / s


def serve(device, work: str, shape=SHAPE, n_volumes: int = N_VOLUMES):
    """Serve ``n_volumes`` synthetic volumes through ``Model``; check the
    files, the launch counts and the masks against the plain engine.
    Returns ``(launches, stats, failures)``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import Model, engine
    from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.data.atlas import register_atlas
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.utils import nifti

    failures = []
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

    params = dict(
        test_flag=True, name="chip_smoke", model_class="UNetSP",
        problem_handler="FlapRecWithShapePriorDoubleOut",
        device=device.type, workspace_path=os.path.join(work, "ws"),
        test_files_csv=csv, resume_model=UNETSP_10K, n_workers=2,
        prefetch_depth=2,
    )
    kernels.reset_launches()
    m = Model(params=params)  # ends with the masks fetched to the host
    launches = kernels.launches()
    want = {"conv3d_bn_relu": 12 * n_volumes, "maxpool2": 4 * n_volumes,
            "upconv_bn_relu": 4 * n_volumes}
    log(f"  launches over {n_volumes} volumes: {launches} (want {want})")
    if launches != want:
        failures.append(f"launch counts {launches} != {want}")
    stats = dict(volumes=m.n_served, loop_s=m.serve_seconds,
                 vol_per_s=m.n_served / m.serve_seconds,
                 ms_per_vol=1e3 * m.serve_seconds / m.n_served)
    log(f"  Model test loop: {m.n_served} volumes in {m.serve_seconds:.3f} s "
        f"= {stats['vol_per_s']:.3f} volumes/s, {stats['ms_per_vol']:.1f} "
        "ms/volume (decode, upload, engine, argmax, fetch, NIfTI writes)")

    out_dir = os.path.join(data, "pred_chip_smoke")
    masks = {}
    for p in paths:
        base = os.path.basename(p).replace(".nii.gz", "")
        for sfx in ("sk", "fl", "i"):
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

    # references on the card, on the first volume: the same engine with the
    # plain versions (bf16, same roundings) and the plain f32 model
    sd = load_any(UNETSP_10K)
    x = np.stack([nifti.read(paths[0]).data.astype(np.float32), atlas], -1)
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    sd = load_any(UNETSP_10K)
    log("== phase 2: kernels vs plain versions (trained layer weights, "
        "bf16 inputs, TF32 off)")
    t0 = time.perf_counter()
    try:
        entries, errs = check_kernels(sd, device)
        failures += errs
    except Exception:  # noqa: BLE001  report, then fail the run below
        traceback.print_exc()
        failures.append("phase 2 raised")
        entries = {}
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    log(f"== phase 3: main path, {N_VOLUMES} UNetSP volumes "
        f"{'x'.join(map(str, SHAPE))} through Model")
    t0 = time.perf_counter()
    launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as work:
            launches, stats, errs = serve(device, work)
        failures += errs
        log("  serve: " + json.dumps(stats))
    except Exception:  # noqa: BLE001  report, then fail the run below
        traceback.print_exc()
        failures.append("phase 3 raised")
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")
    if not launches or min(launches.values()) == 0:
        failures.append(f"a kernel of the path was never launched: "
                        f"{launches}")

    log(f"== total {time.perf_counter() - t_all:.1f} s")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1

    sources = {
        "conv3d_bn_relu": ("ctunet_tpu_torch/csrc/conv3d.cu",
                           "ctunet_tpu/ops/pallas/conv3d.py:1031"),
        "maxpool2": ("ctunet_tpu_torch/csrc/maxpool.cu",
                     "ctunet_tpu/ops/pallas/conv3d.py:1862"),
        "upconv_bn_relu": ("ctunet_tpu_torch/csrc/upconv.cu",
                           "ctunet_tpu/ops/pallas/upconv.py:464"),
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
