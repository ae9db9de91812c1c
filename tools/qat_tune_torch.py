#!/usr/bin/env python
"""Quantization-aware distillation of a trained checkpoint, on the port.

The counterpart of ``tools/qat_tune.py`` for ``ctunet_tpu_torch``: load
weights (a port train-state ``.ckpt``, a flax ``.npz`` export or a
reference ``.pt``), calibrate per-unit activation scales on a synthetic
broken skull, then fine-tune every parameter so that the fake-quantized
forward (``ctunet_tpu_torch/ops/qat.py``, the int8 engine's arithmetic)
reproduces the frozen float model's output probabilities on fresh
synthetic craniectomies: the loss is the summed mean squared difference of
each output head (distillation, not the task loss; ``tools/qat_tune.py``
says why). The optimizer is ``torch.optim.Adam`` at optax ``adam``'s
defaults (betas 0.9 / 0.999, eps 1e-8 added to the square root of the
bias-corrected second moment in both).

Before saving, the plain (not quantized) forward's masks on the
calibration volume are checked against the pre-QAT ones (the collapse
guard): a Dice below 0.9 on either head aborts with exit code 1 and saves
nothing. The result is a port train-state ``.ckpt`` that ``Model`` serves
(``s_resume_model``), int8 included.

Usage (runs on the CUDA card unless ``--device cpu``)::

    python tools/qat_tune_torch.py --ckpt ctunet_tpu_torch/assets/unetsp_10k.npz \\
        --out unetsp_10k_qat.ckpt [--steps 800] [--lr 1e-4] [--shape 64,128,128]

It imports ``ctunet_tpu_torch`` and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL_CLASS = "UNetSP"  # the one family tools/qat_tune.py tunes
SHAPE = (64, 128, 128)
LR = 1e-4  # tools/qat_tune.py's
GUARD_DICE = 0.9


def _dice(a, b) -> float:
    inter = float(((a > 0) & (b > 0)).sum())
    denom = float((a > 0).sum() + (b > 0).sum())
    return 2.0 * inter / denom if denom else 1.0


def adam(params, lr: float = LR):
    """``torch.optim.Adam`` at optax ``adam``'s defaults."""
    import torch

    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def distill_loss(qat, weights, teacher, x):
    """The distillation loss of one input ``x``: the summed mean squared
    difference of each output head between the fake-quantized forward
    (``qat.apply(weights, x)``) and the frozen ``teacher``'s, in f32 (the
    JAX tool's ``loss_fn``)."""
    import torch

    with torch.no_grad():
        t_out = teacher(x)
    s_out = qat.apply(weights, x)
    return sum(torch.mean(torch.square(a.float() - b.float()))
               for a, b in zip(s_out, t_out))


def distill(ckpt: str, out: str, steps: int = 800, lr: float = LR,
            shape=SHAPE, device=None, log=print):
    """Run the distillation and save ``out`` unless the collapse guard
    fails. Returns a summary dict: ``losses``, ``guard_dice`` per head,
    ``saved``, ``seconds``, ``scales``."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import checkpoint, steps as tsteps
    from ctunet_tpu_torch.data.synthetic import spherical_shell
    from ctunet_tpu_torch.device import resolve_device
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import synthesis
    from ctunet_tpu_torch.ops.qat import QATModel, calibrate_unit_scales

    device = resolve_device(device)
    bf = torch.bfloat16
    sd = {k: v.to(device) for k, v in checkpoint.load_any(ckpt).items()}
    atlas = torch.from_numpy(spherical_shell(
        shape, radius_frac=0.42).astype(np.float32)).to(device)

    # calibration input: a broken skull + the atlas (the serving input)
    calib_full = torch.from_numpy(spherical_shell(shape, seed=777).astype(
        np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(9999)
    calib_broken, _ = synthesis.skull_random_hole(gen, calib_full)
    calib = torch.stack([calib_broken, atlas], -1)[None]
    scales = calibrate_unit_scales(MODEL_CLASS, sd, calib)
    log(f"calibrated {len(scales)} unit scales")

    def float_model(weights):
        m = build_model(MODEL_CLASS).to(device)
        m.load_state_dict(weights)
        return m.eval().configure("xla", bf)

    teacher = float_model(sd)  # the frozen anchor
    student = float_model(sd)
    for p in teacher.parameters():
        p.requires_grad_(False)
    live = student.state_dict(keep_vars=True)
    qat = QATModel(MODEL_CLASS, scales=scales)
    opt = adam(student.parameters(), lr)
    vols = [torch.from_numpy(spherical_shell(shape, seed=100 + i).astype(
        np.float32)).to(device) for i in range(8)]
    gen = torch.Generator(device=device).manual_seed(50_000)

    def plain_masks(model):
        with torch.no_grad():
            outs = model(calib.to(bf))
        return [torch.argmax(o.float(), -1).cpu().numpy() for o in outs]

    pre = plain_masks(teacher)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        # a fresh virtual craniectomy each step
        broken, _ = synthesis.skull_random_hole(gen, vols[i % 8])
        x = torch.stack([broken.to(bf), atlas.to(bf)], -1)[None]
        loss = distill_loss(qat, live, teacher, x)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if (i + 1) % 100 == 0:
            log(f"  qat step {i + 1}/{steps} distill_mse="
                f"{float(losses[-1]):.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    log(f"QAT {steps} steps in {secs:.1f}s; distill MSE "
        f"{losses[0]:.3e} -> {losses[-1]:.3e}")

    # collapse guard: the plain forward must keep its masks
    post = plain_masks(student)
    guard = {}
    for name, a, b in zip(("sk", "fl"), pre, post):
        guard[name] = _dice(a, b)
        log(f"  plain-forward {name} mask dice pre->post QAT: "
            f"{guard[name]:.4f} (fg {int((a > 0).sum())} -> "
            f"{int((b > 0).sum())})")
    saved = min(guard.values()) >= GUARD_DICE
    if saved:
        state = tsteps.TrainState(student, tsteps.make_optimizer(
            {}, student.parameters()))
        checkpoint.save_checkpoint(out, state, extra={
            "model_class": MODEL_CLASS, "qat_steps": steps, "source": ckpt})
        log(f"saved {out}")
    else:
        log("ABORT: plain forward diverged under QAT; not saving")
    return dict(losses=losses, guard_dice=guard, saved=saved, seconds=secs,
                scales=scales, out=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default=None,
                    help="default: <ckpt without extension>_qat.ckpt")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)))
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.ckpt.rstrip("/"))[0] + "_qat.ckpt"
    shape = tuple(int(v) for v in args.shape.split(","))
    res = distill(args.ckpt, out, args.steps, args.lr, shape, args.device,
                  log=lambda m: print(m, flush=True))
    return 0 if res["saved"] else 1


if __name__ == "__main__":
    sys.exit(main())
