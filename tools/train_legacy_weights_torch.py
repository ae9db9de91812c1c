#!/usr/bin/env python
"""Train ``UNet4_2IC`` weights on synthetic skulls with the port's own
train step, and save them as a small reference-named ``.pt`` state_dict.

The model is built from ``--seed`` as ``Model`` builds it, then trained
for ``--steps`` batch-1 steps (fewer where ``--max-seconds`` ends it) of
``steps.make_train_step`` for the ``FlapRecWithShapePrior`` handler (its
on-device cranioplasty synthesis cuts the flap out of each complete
skull) with the settings of ``gpubench/configs/unet4_2ic.json`` (the
AutoImplant 2020 INI's: Adam at 1e-4, Dice and cross-entropy at weight 1,
bf16 compute, f32 parameters, ``conv_impl`` xla). The skulls and the
atlas are ``gpubench/inputs.py``'s, drawn from ``--seed`` on ``--canvas``:
``--skulls`` complete skulls go round. Every ``--eval-every`` steps and at
the end it serves ``--eval`` broken skulls of another stream through the
bf16 engine, saves the weights (``<out>_<step>.pt`` before the last step,
``--out`` at it) and prints one JSON line: the share of voxels served as
bone, the Dice of the served mask with the cut-out cap, and the numbers
of ``gpubench/kinds/serve_legacy.compare`` (against the plain f32
reference ``gpubench/reference/legacy.py``); at the end also those of the
reference computed with float8 operands.

``--split`` shifts the head's bone bias before the last save, so that the
reference splits the ``--eval`` skulls about evenly between the classes
(:func:`split_head`): a served mask is then compared on decisions all
over the volume, not on the few voxels of a flap. ``--resume`` starts
from a saved file, and ``--steps 0`` only splits and saves it.

The file keeps every conv and ConvTranspose weight at bf16 precision
(stored as bf16) and the rest in f32, so that it stays near 10 MB;
``Model`` loads it through ``s_resume_model``.

Usage (on the CUDA card unless ``--device cpu``)::

    python tools/train_legacy_weights_torch.py --steps 2000 --seed 20 \\
        --out unet4_2ic_2k_trained.pt
    python tools/train_legacy_weights_torch.py --steps 0 --seed 20 \\
        --eval 8 --resume unet4_2ic_2k_trained.pt --split \\
        --out ctunet_tpu_torch/assets/unet4_2ic_2k.pt

It imports ``ctunet_tpu_torch`` and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL_CLASS = "UNet4_2IC"
HANDLER = "FlapRecWithShapePrior"
CONFIG = os.path.join(REPO, "gpubench", "configs", "unet4_2ic.json")


def stored(sd):
    """The state_dict as saved: conv and ConvTranspose weights in bf16,
    everything else as it is."""
    import torch

    return {k: (v.detach().to("cpu", torch.bfloat16)
                if k.endswith(".weight") and v.ndim == 5
                else v.detach().cpu()) for k, v in sd.items()}


def _reference_inputs(vol, atlas, device):
    """The input ``(1, D, H, W, 2)`` f32: the skull ``vol`` and the atlas."""
    import torch

    return torch.stack([torch.as_tensor(vol[0], device=device),
                        torch.as_tensor(atlas, device=device)], -1)[None]


def evaluate(model, vols, flaps, atlas, device, fp8: bool):
    """One JSON-ready dict of the served masks' numbers on ``vols``, by
    volume: the share served as bone, the Dice with the cut-out cap, and
    ``gpubench/kinds/serve_legacy.compare``'s numbers of the served mask
    (``program``) and, with ``fp8``, of the float8 reference's argmax."""
    import torch

    from ctunet_tpu_torch import engine
    from gpubench import systems
    from gpubench.reference import legacy, precision

    compare = systems.kind("serve_legacy").compare
    sd = {k: v.float() for k, v in stored(model.state_dict()).items()}
    predict = engine.build_predict(MODEL_CLASS, sd, torch.bfloat16, device)
    ref_sd = {k: v.to(device) for k, v in sd.items()}
    out = dict(bone_share=[], dice=[], program=[], fp8=[])
    for vol, flap in zip(vols, flaps):
        x = _reference_inputs(vol, atlas, device)
        mask = torch.argmax(predict(x.to(torch.bfloat16))[0], -1)
        f = torch.as_tensor(flap[0], device=device) > 0
        inter = float((mask.bool() & f).sum())
        out["bone_share"].append(float(mask.float().mean()))
        out["dice"].append(2 * inter / max(float(mask.sum() + f.sum()), 1))
        with systems.reference_precision(), torch.no_grad():
            ref = legacy.forward(ref_sd, x)[0]
            out["program"].append(compare({0: mask}, {0: ref}))
            if fp8:
                out["fp8"].append(compare({0: legacy.forward(
                    ref_sd, x, q=precision.fp8)[0]}, {0: ref}))
        del ref
    return out


def split_head(model, vols, atlas, device, share: float) -> dict:
    """Shift the head's bone bias so that the plain f32 reference puts
    ``share`` of the voxels of ``vols`` in the bone class: by the logit gap
    (bone minus background) that ``share`` of them exceed, on the weights
    as they are saved. Returns the shift, the gap's quantiles less its
    median, and by volume the reference's bone share after the shift and
    the share of voxels whose gap lies within ``FLIP_GAP`` of probability,
    0.1 and 1 of the decision."""
    import torch

    from gpubench import systems
    from gpubench.reference import legacy

    sd = {k: v.to(device, torch.float32)
          for k, v in stored(model.state_dict()).items()}

    def gaps(bias):
        sd["last_conv.bias"] = bias
        for vol in vols:
            with systems.reference_precision(), torch.no_grad():
                p = legacy.forward(sd, _reference_inputs(vol, atlas,
                                                         device))[0]
            yield (torch.log(p[..., 1]) - torch.log(p[..., 0])).flatten()

    ordered = torch.sort(torch.cat(list(gaps(
        sd["last_conv.bias"].clone())))).values

    def quantile(q):
        return float(ordered[min(int(q * ordered.numel()),
                                 ordered.numel() - 1)])

    shift = quantile(1.0 - share)
    median = quantile(0.5)
    out = dict(shift=shift, share=share, quantiles={
        q: quantile(q) - median for q in (
            0.001, 0.01, 0.05, 0.1, 0.2, 0.5, 0.8, 0.9, 0.95, 0.97, 0.98,
            0.99, 0.995, 0.999)}, bone_share=[], within_flip=[],
        within_0p1=[], within_1=[])
    del ordered
    with torch.no_grad():
        model.last_conv.bias[1] -= shift
    flip = 2 * math.atanh(systems.kind("serve_legacy").FLIP_GAP)
    for g in gaps(model.last_conv.bias.detach().to(device, torch.float32)):
        out["bone_share"].append(float((g > 0).float().mean()))
        for key, w in (("within_flip", flip), ("within_0p1", 0.1),
                       ("within_1", 1.0)):
            out[key].append(float((g.abs() <= w).float().mean()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, required=True,
                    help="train steps (0: only --resume, --split, save)")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--out", required=True)
    ap.add_argument("--resume", default="",
                    help="start from these weights (a file this tool saved)")
    ap.add_argument("--split", type=float, default=None, metavar="SHARE",
                    help="before saving --out, shift the head's bone bias "
                         "so that the f32 reference puts SHARE of the "
                         "--eval skulls' voxels in the bone class "
                         "(split_head)")
    ap.add_argument("--canvas", default="224,304,304")
    ap.add_argument("--skulls", type=int, default=32)
    ap.add_argument("--eval", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--max-seconds", type=float, default=float("inf"),
                    help="end at the first step past this many seconds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ctunet_tpu_torch import problem  # noqa: F401 (handlers)
    from ctunet_tpu_torch import checkpoint, registry, steps
    from ctunet_tpu_torch.models import build_model
    from gpubench import inputs

    device = torch.device(args.device)
    canvas = tuple(int(s) for s in args.canvas.split(","))
    with open(CONFIG) as f:
        settings = json.load(f)["settings"]
    if device.type == "cuda":
        from ctunet_tpu_torch.ops.kernels import build

        build.build()
    torch.manual_seed(args.seed)
    model = build_model(MODEL_CLASS)
    if args.resume:
        model.load_state_dict(checkpoint.load_any(args.resume))
    model = model.to(device).configure("xla", torch.bfloat16)
    state = steps.TrainState(model, steps.make_optimizer(
        settings, model.parameters()))
    loss_cfg = {k: settings.get(k)
                for k in ("ce_lambda", "dice_lambda", "save_dice_plots")}
    atlas = inputs.atlas(canvas, device)
    step = steps.make_train_step(model, registry.get_problem(HANDLER)(),
                                 loss_cfg, atlas=atlas,
                                 compute_dtype=torch.bfloat16)
    train = [torch.as_tensor(v, device=device) for v in inputs.skulls(
        canvas, args.skulls if args.steps else 0,
        inputs.subseed(args.seed, 5), device, False)]
    eval_seed = inputs.subseed(args.seed, 6)
    vols = inputs.skulls(canvas, args.eval, eval_seed, device, True)
    full = inputs.skulls(canvas, args.eval, eval_seed, device, False)
    flaps = [f - b for f, b in zip(full, vols)]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0, losses = time.perf_counter(), []

    def save(i, path, fp8):
        model.eval()
        nums = evaluate(model, vols, flaps, atlas, device, fp8)
        torch.save(stored(model.state_dict()), path)
        print(json.dumps(dict(step=i, saved=path, bytes=os.path.getsize(path),
                              seconds=time.perf_counter() - t0, **nums)),
              flush=True)

    i = 0
    for i in range(1, args.steps + 1):
        state, terms = step(state, {"image": train[i % len(train)]}, gen)
        losses.append(terms["epoch_loss"])
        last = (i == args.steps
                or time.perf_counter() - t0 > args.max_seconds)
        if i % args.log_every == 0 or last:
            print(json.dumps(dict(
                step=i, loss=float(torch.stack(losses).mean()),
                s_per_step=(time.perf_counter() - t0) / i)), flush=True)
            losses = []
        if last:
            break
        if i % args.eval_every == 0:
            root, ext = os.path.splitext(args.out)
            save(i, f"{root}_{i}{ext}", False)
    if args.split is not None:
        model.eval()
        print(json.dumps(dict(step=i, split=split_head(
            model, vols, atlas, device, args.split))), flush=True)
    save(i, args.out, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
