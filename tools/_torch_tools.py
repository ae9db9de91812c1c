"""What the ``tools/*_torch.py`` int8 and attribution tools share: their
arguments, the port's weights, the synthetic skulls and the mask Dice.

The JAX tools draw their test and calibration skulls the same way
(``spherical_shell`` seeds 900 + i and 777 + i, a random hole each, the
atlas shell as the second channel); here the holes come from the port's
``ops.synthesis.skull_random_hole`` on a seeded ``torch.Generator``, so the
volumes are the port's own. Imports ``ctunet_tpu_torch`` and nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SHAPE = (64, 128, 128)  # the JAX int8 tools' SHAPE
N_TEST = 5
TEST_SEED, TEST_HOLE_SEED = 900, 5000
CALIB_SEED, CALIB_HOLE_SEED = 777, 9999


def arguments(description: str, shape=SHAPE) -> argparse.ArgumentParser:
    """The options every tool takes: ``--ckpt`` (the port's ``.npz``
    asset, a ``.pt`` or a ``.ckpt``; default ``unetsp_10k``), ``--shape``
    and ``--cpu`` (the card otherwise)."""
    from ctunet_tpu_torch.checkpoint import UNETSP_10K

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--ckpt", default=UNETSP_10K)
    ap.add_argument("--shape", default=",".join(map(str, shape)),
                    type=lambda s: tuple(int(v) for v in s.split(",")))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions of the kernels)")
    return ap


def device_of(args):
    from ctunet_tpu_torch.device import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def load_weights(path: str):
    """The port's state_dict from an ``.npz``, a ``.pt`` or a ``.ckpt``."""
    from ctunet_tpu_torch import checkpoint

    return checkpoint.load_any(path)


def skulls(shape, n: int, seed: int, hole_seed: int, device):
    """``(n, D, H, W, 2)`` f32: broken skulls (shell ``seed + i``, hole
    from generator ``hole_seed + i``) beside the atlas shell."""
    import numpy as np
    import torch

    from ctunet_tpu_torch.data.synthetic import spherical_shell
    from ctunet_tpu_torch.ops import synthesis

    atlas = torch.from_numpy(spherical_shell(
        shape, radius_frac=0.42).astype(np.float32)).to(device)
    out = []
    for i in range(n):
        full = torch.from_numpy(spherical_shell(
            shape, seed=seed + i).astype(np.float32)).to(device)
        gen = torch.Generator(device=device).manual_seed(hole_seed + i)
        broken, _ = synthesis.skull_random_hole(gen, full)
        out.append(torch.stack([broken, atlas], -1))
    return torch.stack(out)


def serving_skulls(shape, device, n: int = N_TEST):
    return skulls(shape, n, TEST_SEED, TEST_HOLE_SEED, device)


def calib_skulls(shape, device, n: int):
    return skulls(shape, n, CALIB_SEED, CALIB_HOLE_SEED, device)


def masks(outputs):
    """Each output head's argmax mask, as numpy."""
    return tuple(o.float().argmax(-1).cpu().numpy() for o in outputs)


def float_masks(model_class: str, state_dict, x):
    """The float model's masks of ``x`` (``conv_impl = xla``, computed in
    ``x``'s dtype: the JAX tools' ``compute_dtype="bfloat16"`` model for a
    bf16 ``x``), on ``x``'s device."""
    import torch

    from ctunet_tpu_torch.models import build_model

    model = build_model(model_class).to(x.device)
    model.load_state_dict(state_dict)
    model.eval().configure("xla", x.dtype)
    with torch.no_grad():
        return masks(model(x))


def dice(a, b) -> float:
    """Mask Dice over the foreground (1.0 when both are empty)."""
    inter = float(((a > 0) & (b > 0)).sum())
    denom = float((a > 0).sum() + (b > 0).sum())
    return 2.0 * inter / denom if denom else 1.0


def head_dice(got, ref) -> dict:
    """``{"sk": ..., "fl": ...}``: each head's mask Dice against ``ref``."""
    return {k: dice(g, r) for k, g, r in zip(("sk", "fl"), got, ref)}


def profile_passes(fn, n: int, device, profile_dir: str = ""):
    """``fn()`` once to warm up, then ``n`` times inside
    ``utils/profiling.trace``'s window (CPU and, on the card, CUDA
    activity; a Chrome trace into ``profile_dir`` when given). Returns the
    attributed rows, the launches the trace lost
    (``utils/profiling.attribute``) and the device's idle stretches
    (``utils/profiling.idle_gaps``)."""
    import torch

    from ctunet_tpu_torch.utils import profiling

    def run():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    with profiling.trace(device) as prof:
        for _ in range(n):
            run()
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"{os.getpid()}.pt.trace.json"))
    events = prof.events()
    return profiling.attribute(events) + (profiling.idle_gaps(events),)


def report(rows, dropped: int, n: int, what: str, device, gaps=(),
           log=print) -> dict:
    """Print (a) the top kernels by self device time with their wrappers'
    and ``ctunet.*`` spans, (b) the rollup by category, each per pass, and
    (c) the ten longest of ``gaps`` (:func:`profile_passes`' idle
    stretches) by the span the host was in; return them for the JSON
    line, with the hand-written launches per pass by wrapper and
    ``dropped``, the launches whose kernel the trace lost (the breakdown
    is whole only at 0).
    On the CPU the rows are the plain versions' ``aten::`` ops by self CPU
    time, and ``clock`` says so."""
    from ctunet_tpu_torch.utils import profiling

    clock = "device" if device.type == "cuda" else "cpu"
    total = sum(r["ms"] for r in rows) / n
    log(f"{what}: {total:.3f} ms of {clock} time a pass ({n} passes); "
        f"{dropped} launches lost by the trace")
    log("(a) top kernels, ms a pass, with the wrappers' spans:")
    tops = profiling.top(rows)
    for t in tops:
        log(f"  {t['ms'] / n:9.3f} ms x{t['count'] / n:<6g} "
            f"{t['name'][:60]:<60s} {t['spans']}")
    roll = {k: v / n for k, v in profiling.rollup(rows).items()}
    log("(b) rollup, ms a pass:")
    for k, v in roll.items():
        log(f"  {v:9.3f} ms {100 * v / total if total else 0:5.1f}%  {k}")
    longest = sorted(gaps, key=lambda g: -g["ms"])[:10]
    log(f"(c) the longest of {len(gaps)} idle stretches, ms, by the span "
        "the host was in:")
    for g in longest:
        log(f"  {g['ms']:9.3f} ms  {g['label']}")
    return dict(clock=clock, ms_per_pass=total, dropped=dropped,
                rollup_ms=roll, idle_gaps=longest,
                top=[dict(t, ms=t["ms"] / n, count=t["count"] / n)
                     for t in tops],
                wrapper_launches={k: v / n for k, v in
                                  profiling.wrapper_counts(rows).items()})


def emit(result: dict) -> None:
    """The tool's one JSON line on standard output."""
    print(json.dumps(result), flush=True)
