#!/usr/bin/env python
"""AdaQuant on trained weights, measured on the port's int8 engine.

The counterpart of ``tools/adaquant_run.py`` for ``ctunet_tpu_torch``:
the int8 engine (``engine_q.build_predict_q``: K1q, K2q and K3q on the
card) is built on the first calibration skull and serves the held-out test
skulls, first rounding to nearest, then with the rounding and bias deltas
``quant_opt.optimize_rounding`` finds on the calibration skulls (and, with
``--learn-scales``, its refined activation scales). Each engine's masks
are held against the float model's (bf16, ``conv_impl = xla``): the mask
Dice of the skull and flap heads.

Usage (the card unless ``--cpu``)::

    python tools/adaquant_run_torch.py [--ckpt <.npz|.pt|.ckpt>]
        [--steps 250] [--lr 0.03] [--calib-n 2] [--head 0] [--tail 0]
        [--save overrides.npz] [--learn-scales] [--shape 64,128,128] [--cpu]

It prints one JSON line: both engines' Dice, the search's seconds and
the int8 kernels' launches.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

MODEL_CLASS = "UNetSP"  # the family tools/adaquant_run.py tunes


def run(state_dict, calib, tests, steps: int = 250, lr: float = 0.03,
        head: float = 0.0, tail: float = 0.0, learn_scales: bool = False,
        device=None) -> dict:
    """Int8 engine vs float-model mask Dice on ``tests`` ``(N, D, H, W,
    2)``, without and with the optimised rounding found on ``calib``.
    Returns ``{"rtn": {"sk", "fl"}, "adaquant": {...}, "search_seconds",
    "launches", "round_opt"}``."""
    import torch

    from ctunet_tpu_torch import engine_q, quant_opt
    from ctunet_tpu_torch.ops import kernels

    x = tests.to(device, torch.bfloat16)
    ref = tt.float_masks(MODEL_CLASS, state_dict, x)
    kernels.reset_launches()

    def engine_dice(**kw):
        fn = engine_q.build_predict_q(
            MODEL_CLASS, state_dict, calib[0].to(device, torch.bfloat16),
            bf16_head=head, bf16_tail=tail, device=device, **kw)
        return tt.head_dice(tt.masks(fn(x)), ref)

    scales: dict = {}
    res = {"rtn": engine_dice(export_scales=scales)}
    print(f"RTN engine (h={head} t={tail}): sk {res['rtn']['sk']:.4f}  fl "
          f"{res['rtn']['fl']:.4f}", flush=True)
    t0 = time.perf_counter()
    refined: dict = {}
    ropt = quant_opt.optimize_rounding(
        MODEL_CLASS, state_dict, calib, scales, steps=steps, lr=lr,
        verbose=True, learn_scales=learn_scales, out_scales=refined,
        bf16_head=head, device=device)
    res["search_seconds"] = time.perf_counter() - t0
    print(f"optimize_rounding: {res['search_seconds']:.1f} s "
          f"(learn_scales={learn_scales})", flush=True)
    res["adaquant"] = engine_dice(round_opt=ropt, import_scales=refined)
    print(f"{'AdaQuant+LS' if learn_scales else 'AdaQuant'} engine: sk "
          f"{res['adaquant']['sk']:.4f}  fl {res['adaquant']['fl']:.4f}",
          flush=True)
    res["launches"] = {k: v for k, v in kernels.launches().items() if v}
    res["round_opt"] = ropt
    return res


def save_overrides(path: str, ropt) -> None:
    """The overrides as ``{"<tag>:<q|k|db>": array}`` in one ``.npz``."""
    import numpy as np

    np.savez(path, **{f"{tag}:{k}": v for tag, ov in ropt.items()
                      for k, v in ov.items()})


def main(argv=None) -> int:
    ap = tt.arguments(__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--calib-n", type=int, default=2)
    ap.add_argument("--head", type=float, default=0.0)
    ap.add_argument("--tail", type=float, default=0.0)
    ap.add_argument("--save", default="")
    ap.add_argument("--learn-scales", action="store_true")
    args = ap.parse_args(argv)
    device = tt.device_of(args)
    sd = tt.load_weights(args.ckpt)
    calib = tt.calib_skulls(args.shape, device, args.calib_n)
    tests = tt.serving_skulls(args.shape, device)
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON only
        res = run(sd, calib, tests, args.steps, args.lr, args.head,
                  args.tail, args.learn_scales, device)
    ropt = res.pop("round_opt")
    if args.save:
        save_overrides(args.save, ropt)
        res["saved"] = args.save
    tt.emit(dict(tool="adaquant_run_torch", device=str(device),
                 shape=list(args.shape), learn_scales=args.learn_scales,
                 **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
