#!/usr/bin/env python
"""int8 PTQ preview through the engine-faithful simulation, on the port.

The counterpart of ``tools/quant_sim_eval.py`` for ``ctunet_tpu_torch``:
``quant_opt.simulate_scales`` calibrates on the calibration skulls, then
each mode quantizes the model and evaluates it on held-out test skulls,
flap and skull mask Dice of the simulated int8 forward against the float
forward (``quant_opt.simulate_int8``):

- ``rtn``: round to nearest on the simulated scales;
- ``aq``: AdaQuant's rounding (``optimize_rounding``, ``--steps``);
- ``aq_ls``: AdaQuant with learned activation scales.

The simulation covers every rounding of the int8 engine but its head's,
so its Dice is an estimate; ``tools/adaquant_run_torch.py`` measures the
engine itself.

Usage (the card unless ``--cpu``)::

    python tools/quant_sim_eval_torch.py [--ckpt <.npz|.pt|.ckpt>]
        [--steps 250] [--lr 0.03] [--calib-n 2] [--head 0]
        [--modes rtn,aq,aq_ls] [--shape 64,128,128] [--cpu]

It prints one JSON line: each mode's ``{"sk", "fl"}`` Dice and seconds.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

MODEL_CLASS = "UNetSP"  # the family tools/quant_sim_eval.py evaluates
MODES = ("rtn", "aq", "aq_ls")


def evaluate(state_dict, calib, tests, modes=MODES, steps: int = 250,
             lr: float = 0.03, head: float = 0.0, device=None,
             log=print) -> dict:
    """Simulated int8 vs float mask Dice on ``tests`` ``(N, D, H, W, 2)``
    for each of ``modes``, calibrated on ``calib`` (the same layout).
    Returns ``{mode: {"sk", "fl", "seconds"}, "scales_seconds": s}``."""
    from ctunet_tpu_torch import quant_opt

    t0 = time.perf_counter()
    scales = quant_opt.simulate_scales(MODEL_CLASS, state_dict, calib,
                                       device=device)
    res = {"scales_seconds": time.perf_counter() - t0}
    log(f"simulate_scales: {res['scales_seconds']:.1f} s")

    def run(eval_scales, ropt):
        out_f, out_q = quant_opt.simulate_int8(
            MODEL_CLASS, state_dict, tests, eval_scales, round_opt=ropt,
            bf16_head=head, device=device)
        return tt.head_dice(tt.masks(out_q), tt.masks(out_f))

    for mode in modes:
        t0 = time.perf_counter()
        if mode == "rtn":
            got = run(scales, None)
        elif mode in ("aq", "aq_ls"):
            refined: dict = {}
            ropt = quant_opt.optimize_rounding(
                MODEL_CLASS, state_dict, calib, scales, steps=steps, lr=lr,
                learn_scales=mode == "aq_ls", out_scales=refined,
                bf16_head=head, verbose=True, device=device)
            got = run(refined, ropt)
        else:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        got["seconds"] = time.perf_counter() - t0
        log(f"{mode:6s} (h={head}): sim sk {got['sk']:.4f}  fl "
            f"{got['fl']:.4f}  ({got['seconds']:.1f} s)")
        res[mode] = got
    return res


def main(argv=None) -> int:
    ap = tt.arguments(__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--calib-n", type=int, default=2)
    ap.add_argument("--head", type=float, default=0.0)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args(argv)
    device = tt.device_of(args)
    sd = tt.load_weights(args.ckpt)
    calib = tt.calib_skulls(args.shape, device, args.calib_n)
    tests = tt.serving_skulls(args.shape, device)
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON only
        res = evaluate(sd, calib, tests, tuple(args.modes.split(",")),
                       args.steps, args.lr, args.head, device)
    tt.emit(dict(tool="quant_sim_eval_torch", device=str(device),
                 shape=list(args.shape), **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
