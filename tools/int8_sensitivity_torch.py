#!/usr/bin/env python
"""Per-unit int8 sensitivity through the fake-quantized forward, on the
port.

The counterpart of ``tools/int8_sensitivity.py`` for ``ctunet_tpu_torch``:
``ops/qat.QATModel`` (the int8 engine's arithmetic in float) on trained
weights, each sweep's masks held against the plain float forward's (mask
Dice of the skull and flap heads) when

- every unit is quantized (the int8 engine's baseline);
- only the weights, or only the activations, are quantized (the JAX tool
  patches ``qat._fq_act`` / ``qat._fq_weight`` for this; here
  :func:`quantizing` swaps them for the identity and puts them back);
- exactly one unit's output is quantized (16 sweeps for UNetSP), which
  ranks the units by the flap voxels their requant rounding flips;
- all units but the worst k are quantized (k = 1..4).

Usage (the card unless ``--cpu``)::

    python tools/int8_sensitivity_torch.py [--ckpt <.npz|.pt|.ckpt>]
        [--shape 64,128,128] [--cpu]

It prints one JSON line with every sweep's Dice.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

MODEL_CLASS = "UNetSP"  # the family tools/int8_sensitivity.py sweeps
WORST_K = (1, 2, 3, 4)


@contextlib.contextmanager
def quantizing(weights: bool = True, activations: bool = True):
    """Within the block, ``QATModel`` quantizes only what is asked: an
    identity stands in for ``qat._fq_weight`` and/or ``qat._fq_act``,
    restored on the way out."""
    from ctunet_tpu_torch.ops import qat

    saved = qat._fq_weight, qat._fq_act
    try:
        if not weights:
            qat._fq_weight = lambda w, s: w
        if not activations:
            qat._fq_act = lambda y, s: y
        yield
    finally:
        qat._fq_weight, qat._fq_act = saved


def sweep(state_dict, calib, tests, scales=None, dtype=None,
          log=print) -> dict:
    """Every sweep's ``{"sk", "fl"}`` Dice against the plain forward on
    ``tests`` ``(N, D, H, W, 2)``, with the unit scales calibrated on
    ``calib`` ``(1, D, H, W, 2)`` (or the given ``scales``), in ``dtype``
    (bf16 by default, the tool's and the JAX tool's)."""
    import torch

    from ctunet_tpu_torch.ops.qat import QATModel, calibrate_unit_scales

    dtype = dtype or torch.bfloat16
    if scales is None:
        scales = calibrate_unit_scales(MODEL_CLASS, state_dict, calib,
                                       dtype=dtype)
    x = tests.to(dtype)
    ref = tt.float_masks(MODEL_CLASS, state_dict, x)

    def run(label, sc):
        with torch.no_grad():
            out = QATModel(MODEL_CLASS, sc, dtype).apply(state_dict, x)
        d = tt.head_dice(tt.masks(out), ref)
        log(f"{label:28s} sk {d['sk']:.4f}  fl {d['fl']:.4f}")
        return d

    res = {"all": run("ALL quantized", scales)}
    with quantizing(activations=False):
        res["weights_only"] = run("weights only", scales)
    with quantizing(weights=False):
        res["activations_only"] = run("activations only", scales)
    res["only"] = {tag: run(f"only {tag}", {tag: scales[tag]})
                   for tag in sorted(scales)}
    worst = sorted(res["only"], key=lambda t: (res["only"][t]["fl"], t))
    res["worst"] = worst[:6]
    log(f"worst units (flap): {res['worst']}")
    res["except_worst"] = {
        str(k): run(f"all EXCEPT worst-{k}", {
            t: s for t, s in scales.items() if t not in worst[:k]})
        for k in WORST_K}
    return res


def main(argv=None) -> int:
    args = tt.arguments(__doc__.split("\n\n")[0]).parse_args(argv)
    device = tt.device_of(args)
    sd = {k: v.to(device) for k, v in tt.load_weights(args.ckpt).items()}
    calib = tt.calib_skulls(args.shape, device, 1)
    tests = tt.serving_skulls(args.shape, device)
    res = sweep(sd, calib, tests,
                log=lambda m: print(m, file=sys.stderr, flush=True))
    tt.emit(dict(tool="int8_sensitivity_torch", device=str(device),
                 shape=list(args.shape), **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
