#!/usr/bin/env python
"""Attribute a full-resolution UNetSP train step's device time, on the
port.

The counterpart of ``tools/attr_train.py`` for ``ctunet_tpu_torch``: one
bf16 train step (synthesis, forward, backward, optimizer) of UNetSP with
``conv_impl`` ``chain`` (K6 forward and input gradient, the tap-shifted
``bmm`` weight gradient) or ``xla`` (cuDNN), profiled over ``--n`` steps
with ``torch.profiler``; it prints

(a) the top kernels by device time, each with the spans of the kernel
    wrappers (``conv3d_bias_act/conv3d_tc``) or of the weight gradient
    (``dw_taps``) around its launch;
(b) the rollup by category: the hand-written kernels by wrapper,
    cuBLAS/cuDNN, the weight gradient's ``bmm``s, elementwise, copies and
    the rest (``ctunet_tpu_torch/utils/profiling.py``);
(c) the ten longest stretches in which the device ran nothing, each by
    the ``ctunet.train.*`` span the host was in (``profiling.idle_gaps``).

Each kernel's spans include the step's phase (``ctunet.train.forward``,
``.backward``, ...) around its wrappers'.

The JAX tool's ``--std``, ``--remat`` and packed-resident variants have
no subject here: the port keeps no packed-resident model and no
rematerialization (``b_packed_train`` and ``b_remat`` change nothing in
the port), so every step is the one dense graph.

Usage (the card unless ``--cpu``)::

    python tools/attr_train_torch.py [--ckpt <.npz|.pt|.ckpt>]
        [--shape 224,304,304] [--impl chain|xla] [--n 3]
        [--profile-dir DIR] [--cpu]

It prints one JSON line: the tables, per step, and the first loss.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

SHAPE = (224, 304, 304)
MODEL_CLASS = "UNetSP"
LOSS = {"ce_lambda": 1.0, "dice_lambda": 1.0, "save_dice_plots": False}


def attribute_train(state_dict, shape, impl: str = "chain", n: int = 3,
                    device=None, profile_dir: str = "") -> dict:
    """Profile ``n`` bf16 train steps of UNetSP at ``shape`` and return
    :func:`_torch_tools.report`'s tables, the wrappers' launch counters
    of one step and the first step's loss."""
    import numpy as np
    import torch

    from ctunet_tpu_torch import steps
    from ctunet_tpu_torch.data.synthetic import spherical_shell
    from ctunet_tpu_torch.models import build_model
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut

    model = build_model(MODEL_CLASS).to(device)
    model.load_state_dict(state_dict)
    model.configure(impl, torch.bfloat16)
    state = steps.TrainState(model, steps.make_optimizer(
        {"optimizer": "adam", "learning_rate": 1e-4}, model.parameters()))
    atlas = spherical_shell(shape, radius_frac=0.42).astype(np.float32)
    step = steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(),
                                 LOSS, atlas=atlas,
                                 compute_dtype=torch.bfloat16)
    batch = {"image": torch.from_numpy(spherical_shell(
        shape, radius_frac=0.4)[None].astype(np.float32)).to(device)}
    gen = torch.Generator(device=device).manual_seed(0)
    kernels.reset_launches()
    _, terms = step(state, batch, gen)
    first = {"loss": float(terms["epoch_loss"]),
             "launches": {k: v for k, v in kernels.launches().items() if v}}
    rows, dropped, gaps = tt.profile_passes(lambda: step(state, batch, gen),
                                            n, device, profile_dir)
    res = tt.report(rows, dropped, n, f"{impl} train step {tuple(shape)}",
                    device, gaps)
    res.update(first_loss=first["loss"], launches=first["launches"])
    return res


def main(argv=None) -> int:
    ap = tt.arguments(__doc__.split("\n\n")[0], SHAPE)
    ap.add_argument("--impl", default="chain", choices=("chain", "xla"))
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--profile-dir", default="")
    args = ap.parse_args(argv)
    device = tt.device_of(args)
    sd = tt.load_weights(args.ckpt)
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON only
        res = attribute_train(sd, args.shape, args.impl, args.n, device,
                              args.profile_dir)
    tt.emit(dict(tool="attr_train_torch", device=str(device),
                 shape=list(args.shape), impl=args.impl, steps=args.n,
                 **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
