#!/usr/bin/env python
"""Attribute the int8 engine's device time to its kernels, on the port.

The counterpart of ``tools/attr_int8.py`` for ``ctunet_tpu_torch``: it
builds the UNetSP int8 engine (``engine_q.build_predict_q``, the PTQ build
without AdaQuant, as the JAX tool builds it) on a random binary volume,
profiles ``--n`` engine passes with ``torch.profiler`` and prints

(a) the top kernels by device time, each with the spans of the kernel
    wrappers that launched it (``conv3d_q_requant/conv3d_tc_q``, ...);
(b) the rollup by category: the hand-written kernels by wrapper,
    cuBLAS/cuDNN, elementwise, copies and the rest
    (``ctunet_tpu_torch/utils/profiling.py``);
(c) the ten longest stretches in which the device ran nothing, each by
    the ``ctunet.*`` span the host was in (``profiling.idle_gaps``).

The JAX tool maps XLA ops to source through the compiled HLO's metadata;
here the wrappers' ``record_function`` spans carry that attribution.

Usage (the card unless ``--cpu``; on the CPU the rows are the plain
versions' ``aten::`` ops by CPU time)::

    python tools/attr_int8_torch.py [--ckpt <.npz|.pt|.ckpt>]
        [--shape 224,304,304] [--tail 0] [--n 3] [--profile-dir DIR] [--cpu]

It prints one JSON line: the tables, per pass.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

SHAPE = (224, 304, 304)
MODEL_CLASS = "UNetSP"


def attribute_int8(state_dict, x, n: int = 3, tail: float = 0.0,
                   device=None, profile_dir: str = "") -> dict:
    """Profile ``n`` int8 engine passes over ``x`` ``(1, D, H, W, 2)`` and
    return :func:`_torch_tools.report`'s tables plus the wrappers'
    launch counters of one pass."""
    from ctunet_tpu_torch import engine_q
    from ctunet_tpu_torch.ops import kernels

    fwd = engine_q.build_predict_q(MODEL_CLASS, state_dict, x[0],
                                   bf16_tail=tail, device=device)
    rows, dropped, gaps = tt.profile_passes(lambda: fwd(x), n, x.device,
                                            profile_dir)
    res = tt.report(rows, dropped, n, f"int8 engine {tuple(x.shape[1:4])}",
                    x.device, gaps)
    kernels.reset_launches()
    fwd(x)
    res["launches"] = {k: v for k, v in kernels.launches().items() if v}
    return res


def main(argv=None) -> int:
    ap = tt.arguments(__doc__.split("\n\n")[0], SHAPE)
    ap.add_argument("--tail", type=float, default=0.0)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--profile-dir", default="")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    device = tt.device_of(args)
    sd = tt.load_weights(args.ckpt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((1, *args.shape, 2)) > 0.5).astype(
        np.float32)).to(device, torch.bfloat16)
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON only
        res = attribute_int8(sd, x, args.n, args.tail, device,
                             args.profile_dir)
    tt.emit(dict(tool="attr_int8_torch", device=str(device),
                 shape=list(args.shape), passes=args.n, **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
