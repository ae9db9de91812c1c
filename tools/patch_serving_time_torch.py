#!/usr/bin/env python
"""Time UNetSPSmall's sliding-window serving of one 224x512x512 volume on
the card, as ``chip_smoke.py`` phase 10 serves it: the bf16 engine
(``engine.build_predict``) on the ``unetspsmall_3k`` weights, windowed by
``ops.sliding_window.make_sliding_window_fn`` with the patch size, overlap
and patch batch of ``examples/UNetSPDO/FlapRecSP2O_512.ini``.

``--package-root`` names the directory whose ``ctunet_tpu_torch`` is
imported (default: this checkout), so that one copy of the script times
two trees, say a parent commit unpacked with ``git archive``, each in a
fresh process: run them as parent, change, change, parent and compare
within one machine. Each process builds every kernel first
(``build.build``), then serves one volume to warm up and ``--reps`` timed
ones, each timed by CUDA events.

Usage::

    python tools/patch_serving_time_torch.py [--package-root DIR]
        [--reps 5]

It prints one JSON line: the card, each repetition's ms a volume, their
mean, the process's age when the timed volumes began, and the kernel
wrapper calls a volume makes (``kernels.launches``, both levels).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (224, 512, 512)


def serve_times(root: str, reps: int) -> dict:
    """Build the kernels and the windowed engine of the tree at ``root``
    and time ``reps`` volumes after one warm-up."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from ctunet_tpu_torch import default_params, engine, load_params
    from ctunet_tpu_torch.checkpoint import UNETSPSMALL_3K, load_any
    from ctunet_tpu_torch.data import spherical_shell
    from ctunet_tpu_torch.ops import kernels
    from ctunet_tpu_torch.ops.kernels import build
    from ctunet_tpu_torch.ops.sliding_window import make_sliding_window_fn

    import ctunet_tpu_torch
    assert os.path.dirname(os.path.dirname(ctunet_tpu_torch.__file__)) == \
        os.path.abspath(root), ctunet_tpu_torch.__file__
    device = torch.device("cuda")
    build.build()
    ini = load_params(os.path.join(root, "examples", "UNetSPDO",
                                   "FlapRecSP2O_512.ini"), default_params())
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    vol = spherical_shell(SHAPE, radius_frac=0.42, seed=1000)
    x = torch.from_numpy(vol.astype(np.float32))[None].to(device)
    pred = engine.build_predict(ini["model_class"], load_any(UNETSPSMALL_3K),
                                torch.bfloat16, device)
    sw = make_sliding_window_fn(
        pred, patch_size=int(ini["patch_size"]),
        overlap=float(ini["patch_overlap"]), atlas=atlas,
        compute_dtype=torch.bfloat16, patch_batch=int(ini["patch_batch"]))
    with torch.inference_mode():
        kernels.reset_launches()
        sw(x)
        torch.cuda.synchronize(device)
        calls = sum(kernels.launches().values())
        age = time.perf_counter() - T_START
        ms = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            sw(x)
            end.record()
            torch.cuda.synchronize(device)
            ms.append(start.elapsed_time(end))
    return dict(ms=ms, mean_ms=sum(ms) / len(ms), age_s=age,
                wrapper_calls_per_volume=calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    res = serve_times(os.path.abspath(args.package_root), args.reps)
    print(json.dumps(dict(tool="patch_serving_time_torch", card=card,
                          package_root=args.package_root, **res)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
