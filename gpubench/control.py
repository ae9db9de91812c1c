"""The readings that a cell's limits are set from: the program's, and its
control's, at the cell's own size, on several seeds in one process.

    python gpubench/control.py --workload <cell> --seeds 11,12,13 [--control]

Each seed prints one JSON line of the numbers the run compares (and the
ones it only reports). The control of a serving cell is the program's own
int8 engine (``use_int8``, calibrated on the first volume served, the
path one step below the configuration's bf16); the control of a training
cell is the reference put in the program's place with every conv,
ConvTranspose and head operand rounded to float8 (e4m3, its gradient
e5m2: one step below bf16), compared with the f32 reference as the
program is. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name: str, seed: int, control: bool, device,
             canvas=None, root: str = ROOT) -> dict:
    """The numbers of one seed: the program's, or with ``control`` the
    control's."""
    from gpubench import harness, systems
    from gpubench.reference.precision import fp8

    _, cfg, mix, _ = harness.cell_parts(harness.manifest(root), cell_name,
                                        root)
    canvas = tuple(canvas or cfg["canvas"])
    loop = systems.kind(mix["kind"], root)
    if mix["kind"] == "serve":
        if control:
            cfg = dict(cfg, settings=dict(cfg["settings"], use_int8=True,
                                          int8_adaquant=False))
        system = loop.System(cfg, mix, seed, device, canvas)
        system.window(count=int(mix["sample"]))
        system.release()
        return system.check()
    system = loop.System(cfg, mix, seed, device, canvas)
    system.release()
    ref = system.reference_readings()
    if control:
        return loop.compare(system.reference_readings(q=fp8), ref)
    return loop.compare(system.readings(), ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = readings(args.workload, seed, args.control, device)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=args.control,
                              seconds=time.perf_counter() - t0, **nums)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
