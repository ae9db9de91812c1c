#!/usr/bin/env python
"""How many kernel records a ``torch.profiler`` window keeps, as a process
ages: the measurement behind ``ctunet_tpu_torch/utils/profiling.trace``.

Every ``--every`` seconds (the card kept busy in between) it opens one
window of each kind over the same body, 40 small kernels each behind a
0.25 ms device sleep, after 40 other kernels that ran (and finished)
before the window:

- ``plain``: ``torch.profiler.profile`` recording from its first instant;
- ``pad``: the same with a 50 ms device sleep at each end of the window;
- ``trace``: ``utils.profiling.trace`` (a warm-up step of the profiler's
  schedule, then the recorded step).

Each window reports the body's kernels it kept (of 40), the position of
the first one kept (so whether the lost ones are the first), the body's
launch records on the host (80 when all are there), whether a pad's
sleep was kept, the earlier kernels it took in, and the launches whose
kernel it lost as ``utils.profiling.attribute`` counts them
(``dropped``) and as ``utils.profiling.dropped_in_trace`` counts them in
the window's Chrome trace (``dropped_json``). Runs on the card only
(``torch.profiler``'s CUDA activity is the subject).

Usage::

    python tools/profiler_windows_torch.py [--windows 10] [--every 20]

It prints one JSON line: the card and every window's counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_tools as tt  # noqa: E402

BODY = 40
SLEEP_MS = 0.25
PAD_MS = 50.0


def windows(n: int, every: float, log=print) -> list:
    """``n`` rounds of the three windows, ``every`` seconds apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ctunet_tpu_torch.device import resolve_device
    from ctunet_tpu_torch.utils import profiling

    dev = resolve_device(None)
    x = torch.zeros(1024, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize(dev)
    cycles_per_ms = 1e7 / start.elapsed_time(end)

    def sleep(ms):
        torch.cuda._sleep(int(ms * cycles_per_ms))

    def before():
        for _ in range(BODY):
            x.cos_()
        torch.cuda.synchronize(dev)

    def body():
        for _ in range(BODY):
            sleep(SLEEP_MS)
            x.sin_()
        torch.cuda.synchronize(dev)

    def counts(prof):
        events = prof.events()
        gpu = [e for e in events if e.device_type == DeviceType.CUDA]
        launch = {e.id: e for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith("cudaLaunchKernel")}
        ops = sorted((e.time_range for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name == "aten::sin_"), key=lambda r: r.start)
        kept = [launch[e.id].time_range.start for e in gpu
                if "sin" in e.name and e.id in launch]
        first = next((i for i, r in enumerate(ops)
                      if any(r.start <= t <= r.end for t in kept)), None)
        out = {"kept": sum("sin" in e.name for e in gpu),
               "first_kept": first, "launch_records": len(launch),
               "sleeps_kept": sum("spin" in e.name for e in gpu),
               "took_in": sum("cos" in e.name for e in gpu),
               "dropped": profiling.attribute(events)[1]}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "window.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                out["dropped_json"] = profiling.dropped_in_trace(
                    json.load(f)["traceEvents"])
        return out

    def plain(pad_ms):
        before()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if pad_ms:
                sleep(pad_ms)
            body()
            if pad_ms:
                sleep(pad_ms)
                torch.cuda.synchronize(dev)
        return counts(prof)

    def traced():
        before()
        with profiling.trace(dev) as prof:
            body()
        return counts(prof)

    out, t0 = [], time.time()
    for i in range(n):
        while time.time() < t0 + every * i:
            x.add_(1)
            sleep(5.0)
            torch.cuda.synchronize(dev)
        row = {"t_s": round(time.time() - t0, 1), "plain": plain(0.0),
               "pad": plain(PAD_MS), "trace": traced()}
        log(row)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--every", type=float, default=20.0)
    args = ap.parse_args(argv)
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rows = windows(args.windows, args.every,
                   log=lambda r: print(r, file=sys.stderr, flush=True))
    tt.emit(dict(tool="profiler_windows_torch", card=card, body=BODY,
                 windows=rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
