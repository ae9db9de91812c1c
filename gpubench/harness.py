"""One run of one cell: find its parts by name, set the system up, measure
a window (or trace one), compare with the reference, and build the
result.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is found by its name in ``BENCHMARK.json``:

- ``gpubench/configs/<config>.json``: the configuration (its ``file``);
- ``gpubench/mixes/<traffic>.json``: the mix's parameters, read by the
  loop of its ``kind``, ``gpubench/kinds/<kind>.py`` (:mod:`systems`);
- ``gpubench/metrics/<metric>.py``: ``read(view)``, the metric's value
  from a traced window, or None where it finds nothing to read;
- ``gpubench/limits/<cell>.json``: the limit of each number compared.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
import types
from typing import Dict, List, Optional, Tuple

import torch

from . import flops, systems, trace_math

ROOT = systems.ROOT
# the warm-up step of a profiling window: this many tiny kernels, whose
# records the profiler may drop in place of the window's own
# (``ctunet_tpu_torch/utils/profiling.py``)
WARMUP_KERNELS = 8192


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries: List[Dict], name: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``gpubench/metrics/<name>.py``."""
    path = os.path.join(root, "gpubench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_parts(bench: Dict, cell_name: str, root: str = ROOT
               ) -> Tuple[Dict, Dict, Dict, Dict]:
    """``(cell, config, mix, limits)`` of a cell, each found by name."""
    cell = by_name(bench["workloads"], cell_name)
    cfg = load_json(os.path.join(root, by_name(bench["configs"],
                                               cell["config"])["file"]))
    mix = load_json(os.path.join(root, "gpubench", "mixes",
                                 f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(root, "gpubench", "limits",
                                    f"{cell_name}.json"))
    return cell, cfg, mix, limits


def _listed(metric: Dict, cell_name: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell_metrics(bench: Dict, cell_name: str) -> Tuple[List[Dict],
                                                       List[Dict]]:
    """The end-to-end and per-layer metrics a cell reports."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, cell_name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _listed(m, cell_name, names)]
    return e2e, layer


@contextlib.contextmanager
def profiled(device):
    """A ``torch.profiler`` window over the block, recorded from the
    second step of the profiler's schedule after a warm-up step of
    :data:`WARMUP_KERNELS` tiny kernels (a frozen copy of
    ``ctunet_tpu_torch/utils/profiling.trace``). Yields the profile, whose
    ``events()`` hold the block's events after it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    systems.sync(device)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if cuda:
            for _ in range(WARMUP_KERNELS):
                torch.cuda._sleep(64)
            torch.cuda.synchronize(device)
        prof.step()
        yield prof
        systems.sync(device)


def trace_view(events, units: int, cfg: Dict, kind: str, canvas,
               untraced: Dict) -> Tuple[types.SimpleNamespace, Dict, int]:
    """What the metric readers read of a traced window (and, as
    ``untraced``, what the run's untraced window measured), the
    breakdown, and the count of launches whose record the trace lost."""
    rows, dropped, spans = trace_math.attribute(events)
    lo, hi = spans.bounds(trace_math.OWN_PREFIX + "window")
    dev_rows = [r for r in rows if r["end"] >= lo and r["start"] <= hi]
    busy = trace_math.busy_intervals(dev_rows, lo, hi)
    window_s = (hi - lo) / 1e6
    busy_s = sum(e - s for s, e in busy) / 1e6
    spec = cfg["model"]
    layers = flops.layers(spec, canvas)
    view = types.SimpleNamespace(
        kind=kind, untraced=untraced, rows=dev_rows, units=units,
        window_s=window_s,
        busy_s=busy_s, host_ms=spans.total_ms, config=cfg, canvas=canvas,
        forward_flops=flops.forward_flops(spec, canvas),
        train_flops=flops.train_flops(spec, canvas) * int(
            cfg["settings"].get("batch_size") or 1),
        least_s=flops.least_seconds(layers, trace_math.BF16_FLOP_PER_S,
                                    trace_math.HBM_BYTES_PER_S),
        peak_flop_per_s=trace_math.BF16_FLOP_PER_S)
    gaps = sorted(trace_math.idle_gaps(busy, lo, hi, spans),
                  key=lambda g: -g[1])[:10]
    breakdown = dict(device_ops=[list(t) for t in
                                 trace_math.top_ops(dev_rows)],
                     idle_gaps=[[label, us / 1e6] for label, us in gaps])
    return view, breakdown, dropped


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, root: str = ROOT,
             canvas: Optional[Tuple[int, int, int]] = None) -> Dict:
    """Run ``cell_name`` once and return the result line's object (the
    numbers compared under ``checks``, last). ``canvas`` replaces the
    configuration's (small runs off the card only)."""
    bench = manifest(root)
    cell, cfg, mix, limits = cell_parts(bench, cell_name, root)
    canvas = tuple(canvas or cfg["canvas"])
    e2e, layer = cell_metrics(bench, cell_name)
    t_system = time.perf_counter()
    system = systems.kind(mix["kind"], root).System(cfg, mix, seed, device,
                                                    canvas)
    setup_s = time.perf_counter() - t0
    stages = dict(imports=t_system - t0, **system.setup_stages.seconds)
    breakdown = None
    if trace:
        # the untraced window first, then a traced one of fixed length
        untraced = system.window(seconds=seconds)
        with profiled(device) as prof:
            with systems.span(trace_math.OWN_PREFIX + "window"):
                out = system.window(count=int(mix["trace_units"]))
        view, breakdown, dropped = trace_view(
            prof.events(), out["completed"], cfg, mix["kind"], canvas,
            untraced)
        print(f"gpubench: the trace lost {dropped} launch records",
              flush=True)
        values = {}
        for m in layer:
            v = reader(m["name"], root)(view)
            if v is not None:
                values[m["name"]] = v
    else:
        out = system.window(seconds=seconds)
        values = {m["name"]: out.get(m["name"]) for m in e2e
                  if m["name"] != "setup_s"}
        values = {k: v for k, v in values.items() if v is not None}
        values["setup_s"] = setup_s
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    system.release()
    numbers = system.check()
    checks = {k: [numbers[k], lim] for k, lim in limits.items()}
    correct = all(v <= lim for v, lim in checks.values())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=int(cell["chips"]), memory_peak_bytes=int(peak))
    # every volume or step attempted completes (the window's last ones
    # after it closes) or the run raises
    result = dict(correct=correct, attempted=int(out["attempted"]),
                  failed=0,
                  metrics={k: dict(value=v, unit=units[k])
                           for k, v in values.items()},
                  device=dev)
    if trace:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = breakdown
    # set-up by stage: ``build`` is the kernels' nvcc build, which only a
    # checkout's first run makes
    result["numbers"] = dict(
        {k: v for k, v in numbers.items() if k not in limits},
        setup_stages_s=stages,
        **{k: out[k] for k in ("stage_ms", "latency_ms") if k in out})
    result["checks"] = checks
    return result
