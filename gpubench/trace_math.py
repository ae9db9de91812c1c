"""Reduction of a ``torch.profiler`` window to the benchmark's numbers.

A frozen copy of the arithmetic of ``ctunet_tpu_torch/utils/profiling.py``
(``category``'s library, copy and elementwise tests, ``attribute``), so
that a later change to the package cannot change how its time is counted,
with the published peaks of one NVIDIA H100 SXM. On top of it: each device
event's start and end, the benchmark's own ``gpubench.*`` spans around its
launch, the busy time of the device (kernels, copies and fills, overlaps
counted once) and its idle gaps, each labelled by the benchmark span the
host was in. It takes nothing from the package.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 bandwidth
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

OWN_PREFIX = "gpubench."
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
_LIBRARY = ("gemm", "cutlass", "nvjet", "xmma", "cudnn", "cublas",
            "convolve", "conv2d", "conv3d_grouped", "implicit", "winograd",
            "wgrad", "dgrad", "fprop", "addmm", "bmm", "aten::mm",
            "aten::convolution", "aten::_convolution", "mkldnn")
_COPIES = ("memcpy", "memset", "copy", "cat", "fill", "aten::to",
           "aten::_to_copy", "aten::clone", "aten::contiguous")
_ELEMENTWISE = ("elementwise", "reduce", "aten::")


def category(name: str) -> str:
    """``cuBLAS/cuDNN``, ``copies``, ``elementwise`` or ``rest`` for a
    kernel (or a CPU profile's ``aten::`` op) named ``name``."""
    low = name.lower()
    if any(k in low for k in _LIBRARY):
        return "cuBLAS/cuDNN"
    if any(k in low for k in _COPIES):
        return "copies"
    if any(k in low for k in _ELEMENTWISE):
        return "elementwise"
    return "rest"


class _Spans:
    """The benchmark's own host spans, by name, for lookups of the spans
    open at a time on any thread (the backward pass launches from
    autograd's thread while the host's step span is open; spans of one
    name never overlap)."""

    def __init__(self, events):
        by_name = collections.defaultdict(list)
        for e in events:
            if e.name.startswith(OWN_PREFIX):
                by_name[e.name].append(e)
        self.groups = {}
        for name, evs in by_name.items():
            evs.sort(key=lambda e: e.time_range.start)
            self.groups[name] = ([e.time_range.start for e in evs], evs)

    def around(self, t: float) -> List[str]:
        """Names of the spans open at ``t``, outermost first."""
        found = []
        for name, (starts, evs) in self.groups.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and evs[i].time_range.end >= t:
                found.append((evs[i].time_range.start, name))
        return [n for _, n in sorted(found)]

    def total_ms(self, name: str) -> float:
        _, evs = self.groups.get(name, ([], []))
        return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3

    def bounds(self, name: str) -> Tuple[float, float]:
        """The first start and the last end of the spans of ``name``."""
        _, evs = self.groups[name]
        return evs[0].time_range.start, max(e.time_range.end for e in evs)


def attribute(events) -> Tuple[List[Dict], int, _Spans]:
    """One row per device event of ``events`` (``prof.events()``):
    ``{"name", "start", "end", "ms", "spans", "category"}`` (times in
    microseconds of the profiler's clock), ``spans`` the benchmark's spans
    around its launch, outermost first. With no device event (a CPU-only
    profile) the rows are the leaf ``aten::`` ops by self CPU time.
    Returns ``(rows, dropped, spans)``, ``dropped`` the launches whose
    kernel record the trace lost."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(OWN_PREFIX)
           and not e.name.startswith("ProfilerStep")]
    spans = _Spans(cpu)
    kernel_ids = {k.id for k in dev}
    dropped = sum(1 for e in cpu if e.name.startswith(LAUNCH_CALLS)
                  and e.id not in kernel_ids)
    rows = []
    if dev:
        by_id = collections.defaultdict(list)
        for e in cpu:
            by_id[e.id].append(e)
        for k in dev:
            launch = next((e for e in by_id.get(k.id, ())
                           if e.name.startswith("cu")), None)
            if launch is None:
                launch = next(iter(by_id.get(getattr(
                    k, "linked_correlation_id", 0), ())), None)
            chain = ([] if launch is None else
                     spans.around(launch.time_range.start))
            rows.append(dict(
                name=k.name, start=k.time_range.start, end=k.time_range.end,
                ms=(k.time_range.end - k.time_range.start) / 1e3,
                spans=chain, category=category(k.name)))
        return rows, dropped, spans
    for e in cpu:
        if not e.name.startswith("aten::") or e.self_cpu_time_total <= 0:
            continue
        rows.append(dict(
            name=e.name, start=e.time_range.start, end=e.time_range.end,
            ms=e.self_cpu_time_total / 1e3,
            spans=spans.around(e.time_range.start),
            category=category(e.name)))
    return rows, dropped, spans


def busy_intervals(rows: Iterable[Dict], lo: float, hi: float
                   ) -> List[Tuple[float, float]]:
    """The union of the rows' ``[start, end]`` clipped to ``[lo, hi]``."""
    merged: List[List[float]] = []
    for s, e in sorted((max(r["start"], lo), min(r["end"], hi))
                       for r in rows):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
              spans: _Spans) -> List[Tuple[str, float]]:
    """Every idle stretch of ``[lo, hi]`` as ``(label, microseconds)``,
    the label the innermost benchmark span the host was in at its middle
    (``host`` when in none)."""
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    out = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            own = [n for n in spans.around((s + e) / 2)
                   if n.startswith(OWN_PREFIX) and n != OWN_PREFIX + "window"]
            out.append((own[-1] if own else "host", e - s))
    return out


def top_ops(rows: Iterable[Dict], n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device operations that took most time in all, by name
    with the spans they ran in: ``(label, seconds)``."""
    agg = collections.defaultdict(float)
    for r in rows:
        where = "/".join(s for s in r["spans"]
                         if s != OWN_PREFIX + "window")
        name = r["name"].replace("(anonymous namespace)::", "")
        name = name.split("(")[0].strip()
        label = f"{where}: {name}" if where else name
        agg[label[:160]] += r["ms"] / 1e3
    return sorted(agg.items(), key=lambda kv: -kv[1])[:n]
