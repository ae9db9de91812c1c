"""Attribute a ``torch.profiler`` trace's kernel time to the port's layers.

While a profiler runs, every kernel wrapper of ``ops/kernels`` runs
inside a ``record_function`` span named after it (``ops/kernels/build.py``
``traced``), and so does the weight gradient of the training conv
(``dw_taps``). :func:`attribute` reads a finished profile: each device
kernel (or, in a CPU-only profile, each leaf ``aten::`` op) is matched to
the CPU call that launched it, then to the spans around that call, and
gets a category:

==========================  ==============================================
``kernel:<wrapper>``        a hand-written kernel (:data:`HAND_KERNELS`) by
                            its outermost wrapper (``conv3d_bn_relu``,
                            ``maxpool2``, ...); in a CPU profile, any op
                            inside a wrapper (the plain versions)
``wgrad bmm``               launched inside ``dw_taps``
``cuBLAS/cuDNN``            a library GEMM or convolution
``elementwise``             PyTorch's elementwise and reduction kernels
``copies``                  copies, memcpy and memset
``rest``                    anything else
==========================  ==============================================

:func:`attribute` also counts the launches whose kernel record the trace
lost (a runtime launch call whose correlation id no device kernel carries),
and :func:`dropped_in_trace` counts them in a written Chrome trace: a
breakdown with a lost record is missing that kernel's time, so every user
prints the count and ``chip_smoke.py`` fails on one.
:func:`rollup` sums the rows by category and :func:`top` lists the largest
by name. The JAX package's attribution tools read the XLA trace's HLO
metadata instead (``tools/attr_int8.py``, ``tools/attr_train.py``).

:func:`trace` is the profiling window every user of this module opens
(``Model``'s ``profile_dir``, the attribution tools, ``chip_smoke.py``):
the profiler's schedule runs a warm-up step of :data:`WARMUP_KERNELS`
tiny kernels, then records the block as its second step. Measured on an
H100 (``tools/profiler_windows_torch.py``): a window drops the first
activity records it takes after the profiler starts, the launches' CPU
records kept; their number grows with the process's age, about one every
20 s, and jumps now and then; a device sleep of 20 or 50 ms at the
window's start is dropped in their place but counts as one record only.
Fourteen minutes into ``chip_smoke.py`` a 20-sleep warm-up no longer
covered them (a bf16 engine pass lost its first 30 or so kernels, every
hand-written one among them). Why the records are dropped is not known,
so :data:`WARMUP_KERNELS` is a size found by trial, not a bound: with it
one full ``chip_smoke.py`` run's window still lost 1 of 25 launches. The ctypes launches were never the cause: a
fresh process's windows hold every one of them, with the kernels built
against the static or the shared CUDA runtime alike.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, Iterable, List, Tuple

# the spans that are not kernel wrappers
WGRAD_SPAN = "dw_taps"
# the warm-up step of a profiling window on the card: this many tiny
# kernels, each an activity record the window may drop in its place
WARMUP_KERNELS = 8192
# the runtime and driver calls that launch one kernel each, as a trace names
# them (``cudaLaunchKernelExC`` and ``cuLaunchKernelEx`` included)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
# the kernels of ``ctunet_tpu_torch/csrc``, as a trace names them
HAND_KERNELS = (
    "conv3d_tc_kernel", "conv3d_tc_f32_kernel", "conv3d_tc_q_kernel",
    "upconv_tc_kernel", "upconv_tc_f32_kernel", "upconv_tc_q_kernel",
    "maxpool2_rows_kernel", "conv3d_bias_act_kernel",
    "conv3d_plane_staged_kernel", "conv3d_q_kernel", "convt_k2s2_kernel",
    "maxpool2_kernel", "maxpool2_f32x4_kernel", "upconv_bn_relu_kernel",
    "upconv_q_kernel")


def hand_written(name: str) -> bool:
    """Whether a trace's kernel ``name`` is one of :data:`HAND_KERNELS`."""
    return any(f"::{k}{c}" in name for k in HAND_KERNELS for c in "<(")


def _warm_up(device) -> None:
    """:data:`WARMUP_KERNELS` device sleeps of a few dozen cycles each
    (tens of milliseconds of launches in all), then a synchronization."""
    import torch

    for _ in range(WARMUP_KERNELS):
        torch.cuda._sleep(64)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(device, on_trace_ready=None):
    """``torch.profiler.profile`` over the block: CPU activity, and on the
    card CUDA activity, recorded from a second step of the profiler's
    schedule after a warm-up step of tiny kernels (module docstring);
    ``on_trace_ready`` is called with the profile when the block ends.
    ``prof.events()`` holds the block's events after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts, on_trace_ready=on_trace_ready,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if cuda:
            _warm_up(device)
        prof.step()  # the warm-up step ends, the recorded one begins
        yield prof
        if cuda:
            torch.cuda.synchronize(device)


_LIBRARY = ("gemm", "cutlass", "nvjet", "xmma", "cudnn", "cublas",
            "convolve", "conv2d", "conv3d_grouped", "implicit", "winograd",
            "wgrad", "dgrad", "fprop", "addmm", "bmm", "aten::mm",
            "aten::convolution", "aten::_convolution", "mkldnn")
_COPIES = ("memcpy", "memset", "copy", "cat", "fill", "aten::to",
           "aten::_to_copy", "aten::clone", "aten::contiguous")
_ELEMENTWISE = ("elementwise", "reduce", "aten::")


def _wrapper_names():
    from ..ops.kernels import WRAPPERS

    return set(WRAPPERS)


def category(name: str, spans: List[str], wrappers=None,
             device: bool = True) -> str:
    """The category of a kernel ``name`` launched inside ``spans``
    (outermost first); ``device`` False for a CPU profile's ``aten::``
    op."""
    wrappers = _wrapper_names() if wrappers is None else wrappers
    ours = [s for s in spans if s in wrappers]
    if ours and (hand_written(name) or not device):
        return f"kernel:{ours[0]}"
    if WGRAD_SPAN in spans:
        return "wgrad bmm"
    low = name.lower()
    if any(k in low for k in _LIBRARY):
        return "cuBLAS/cuDNN"
    if any(k in low for k in _COPIES):
        return "copies"
    if any(k in low for k in _ELEMENTWISE):
        return "elementwise"
    return "rest"


def attribute(events) -> Tuple[List[Dict], int]:
    """One row per device kernel of ``events`` (``prof.events()``):
    ``{"name", "ms", "spans", "category"}``, ``spans`` the port's spans
    around its launch, outermost first. With no device event (a CPU-only
    profile) the rows are the leaf ``aten::`` ops by self CPU time.
    Returns ``(rows, dropped)``, ``dropped`` the launches
    (:data:`LAUNCH_CALLS`) whose kernel the trace lost: 0 when the rows
    hold every kernel launched in the window."""
    from torch.autograd import DeviceType

    wrappers = _wrapper_names()
    named = wrappers | {WGRAD_SPAN}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the device timeline also carries the spans themselves (user
    # annotations: the wrappers', ``ProfilerStep#``), which are no kernels
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)
           and e.name not in named and not e.name.startswith("ProfilerStep")]
    spans = sorted((e for e in cpu if e.name in named),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]

    def around(t: float, thread) -> List[str]:
        out = []
        for s in spans[:bisect.bisect_right(starts, t)]:
            if s.time_range.end >= t and (thread is None
                                          or s.thread == thread):
                out.append(s.name)
        return out

    kernel_ids = {k.id for k in dev}
    dropped = sum(1 for e in cpu if e.name.startswith(LAUNCH_CALLS)
                  and e.id not in kernel_ids)
    rows = []
    if dev:
        # a kernel's launch: the runtime call with its correlation id, else
        # the CPU op it is linked to
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
                     around(launch.time_range.start, launch.thread))
            ms = (k.time_range.end - k.time_range.start) / 1e3
            rows.append(dict(name=k.name, ms=ms, spans=chain,
                             category=category(k.name, chain, wrappers)))
        return rows, dropped
    for e in cpu:
        if not e.name.startswith("aten::") or e.self_cpu_time_total <= 0:
            continue
        chain = around(e.time_range.start, e.thread)
        rows.append(dict(name=e.name, ms=e.self_cpu_time_total / 1e3,
                         spans=chain, category=category(e.name, chain,
                                                        wrappers, False)))
    return rows, dropped


def dropped_in_trace(trace_events) -> int:
    """:func:`attribute`'s ``dropped`` for a written Chrome trace (the
    ``traceEvents`` of a ``tensorboard_trace_handler`` file): launch calls
    whose correlation id no ``kernel`` event carries."""
    def corr(e):
        return (e.get("args") or {}).get("correlation")

    kernel_ids = {corr(e) for e in trace_events if e.get("cat") == "kernel"}
    return sum(1 for e in trace_events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and str(e.get("name")).startswith(LAUNCH_CALLS)
               and corr(e) not in kernel_ids)


def rollup(rows: Iterable[Dict]) -> Dict[str, float]:
    """Milliseconds by category, largest first."""
    tot = collections.defaultdict(float)
    for r in rows:
        tot[r["category"]] += r["ms"]
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def top(rows: Iterable[Dict], n: int = 15) -> List[Dict]:
    """The ``n`` largest kernels by total time, rows of the same name and
    spans merged: ``{"name", "spans", "count", "ms"}``."""
    agg: Dict[tuple, Dict] = {}
    for r in rows:
        key = (r["name"], "/".join(r["spans"]))
        a = agg.setdefault(key, dict(name=r["name"], spans=key[1],
                                     count=0, ms=0.0,
                                     category=r["category"]))
        a["count"] += 1
        a["ms"] += r["ms"]
    return sorted(agg.values(), key=lambda a: -a["ms"])[:n]


def wrapper_counts(rows: Iterable[Dict]) -> Dict[str, int]:
    """Hand-written kernel launches per outermost wrapper, as a trace on
    the card attributes them (a CPU profile's rows count none)."""
    out = collections.Counter(r["category"][len("kernel:"):] for r in rows
                              if r["category"].startswith("kernel:")
                              and hand_written(r["name"]))
    return dict(out)
