"""The port's spans and counters, and the attribution of a
``torch.profiler`` trace's kernel time to the port's layers.

**Spans and counters.** :func:`span` is the one span of the package. Its
names start with :data:`SPAN_PREFIX` (``ctunet.upload``,
``ctunet.engine.heads``, ``ctunet.train.step`` and its phases,
``ctunet.serve.*``), except the kernel wrappers' (``ops/kernels/build.py``
``traced``: each named after its wrapper) and the training conv's weight
gradient (``dw_taps``). :func:`count` adds to a named counter.

- Off (no profiler runs and no :func:`recording` block is open), a span
  costs one check of the profiler's state and a flag, allocates nothing
  and records nothing; so does a count.
- On (any ``torch.profiler`` session, such as :func:`trace`'s window, or
  inside :func:`recording`), a span opens a ``record_function`` of its
  name while a profiler runs, so that it sits in the profile beside the
  device's kernels on the profiler's clock, and adds its host duration
  (``time.perf_counter_ns``) to the totals of its path: the names from the
  outermost span open on the same thread to the span. With ``device=True``
  it also records a pair of timing events on the current stream, taken
  from a pool of reused pairs; it never waits for the device.
  :func:`snapshot` resolves the pairs whose work is done, so a caller
  synchronizes before it.
- Memory is bounded: totals by path and counters, no raw spans. A device
  span that finds none of :data:`EVENT_PAIRS` pairs free is timed on the
  host only and counted as ``untimed``; a device total is then short.

:func:`snapshot` gives by span name: count, host ms, self ms (the
duration less that of the child spans on its thread) and device ms (None
where the span records no events); the same by path; the counters; the
untimed count. :func:`reset` clears all of it.

**Attribution.** :func:`attribute` reads a finished profile: each device
kernel (or, in a CPU-only profile, each leaf ``aten::`` op) is matched to
the CPU call that launched it, then to the spans around that call, and
gets a category (the ``ctunet.*`` spans around it are listed in its row
but choose no category):

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
by name. :func:`idle_gaps` labels each stretch in which the device ran
nothing by the innermost ``ctunet.*`` span the host was in. The JAX
package's attribution tools read the XLA trace's HLO metadata instead
(``tools/attr_int8.py``, ``tools/attr_train.py``).

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
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# the first letters of every span name of the package but the kernel
# wrappers' and WGRAD_SPAN
SPAN_PREFIX = "ctunet."
# the spans that are not kernel wrappers
WGRAD_SPAN = "dw_taps"
# timing-event pairs in use or free at most
EVENT_PAIRS = 256


def _enabled() -> bool:
    """Whether a ``torch.profiler`` session runs. The first call binds the
    module's ``_enabled`` to torch's own check, so that later calls cost
    that check alone and importing this module imports no torch."""
    global _enabled
    import torch

    _enabled = torch._C._autograd._profiler_enabled
    return _enabled()


class _Total:
    """What the recorder keeps of every span of one path."""

    __slots__ = ("count", "host_ns", "self_ns", "device_ms")

    def __init__(self) -> None:
        self.count = self.host_ns = self.self_ns = 0
        self.device_ms: Optional[float] = None


class Recorder:
    """Spans and counters kept in memory (module docstring); the one
    instance, :data:`RECORDER`, is behind :func:`span`, :func:`count`,
    :func:`recording`, :func:`snapshot` and :func:`reset`."""

    def __init__(self) -> None:
        self.recording = 0  # open recording() blocks
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._totals: Dict[tuple, _Total] = {}
            self._counters: Dict[str, int] = collections.Counter()
            # timing-event pairs: those made (and not let go), those ready
            # for reuse, those whose work is not known to be done
            self._pairs = 0
            self._free: List[tuple] = []
            self._unresolved: collections.deque = collections.deque()
            self._untimed = 0

    def stack(self) -> list:
        """The spans open on this thread, outermost first."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _resolve(self) -> None:
        """Add the device time of every pair whose work is done, oldest
        first, to its path; the pair is free again. Never waits (the
        lock is held)."""
        while self._unresolved:
            path, start, end = self._unresolved[0]
            if not (end.query() and start.query()):
                return
            self._unresolved.popleft()
            total = self._totals[path]
            total.device_ms = (total.device_ms or 0.0) + start.elapsed_time(
                end)
            self._free.append((start, end))

    def pair(self):
        """A free timing-event pair, a new one while fewer than
        :data:`EVENT_PAIRS` exist, else None (the span is untimed)."""
        with self._lock:
            if not self._free:
                self._resolve()
            if self._free:
                return self._free.pop()
            if self._pairs >= EVENT_PAIRS:
                self._untimed += 1
                return None
            self._pairs += 1
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def close(self, sp: "_Span", end_ns: int) -> None:
        duration = end_ns - sp.start_ns
        with self._lock:
            total = self._totals.get(sp.path)
            if total is None:
                total = self._totals[sp.path] = _Total()
            total.count += 1
            total.host_ns += duration
            total.self_ns += duration - sp.child_ns
            if sp.events is not None:
                self._unresolved.append((sp.path,) + sp.events)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] += n

    def snapshot(self) -> Dict:
        with self._lock:
            self._resolve()
            paths = {"/".join(p): _view(t) for p, t in self._totals.items()}
            spans: Dict[str, Dict] = {}
            for p, t in self._totals.items():
                spans[p[-1]] = _merge(spans.get(p[-1]), _view(t))
            return dict(spans=spans, paths=paths,
                        counters=dict(self._counters), untimed=self._untimed)


def _view(t: _Total) -> Dict:
    return dict(count=t.count, host_ms=t.host_ns / 1e6,
                self_ms=t.self_ns / 1e6, device_ms=t.device_ms)


def _merge(a: Optional[Dict], b: Dict) -> Dict:
    if a is None:
        return b
    dev = [v for v in (a["device_ms"], b["device_ms"]) if v is not None]
    return dict(count=a["count"] + b["count"],
                host_ms=a["host_ms"] + b["host_ms"],
                self_ms=a["self_ms"] + b["self_ms"],
                device_ms=sum(dev) if dev else None)


class _Span:
    """One span while the recorder is on (:func:`span`)."""

    __slots__ = ("rec", "name", "device", "parent", "path", "events",
                 "profiled", "child_ns", "start_ns")

    def __init__(self, rec: Recorder, name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self) -> "_Span":
        stack = self.rec.stack()
        self.parent = stack[-1] if stack else None
        self.path = (self.name,) if self.parent is None else \
            self.parent.path + (self.name,)
        self.profiled = None
        if _enabled():
            import torch

            self.profiled = torch.profiler.record_function(self.name)
            self.profiled.__enter__()
        self.events = self.rec.pair() if self.device else None
        if self.events is not None:
            self.events[0].record()
        self.child_ns = 0
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.rec.stack().pop()  # ``with`` blocks nest: this span is on top
        if self.parent is not None:
            self.parent.child_ns += end_ns - self.start_ns
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        self.rec.close(self, end_ns)
        return False


RECORDER = Recorder()
# what span() returns while off: one reusable do-nothing context
_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether spans and counts record now."""
    return bool(RECORDER.recording or _enabled())


def span(name: str, device: bool = False):
    """A context manager around one stretch of the package's work named
    ``name`` (module docstring); ``device`` True to time it on the card's
    current stream too."""
    if not (RECORDER.recording or _enabled()):
        return _OFF
    return _Span(RECORDER, name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans record."""
    if RECORDER.recording or _enabled():
        RECORDER.add(name, n)


@contextlib.contextmanager
def recording():
    """Spans and counts record inside the block, with or without a
    profiler."""
    with RECORDER._lock:
        RECORDER.recording += 1
    try:
        yield RECORDER
    finally:
        with RECORDER._lock:
            RECORDER.recording -= 1


def snapshot() -> Dict:
    """What the recorder holds (module docstring): ``{"spans": {name:
    {"count", "host_ms", "self_ms", "device_ms"}}, "paths":
    {"outer/.../name": the same}, "counters": {name: n}, "untimed": device
    spans that found no free event pair}``. Device time counts only the
    work done by now: synchronize first."""
    return RECORDER.snapshot()


def reset() -> None:
    """Forget every span and counter."""
    RECORDER.reset()


def children_ms(snap: Dict, parent: str) -> Dict[str, float]:
    """Host ms by name of the spans directly inside spans named
    ``parent``, from a :func:`snapshot`."""
    out: Dict[str, float] = collections.defaultdict(float)
    for path, t in snap["paths"].items():
        names = path.split("/")
        if len(names) > 1 and names[-2] == parent:
            out[names[-1]] += t["host_ms"]
    return dict(out)


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
    "upconv_q_kernel", "adam_mt_kernel")


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


def _device_events(events, named) -> List:
    """The kernels, copies and fills of a profile's ``events``: not the
    spans themselves (user annotations on the device timeline: the
    wrappers', ``ctunet.*``, ``ProfilerStep#``)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and e.name not in named and not e.name.startswith(SPAN_PREFIX)
            and not e.name.startswith("ProfilerStep")]


def attribute(events) -> Tuple[List[Dict], int]:
    """One row per device kernel of ``events`` (``prof.events()``):
    ``{"name", "ms", "spans", "category"}``, ``spans`` the port's spans
    (the wrappers', ``dw_taps`` and ``ctunet.*``) around its launch,
    outermost first. With no device event (a CPU-only profile) the rows
    are the leaf ``aten::`` ops by self CPU time.
    Returns ``(rows, dropped)``, ``dropped`` the launches
    (:data:`LAUNCH_CALLS`) whose kernel the trace lost: 0 when the rows
    hold every kernel launched in the window."""
    from torch.autograd import DeviceType

    wrappers = _wrapper_names()
    named = wrappers | {WGRAD_SPAN}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = _device_events(events, named)
    spans = sorted((e for e in cpu if e.name in named
                    or e.name.startswith(SPAN_PREFIX)),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]

    def around(t: float, thread) -> List[str]:
        # a ctunet.* span holds what other threads launch meanwhile (the
        # backward pass launches from autograd's thread)
        out = []
        for s in spans[:bisect.bisect_right(starts, t)]:
            if s.time_range.end >= t and (
                    thread is None or s.thread == thread
                    or s.name.startswith(SPAN_PREFIX)):
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


def idle_gaps(events) -> List[Dict]:
    """Every stretch of a profile's ``events`` between its first and last
    device event in which the device ran nothing (no kernel, copy or
    fill), in time order: ``{"label", "start", "ms"}``, ``start`` on the
    profiler's clock (microseconds) and ``label`` the innermost
    ``ctunet.*`` span open on the host at the stretch's middle, on any
    thread (``host`` where none is)."""
    from torch.autograd import DeviceType

    named = _wrapper_names() | {WGRAD_SPAN}
    busy: List[List[float]] = []
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in _device_events(events, named)):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith(SPAN_PREFIX))
    starts = [s for s, _, _ in spans]
    out = []
    for (_, lo), (hi, _) in zip(busy, busy[1:]):
        mid = (lo + hi) / 2
        # the latest-starting span still open at ``mid`` is the innermost
        label = next((name for s, e, name in reversed(
            spans[:bisect.bisect_right(starts, mid)]) if e >= mid), "host")
        out.append(dict(label=label, start=lo, ms=(hi - lo) / 1e3))
    return out


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
