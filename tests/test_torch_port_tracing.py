"""PyTorch port, the spans and counters of ``utils/profiling.py`` on the
CPU: nothing recorded while off; under a profiler and under
``recording()`` every ``ctunet.*`` span of a train step once a step, under
its parent, self time within its duration, the profile's CPU events named
alike and the kernel wrappers' spans under their own names; the upload's
spans and counters; the timing-event pool, which never waits; threads;
the idle stretches of a profile and the ``ctunet.*`` spans in the
attribution.
"""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ctunet_tpu_torch import engine, steps
from ctunet_tpu_torch.checkpoint import UNETSP_10K, load_any
from ctunet_tpu_torch.data import spherical_shell
from ctunet_tpu_torch.data.pipeline import upload
from ctunet_tpu_torch.models import build_model
from ctunet_tpu_torch.problem import FlapRecWithShapePriorDoubleOut
from ctunet_tpu_torch.utils import profiling

torch.set_num_threads(2)

SHAPE = (16, 16, 32)
PHASES = ("synthesis", "forward", "loss", "backward", "optimizer")
LOSS = {"ce_lambda": 1.0, "dice_lambda": 1.0, "save_dice_plots": False}


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _train_step(impl="chain"):
    torch.manual_seed(0)
    model = build_model("UNetSP").configure(impl, torch.float32)
    state = steps.TrainState(model, steps.make_optimizer(
        {"optimizer": "adam", "learning_rate": 1e-4}, model.parameters()))
    atlas = spherical_shell(SHAPE, radius_frac=0.42).astype(np.float32)
    step = steps.make_train_step(model, FlapRecWithShapePriorDoubleOut(),
                                 LOSS, atlas=atlas,
                                 compute_dtype=torch.float32)
    batch = {"image": torch.from_numpy(spherical_shell(
        SHAPE, radius_frac=0.4)[None].astype(np.float32))}
    gen = torch.Generator().manual_seed(0)
    return lambda: step(state, batch, gen), state


def _serve_one():
    fwd = engine.build_predict("UNetSP", load_any(UNETSP_10K),
                               torch.float32, device="cpu")
    vol = np.stack([spherical_shell(SHAPE, seed=1),
                    spherical_shell(SHAPE, radius_frac=0.42)], -1)
    fwd(upload(vol[None].astype(np.float32), torch.device("cpu"),
               torch.float32))


def test_off_records_nothing():
    run, _ = _train_step()
    _serve_one()
    run()
    profiling.count("ctunet.upload.bytes", 5)
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["paths"] == {}
    assert snap["counters"] == {} and snap["untimed"] == 0
    assert not profiling.active()
    assert profiling.span("ctunet.x") is profiling.span("ctunet.y")


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_train_step_spans_once_a_step_under_their_parent(how):
    run, _ = _train_step()
    run()  # the lazy set-up outside the window
    block = (profile(activities=[ProfilerActivity.CPU]) if how == "profiler"
             else profiling.recording())
    with block as prof:
        run()
        run()
    snap = profiling.snapshot()
    spans, paths = snap["spans"], snap["paths"]
    names = ["ctunet.train.step"] + [f"ctunet.train.{p}" for p in PHASES]
    for name in names:
        assert spans[name]["count"] == 2, name
        assert spans[name]["device_ms"] is None  # no device on the CPU
    for p in PHASES:
        assert paths[f"ctunet.train.step/ctunet.train.{p}"]["count"] == 2
    for t in list(spans.values()) + list(paths.values()):
        assert 0 <= t["self_ms"] <= t["host_ms"] + 1e-9
    step = spans["ctunet.train.step"]
    inner = sum(spans[f"ctunet.train.{p}"]["host_ms"] for p in PHASES)
    assert step["self_ms"] == pytest.approx(step["host_ms"] - inner,
                                            abs=1e-6)
    # the kernel wrappers' spans, under their own names, inside the phases
    assert spans["conv3d_bias_act"]["count"] > 0
    assert any(p.startswith("ctunet.train.step/ctunet.train.forward/")
               and p.endswith("conv3d_bias_act") for p in paths)
    if how == "profiler":
        events = [e.name for e in prof.events()]
        for name in names:
            assert events.count(name) == 2, name
        assert "conv3d_bias_act" in events and "dw_taps" in events


def test_engine_heads_span_once_a_volume():
    with profiling.recording():
        _serve_one()
    snap = profiling.snapshot()
    assert snap["spans"]["ctunet.engine.heads"]["count"] == 1
    assert snap["spans"]["conv3d_bn_relu"]["count"] == 12
    assert "ctunet.engine.heads" in snap["paths"]  # no serving loop around


def test_upload_spans_and_counters():
    arr = np.arange(4 * 6 * 8, dtype=np.float64).reshape(1, 4, 6, 8)
    with profiling.recording():
        out = upload(arr, torch.device("cpu"), torch.float32)
    np.testing.assert_array_equal(out.numpy(), arr.astype(np.float32))
    snap = profiling.snapshot()
    assert set(snap["paths"]) == {"ctunet.upload",
                                  "ctunet.upload/ctunet.upload.stage",
                                  "ctunet.upload/ctunet.upload.copy"}
    assert all(t["count"] == 1 for t in snap["paths"].values())
    # the pinned pool is the card's: no such counter on the CPU
    assert snap["counters"] == {"ctunet.upload.bytes": arr.nbytes}


def test_a_span_closes_when_its_block_raises():
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.span("ctunet.outer"):
                with profiling.span("ctunet.inner"):
                    raise ValueError
        with profiling.span("ctunet.after"):
            pass
    assert profiling.RECORDER.stack() == []
    assert set(profiling.snapshot()["paths"]) == {
        "ctunet.outer", "ctunet.outer/ctunet.inner", "ctunet.after"}


class _Event:
    """A stand-in for ``torch.cuda.Event``: done when the test says."""

    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1
        self.done, self.t = False, 0.0

    def record(self, stream=None):
        self.done = False
        self.t = 1.5 * _Event.made

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done  # never asked of unfinished work
        return 2.0


def test_device_spans_never_wait_and_reuse_their_pairs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", None)  # must not run
    _Event.made = 0
    with profiling.recording():
        for _ in range(3):
            with profiling.span("ctunet.d", device=True):
                pass
    snap = profiling.snapshot()  # none done: nothing resolved, no wait
    assert snap["spans"]["ctunet.d"]["device_ms"] is None
    for _, start, end in profiling.RECORDER._unresolved:
        start.done = end.done = True
    snap = profiling.snapshot()
    assert snap["spans"]["ctunet.d"]["device_ms"] == 6.0
    made = _Event.made
    with profiling.recording():
        with profiling.span("ctunet.d", device=True):
            pass
    assert _Event.made == made  # a free pair was taken again


def test_device_spans_past_the_pool_are_untimed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    n = profiling.EVENT_PAIRS + 3
    with profiling.recording():
        for _ in range(n):  # no pair's work finishes
            with profiling.span("ctunet.d", device=True):
                pass
    snap = profiling.snapshot()
    assert snap["untimed"] == 3 and snap["spans"]["ctunet.d"]["count"] == n
    profiling.reset()  # every pair is let go
    assert profiling.RECORDER._pairs == 0 and not profiling.RECORDER._free


def test_threads_keep_their_own_parents_and_lose_no_update():
    workers, each = 16, 300
    barrier = threading.Barrier(workers)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        barrier.wait(timeout=30)
        for i in range(each):
            with profiling.span(f"ctunet.t{k % 2}"):
                with profiling.span("ctunet.leaf"):
                    profiling.count("ctunet.n")

    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.snapshot()
    assert snap["counters"] == {"ctunet.n": workers * each}
    assert snap["spans"]["ctunet.leaf"]["count"] == workers * each
    half = workers * each // 2
    assert snap["paths"]["ctunet.t0/ctunet.leaf"]["count"] == half


def _event(name, t0, t1, device=False, cid=0, thread=1):
    return SimpleNamespace(
        name=name, id=cid, thread=thread, self_cpu_time_total=0,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=t0, end=t1))


def test_idle_gaps_are_labelled_by_the_innermost_span():
    """Kernels at [0, 10], [12, 20] and [20, 30], a memcpy at [50, 60];
    the host in ``ctunet.train.step`` throughout, in ``.synthesis`` over
    the first gap and in the upload's stage over the second."""
    events = [
        _event("ctunet.train.step", 0.0, 40.0),
        _event("ctunet.train.synthesis", 9.0, 14.0),
        _event("ctunet.upload", 35.0, 58.0),
        _event("ctunet.upload.stage", 36.0, 48.0),
        _event("conv3d_bn_relu", 0.0, 1.0),  # a wrapper's span: no label
        _event("k1", 0.0, 10.0, True), _event("k2", 12.0, 20.0, True),
        _event("k3", 20.0, 30.0, True),
        _event("ctunet.train.step", 0.0, 40.0, True),  # an annotation
        _event("Memcpy HtoD", 50.0, 60.0, True)]
    gaps = profiling.idle_gaps(events)
    assert [(g["label"], g["start"], g["ms"]) for g in gaps] == [
        ("ctunet.train.synthesis", 10.0, 0.002),
        ("ctunet.upload.stage", 30.0, 0.02)]
    assert profiling.idle_gaps(events[:4]) == []


def test_attribution_lists_the_ctunet_spans_beside_the_wrappers():
    """A kernel launched from autograd's thread inside a wrapper while
    the host thread is in ``ctunet.train.backward``: both spans in its
    row, the wrapper's category."""
    ours = "void ctunet::conv3d_tc_kernel<64>(Params)"
    events = [_event("ctunet.train.backward", 0.0, 10.0, thread=1),
              _event("conv3d_bias_act", 1.0, 3.0, thread=2),
              _event("cudaLaunchKernel", 2.0, 2.5, cid=7, thread=2),
              _event(ours, 4.0, 5.0, True, cid=7),
              _event("ctunet.train.backward", 0.0, 10.0, True)]
    rows, dropped = profiling.attribute(events)
    assert dropped == 0 and len(rows) == 1
    assert rows[0]["spans"] == ["ctunet.train.backward", "conv3d_bias_act"]
    assert rows[0]["category"] == "kernel:conv3d_bias_act"
