"""The per-layer metrics read from the program's recorder
(``ctunet_tpu_torch/utils/profiling.snapshot``): each on a filled recorder,
divided by the traced window's units, and None on an empty one, on one
whose spans carry no device time or left a span untimed, and on a
program without a recorder."""

from __future__ import annotations

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import harness  # noqa: E402
from ctunet_tpu_torch.utils import profiling  # noqa: E402


def _t(host_ms, device_ms=None):
    return dict(count=4, host_ms=host_ms, self_ms=host_ms,
                device_ms=device_ms)


PATHS = {
    "ctunet.upload/ctunet.upload.stage": _t(12.0),
    "ctunet.prefetch/ctunet.upload/ctunet.upload.stage": _t(40.0),
    "ctunet.prefetch/ctunet.upload": _t(60.0),
    "ctunet.serve/ctunet.serve.dispatch/ctunet.engine.heads": _t(3.0, 24.0),
    "ctunet.train.step": _t(600.0, 640.0),
    "ctunet.train.step/ctunet.train.synthesis": _t(20.0, 32.0),
}
SPANS = {
    "ctunet.upload.stage": _t(52.0),
    "ctunet.upload": _t(60.0),
    "ctunet.engine.heads": _t(3.0, 24.0),
    "ctunet.train.step": _t(600.0, 640.0),
    "ctunet.train.synthesis": _t(20.0, 32.0),
}
# metric: its value a unit over the snapshot above at 4 units
EXPECTED = {
    "serve_stage_ms": 13.0,
    "engine_heads_device_ms": 6.0,
    "train_stage_ms": 10.0,
    "train_step_host_ms": 150.0,
    "train_synthesis_device_ms": 8.0,
}


def _snapshot(spans, paths, untimed=0):
    return lambda: dict(spans=spans, paths=paths, counters={},
                        untimed=untimed)


def _view(units):
    return types.SimpleNamespace(units=units)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_a_filled_recorder_per_unit(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", _snapshot(SPANS, PATHS))
    read = harness.reader(name)
    assert read(_view(4)) == pytest.approx(EXPECTED[name])
    assert read(_view(0)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_on_an_empty_recorder(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", _snapshot({}, {}))
    assert harness.reader(name)(_view(4)) is None


@pytest.mark.parametrize("name", ["engine_heads_device_ms",
                                  "train_synthesis_device_ms"])
def test_device_metrics_none_without_device_time(monkeypatch, name):
    host_only = {k: dict(v, device_ms=None) for k, v in SPANS.items()}
    monkeypatch.setattr(profiling, "snapshot", _snapshot(host_only, PATHS))
    assert harness.reader(name)(_view(4)) is None


@pytest.mark.parametrize("name", ["engine_heads_device_ms",
                                  "train_synthesis_device_ms"])
def test_device_metrics_none_when_a_span_went_untimed(monkeypatch, name):
    """A span that found no free event pair: the device total is short,
    so the reader reports nothing rather than too low a value."""
    monkeypatch.setattr(profiling, "snapshot", _snapshot(SPANS, PATHS, 1))
    assert harness.reader(name)(_view(4)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_on_a_program_without_a_recorder(monkeypatch, name):
    """The parent commit's program has no ``snapshot``: the reader finds
    nothing and raises nothing."""
    monkeypatch.delattr(profiling, "snapshot")
    assert harness.reader(name)(_view(4)) is None


def test_the_serve_stage_is_the_recorders_own(monkeypatch):
    """The real recorder: an upload inside ``recording()`` is read back."""
    import numpy as np
    import torch

    from ctunet_tpu_torch.data.pipeline import upload

    profiling.reset()
    try:
        with profiling.recording():
            for _ in range(2):
                upload(np.zeros((1, 4, 4, 4), np.float32),
                       torch.device("cpu"), torch.float32)
        stage = profiling.snapshot()["spans"]["ctunet.upload.stage"]
        assert harness.reader("serve_stage_ms")(_view(2)) == pytest.approx(
            stage["host_ms"] / 2)
        assert harness.reader("train_stage_ms")(_view(2)) is None
    finally:
        profiling.reset()
