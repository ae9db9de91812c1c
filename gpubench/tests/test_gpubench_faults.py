"""With the timed path broken underneath, a run's comparison comes out not
correct; and so does the control, the step below the configuration's
precision. Small sizes on the CPU, past the harness's look for a card.

The faults a cell can have on one card at batch 1: a served answer
altered where it is produced, and a train step that returns its state
unchanged. The limits are the cells' own, set at full size on the card;
the control readings that set them are ``control.py``'s on the card."""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import control, harness  # noqa: E402

CPU = torch.device("cpu")


def _run(cell, canvas, trace=False):
    return harness.run_cell(cell, 2 ** 31 + 101, 0.3, trace, CPU,
                            time.perf_counter(), canvas=canvas)


def _altered_engine(monkeypatch):
    """The engine's flap head served with its two classes swapped in one
    corner block of every volume."""
    from ctunet_tpu_torch import engine

    build = engine.build_predict

    def broken(*args, **kwargs):
        predict = build(*args, **kwargs)

        def run(images):
            full, flap = predict(images)
            flap = flap.clone()
            flap[:, :8, :8, :8] = flap[:, :8, :8, :8].flip(-1)
            return full, flap

        return run

    monkeypatch.setattr(engine, "build_predict", broken)


def test_an_altered_answer_is_not_correct(monkeypatch):
    for cell, canvas in (("unetsp.serve", (32, 48, 48)),
                         ("unetspsmall.serve", (32, 64, 64))):
        _altered_engine(monkeypatch)
        result = _run(cell, canvas)
        value, limit = result["checks"]["flip_share_worst"]
        assert result["correct"] is False and value > 10 * limit
        monkeypatch.undo()


def _frozen_step(monkeypatch):
    """A train step that runs and then returns its state as it found it:
    parameters, BatchNorm statistics and the optimizer's state."""
    import copy

    from ctunet_tpu_torch import steps

    make = steps.make_train_step

    def broken(model, *args, **kwargs):
        step = make(model, *args, **kwargs)

        def run(state, batch, gen):
            saved = copy.deepcopy((state.model.state_dict(),
                                   state.optimizer.state_dict()))
            state, terms = step(state, batch, gen)
            state.model.load_state_dict(saved[0])
            state.optimizer.load_state_dict(saved[1])
            return state, terms

        return run

    monkeypatch.setattr(steps, "make_train_step", broken)


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    for cell, canvas in (("unetsp.train", (32, 48, 48)),):
        _frozen_step(monkeypatch)
        result = _run(cell, canvas)
        checks = result["checks"]
        assert result["correct"] is False
        # nothing moved and the optimizer holds no gradient: the worst
        # leaf reads 1, the median leaf its norm over the floor's
        read = dict(result["numbers"], **{k: v for k, (v, _) in
                                          checks.items()})
        for name in ("grad_gap", "change_gap", "stats_gap"):
            assert abs(read[name] - 1.0) < 1e-6, name
        for name in ("grad_gap_median", "change_gap_median"):
            assert checks[name][0] > 0.5, name
        monkeypatch.undo()


def test_the_controls_fail_their_cells_limits():
    """The int8 engine of a serving cell and the fp8 reference of a
    training cell, at a size a test run holds."""
    bench = harness.manifest()
    for cell, canvas in (("unetsp.serve", (32, 48, 48)),
                         ("unetsp.train", (32, 48, 48))):
        limits = harness.cell_parts(bench, cell)[3]
        nums = control.readings(cell, 2 ** 31 + 55, True, CPU, canvas)
        assert any(nums[k] > lim for k, lim in limits.items()), (cell, nums)
