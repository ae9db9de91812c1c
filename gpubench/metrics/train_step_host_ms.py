"""train_step_host_ms: host milliseconds a training step spends in the
program's ``ctunet.train.step`` span (``steps.py::make_train_step``: the
launches of the synthesis, forward, loss, backward and optimizer, and any
wait on the device among them), from the program's recorder
(``ctunet_tpu_torch/utils/profiling.snapshot``). Near the step's device
time where the step waits for the card, far under it where it does not.
The recorder records only while a profiler runs or a ``recording()`` block
is open, and in one run of the benchmark only the traced window runs under
a profiler, so it holds exactly that window. None where the program has no
recorder or recorded no such span."""


def read(view):
    from ctunet_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not view.units:
        return None
    span = snapshot()["spans"].get("ctunet.train.step")
    return span["host_ms"] / view.units if span else None
