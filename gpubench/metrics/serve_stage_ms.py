"""serve_stage_ms: host milliseconds a served volume spends in the
program's ``ctunet.upload.stage`` span (``data/pipeline.py::upload``: the
volume's contiguous copy and its pinning), from the program's recorder
(``ctunet_tpu_torch/utils/profiling.snapshot``). The recorder records only
while a profiler runs or a ``recording()`` block is open, and in one run
of the benchmark only the traced window runs under a profiler, so it holds
exactly that window. None where the program has no recorder or recorded no
such span."""


def read(view):
    from ctunet_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not view.units:
        return None
    span = snapshot()["spans"].get("ctunet.upload.stage")
    return span["host_ms"] / view.units if span else None
