"""train_stage_ms: host milliseconds a training step spends in the
program's ``ctunet.upload.stage`` spans inside ``ctunet.prefetch``
(``data/pipeline.py``: ``device_prefetch`` staging the batch a step ahead,
its contiguous copy and its pinning), from the program's recorder
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
    ms = [t["host_ms"] for path, t in snapshot()["paths"].items()
          if path.endswith("ctunet.upload.stage")
          and "ctunet.prefetch" in path.split("/")]
    return sum(ms) / view.units if ms else None
