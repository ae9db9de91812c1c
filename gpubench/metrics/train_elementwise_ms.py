"""train_elementwise_ms: device milliseconds a training step in
elementwise and reduction kernels (the elementwise category of
``trace_math.category``: the synthesis, BatchNorm, the losses, the
optimizer's update)."""


def read(view):
    ms = sum(r["ms"] for r in view.rows if r["category"] == "elementwise"
             and "gpubench.step" in r["spans"])
    return ms / view.units if ms and view.units else None
