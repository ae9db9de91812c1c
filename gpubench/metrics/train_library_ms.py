"""train_library_ms: device milliseconds a training step in library
kernels (the cuBLAS/cuDNN category of ``trace_math.category``: the
convolutions and their gradients under ``conv_impl = xla``, the
ConvTranspose and head products)."""


def read(view):
    ms = sum(r["ms"] for r in view.rows if r["category"] == "cuBLAS/cuDNN"
             and "gpubench.step" in r["spans"])
    return ms / view.units if ms and view.units else None
