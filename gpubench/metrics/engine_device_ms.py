"""engine_device_ms: device milliseconds a served volume of the kernels
launched inside the benchmark's predict span (the atlas stack and the
engine: every K1, K2, K3 launch and the heads)."""


def read(view):
    ms = sum(r["ms"] for r in view.rows if "gpubench.predict" in r["spans"])
    return ms / view.units if ms and view.units else None
