"""engine_roofline: the serving pass's least time on the card (the larger
of its operations at the bf16 peak and its bytes at the HBM bandwidth,
``gpubench/flops.py``) as a share of ``engine_device_ms``, in percent."""


def read(view):
    ms = sum(r["ms"] for r in view.rows if "gpubench.predict" in r["spans"])
    if not ms or not view.units:
        return None
    return 100.0 * view.least_s * 1e3 / (ms / view.units)
