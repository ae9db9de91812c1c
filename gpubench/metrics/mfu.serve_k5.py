"""mfu.serve_k5: the model FLOPs of the legacy k=5 family's volumes served
in the traced window (``gpubench/flops_k5.py``: every k=5 conv,
ConvTranspose and the 1x1 head) per second of it, as a share of the
card's bf16 peak, in percent."""

from gpubench import flops_k5


def read(view):
    if not view.units or view.window_s <= 0:
        return None
    flops = flops_k5.forward_flops(view.config["model"], view.canvas)
    return 100.0 * flops * (view.units / view.window_s) / view.peak_flop_per_s
