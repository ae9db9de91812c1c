"""mfu.serve: the model FLOPs of the volumes served in the traced window
per second of it, as a share of the card's bf16 peak, in percent."""


def read(view):
    if not view.units or view.window_s <= 0:
        return None
    rate = view.units / view.window_s
    return 100.0 * view.forward_flops * rate / view.peak_flop_per_s
