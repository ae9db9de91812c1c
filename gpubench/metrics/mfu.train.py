"""mfu.train: the FLOPs of the training steps in the traced window (the
forward, every input gradient but the network input's, every weight
gradient; ``gpubench/flops.py``) per second of it, as a share of the
card's bf16 peak, in percent."""


def read(view):
    if not view.units or view.window_s <= 0:
        return None
    rate = view.units / view.window_s
    return 100.0 * view.train_flops * rate / view.peak_flop_per_s
