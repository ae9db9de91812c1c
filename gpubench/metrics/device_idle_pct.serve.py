"""device_idle_pct.serve: the share of the traced serving window in which
no kernel, copy or fill ran on the card, in percent."""


def read(view):
    if view.window_s <= 0 or not view.rows:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
