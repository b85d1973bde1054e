"""The device's idle share of the traced window: 1 - (the union of the
device operations' intervals) / (the window on the host clock)."""

UNIT = "%"


def read(view):
    busy = view.busy_s()
    if busy <= 0 or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / view.window_s)
