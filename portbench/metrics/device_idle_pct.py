"""The cards' idle share of the traced window: for each card, 1 - (the
union of its operations' intervals) / (the window on the host clock),
the mean over the cell's cards (on one card, that card's share)."""

UNIT = "%"


def read(view):
    busy = view.busy_s()
    if busy <= 0 or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / view.window_s)
