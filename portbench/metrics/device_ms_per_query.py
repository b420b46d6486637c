"""Device time per request answered in the traced window: the union of
the device's operation intervals over the replies, in ms. Steadier than
the host-clock metrics, whose runs move with the host's speed."""


def read(w):
    tr = w.trace
    if tr is None or tr.busy_s <= 0 or not w.answered:
        return None
    return 1e3 * tr.busy_s / w.answered
