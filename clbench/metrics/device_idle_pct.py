"""device_idle_pct: the share of the traced window in which the card ran
no operation: 1 less the union of every kernel's, copy's and memset's
interval over the window, in percent."""


def read(rec):
    t = rec.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
