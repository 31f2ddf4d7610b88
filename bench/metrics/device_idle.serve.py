"""The device's idle share: the part of the traced window in which no
kernel, copy or set ran on the card (one less the union of their
intervals in the profiler's timeline over the window)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
