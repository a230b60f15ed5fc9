"""Share of the traced offline window (first traced request's start to the
last one's return) in which no operation ran on the device, in %."""


def read(v):
    if v.trace is None or getattr(v, "counters", None) is None or not getattr(v, "window_s", 0):
        return None
    return 100.0 * (1.0 - v.busy_s / v.window_s)
