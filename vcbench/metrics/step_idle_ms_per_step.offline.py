"""Device idle time inside the program's ``offline.step`` spans (the body of
``infer/offline.py:convert_window``), per step, over the traced window, in
ms: the upload of the windows, launch gaps among the step's operations and
the host work between them."""


def read(v):
    tr = v.trace
    if tr is None or not hasattr(v, "t0"):
        return None
    steps = [(a, b) for a, b in tr.spans.get("offline.step", []) if v.t0 <= a and b <= v.t1]
    if not steps:
        return None
    return 1e3 * sum((b - a) / 1e9 - tr.busy_s(a, b) for a, b in steps) / len(steps)
