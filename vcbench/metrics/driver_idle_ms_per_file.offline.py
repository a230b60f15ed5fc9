"""Device idle time inside the program's ``offline.convert`` spans (one a
file: ``OfflineConverter.convert``) outside its ``offline.step`` spans (the
body of ``convert_window``), per file, over the traced window, in ms: the
converter's own host time in which the card waits (cutting windows, padding
the last batch, each step's copy back, assembly, the resampler's copies)."""


def read(v):
    tr = v.trace
    if tr is None or not hasattr(v, "t0"):
        return None
    files = [(a, b) for a, b in tr.spans.get("offline.convert", []) if v.t0 <= a and b <= v.t1]
    if not files:
        return None
    steps = [(a, b) for a, b in tr.spans.get("offline.step", [])
             if any(fa <= a and b <= fb for fa, fb in files)]

    def idle_s(iv):
        return sum((b - a) / 1e9 - tr.busy_s(a, b) for a, b in iv)

    return 1e3 * (idle_s(files) - idle_s(steps)) / len(files)
