"""Device time of the operations launched inside the program's
``step.content_encoder`` spans (the content encoder,
``models/content_encoder.py``), per ``offline.step`` span, over the traced
window, in ms."""


def read(v):
    tr = v.trace
    if tr is None or not hasattr(v, "t0") or "step.content_encoder" not in tr.spans:
        return None
    steps = [(a, b) for a, b in tr.spans.get("offline.step", []) if v.t0 <= a and b <= v.t1]
    if not steps:
        return None
    inside = (tr.start >= v.t0) & (tr.end <= v.t1)
    return 1e3 * tr.device_s(tr.launched_in("step.content_encoder") & inside) / len(steps)
