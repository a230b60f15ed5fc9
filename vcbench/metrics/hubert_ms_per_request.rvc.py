"""Device time of the operations launched inside the program's
``rvc.content`` spans (HuBERT-base's conv front end and 12 layers,
``models/wavlm.py``), per traced request, over the traced window, in ms."""


def read(v):
    tr = v.trace
    if tr is None or not getattr(v, "request_segments", None) or "rvc.content" not in tr.spans:
        return None
    inside = (tr.start >= v.t0) & (tr.end <= v.t1)
    return 1e3 * tr.device_s(tr.launched_in("rvc.content") & inside) / len(v.request_segments)
