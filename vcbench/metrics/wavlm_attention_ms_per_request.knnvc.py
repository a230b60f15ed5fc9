"""Device time of the operations launched inside the program's
``wavlm.attention`` spans (each layer's scores, gated bias, softmax and
product with V), per traced request, over the traced window, in ms."""


def read(v):
    tr = v.trace
    if tr is None or not getattr(v, "request_samples", None) or "wavlm.attention" not in tr.spans:
        return None
    inside = (tr.start >= v.t0) & (tr.end <= v.t1)
    return 1e3 * tr.device_s(tr.launched_in("wavlm.attention") & inside) / len(v.request_samples)
