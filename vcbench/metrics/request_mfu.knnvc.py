"""The model operations of the traced requests (``work_knnvc.py``: the
WavLM front end, the six layers with their attention, the kNN counted once,
the vocoder) over the traced window's wall time (first request's start to
the last one's return), against the configuration's peak, in %."""

import work
import work_knnvc


def read(v):
    samples = getattr(v, "request_samples", None)
    if v.trace is None or not samples or not getattr(v, "window_s", 0):
        return None
    flops = sum(sum(work_knnvc.request_flops(v.model, n, v.library_rows).values()) for n in samples)
    return 100.0 * flops / v.window_s / work.PEAK_FLOPS[v.precision["peak"]]
