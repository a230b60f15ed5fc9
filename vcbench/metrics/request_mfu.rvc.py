"""The model operations of the traced requests (``work_rvc.py``: HuBERT's
front end and 12 layers with their attention, the kNN counted once, the
prior, the flow and the generator, over each request's segments) over the
traced window's wall time (first request's start to the last one's return),
against the configuration's peak, in %."""

import work
import work_rvc


def read(v):
    segs = getattr(v, "request_segments", None)
    if v.trace is None or not segs or not getattr(v, "window_s", 0):
        return None
    flops = sum(sum(work_rvc.request_flops(v.model, s, v.library_rows).values()) for s in segs)
    return 100.0 * flops / v.window_s / work.PEAK_FLOPS[v.precision["peak"]]
