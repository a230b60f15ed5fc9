"""Retrieval's share of its roofline: the sum of ``work.knn_call``'s bound
(a request's WavLM frames as queries, the matching set's rows, 1 024
features, float32 'high') over the traced requests, over the device time of
every operation launched inside the program's ``knnvc.match`` spans, in %."""

import work
import work_knnvc


def read(v):
    tr = v.trace
    samples = getattr(v, "request_samples", None)
    if tr is None or not samples or "knnvc.match" not in tr.spans:
        return None
    inside = (tr.start >= v.t0) & (tr.end <= v.t1)
    dev = tr.device_s(tr.launched_in("knnvc.match") & inside)
    if dev <= 0:
        return None
    w = v.model["wavlm"]
    bound = sum(work.knn_call(work_knnvc.frames(n, w), v.library_rows, w["hidden_size"], "fp32",
                              v.precision["knn_precision"])["bound_s"] for n in samples)
    return 100.0 * bound / dev
