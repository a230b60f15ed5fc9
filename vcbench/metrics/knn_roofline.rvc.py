"""The L2 kNN's share of its roofline: the sum of ``work.knn_call``'s bound
over the traced requests' kNN calls (one a segment: its HuBERT frames as
queries, the index's rows, 768 features, float32 'high';
``work_rvc.knn_bound_s``), over the device time of the kNN kernels (prep,
tile and merge: the operations named ``knn_``) launched inside the
program's ``rvc.match`` spans, in %."""

import numpy as np

import work_rvc


def read(v):
    tr = v.trace
    segs = getattr(v, "request_segments", None)
    if tr is None or not segs or "rvc.match" not in tr.spans:
        return None
    named = np.array(["knn_" in n for n in tr.names], bool)
    inside = (tr.start >= v.t0) & (tr.end <= v.t1)
    dev = tr.device_s(tr.launched_in("rvc.match") & inside & named)
    if dev <= 0:
        return None
    return 100.0 * sum(work_rvc.knn_bound_s(v.model, s, v.library_rows) for s in segs) / dev
