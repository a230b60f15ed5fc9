"""Retrieval's share of its roofline: the sum of ``work.knn_call``'s bound
over the traced ``match_features_kernel`` calls, over the device time of
every operation launched inside them, in %."""

import work


def read(v):
    calls = (getattr(v, "calls", None) or {}).get("retrieval")
    if v.trace is None or not calls:
        return None
    dev = v.trace.device_s(v.trace.launched_in("retrieval"))
    if dev <= 0:
        return None
    return 100.0 * sum(work.knn_call(*c)["bound_s"] for c in calls) / dev
