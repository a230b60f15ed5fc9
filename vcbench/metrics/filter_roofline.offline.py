"""The filter U-Net's up levels' share of their roofline: the sum of
``work.filter_level_call``'s bound over the traced ``filter_level`` calls,
over the device time of every operation launched inside them, in %."""

import work


def read(v):
    calls = (getattr(v, "calls", None) or {}).get("filter_level")
    if v.trace is None or not calls:
        return None
    dev = v.trace.device_s(v.trace.launched_in("filter_level"))
    if dev <= 0:
        return None
    peak = v.precision["peak"]
    return 100.0 * sum(work.filter_level_call(*c, precision=peak)["bound_s"] for c in calls) / dev
