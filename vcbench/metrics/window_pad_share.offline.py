"""Share of the windows the offline driver computes that no file needs:
windows per ``convert_window`` call (the step wrapper's count) against the
windows the overlap-discard cuts from each traced file (``work.windows_cut``),
in %."""


def read(v):
    c = getattr(v, "counters", None)
    if not c or not c.get("windows_computed"):
        return None
    return 100.0 * (c["windows_computed"] - c["windows_cut"]) / c["windows_computed"]
