"""Device time a step spends outside retrieval and the filter levels (the
frame-rate models, FiLM, the oscillator, the STFT, elementwise work and
copies), per ``convert_window`` call, in ms."""


def read(v):
    c = getattr(v, "counters", None)
    if v.trace is None or not c or not c.get("steps"):
        return None
    tr = v.trace
    rest = tr.launched_in("step") & ~tr.launched_in("retrieval") & ~tr.launched_in("filter_level")
    return 1e3 * tr.device_s(rest) / c["steps"]
