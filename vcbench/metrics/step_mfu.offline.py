"""The model operations of the windows the traced files need (``work.py``:
STFT, content encoder, F0 estimator, kNN, feature extractor, oscillator,
filter U-Net; padding not counted) over the traced window's wall time,
against the configuration's peak, in %."""

import work


def read(v):
    c = getattr(v, "counters", None)
    if v.trace is None or not c or not c.get("windows_cut"):
        return None
    samples = 3 * v.spec.traffic["infer"]["chunk"]
    flops = c["windows_cut"] * work.window_flops(v.model, v.library_rows, samples)
    return 100.0 * flops / v.window_s / work.PEAK_FLOPS[v.precision["peak"]]
