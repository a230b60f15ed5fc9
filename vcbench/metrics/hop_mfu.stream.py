"""A hop's model operations (``work.py`` over the hop's window of frames)
over the mean hop latency (due to return), against the configuration's
peak, in %."""

import work


def read(v):
    if not getattr(v, "hops", None):
        return None
    flops = v.hop_frames * sum(work.frame_flops(v.model, v.library_rows).values())
    latency = sum((h[2] - h[0]) / 1e9 for h in v.hops) / len(v.hops)
    return 100.0 * flops / latency / work.PEAK_FLOPS[v.precision["peak"]]
