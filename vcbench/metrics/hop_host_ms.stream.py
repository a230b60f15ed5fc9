"""The host's own share of a streaming hop: each hop's call (the
benchmark's ``hop`` span around ``StreamingConverter.process_chunk``) less
the program's spans inside it that are not the host's own work, averaged
over the hops of the traced window, in ms: ``stream.wait`` (the CUDA event
waits) and ``stream.replay`` (the graph's launch, which the profiler makes
many times longer than it is untraced).  What is left is staging the
chunk, enqueueing the copies and copying the output out."""

import numpy as np


def read(v):
    spans = getattr(v.trace, "spans", None)
    if not spans or not getattr(v, "hops", None) or "stream.wait" not in spans:
        return None
    inner = sorted(spans["stream.wait"] + spans.get("stream.replay", []))
    starts = np.array([a for a, _ in inner], np.int64)
    host = 0
    for _, a, b, _ in v.hops:
        lo, hi = np.searchsorted(starts, a), np.searchsorted(starts, b)
        host += (b - a) - sum(min(e, b) - s for s, e in inner[lo:hi])
    return host / len(v.hops) / 1e6
