"""Share of the hops' own intervals (due to return) in which no operation
ran on the device, in %.  Over the whole paced window the card idles
between hops by design; that share says nothing."""


def read(v):
    if not getattr(v, "hops", None):
        return None
    span = sum((h[2] - h[0]) / 1e9 for h in v.hops)
    return 100.0 * (1.0 - sum(h[3] for h in v.hops) / span)
