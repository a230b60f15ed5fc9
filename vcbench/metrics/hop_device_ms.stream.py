"""Device time of a streaming hop (a graph replay has no inner spans): the
time some operation ran within each hop's call, averaged over the hops, in
ms."""


def read(v):
    if not getattr(v, "hops", None):
        return None
    return 1e3 * sum(h[3] for h in v.hops) / len(v.hops)
