"""The traced run: spans around the calls into the program's layers (from
this benchmark's files, applied only with ``--trace 1``), the profiler's
device events, and the arithmetic the per-layer readers share.

A device operation belongs to a span when the host call that launched it
(the CUDA runtime event with its correlation id) ran inside the span.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "vc::"


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def patched(target, attr: str, make: Callable):
    """Replace ``target.attr`` by ``make(original)`` while in use."""
    original = getattr(target, attr)
    setattr(target, attr, make(original))
    try:
        yield original
    finally:
        setattr(target, attr, original)


def spanned(name: str, fn: Callable, record: Optional[Callable] = None) -> Callable:
    """``fn`` inside the span ``name``; ``record(args, kwargs)`` first, if
    given (the call's shapes, for the yardstick)."""
    def call(*args, **kwargs):
        if record is not None:
            record(args, kwargs)
        with span(name):
            return fn(*args, **kwargs)
    return call


class Session:
    """The profiler and the span wrappers (``patches``, an ExitStack of
    ``patched``), from construction to ``stop``, which builds the Trace."""

    def __init__(self, patches: Optional[contextlib.ExitStack] = None):
        self.patches = patches or contextlib.ExitStack()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.trace: Optional["Trace"] = None

    @property
    def active(self) -> bool:
        return self.trace is None

    def stop(self) -> "Trace":
        if self.trace is None:
            self.patches.close()
            self.trace = Trace(self.prof)
        return self.trace


def _merge(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


class Trace:
    """Device operations (start, end, name, launch time; ns on the
    profiler's clock) and the benchmark's host spans, by name."""

    def __init__(self, prof: torch.profiler.profile):
        prof.stop()
        events = prof.profiler.kineto_results.events()
        dev, launch = [], {}
        self.spans: Dict[str, List[Tuple[int, int]]] = {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.correlation_id()))
            elif name.startswith(PREFIX):
                self.spans.setdefault(name[len(PREFIX):], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith("cu") and e.correlation_id() > 0:
                launch[e.correlation_id()] = e.start_ns()
        for v in self.spans.values():
            v.sort()
        # spans of one name do not overlap (the calls they wrap run one after another)
        self._starts = {k: np.array([a for a, _ in v], np.int64) for k, v in self.spans.items()}
        self.start = np.array([d[0] for d in dev], np.int64)
        self.end = np.array([d[1] for d in dev], np.int64)
        self.names = [d[2] for d in dev]
        hit = [launch.get(d[3]) for d in dev]
        self.linked = sum(h is not None for h in hit)
        # an operation whose launch was not recorded is placed at its own start
        self.launch = np.array([h if h is not None else d[0] for h, d in zip(hit, dev)], np.int64)
        self.busy_s_, self.busy_e_ = _merge(self.start, self.end)
        print(f"trace: {len(dev)} device operations, {self.linked} linked to their launch, "
              f"spans {{{', '.join(f'{k}: {len(v)}' for k, v in self.spans.items())}}}", flush=True)

    def __len__(self) -> int:
        return len(self.names)

    def launched_in(self, name: str) -> np.ndarray:
        """Mask of the operations launched inside any span ``name``."""
        iv = self.spans.get(name, [])
        if not iv:
            return np.zeros(len(self), bool)
        e = np.array([b for _, b in iv], np.int64)
        k = np.searchsorted(self._starts[name], self.launch, side="right") - 1
        ok = k >= 0
        return ok & (self.launch <= np.where(ok, e[np.clip(k, 0, None)], -1))

    def device_s(self, mask: np.ndarray) -> float:
        return float((self.end[mask] - self.start[mask]).sum()) / 1e9

    def busy_s(self, t0: int, t1: int) -> float:
        """Seconds of [t0, t1] in which some operation ran on the device."""
        s = np.clip(self.busy_s_, t0, t1)
        e = np.clip(self.busy_e_, t0, t1)
        return float((e - s).sum()) / 1e9

    def idle_gaps(self, t0: int, t1: int) -> List[Tuple[int, int]]:
        s = np.clip(self.busy_s_, t0, t1)
        e = np.clip(self.busy_e_, t0, t1)
        keep = e > s
        s, e = s[keep], e[keep]
        edges = np.concatenate([[t0], e]), np.concatenate([s, [t1]])
        return [(int(a), int(b)) for a, b in zip(*edges) if b > a]

    def idle_by_span(self, t0: int, t1: int, order: List[str], other: str) -> Dict[str, float]:
        """The idle seconds of [t0, t1] by the first of ``order``'s spans
        open at the time (``other`` where none is)."""
        idle = self.idle_gaps(t0, t1)
        out: Dict[str, float] = {}
        for name in order:
            idle, inside = _split(idle, self.spans.get(name, []))
            out[name] = sum(e - s for s, e in inside) / 1e9
        out[other] = sum(e - s for s, e in idle) / 1e9
        return out


def _split(gaps: List[Tuple[int, int]], spans: List[Tuple[int, int]]):
    """(the parts of ``gaps`` outside ``spans``, the parts inside); both
    lists sorted, each of disjoint intervals."""
    outside, inside, j = [], [], 0
    for s, e in gaps:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(spans) and spans[k][0] < e:
            a, b = max(spans[k][0], s), min(spans[k][1], e)
            if a > cur:
                outside.append((cur, a))
            if b > a:
                inside.append((a, b))
            cur = max(cur, b)
            k += 1
        if cur < e:
            outside.append((cur, e))
    return outside, inside


def breakdown(tr: Trace, t0: int, t1: int, groups: List[Tuple[str, str]], labels: List[str]) -> dict:
    """The traced window's device time by group (``groups``: label and the
    span whose launches it takes; the rest by operation name, copies
    together) and its idle time by the host span open at the time, each
    the 10 largest, in seconds."""
    inside = (tr.start >= t0) & (tr.end <= t1)
    taken = np.zeros(len(tr), bool)
    ops: Dict[str, float] = {}
    for label, name in groups:
        m = tr.launched_in(name) & inside & ~taken
        taken |= m
        ops[label] = tr.device_s(m)
    for i in np.flatnonzero(inside & ~taken):
        n = tr.names[i]
        key = "copies (memcpy, memset)" if n.startswith(("Memcpy", "Memset", "memcpy", "memset")) else n[:80]
        ops[key] = ops.get(key, 0.0) + (tr.end[i] - tr.start[i]) / 1e9
    idle = tr.idle_by_span(t0, t1, labels, "no span (the harness, between requests or hops)")
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10] if v > 0]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
