"""Profiling helpers: the program's spans and ``torch.profiler`` traces.

``span(name)`` marks a stage of the program as ``vc::<name>`` in whatever
``torch.profiler`` trace is being recorded, on the profiler's clock beside
the device's events; with no profiler running it costs one check and
returns a shared no-op context.  A span's parent is the span that encloses
it on the thread: each converter runs one request at a time, so the enclosing
``offline.convert`` (or, in a stream, the caller's span around
``process_chunk``) names the request.  PERF.md lists the spans and what
reads each.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from alivevc_tpu_torch.device import DeviceLike, resolve_device

PREFIX = "vc::"

_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the span ``vc::<name>``: recorded while a profiler
    runs, the shared no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF


@contextlib.contextmanager
def profile_trace(logdir: str, device: DeviceLike = None):
    """Profile the block (host and, on the card, device activity, with the
    program's spans) and write a Chrome trace to ``logdir/trace.json``;
    yields the profiler, whose ``key_averages()`` sums the time by
    operation."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
