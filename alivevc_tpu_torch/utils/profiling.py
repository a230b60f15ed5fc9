"""Profiling helpers: ``torch.profiler`` traces and device timing.

PyTorch returns from a call on the card before the card has finished, so
``device_time`` times a run of calls between two CUDA events and waits for
the second; on the CPU, which computes as it is called, it reads the host
clock.  Both run on the card unless the caller names the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

from alivevc_tpu_torch.device import DeviceLike, resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str, device: DeviceLike = None):
    """Profile the block (host and, on the card, device activity) and write
    a Chrome trace to ``logdir/trace.json``; yields the profiler, whose
    ``key_averages()`` sums the time by operation."""
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


def device_time(fn: Callable, *args, reps: int = 4, warmup: int = 1,
                device: DeviceLike = None) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls after
    ``warmup`` untimed ones: CUDA events on the card, the host clock on the
    CPU."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps
