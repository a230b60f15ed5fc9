"""What both kinds of traffic share: the run's seed split by use, the seeded
weights, the device's description, the set-up's timeline and the entries
of ``checks``."""

from __future__ import annotations

import os
import resource
import time

import numpy as np
import torch

import weights as weights_mod
from reference import model as ref_model


def subseed(seed: int, stream: str) -> int:
    """A 31-bit seed for one use (weights, traffic, ...) of the run's seed,
    which may be any whole number below 2**64."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + [ord(ch) for ch in stream]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, stream))


def draw_weights(config: dict, seed: int, device):
    """The seeded weights of the three networks (float32, on ``device``)."""
    specs = ref_model.param_specs(config["model"])
    return weights_mod.draw(specs, generator(seed, "weights", device), device), specs


def device_info(device, count: int = 1) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def free_program(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def stage(t_start: float, what: str) -> None:
    """A line of the set-up's timeline: seconds since the process started."""
    sync()
    print(f"setup: {what} at {time.perf_counter() - t_start:.3f} s", flush=True)


def sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def host_usage() -> resource.struct_rusage:
    return resource.getrusage(resource.RUSAGE_SELF)


def host_line(a: resource.struct_rusage, b: resource.struct_rusage) -> str:
    """The process's time on the host's CPU between two ``host_usage``
    readings (a CUDA wait spins, so it counts), and the CPU it ran on last."""
    with open("/proc/self/stat") as f:
        cpu = f.read().rsplit(")", 1)[1].split()[36]
    return (f"host: user {b.ru_utime - a.ru_utime:.3f} s, sys {b.ru_stime - a.ru_stime:.3f} s, "
            f"last on cpu {cpu} of {len(os.sched_getaffinity(0))}")
