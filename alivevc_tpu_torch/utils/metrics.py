"""Observability: structured per-step metrics, throughput/RTF meters (a
copy of the JAX package's ``utils/metrics.py``).

Every training or inference loop can emit structured scalars to a JSONL
file, and the serving paths track audio-seconds/s and the real-time factor
directly.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL scalar logger, one record per step."""

    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        self._f = open(path, "a") if path else None
        self._n = 0

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        self._n += 1
        if self.print_every and self._n % self.print_every == 0:
            parts = " ".join(f"{k}: {float(v):.4f}" for k, v in scalars.items())
            print(f"step {step} {parts}")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class StepTimer:
    """Rolling wall-clock step timer (seconds/step and steps/s)."""

    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def seconds_per_step(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def steps_per_second(self) -> float:
        sps = self.seconds_per_step
        return 1.0 / sps if sps else 0.0


class RealTimeFactorMeter:
    """Tracks audio-seconds processed per wall-clock second (and RTF)."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0

    def update(self, audio_seconds: float, wall_seconds: float) -> None:
        self.audio_seconds += audio_seconds
        self.wall_seconds += wall_seconds

    @property
    def audio_seconds_per_second(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def rtf(self) -> float:
        asps = self.audio_seconds_per_second
        return 1.0 / asps if asps else float("inf")

    def summary(self) -> Dict[str, float]:
        return {
            "audio_seconds": self.audio_seconds,
            "wall_seconds": self.wall_seconds,
            "audio_seconds_per_second": self.audio_seconds_per_second,
            "rtf": self.rtf,
        }
