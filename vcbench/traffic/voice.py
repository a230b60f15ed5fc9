"""A seeded synthetic voice, made on the device in a few large calls: a
harmonic source whose f0 glides between anchors drawn every ``glide_s``
seconds (log-uniform between ``f0_min_hz`` and ``f0_max_hz``), its
harmonics at 1/h, under a syllable-rate envelope, plus white noise."""

from __future__ import annotations

import math

import torch


def voice(gen: torch.Generator, samples: int, sr: int, p: dict, device) -> torch.Tensor:
    """[samples] float32 on ``device``."""
    step = max(1, int(p["glide_s"] * sr))
    anchors = samples // step + 2
    lo, hi = math.log(p["f0_min_hz"]), math.log(p["f0_max_hz"])
    logf = torch.empty(anchors, device=device, dtype=torch.float64).uniform_(lo, hi, generator=gen)
    env_a = torch.empty(anchors, device=device, dtype=torch.float64).uniform_(0.2, 1.0, generator=gen)
    pos = torch.arange(samples, device=device, dtype=torch.float64) / step
    i0 = pos.floor().long()
    frac = pos - i0
    f0 = torch.exp(logf[i0] * (1 - frac) + logf[i0 + 1] * frac)
    env = env_a[i0] * (1 - frac) + env_a[i0 + 1] * frac
    phase = torch.cumsum(f0 / sr, dim=0)
    out = torch.zeros(samples, device=device, dtype=torch.float32)
    for h in range(1, p["harmonics"] + 1):
        hp = phase * h
        out += (torch.sin(2 * math.pi * (hp - hp.floor())) / h).float()
    noise = torch.empty(samples, device=device).normal_(0.0, p["noise"], generator=gen)
    return (p["level"] * env.float() * out + noise).contiguous()
