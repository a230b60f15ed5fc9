"""Pitch <-> F0 math of the conversion pipelines (inference.py:119-126,
realtime_inference.py:157-163).  NaN/Inf from log2(0) on unvoiced frames
are scrubbed to 0 Hz as the reference does."""

from __future__ import annotations

import torch


def f0_to_pitch(f0: torch.Tensor) -> torch.Tensor:
    """Hz -> semitone pitch: 12*log2(f0/440) - 9."""
    return 12.0 * torch.log2(f0 / 440.0) - 9.0


def pitch_to_f0(pitch: torch.Tensor) -> torch.Tensor:
    """Semitone pitch -> Hz: 440 * 2**((p+9)/12)."""
    return 440.0 * torch.pow(2.0, (pitch + 9.0) / 12.0)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def shift_pitch(f0: torch.Tensor, semitones: float) -> torch.Tensor:
    """Streaming-path pitch shift: pitch += shift, back to Hz, NaN/Inf -> 0."""
    return _finite_or_zero(pitch_to_f0(f0_to_pitch(f0) + semitones))


def apply_intonation(
    f0: torch.Tensor, intonation: float = 1.0, pitch_shift: float = 0.0
) -> torch.Tensor:
    """Offline-path intonation scaling about the voiced-mean pitch plus shift,
    over the whole of ``f0`` (call per window).  The mean is taken over
    finite pitch values only (unvoiced frames give -inf after log2)."""
    pitch = f0_to_pitch(f0)
    finite = torch.isfinite(pitch)
    n = torch.clamp(finite.sum(), min=1)
    mean_pitch = torch.where(finite, pitch, torch.zeros_like(pitch)).sum() / n
    pitch = mean_pitch + (pitch - mean_pitch) * intonation + pitch_shift
    return _finite_or_zero(pitch_to_f0(pitch))
