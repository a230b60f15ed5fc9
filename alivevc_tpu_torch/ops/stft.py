"""STFT / mel front end, plain PyTorch.

The reference's signal contract (module/spectrogram.py:5-10):

  * n_fft=1280, hop=320, win=1280, center=True with reflect padding,
  * rectangular window (torch.stft called without ``window=``),
  * magnitude only, computed in float32 whatever the input dtype,
  * the last frame is dropped so T == len // hop (``spectrogram``).

The magnitude is two products of the frames with a real DFT basis, as in the
JAX package; ``kernels/stft.py`` holds the CUDA kernel that the conversion
path runs.  The mel path reproduces ``torchaudio.transforms.MelSpectrogram(
16000, n_fft=1280, hop_length=320, n_mels=80)``: periodic Hann window,
power 2, HTK mel scale, no norm.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alivevc_tpu_torch.device import cached

@functools.lru_cache(maxsize=None)
def _window_np(kind: str, win_length: int) -> np.ndarray:
    if kind == "rect":
        return np.ones(win_length, dtype=np.float64)
    if kind == "hann":
        n = np.arange(win_length, dtype=np.float64)
        return 0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)
    raise ValueError(f"unknown window: {kind}")


@functools.lru_cache(maxsize=None)
def dft_basis_np(n_fft: int, window: str, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT basis with the window folded in: [n_fft, n_bins] each,
    computed in float64 and rounded to float32."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / n_fft
    w = _window_np(window, win_length)
    if win_length < n_fft:  # torch centre-pads the window inside the frame
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    cos_b = np.cos(ang) * w[:, None]
    sin_b = -np.sin(ang) * w[:, None]
    return cos_b.astype(np.float32), sin_b.astype(np.float32)


_BASIS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def dft_basis(n_fft: int, window: str, win_length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DFT basis as float32 tensors on ``device`` (``device.cached``)."""
    return cached(_BASIS, (n_fft, window, win_length, str(torch.device(device))), lambda: tuple(
        torch.from_numpy(b).to(device) for b in dft_basis_np(n_fft, window, win_length)))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """[N, L] -> [N, L + 2*pad], reflect padding on both sides."""
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def frame(x: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """x [N, L] -> frames [N, T, n_fft] with T = 1 + L//hop (torch.stft count)."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    return x.unfold(-1, n_fft, hop)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int = 1280,
    hop_length: int = 320,
    win_length: int | None = None,
    window: str = "rect",
    center: bool = True,
) -> torch.Tensor:
    """Magnitude STFT of ``x`` [N, L] -> [N, T, n_bins] in float32,
    torch.stft semantics (T = 1 + L // hop_length for center=True)."""
    win_length = n_fft if win_length is None else win_length
    frames = frame(x.float(), n_fft, hop_length, center)
    cos_b, sin_b = dft_basis(n_fft, window, win_length, x.device)
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re * re + im * im)


def spectrogram(x: torch.Tensor, n_fft: int = 1280, hop_length: int = 320) -> torch.Tensor:
    """The reference front end, channels-last: x [N, L] -> [N, L//hop, 641],
    last torch.stft frame dropped, cast back to x.dtype.  The magnitude is
    ``kernels/stft.py:stft_magnitude``: the kernel (differentiable) on a
    CUDA tensor, this module's plain version on a CPU tensor."""
    from alivevc_tpu_torch.kernels.stft import stft_magnitude as magnitude   # it imports this module

    return magnitude(x, n_fft, hop_length)[:, :-1, :].to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mel_fbank_np(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """HTK-scale triangular filterbank (torchaudio melscale_fbanks with
    mel_scale='htk', norm=None): [n_bins, n_mels]."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_bins)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def mel_spectrogram(
    x: torch.Tensor,
    sample_rate: int = 16_000,
    n_fft: int = 1280,
    hop_length: int = 320,
    n_mels: int = 80,
) -> torch.Tensor:
    """torchaudio MelSpectrogram defaults: x [N, L] -> [N, 1 + L//hop, n_mels]."""
    mag = stft_magnitude(x, n_fft, hop_length, None, "hann", True)
    fb = torch.from_numpy(
        _mel_fbank_np(sample_rate, n_fft, n_mels, 0.0, sample_rate / 2)
    ).to(x.device)
    return (mag * mag) @ fb


def log_mel_spectrogram(
    x: torch.Tensor,
    sample_rate: int = 16_000,
    n_fft: int = 1280,
    hop_length: int = 320,
    n_mels: int = 80,
    eps: float = 1e-4,
) -> torch.Tensor:
    """log(mel + eps) with NaN/Inf scrubbed to 0 first (the GAN mel loss and
    the bf16 licence metric).  x [N, L] -> [N, T, n_mels]."""
    m = mel_spectrogram(x.float(), sample_rate, n_fft, hop_length, n_mels)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(m + eps)
