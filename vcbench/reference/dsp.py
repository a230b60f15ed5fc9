"""Signal functions of the reference: the magnitude STFT front end
(module/spectrogram.py: n_fft 1280, hop 320, rectangular window, centre
reflect padding, last frame dropped), torchaudio's sinc-Hann resampler,
pitch arithmetic, and the log-mel spectrogram the bf16 licence is stated
in (torchaudio MelSpectrogram(16000, n_fft=1280, hop_length=320,
n_mels=80): periodic Hann window, power 2, HTK mel scale)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.numerics import Math


def _dft_basis(n_fft: int, window: np.ndarray, device) -> torch.Tensor:
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * n * k / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * window[:, None]
    return torch.from_numpy(basis.astype(np.float32)).to(device)


def stft_magnitude(m: Math, x: torch.Tensor, n_fft: int, hop: int, window: np.ndarray = None) -> torch.Tensor:
    """x [N, L] -> [N, 1 + L // hop, n_fft // 2 + 1] float32."""
    pad = n_fft // 2
    x = x.float()
    x = torch.cat([x[:, 1:pad + 1].flip(1), x, x[:, -pad - 1:-1].flip(1)], dim=1)
    frames = x.unfold(-1, n_fft, hop)
    w = np.ones(n_fft) if window is None else window
    ri = m.mm(frames, _dft_basis(n_fft, w, x.device))
    nb = n_fft // 2 + 1
    return torch.sqrt(ri[..., :nb] ** 2 + ri[..., nb:] ** 2)


def spectrogram(m: Math, x: torch.Tensor, audio: dict) -> torch.Tensor:
    """The model's input: [N, L] -> [N, L // hop, n_bins]."""
    return stft_magnitude(m, x, audio["n_fft"], audio["hop_length"])[:, :-1]


def resample(x: torch.Tensor, orig: int, new: int, width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """torchaudio.functional.resample (sinc_interp_hann) of x [N, L];
    output length ceil(new L / orig)."""
    if orig == new:
        return x
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    w = int(math.ceil(width * orig / base))
    idx = np.arange(-w, w + orig, dtype=np.float64) / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None, :]
    t = np.clip(t * base, -width, width)
    window = np.cos(t * math.pi / width / 2.0) ** 2
    tpi = t * math.pi
    kern = np.where(tpi == 0.0, 1.0, np.sin(tpi) / np.where(tpi == 0.0, 1.0, tpi)) * window * (base / orig)
    kern = torch.from_numpy(kern.astype(np.float32)).to(x.device)[:, None, :]
    n, length = x.shape
    out_len = int(math.ceil(new * length / orig))
    blocks = (out_len + new - 1) // new
    xp = F.pad(x.float()[:, None, :], (w, w + orig + max(0, (blocks - 1) * orig + kern.shape[-1] - (length + 2 * w + orig))))
    y = F.conv1d(xp, kern, stride=orig)[:, :, :blocks]
    return y.transpose(1, 2).reshape(n, blocks * new)[:, :out_len]


def shift_pitch(f0: torch.Tensor, semitones: float) -> torch.Tensor:
    """Hz -> pitch + shift -> Hz; non-finite (unvoiced) -> 0."""
    p = 12.0 * torch.log2(f0 / 440.0) - 9.0 + semitones
    y = 440.0 * torch.pow(2.0, (p + 9.0) / 12.0)
    return torch.where(torch.isfinite(y), y, torch.zeros_like(y))


def apply_intonation(f0: torch.Tensor, intonation: float, semitones: float) -> torch.Tensor:
    """One window's f0 scaled about its voiced-mean pitch, plus a shift."""
    p = 12.0 * torch.log2(f0 / 440.0) - 9.0
    finite = torch.isfinite(p)
    mean = torch.where(finite, p, torch.zeros_like(p)).sum() / torch.clamp(finite.sum(), min=1)
    p = mean + (p - mean) * intonation + semitones
    y = 440.0 * torch.pow(2.0, (p + 9.0) / 12.0)
    return torch.where(torch.isfinite(y), y, torch.zeros_like(y))


def _mel_fbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    return np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))


def log_mel(x: torch.Tensor, sr: int = 16_000, n_fft: int = 1280, hop: int = 320, n_mels: int = 80,
            eps: float = 1e-4) -> torch.Tensor:
    """log(mel power + eps), non-finite power scrubbed to 0: [N, L] ->
    [N, 1 + L // hop, n_mels]."""
    n = np.arange(n_fft, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / n_fft)
    mag = stft_magnitude(Math("fp32"), x, n_fft, hop, hann)
    fb = torch.from_numpy(_mel_fbank(sr, n_fft, n_mels).astype(np.float32)).to(x.device)
    mel = (mag * mag) @ fb
    mel = torch.where(torch.isfinite(mel), mel, torch.zeros_like(mel))
    return torch.log(mel + eps)
