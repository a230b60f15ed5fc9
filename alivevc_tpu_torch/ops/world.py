"""WORLD-style F0 estimation (DIO + StoneMask) on the host: the labeler of
the F0 estimator's training data and the ``-wpe`` pitch path
(module/common.py:113-137).

The numpy DIO (band-wise zero-crossing/peak/dip period candidates, best-band
selection, FixF0Contour), StoneMask and ``_interp_linear_np`` are copies of
the JAX package's ``ops/world.py``; they are the plain version of the native
labeler (``native/world.cpp`` through ``native_bindings.py``), which
``compute_f0`` and ``compute_f0_dio`` call.  A native library that does not
build raises; ``compute_f0_dio(use_native=False)`` is the explicit numpy
route.

``compute_f0`` mirrors the reference helper's shapes: resample to 8 kHz,
estimate, linear-interp to len8k // 256 frames, interp to len16k // 320
frames.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import fftconvolve

from alivevc_tpu_torch.native_bindings import dio_stonemask_native, dio_stonemask_native_batch
from alivevc_tpu_torch.ops.resample import resample


# ---------------------------------------------------------------------------
# DIO
# ---------------------------------------------------------------------------


def _nuttall_lowpass(cutoff_hz: float, fs: float) -> np.ndarray:
    """Nuttall-windowed sinc low-pass FIR (the filter family WORLD uses)."""
    half = int(round(fs / cutoff_hz * 2.0))
    n = np.arange(-half, half + 1)
    h = np.sinc(2.0 * cutoff_hz / fs * n) * (2.0 * cutoff_hz / fs)
    t = (n + half) / (2 * half)
    win = (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )
    h = h * win
    return h / h.sum()


def _event_intervals(x: np.ndarray, fs: float, kind: str):
    """Times and instantaneous F0 from successive events of one kind."""
    if kind == "zc_up":
        idx = np.nonzero((x[:-1] < 0) & (x[1:] >= 0))[0]
        frac = np.where(x[idx + 1] != x[idx], -x[idx] / (x[idx + 1] - x[idx]), 0.0)
        times = (idx + frac) / fs
    elif kind == "zc_down":
        idx = np.nonzero((x[:-1] >= 0) & (x[1:] < 0))[0]
        frac = np.where(x[idx + 1] != x[idx], x[idx] / (x[idx] - x[idx + 1]), 0.0)
        times = (idx + frac) / fs
    elif kind == "peak":
        d = np.diff(x)
        idx = np.nonzero((d[:-1] > 0) & (d[1:] <= 0))[0] + 1
        times = idx / fs
    else:  # dip
        d = np.diff(x)
        idx = np.nonzero((d[:-1] < 0) & (d[1:] >= 0))[0] + 1
        times = idx / fs
    if times.shape[0] < 2:
        return None
    intervals = np.diff(times)
    centers = (times[:-1] + times[1:]) / 2.0
    with np.errstate(divide="ignore"):
        f0 = 1.0 / intervals
    return centers, f0


def _voiced_runs(f0: np.ndarray):
    """[(start, end_exclusive), ...] of contiguous voiced (>0) frames."""
    runs = []
    start = None
    for i, v in enumerate(f0):
        if v > 0 and start is None:
            start = i
        elif v <= 0 and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, len(f0)))
    return runs


def fix_f0_contour(
    f0: np.ndarray,
    cand_f0: np.ndarray,          # [n_bands, F] per-band candidate contours (0 = none)
    allowed_range: float = 0.1,
    min_voiced_frames: int = 6,
    max_extend: int = 10,
) -> np.ndarray:
    """WORLD DIO's FixF0Contour post-processing (published step 3).

    1. octave-jump elimination: zero frames whose relative change vs the
       *original* previous frame exceeds ``allowed_range`` (WORLD FixStep2).
       A multi-frame octave spike thus loses its entry frame, survives as a
       detached short segment (removed by step 2), and the one good frame
       killed at the spike's exit is re-filled by step 3,
    2. short-segment removal: voiced runs shorter than ``min_voiced_frames``
       are unvoiced (WORLD FixStep1's voice_range_minimum),
    3. candidate extension: each surviving voiced section is extended forward
       and backward (≤ ``max_extend`` frames) by picking, per frame, the
       band candidate closest to the running reference, accepted while within
       ``allowed_range`` of it (WORLD FixStep3/4's ExtendF0 + SelectBestF0).
    """
    F = f0.shape[0]
    prev = np.concatenate([[0.0], f0[:-1]])
    jump = (f0 > 0) & (prev > 0) & (
        np.abs(f0 - prev) / np.maximum(prev, 1e-12) > allowed_range
    )
    out = np.where(jump, 0.0, f0)

    for s, e in _voiced_runs(out):
        if e - s < min_voiced_frames:
            out[s:e] = 0.0

    runs = _voiced_runs(out)
    for ri, (s, e) in enumerate(runs):
        nxt_start = runs[ri + 1][0] if ri + 1 < len(runs) else F
        ref = out[e - 1]
        for j in range(e, min(e + max_extend, nxt_start)):
            c = cand_f0[:, j]
            rel = np.where(c > 0, np.abs(c - ref) / max(ref, 1e-12), np.inf)
            b = int(np.argmin(rel))
            if rel[b] > allowed_range:
                break
            out[j] = c[b]
            ref = c[b]
        prev_end = runs[ri - 1][1] if ri > 0 else 0
        ref = out[s]
        for j in range(s - 1, max(s - 1 - max_extend, prev_end - 1), -1):
            if out[j] > 0:          # already filled by the previous forward pass
                break
            c = cand_f0[:, j]
            rel = np.where(c > 0, np.abs(c - ref) / max(ref, 1e-12), np.inf)
            b = int(np.argmin(rel))
            if rel[b] > allowed_range:
                break
            out[j] = c[b]
            ref = c[b]
    return out


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 40.0,
    f0_ceil: float = 800.0,
    frame_period_ms: float = 5.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
):
    """→ (f0 [F], frame_times [F]) with F ≈ duration/frame_period; 0 = unvoiced."""
    x = np.asarray(x, np.float64)
    f0_ceil = min(f0_ceil, fs / 2.0 * 0.9)
    n_frames = int(len(x) / fs * 1000.0 / frame_period_ms) + 1
    frame_t = np.arange(n_frames) * frame_period_ms / 1000.0

    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    best_f0 = np.zeros(n_frames)
    best_dev = np.full(n_frames, np.inf)
    cand_f0 = np.zeros((n_bands, n_frames))

    for b in range(n_bands):
        boundary = f0_floor * (2.0 ** ((b + 1) / channels_in_octave))
        h = _nuttall_lowpass(boundary, fs)
        y = fftconvolve(x, h, mode="same")
        cands = []
        for kind in ("zc_up", "zc_down", "peak", "dip"):
            ev = _event_intervals(y, fs, kind)
            if ev is None:
                cands = []
                break
            centers, f0v = ev
            cands.append(np.interp(frame_t, centers, f0v, left=0.0, right=0.0))
        if not cands:
            continue
        cands = np.stack(cands)                      # [4, F]
        mean_f0 = cands.mean(axis=0)
        dev = cands.std(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel_dev = np.where(mean_f0 > 0, dev / np.maximum(mean_f0, 1e-12), np.inf)
        in_range = (mean_f0 > max(f0_floor, boundary / 4.0)) & (mean_f0 < min(f0_ceil, boundary * 1.1))
        cand_f0[b] = np.where(in_range, mean_f0, 0.0)
        score = np.where(in_range, rel_dev, np.inf)
        better = score < best_dev
        best_f0 = np.where(better, mean_f0, best_f0)
        best_dev = np.where(better, score, best_dev)

    f0 = np.where(best_dev < allowed_range, best_f0, 0.0)
    f0 = fix_f0_contour(f0, cand_f0, allowed_range)
    return f0, frame_t


# ---------------------------------------------------------------------------
# StoneMask
# ---------------------------------------------------------------------------


def _refine_frame(x: np.ndarray, fs: int, t: float, f0_init: float) -> float:
    """One StoneMask refinement: amplitude-weighted instantaneous frequency of
    the first harmonics around a 3-period Blackman-windowed segment."""
    if f0_init <= 0:
        return 0.0
    half = int(round(1.5 * fs / f0_init))
    c = int(round(t * fs))
    lo, hi = c - half, c + half + 1
    if lo < 0 or hi + 1 > len(x):
        return f0_init
    seg = x[lo:hi]
    seg2 = x[lo + 1 : hi + 1]
    win = np.blackman(len(seg))
    n_fft = int(2 ** np.ceil(np.log2(len(seg) + 1)))
    s1 = np.fft.rfft(seg * win, n_fft)
    s2 = np.fft.rfft(seg2 * win, n_fft)
    # instantaneous frequency per bin from the one-sample phase advance
    dphi = np.angle(s2 * np.conj(s1))
    inst_f = dphi * fs / (2 * np.pi)
    amp = np.abs(s1)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)

    num, den = 0.0, 0.0
    k = 1
    while k * f0_init < fs / 2 - f0_init / 2 and k <= 6:
        bin_idx = int(round(k * f0_init * n_fft / fs))
        if bin_idx >= len(amp):
            break
        w = amp[bin_idx]
        fk = inst_f[bin_idx]
        if fk > 0:
            num += w * fk / k
            den += w
        k += 1
    if den <= 0:
        return f0_init
    refined = num / den
    if abs(refined - f0_init) / f0_init > 0.2:
        return f0_init
    return refined


def stonemask(
    x: np.ndarray, f0: np.ndarray, frame_t: np.ndarray, fs: int
) -> np.ndarray:
    x = np.asarray(x, np.float64)
    out = f0.copy()
    for i in range(len(f0)):
        r = _refine_frame(x, fs, frame_t[i], f0[i])
        out[i] = _refine_frame(x, fs, frame_t[i], r)
    return out


# ---------------------------------------------------------------------------
# reference-shaped helpers (module/common.py:113-137)
# ---------------------------------------------------------------------------


def _interp_linear_np(y: np.ndarray, out_len: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) in numpy."""
    in_len = y.shape[-1]
    if in_len == out_len:
        return y
    src = np.maximum((np.arange(out_len) + 0.5) * in_len / out_len - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(int), in_len - 1)
    i1 = np.minimum(i0 + 1, in_len - 1)
    frac = src - np.floor(src)
    return y[..., i0] * (1 - frac) + y[..., i1] * frac


def compute_f0_dio(
    wave_8k: np.ndarray,
    sample_rate: int = 8000,
    segment_size: int = 256,
    f0_min: float = 20.0,
    f0_max: float = 4096.0,
    use_native: bool = True,
) -> np.ndarray:
    """wave [L] at 8 kHz -> f0 [L // segment_size] (module/common.py:113-131),
    by the native labeler, or by the numpy one with ``use_native=False``."""
    if use_native:
        f0 = dio_stonemask_native(wave_8k, sample_rate, f0_floor=f0_min, f0_ceil=f0_max)
    else:
        f0, t = dio(wave_8k, sample_rate, f0_floor=f0_min, f0_ceil=f0_max)
        f0 = stonemask(wave_8k, f0, t, sample_rate)
    return _interp_linear_np(f0, wave_8k.shape[0] // segment_size)


def compute_f0(
    wave: np.ndarray, sample_rate: int = 16_000, segment_size: int = 320
) -> np.ndarray:
    """wave [N, L] at ``sample_rate`` -> f0 Hz [N, L // segment_size]
    (module/common.py:133-137: resample to 8 kHz, DIO + StoneMask, interp).

    Host work throughout: the wave is host numpy, so the resampling runs on
    a CPU tensor (``ops/resample.py``) and never visits the card; the threaded
    native batch labeler does the rest."""
    length = wave.shape[1]
    x = torch.from_numpy(np.ascontiguousarray(wave, np.float32))
    wave8 = resample(x, sample_rate, 8000).numpy()
    f0 = dio_stonemask_native_batch(wave8, 8000, f0_floor=20.0, f0_ceil=4096.0)
    out = _interp_linear_np(f0, wave8.shape[1] // 256)   # compute_f0_dio's 8 kHz frames
    return _interp_linear_np(out, length // segment_size).astype(np.float32)
