"""Offline chunked voice conversion (inference.py:87-134).

The input is peak-normalised, padded by one chunk on each side, cut into
overlapping 3-chunk windows with a 1-chunk stride (overlap-discard); each
window is converted independently and its centre chunk kept.  Windows are
converted as one batch ``[N, 3*chunk]`` per step:

    wave -> STFT kernel -> [F0 estimate -> intonation] || [ContentEncoder ->
    kNN kernel vs target matrix] -> decoder (oscillator kernel, filter-level
    kernels) -> wave

This is the JAX package's ``convert_window`` with ``impl='pallas'``; every
Pallas kernel on that path is a CUDA kernel here (``kernels/``).  Entry
points run on CUDA unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run.  With ``world_pitch`` the F0 estimator
is bypassed: WORLD's DIO + StoneMask (``ops/world.py``, on the host) labels
every window's pitch before the first batch goes to the card.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from alivevc_tpu_torch.config import DecoderConfig, InferenceConfig
from alivevc_tpu_torch.device import DeviceLike, float32_math, resolve_device
from alivevc_tpu_torch.kernels.stft import stft_magnitude
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import decoder
from alivevc_tpu_torch.models.f0_estimator import f0_estimate
from alivevc_tpu_torch.ops.knn import match_features_kernel
from alivevc_tpu_torch.ops.pitch import apply_intonation
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.ops.world import compute_f0
from alivevc_tpu_torch.utils.profiling import span

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose float32 parameters are cast to ``dtype``
    (the bf16 mode casts only the CE and decoder parameters)."""
    if next(module.parameters()).dtype == dtype:
        return module
    out = copy.deepcopy(module)
    for p in out.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return out


def _on(module: nn.Module, dev: torch.device, name: str) -> None:
    if next(module.parameters()).device != dev:
        raise ValueError(f"{name} is on {next(module.parameters()).device}, not {dev}; "
                         f"move it with .to({str(dev)!r})")


@torch.no_grad()
def convert_window(
    ce: nn.Module,
    f0_est: nn.Module,
    dec: nn.Module,
    window,                      # [N, Lw] windows at 16 kHz
    tgt,                         # [Lr, 768] target matrix
    f0_rate: float = 1.0,
    pitch_shift: float = 0.0,
    intonation: float = 1.0,
    k: int = 4,
    alpha: float = 0.0,
    dec_cfg: Optional[DecoderConfig] = None,
    f0_override=None,            # [N, T, 1] Hz, bypasses the estimator
    dtype: str = "fp32",         # 'bf16': CE + decoder in bf16 (licensed mode)
    knn_precision: Optional[str] = None,   # None -> 'default' (bf16) / 'high' (fp32)
    device: DeviceLike = None,
) -> torch.Tensor:
    """Convert a batch of 16 kHz windows; returns [N, Lw] float32.

    In bf16 mode only the float32 content-encoder and decoder parameters are
    cast; the F0 estimator keeps float32 parameters and sees the float32
    upcast of the bf16 spectrogram.  The last STFT frame is dropped.
    """
    with span("offline.step"):
        dev = resolve_device(device)
        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        for m, name in ((ce, "ce"), (f0_est, "f0_est"), (dec, "dec")):
            _on(m, dev, name)
        dec_cfg = dec.cfg if dec_cfg is None else dec_cfg
        window = torch.as_tensor(window, dtype=torch.float32).to(dev)
        tgt = torch.as_tensor(tgt).to(dev)
        act = DTYPES[dtype]
        if dtype == "bf16":
            ce, dec = cast_params(ce, act), cast_params(dec, act)
        window = window.to(act)
        ctx = float32_math() if dtype == "fp32" else contextlib.nullcontext()
        with ctx:
            spec = stft_magnitude(window)[:, :-1, :].to(act)
            with span("step.f0"):
                if f0_override is not None:
                    f0 = torch.as_tensor(f0_override, dtype=torch.float32).to(dev)
                else:
                    f0 = f0_estimate(f0_est, spec.float())                   # [N, T, 1]
                # per-window intonation scaling about the voiced mean
                f0 = torch.stack([apply_intonation(f, intonation, pitch_shift) for f in f0])
            with span("step.content_encoder"):
                feat = content_encoder(ce, spec)
            if knn_precision is None:
                knn_precision = "default" if dtype == "bf16" else "high"
            feat = match_features_kernel(feat, tgt, k=k, alpha=alpha, precision=knn_precision)
            wave, _ = decoder(dec, feat.to(act), f0 * f0_rate, cfg=dec_cfg)
        return wave.float()


@torch.no_grad()
def build_target_matrix(
    ce: nn.Module,
    target_wave: Optional[np.ndarray] = None,
    library_tokens=None,
    decimation: int = 1,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Target matrix [Lr, 768]: encoder frames of a target utterance (16 kHz,
    peak-normalised) concatenated with library tokens."""
    dev = resolve_device(device)
    parts = []
    if target_wave is not None:
        _on(ce, dev, "ce")
        w = torch.as_tensor(np.asarray(target_wave, np.float32))[None, :].to(dev)
        with float32_math():
            feat = content_encoder(ce, spectrogram(w))[0]
        if decimation > 1:
            feat = feat[::decimation]
        parts.append(feat.float())
    if library_tokens is not None:
        parts.append(torch.as_tensor(library_tokens, dtype=torch.float32).to(dev))
    if not parts:
        raise ValueError("need a target utterance and/or a voice library")
    return torch.cat(parts, dim=0)


class OfflineConverter:
    """File-level driver of the chunked overlap-discard conversion."""

    def __init__(
        self,
        ce: nn.Module,
        f0_est: nn.Module,
        dec: nn.Module,
        tgt,
        cfg: InferenceConfig = InferenceConfig(),
        dec_cfg: Optional[DecoderConfig] = None,
        sample_rate: int = 16_000,
        world_pitch: bool = False,
        dtype: str = "fp32",
        knn_precision: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.world_pitch = world_pitch
        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        self.ce = cast_params(ce.to(self.device).eval(), DTYPES[dtype])
        self.f0 = f0_est.to(self.device).eval()
        self.dec = cast_params(dec.to(self.device).eval(), DTYPES[dtype])
        self.tgt = torch.as_tensor(tgt, dtype=torch.float32).to(self.device)
        self.cfg = cfg
        self.dec_cfg = dec.cfg if dec_cfg is None else dec_cfg
        self.sample_rate = sample_rate
        self.dtype = dtype
        self.knn_precision = knn_precision

    def convert_16k(self, wave: np.ndarray) -> np.ndarray:
        """wave [L] mono at 16 kHz -> converted [L] (peak-normalised input)."""
        with span("offline.convert"):
            return self._convert_16k(wave)

    def _convert_16k(self, wave: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        c = cfg.chunk
        wave = np.asarray(wave, np.float32)
        total = wave.shape[0]
        peak = np.abs(wave).max() if total else 0.0
        if peak > 0:
            wave = wave / peak
        # pad + unfold into [M, 3c] windows, stride c (inference.py:96-101)
        padded = np.concatenate([np.zeros(c, np.float32), wave, np.zeros(4 * c, np.float32)])
        m = (padded.shape[0] - 3 * c) // c + 1
        windows = np.stack([padded[i * c: i * c + 3 * c] for i in range(m)])
        f0 = compute_f0(windows, self.sample_rate)[..., None] if self.world_pitch else None

        # fixed-size window batches bound device memory on long files; the
        # last batch (and its f0) is zero-padded to the same shape
        bsz = max(1, cfg.max_windows_per_step)
        outs = []
        for i in range(0, m, bsz):
            batch = windows[i: i + bsz]
            f0_b = None if f0 is None else f0[i: i + bsz]
            n_real = batch.shape[0]
            pad = bsz - n_real if m > bsz else 0
            if pad:
                batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
                if f0_b is not None:
                    f0_b = np.concatenate([f0_b, np.zeros((pad,) + f0_b.shape[1:], f0_b.dtype)])
            got = convert_window(
                self.ce, self.f0, self.dec, torch.from_numpy(batch), self.tgt,
                cfg.f0_rate, cfg.pitch_shift, cfg.intonation, cfg.k, cfg.alpha,
                self.dec_cfg, None if f0_b is None else torch.from_numpy(f0_b), self.dtype,
                self.knn_precision, self.device,
            )
            outs.append(got[:n_real].cpu().numpy())
        out = np.concatenate(outs)[:, c:-c].reshape(-1)[:total]
        out = out * (10.0 ** (cfg.gain_db / 20.0))
        if cfg.normalize and np.abs(out).max() > 0:
            out = out / np.abs(out).max()
        return out

    def convert(self, wave: np.ndarray, sr: int) -> np.ndarray:
        """Any rate in and out: mono-mix, resample to 16 kHz, convert, and
        resample back to ``sr`` (``ops/resample.py`` on the converter's
        device; the output has ceil-rounded length at each step, as JAX's)."""
        with span("offline.convert"):
            wave = np.asarray(wave, np.float32)
            if wave.ndim == 2:  # [C, L] or [L, C] -> mono (channel axis = shorter)
                wave = wave.mean(axis=0 if wave.shape[0] <= wave.shape[1] else 1)
            if sr == self.sample_rate:
                return self._convert_16k(wave)
            x = torch.from_numpy(np.ascontiguousarray(wave))[None].to(self.device)
            wave16 = resample(x, sr, self.sample_rate)[0].cpu().numpy()
            out16 = torch.from_numpy(self._convert_16k(wave16))[None].to(self.device)
            return resample(out16, self.sample_rate, sr)[0].cpu().numpy()
