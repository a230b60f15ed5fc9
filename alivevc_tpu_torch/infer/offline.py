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

A file crosses between host and card once each way (``CROSSINGS``): the
driver uploads it, resamples, normalises, cuts its windows, assembles the
steps' centre chunks and resamples back on the card, and downloads the
result.  Nothing in between waits on the card (``world_pitch`` aside, whose
labeler reads the 16 kHz wave on the host), so the host launches a step
while the card still runs the one before.

``KnnVCConverter`` is the same driver over the kNN-VC family (Baas et al.,
Interspeech 2023; github.com/bshall/knn-vc): the file-level code (mono mix,
resampling, the two crossings, spans) is ``OfflineConverter``'s, and the
per-file step converts the whole utterance at once, as kNN-VC's WavLM
attends over all of it:

    wave -> WavLM-Large to layer 6 -> kNN kernel vs the matching set (cosine
    top-k, mean) -> prematched HiFi-GAN -> wave

``RvcConverter`` is RVC v2 (github.com/RVC-Project/Retrieval-based-Voice-
Conversion-WebUI, infer/modules/vc/pipeline.py:Pipeline.pipeline and
Pipeline.vc) on the same file-level driver, which returns its 40 kHz output
as it is (RVC's ``resample_sr`` 0).  The caller gives the F0 curve (RVC's
``f0_file`` input; no pitch extractor runs).  On the host, as RVC does: the
16 kHz wave comes down once for the 48 Hz Butterworth high-pass (scipy
``filtfilt`` in float64) and the search for cut points (float64), then the
padded wave and the pitch go up once each.  Each segment is one step:

    segment -> HuBERT-base, 12 layers -> L2 8-NN kernel vs the index, RVC's
    inverse-square blend -> x2 frames, protect -> prior, draw, reversed flow
    -> NSF generator (the kNN-VC vocoder's ResBlock kernel) -> 40 kHz
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alivevc_tpu_torch.config import DecoderConfig, InferenceConfig, RvcInferenceConfig
from alivevc_tpu_torch.device import DeviceLike, float32_math, resolve_device
from alivevc_tpu_torch.kernels.knn import l2_penalty, l2_topk
from alivevc_tpu_torch.kernels.stft import stft_magnitude
from alivevc_tpu_torch.models.content_encoder import content_encoder
from alivevc_tpu_torch.models.decoder import decoder
from alivevc_tpu_torch.models.f0_estimator import f0_estimate
from alivevc_tpu_torch.models.hifigan import HiFiGAN, hifigan, nsf_hifigan
from alivevc_tpu_torch.models.rvc import RvcSynthesizer, flow_reverse, prior
from alivevc_tpu_torch.models.wavlm import WavLM, wavlm_hidden_states
from alivevc_tpu_torch.ops.knn import match_features_kernel, rvc_blend
from alivevc_tpu_torch.ops.pitch import apply_intonation
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.ops.stft import spectrogram
from alivevc_tpu_torch.ops.world import compute_f0
from alivevc_tpu_torch.utils.profiling import span

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

# the file-level driver's explicit copies between host and device: one
# upload and one download a file (``world_pitch`` adds the labeler's 16 kHz
# wave down and its labels up); tests and chip_smoke.py read it
CROSSINGS: Dict[str, int] = {"to_card": 0, "to_host": 0}


def reset_crossings() -> None:
    for key in CROSSINGS:
        CROSSINGS[key] = 0


def _to_card(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    CROSSINGS["to_card"] += 1
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def _to_host(x: torch.Tensor) -> np.ndarray:
    CROSSINGS["to_host"] += 1
    return x.cpu().numpy()


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

    output_rate: Optional[int] = None       # None: back at the input's rate

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
            return _to_host(self._convert_16k(_to_card(wave, self.device)))

    def _convert_16k(self, wave: torch.Tensor) -> torch.Tensor:
        """wave [L] at 16 kHz on the converter's device -> converted [L]
        there, with no host wait: the card values are never branched on."""
        cfg = self.cfg
        c = cfg.chunk
        total = wave.shape[0]
        if total:
            peak = wave.abs().max()
            wave = torch.where(peak > 0, wave / peak, wave)
        # pad + unfold into [M, 3c] windows, stride c (inference.py:96-101)
        padded = F.pad(wave, (c, 4 * c))
        windows = padded.unfold(0, 3 * c, c)
        m = windows.shape[0]
        # fixed-size window batches bound device memory on long files; the
        # last batch (and its f0) is zero-padded to the same shape
        bsz = max(1, cfg.max_windows_per_step)
        f0 = self._world_f0(padded, m, bsz) if self.world_pitch else None
        out = wave.new_empty(m, c)
        for i in range(0, m, bsz):
            batch = windows[i: i + bsz]
            n_real = batch.shape[0]
            pad = bsz - n_real if m > bsz else 0
            batch = torch.cat([batch, batch.new_zeros(pad, 3 * c)]) if pad else batch.contiguous()
            got = convert_window(
                self.ce, self.f0, self.dec, batch, self.tgt,
                cfg.f0_rate, cfg.pitch_shift, cfg.intonation, cfg.k, cfg.alpha,
                self.dec_cfg, None if f0 is None else f0[i: i + bsz], self.dtype,
                self.knn_precision, self.device,
            )
            out[i: i + n_real] = got[:n_real, c:2 * c]
        out = out.reshape(-1)[:total] * (10.0 ** (cfg.gain_db / 20.0))
        if cfg.normalize and total:
            peak = out.abs().max()
            out = torch.where(peak > 0, out / peak, out)
        return out

    def _world_f0(self, padded: torch.Tensor, m: int, bsz: int) -> torch.Tensor:
        """WORLD's labels [rows, T, 1] of the m windows of ``padded`` (on the
        host, from one copy of the wave), zero rows past m up to whole
        batches, uploaded once."""
        c = self.cfg.chunk
        windows = np.lib.stride_tricks.sliding_window_view(_to_host(padded), 3 * c)[::c]
        f0 = compute_f0(windows, self.sample_rate)[..., None]
        rows = -(-m // bsz) * bsz if m > bsz else m
        return _to_card(np.concatenate([f0, np.zeros((rows - m,) + f0.shape[1:], f0.dtype)]), self.device)

    def convert(self, wave: np.ndarray, sr: int, **step) -> np.ndarray:
        """Any rate in and out: mono-mix, resample to 16 kHz, convert, and
        resample back to ``sr`` (``ops/resample.py`` on the converter's
        device; the output has ceil-rounded length at each step, as JAX's),
        or return the model's own ``output_rate`` where it has one.  The
        file goes to the device once and comes back once.  ``step``'s
        keywords go to the model's conversion (RVC's ``f0``, ``generator``)."""
        with span("offline.convert"):
            wave = np.asarray(wave, np.float32)
            if wave.ndim == 2:  # [C, L] or [L, C] -> mono (channel axis = shorter)
                wave = wave.mean(axis=0 if wave.shape[0] <= wave.shape[1] else 1)
            x = _to_card(wave, self.device)
            if sr != self.sample_rate:
                x = resample(x[None], sr, self.sample_rate)[0]
            out = self._convert_16k(x, **step)
            if self.output_rate is None and sr != self.sample_rate:
                out = resample(out[None], self.sample_rate, sr)[0]
            return _to_host(out)


# ---------------------------------------------------------------------------
# kNN-VC
# ---------------------------------------------------------------------------


class KnnVC(NamedTuple):
    """kNN-VC's networks: WavLM (Large), read at the output of ``layer``
    (``hidden_states[layer]``; the layers past it never run), and the
    prematched vocoder."""

    wavlm: WavLM
    vocoder: HiFiGAN
    layer: int = 6


def knnvc_features(model: KnnVC, wave: torch.Tensor) -> torch.Tensor:
    """wave [L] at 16 kHz on the model's device -> features [T, D] (kNN-VC's
    ``get_features``: the samples as they are, not normalised), in float32
    with TF32 off."""
    with float32_math():
        return wavlm_hidden_states(model.wavlm, wave[None], upto=model.layer)[model.layer][0]


@torch.no_grad()
def build_matching_set(model: KnnVC, waves: Sequence[np.ndarray], device: DeviceLike = None) -> torch.Tensor:
    """The matching set [R, D]: the features of each target utterance (16
    kHz), one utterance at a time as kNN-VC's ``get_matching_set``,
    concatenated."""
    dev = resolve_device(device)
    _on(model.wavlm, dev, "wavlm")
    if not waves:
        raise ValueError("need at least one target utterance")
    return torch.cat([knnvc_features(model, torch.as_tensor(np.asarray(w, np.float32)).to(dev))
                      for w in waves])


@torch.no_grad()
def convert_knnvc(model: KnnVC, wave, matching_set: torch.Tensor, k: int = 4,
                  precision: str = "high") -> torch.Tensor:
    """One utterance [L] at 16 kHz -> converted [L] float32 on the
    matching set's device: features, the mean of the k nearest matching-set
    rows (no blend with the source), the vocoder, the frames' ``T *
    hop_length`` samples zero-padded or cut to L."""
    with span("offline.step"):
        dev = matching_set.device
        wave = torch.as_tensor(wave, dtype=torch.float32).to(dev)
        with span("knnvc.content"):
            feat = knnvc_features(model, wave)
        with span("knnvc.match"):
            feat = match_features_kernel(feat[None], matching_set, k=k, alpha=0.0, precision=precision)
        with span("knnvc.vocoder"), float32_math():
            out = hifigan(model.vocoder, feat)[0]
        n = wave.shape[0]
        return out[:n] if out.shape[0] >= n else torch.cat([out, out.new_zeros(n - out.shape[0])])


class KnnVCConverter(OfflineConverter):
    """``OfflineConverter``'s file-level driver (``convert``, ``convert_16k``)
    over a kNN-VC model and its matching set: each file converted whole in
    one step, with 'high' (float32-exact) scores by default."""

    def __init__(self, model: KnnVC, matching_set, k: int = 4, precision: str = "high",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = KnnVC(model.wavlm.to(self.device).eval(), model.vocoder.to(self.device).eval(),
                           model.layer)
        self.matching_set = torch.as_tensor(matching_set, dtype=torch.float32).to(self.device)
        self.k = k
        self.precision = precision
        self.sample_rate = 16_000
        cfg = model.wavlm.cfg
        # the conv front end's receptive field: the fewest samples that make a frame
        self.min_samples = 1
        for kk, st in zip(reversed(cfg.conv_kernel), reversed(cfg.conv_stride)):
            self.min_samples = (self.min_samples - 1) * st + kk

    def _convert_16k(self, wave: torch.Tensor) -> torch.Tensor:
        if wave.shape[0] < self.min_samples:
            raise ValueError(f"{wave.shape[0]} samples at 16 kHz: kNN-VC needs at least "
                             f"{self.min_samples}, one WavLM frame")
        return convert_knnvc(self.model, wave, self.matching_set, self.k, self.precision)


# ---------------------------------------------------------------------------
# RVC v2
# ---------------------------------------------------------------------------


class Rvc(NamedTuple):
    """RVC's networks: HuBERT-base (all its layers; the last one's output is
    read, ``output_layer=12``) and the synthesizer."""

    hubert: WavLM
    synth: RvcSynthesizer


def rvc_features(model: Rvc, wave: torch.Tensor) -> torch.Tensor:
    """wave [L] at 16 kHz on the model's device -> HuBERT's last hidden
    state [T, 768], in float32 with TF32 off."""
    with float32_math():
        return wavlm_hidden_states(model.hubert, wave[None])[-1][0]


@torch.no_grad()
def build_rvc_index(model: Rvc, waves: Sequence[np.ndarray], device: DeviceLike = None) -> torch.Tensor:
    """The index's rows [R, 768]: the features of each training-set piece
    (16 kHz), one piece at a time as RVC's feature extraction, concatenated."""
    dev = resolve_device(device)
    _on(model.hubert, dev, "hubert")
    if not waves:
        raise ValueError("need at least one piece")
    return torch.cat([rvc_features(model, torch.as_tensor(np.asarray(w, np.float32)).to(dev)) for w in waves])


def rvc_highpass(audio: np.ndarray, cfg: RvcInferenceConfig = RvcInferenceConfig(), sr: int = 16_000) -> np.ndarray:
    """RVC's high-pass: ``filtfilt`` of a Butterworth filter (order 5, 48 Hz)
    in float64."""
    from scipy import signal

    b, a = signal.butter(N=cfg.highpass_order, Wn=cfg.highpass_hz, btype="high", fs=sr)
    return signal.filtfilt(b, a, audio)


def rvc_moving_sum(audio: np.ndarray, window: int) -> np.ndarray:
    """[len(audio)]: the sum of |x| over ``window`` samples of the audio
    reflect-padded by window / 2 each side, from a float64 cumulative sum."""
    pad = np.pad(np.asarray(audio, np.float64), (window // 2, window // 2), mode="reflect")
    c = np.concatenate([[0.0], np.cumsum(np.abs(pad))])
    return np.abs(c[window:window + audio.shape[0]] - c[:audio.shape[0]])


def rvc_split_points(audio: np.ndarray, cfg: RvcInferenceConfig = RvcInferenceConfig(),
                     sr: int = 16_000) -> list:
    """Pipeline.pipeline's cut points of a file over ``x_max`` s (and its
    window): near every ``x_center`` s, the first smallest moving sum of |x|
    within ``x_query`` s either side."""
    window = cfg.window
    if audio.shape[0] + window // 2 * 2 <= sr * cfg.x_max:
        return []
    total = rvc_moving_sum(audio, window)
    query = sr * cfg.x_query
    return [t - query + int(np.argmin(total[t - query:t + query]))
            for t in range(sr * cfg.x_center, audio.shape[0], sr * cfg.x_center)]


def rvc_segments(samples: int, cuts: Sequence[int], cfg: RvcInferenceConfig = RvcInferenceConfig(),
                 sr: int = 16_000) -> list:
    """Pipeline.pipeline's slices of the padded audio (``x_pad`` s reflected
    each side) and of its frames, one (a0, a1, f0, f1) a segment: each cut
    floored to a frame, a segment from the cut before to the cut plus
    twice the padding and a frame, its pitch to the cut plus the padding;
    the last from the last cut to the end."""
    window, pad2 = cfg.window, 2 * sr * cfg.x_pad
    total = samples + pad2
    out, s, t = [], 0, 0
    for t in cuts:
        t = t // window * window
        out.append((s, t + pad2 + window, s // window, (t + pad2) // window))
        s = t
    out.append((t, total, t // window, total // window))
    return out


def rvc_pitch(f0: np.ndarray, samples: int, cfg: RvcInferenceConfig = RvcInferenceConfig(),
              sr: int = 16_000):
    """The F0 of the padded audio's frames from a curve of ``samples //
    window`` frames (100 a second at 16 kHz; cut or zero-extended to that),
    mirrored through the ``x_pad`` s of padding as the audio is: (f0 [P]
    float32 Hz, coarse [P] int64 bins).  The bins are RVC's get_f0: 1127 ln(1
    + f0 / 700) mapped linearly so that f0_min goes to 1 and f0_max to 255,
    clipped to 1..255, rounded half to even; computed in float64."""
    frames = samples // cfg.window
    curve = np.zeros(frames, np.float32)
    given = np.asarray(f0, np.float32).reshape(-1)[:frames]
    curve[:given.shape[0]] = given
    pad = sr * cfg.x_pad // cfg.window
    f0p = np.pad(curve, (pad, pad), mode="reflect")
    mel_min, mel_max = (1127 * np.log(1 + f / 700) for f in (cfg.f0_min, cfg.f0_max))
    mel = 1127 * np.log(1 + f0p.astype(np.float64) / 700)
    voiced = mel > 0
    mel[voiced] = (mel[voiced] - mel_min) * 254 / (mel_max - mel_min) + 1
    mel = np.clip(mel, 1, 255)
    return f0p, np.rint(mel).astype(np.int64)


def rvc_protect(feats: torch.Tensor, feats0: torch.Tensor, f0: torch.Tensor, frames: int,
                protect: float) -> torch.Tensor:
    """The retrieved and the HuBERT features [T1, D], each doubled to 100
    frames a second (nearest) and cut to ``frames``, mixed as Pipeline.vc
    protects unvoiced frames: weight 1 on the retrieved where f0 >= 1,
    ``protect`` where f0 < 1."""
    feats = feats.repeat_interleave(2, dim=0)[:frames]
    feats0 = feats0.repeat_interleave(2, dim=0)[:frames]
    w = torch.where(f0[:frames] < 1, protect, 1.0)[:, None]
    return feats * w + feats0 * (1 - w)


@torch.no_grad()
def convert_rvc_segment(model: Rvc, audio: torch.Tensor, coarse: torch.Tensor, f0: torch.Tensor,
                        index: torch.Tensor, penalty: torch.Tensor, cfg: RvcInferenceConfig = RvcInferenceConfig(),
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One segment (Pipeline.vc): audio [L] at 16 kHz, its frames' coarse
    pitch and f0 [P] on the index's device -> [T * 400] at 40 kHz, T = the
    HuBERT frames doubled (at most P).  Draws the prior's noise [1, 192, T]
    and then the source's [1, T * 400, 1] from ``generator``."""
    synth = model.synth
    scfg = synth.cfg
    with span("offline.step"):
        with span("rvc.content"):
            feats0 = rvc_features(model, audio)                        # [T1, 768]
        with span("rvc.match"):
            _, idx = l2_topk(feats0, index, penalty, cfg.k)
            feats = rvc_blend(feats0, index, idx, cfg.index_rate)
            frames = min(audio.shape[0] // cfg.window, 2 * feats0.shape[0], f0.shape[0])
            feats = rvc_protect(feats, feats0, f0, frames, cfg.protect)
            f0, coarse = f0[:frames], coarse[:frames]
        g = synth.emb_g.weight[cfg.sid][None, :, None]                 # [1, gin, 1]
        with span("rvc.prior"), float32_math():
            m_p, logs_p = prior(synth.enc_p, scfg, feats[None], coarse[None])
            eps = torch.randn(m_p.shape, generator=generator, device=m_p.device)
            z = flow_reverse(synth.flow, m_p + torch.exp(logs_p) * eps * scfg.noise_scale, g)
        with span("rvc.vocoder"), float32_math():
            noise = torch.randn((1, frames * scfg.generator.hop_length, 1), generator=generator, device=z.device)
            return nsf_hifigan(synth.dec, z, f0[None], g, noise)[0]


class RvcConverter(OfflineConverter):
    """``OfflineConverter``'s file-level driver (``convert(wave, sr, f0=...,
    generator=...)``) over RVC v2: the file's 16 kHz wave cut into segments
    as Pipeline.pipeline cuts it, each converted against the index with its
    L2 penalty (computed once here), the segments' 40 kHz outputs less their
    padding concatenated.  ``last_cuts`` holds the last file's cut points
    (before they are floored to a frame)."""

    def __init__(self, model: Rvc, index, cfg: RvcInferenceConfig = RvcInferenceConfig(), device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = Rvc(model.hubert.to(self.device).eval(), model.synth.to(self.device).eval())
        self.index = torch.as_tensor(index, dtype=torch.float32).to(self.device)
        self.penalty = l2_penalty(self.index)
        self.cfg = cfg
        self.sample_rate = 16_000
        self.output_rate = model.synth.cfg.generator.sample_rate
        self.last_cuts: list = []

    def _convert_16k(self, wave: torch.Tensor, f0=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """wave [L] at 16 kHz on the card -> [~2.5 L] at 40 kHz there; ``f0``
        the curve, ``L // 160`` frames (10 ms) of Hz, 0 where unvoiced."""
        if f0 is None:
            raise ValueError("RVC converts with the F0 curve it is given (f0=...): no pitch extractor runs")
        cfg, sr = self.cfg, self.sample_rate
        audio = _to_host(wave)
        peak = np.abs(audio).max() / 0.95 if audio.size else 0.0
        if peak > 1:                                  # vc_single's guard, in float32
            audio = audio / peak
        with span("rvc.highpass"):
            audio = rvc_highpass(audio, cfg, sr)
        with span("rvc.split"):
            self.last_cuts = rvc_split_points(audio, cfg, sr)
        t_pad = sr * cfg.x_pad
        f0p, coarse = rvc_pitch(f0.cpu().numpy() if torch.is_tensor(f0) else f0, audio.shape[0], cfg, sr)
        x = _to_card(np.pad(audio, (t_pad, t_pad), mode="reflect"), self.device)
        pitch = _to_card(np.stack([f0p, coarse.astype(np.float32)]), self.device)
        f0d, coarsed = pitch[0], pitch[1].long()
        trim = self.output_rate * cfg.x_pad
        outs = []
        for a0, a1, b0, b1 in rvc_segments(audio.shape[0], self.last_cuts, cfg, sr):
            y = convert_rvc_segment(self.model, x[a0:a1], coarsed[b0:b1], f0d[b0:b1], self.index, self.penalty,
                                    cfg, generator)
            outs.append(y[trim:-trim])
        return torch.cat(outs)
