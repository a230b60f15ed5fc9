"""Configuration of the PyTorch port: the same frozen dataclasses, and the
same defaults, as the JAX package's ``config.py``.

The defaults reproduce the reference's global signal contract and model
hyper-parameters (module/spectrogram.py:8-10, module/content_encoder.py:9-14,
module/f0_estimator.py:9-14, module/decoder.py:27-210).  The port keeps its
own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Global signal contract (shared by every component)."""

    sample_rate: int = 16_000
    n_fft: int = 1280
    hop_length: int = 320          # 20 ms == 50 Hz frame rate
    win_length: int = 1280
    # torch.stft without a window argument: a rectangular (all-ones) window
    window: str = "rect"
    center: bool = True
    pad_mode: str = "reflect"
    n_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1  # 641

    @property
    def frame_rate(self) -> int:
        return self.sample_rate // self.hop_length  # 50


@dataclasses.dataclass(frozen=True)
class ContentEncoderConfig:
    """ConvNeXt-1d content encoder (reference: module/content_encoder.py:9-14)."""

    n_fft: int = 1280
    internal_channels: int = 512
    hidden_channels: int = 1536
    output_channels: int = 768
    num_layers: int = 4
    kernel_size: int = 7

    @property
    def input_channels(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class F0EstimatorConfig:
    """Per-frame F0 classifier; bin index == Hz (module/f0_estimator.py:9-14)."""

    n_fft: int = 1280
    internal_channels: int = 256
    hidden_channels: int = 512
    output_channels: int = 4096
    num_layers: int = 4
    kernel_size: int = 7

    @property
    def input_channels(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """DDSP decoder: feature extractor + oscillator + filter U-Net
    (reference: module/decoder.py:27-210)."""

    content_channels: int = 768
    channels: int = 512
    hidden_channels: int = 1536
    num_layers: int = 4
    kernel_size: int = 7
    num_harmonics: int = 64
    segment_size: int = 320
    sample_rate: int = 16_000
    filter_rates: Tuple[int, ...] = (2, 2, 8, 10)
    filter_channels: Tuple[int, ...] = (8, 16, 64, 256)
    filter_kernel_size: int = 5
    filter_dilations: int = 3


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """MPD + MRD GAN discriminators (module/discriminator.py:86-174)."""

    periods: Tuple[int, ...] = (2, 3, 5, 7, 11, 17, 23, 37)
    period_groups: Tuple[int, ...] = (1, 4, 8, 8, 8, 8)
    period_channels: int = 64
    period_kernel_size: int = 5
    period_stride: int = 3
    period_stages: int = 5
    period_max_channels: int = 512
    resolutions: Tuple[int, ...] = (512, 1024, 2048)
    resolution_channels: int = 64
    lrelu_slope: float = 0.1


@dataclasses.dataclass(frozen=True)
class VoiceLibraryConfig:
    """Learnable 512-token voice library (module/voice_library.py:7)."""

    num_tokens: int = 512
    dim: int = 768


@dataclasses.dataclass(frozen=True)
class KNNConfig:
    """Feature matching defaults (module/common.py:96, inference.py:33-34)."""

    k: int = 4
    alpha: float = 0.0


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Offline chunked VC defaults (inference.py:20-43)."""

    chunk: int = 48_000
    f0_rate: float = 1.0
    pitch_shift: float = 0.0
    intonation: float = 1.0
    k: int = 4
    alpha: float = 0.0
    gain_db: float = 0.0
    normalize: bool = False
    # Max overlap-discard windows converted per step: bounds the decoder's
    # intermediates regardless of file length.
    max_windows_per_step: int = 16


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Realtime streaming defaults (realtime_inference.py:33-36,122-128)."""

    chunk: int = 960               # 60 ms hop at 16 kHz
    buffer_size: int = 8           # 480 ms analysis window
    f0_rate: float = 1.0
    pitch_shift: float = 0.0
    k: int = 4
    alpha: float = 0.0
    target_decimation: int = 4     # realtime_inference.py:88: tgt[:, :, ::4]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Shared training-loop defaults (train_*.py argparse defaults)."""

    learning_rate: float = 1e-4
    batch_size: int = 1
    length: int = 38_400
    mel_weight: float = 45.0
    feat_weight: float = 2.0
    content_weight: float = 1.0
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    cosine_t_max: int = 5000


AUDIO = AudioConfig()
CONTENT_ENCODER = ContentEncoderConfig()
F0_ESTIMATOR = F0EstimatorConfig()
DECODER = DecoderConfig()
KNN = KNNConfig()
