"""Configuration of the PyTorch port: the same frozen dataclasses, and the
same defaults, as the JAX package's ``config.py``.

The defaults reproduce the reference's global signal contract and model
hyper-parameters (module/spectrogram.py:8-10, module/content_encoder.py:9-14,
module/f0_estimator.py:9-14, module/decoder.py:27-210).  The port keeps its
own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
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
class HiFiGANConfig:
    """kNN-VC's prematched HiFi-GAN V1 generator (github.com/bshall/knn-vc
    hifigan/models.py; Kong et al. 2020 config_v1.json) at 16 kHz: a linear
    map of the 1 024-wide WavLM features, then x320 upsampling in four
    transposed convs, each followed by the mean of three ResBlock1 stacks."""

    input_channels: int = 1024            # hubert_dim
    hidden_channels: int = 512            # hifi_dim
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (10, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (20, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)     # output samples a frame: 320


@dataclasses.dataclass(frozen=True)
class NsfGeneratorConfig:
    """RVC's source-filter generator ``GeneratorNSF``
    (infer/lib/infer_pack/models.py) at 40 kHz (configs/v1/40k.json): the
    prior's 192 channels at 100 frames a second -> x400 upsampling in four
    transposed convs, each followed by the source through its noise conv and
    the mean of three ResBlock1 stacks; a sine source of the frame-rate F0
    (``SourceModuleHnNSF``, harmonic_num 0) and the speaker's conditioning."""

    initial_channel: int = 192
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (10, 10, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    gin_channels: int = 256
    sample_rate: int = 40_000
    sine_amp: float = 0.1
    noise_std: float = 0.003
    lrelu_slope: float = 0.1

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)     # output samples a frame: 400


@dataclasses.dataclass(frozen=True)
class RvcConfig:
    """RVC v2's synthesizer ``SynthesizerTrnMs768NSFsid`` at inference: the
    prior ``enc_p`` (TextEncoder768: 768-wide content + a 256-bin pitch
    embedding, 6 post-LN layers of VITS relative-position attention, window
    10), the reversed flow (4 mean-only coupling layers of 3 gated WaveNet
    layers), the speaker table ``emb_g`` and the generator."""

    phone_channels: int = 768
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    window_size: int = 10
    pitch_bins: int = 256
    flow_kernel_size: int = 5
    flow_dilation_rate: int = 1
    flow_layers: int = 3
    n_flows: int = 4
    gin_channels: int = 256
    spk_embed_dim: int = 109
    noise_scale: float = 0.66666
    generator: NsfGeneratorConfig = NsfGeneratorConfig()


@dataclasses.dataclass(frozen=True)
class RvcInferenceConfig:
    """RVC's inference settings (infer/modules/vc/pipeline.py, configs/
    config.py in float32): 160-sample frames at 16 kHz; a file over
    ``x_max`` s is cut near every ``x_center`` s at the quietest frame within
    ``x_query`` s, each segment converted with ``x_pad`` s of context on each
    side; the 5th-order 48 Hz Butterworth high-pass; k = 8 retrieval blended
    at ``index_rate``; ``protect`` for unvoiced frames; the pitch bins' range."""

    window: int = 160
    x_pad: int = 1
    x_query: int = 6
    x_center: int = 38
    x_max: int = 41
    highpass_order: int = 5
    highpass_hz: float = 48.0
    k: int = 8
    index_rate: float = 0.75
    protect: float = 0.33
    sid: int = 0
    f0_min: float = 50.0
    f0_max: float = 1100.0


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
