"""The offline driver (``infer/offline.py:OfflineConverter.convert`` and
``convert_16k``) on the CPU, at small widths, against a frozen copy of the
NumPy driver it replaced (``tests/torch_port_frozen_driver.py``): the same
batches, the same element-wise float32 operations, so the outputs are held
equal bit for bit.  ``CROSSINGS`` shows that a file went to the device once
and came back once on every path a benchmark cell runs; ``world_pitch``
adds one download (the labeler's 16 kHz wave) and one upload (its labels)."""

import math

import numpy as np
import pytest
import torch

from alivevc_tpu_torch.config import (ContentEncoderConfig, DecoderConfig, F0EstimatorConfig, HiFiGANConfig,
                                      InferenceConfig)
from alivevc_tpu_torch.infer import offline
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.models.hifigan import HiFiGAN
from alivevc_tpu_torch.models.wavlm import WavLM, WavLMConfig

from test_torch_port_util import CE_KW, DEC_KW, F0_KW
from torch_port_frozen_driver import frozen_convert, frozen_convert_16k

C, PER_STEP = 1600, 4
# 16 kHz lengths by the windows they cut, m = (n + 2c) // c + 1, against 4 a step
LENGTHS = {"under_a_batch": 1000, "one_batch": 1700, "padded_last_batch": 6000}


@pytest.fixture(scope="module")
def models():
    g = torch.Generator().manual_seed(0)
    ce = ContentEncoder(ContentEncoderConfig(**CE_KW), generator=g)
    f0m = F0Estimator(F0EstimatorConfig(**F0_KW), generator=g)
    dec = Decoder(DecoderConfig(**DEC_KW), generator=g)
    for m in (ce, f0m, dec):
        m.eval().requires_grad_(False)
    tgt = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    return ce, f0m, dec, tgt


@pytest.fixture(scope="module")
def knnvc_model():
    torch.manual_seed(5)
    wavlm = WavLM(WavLMConfig(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64, conv_dim=(16,) * 7,
                              conv_bias=True, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                              feat_extract_norm="layer", do_stable_layer_norm=True))
    voc = HiFiGAN(HiFiGANConfig(input_channels=32, hidden_channels=16, upsample_initial_channel=32))
    return offline.KnnVC(wavlm.eval().requires_grad_(False), voc.eval().requires_grad_(False), layer=2)


def _speech(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 150 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _at(sr: int, n16: int, seed: int = 0) -> np.ndarray:
    """A wave at ``sr`` that resamples to about ``n16`` samples at 16 kHz."""
    return _speech(n16 * sr // 16_000, seed)


def _windows(n: int, sr: int) -> int:
    n16 = math.ceil(16_000 * n / sr)
    return (n16 + 2 * C) // C + 1


def _converter(models, **kw):
    ce, f0m, dec, tgt = models
    world = kw.pop("world_pitch", False)
    return offline.OfflineConverter(ce, f0m, dec, tgt, InferenceConfig(chunk=C, max_windows_per_step=PER_STEP, **kw),
                                    world_pitch=world, device="cpu")


def _same_as_frozen(conv, wave, sr, crossings=(1, 1)):
    want = frozen_convert(conv, wave, sr)
    offline.reset_crossings()
    got = conv.convert(wave, sr)
    assert offline.CROSSINGS == {"to_card": crossings[0], "to_host": crossings[1]}
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    return got


@pytest.mark.parametrize("case", sorted(LENGTHS))
@pytest.mark.parametrize("sr", [16_000, 24_000, 44_100])
def test_convert_equals_the_frozen_driver(models, sr, case):
    conv = _converter(models)
    wave = _at(sr, LENGTHS[case], seed=sr)
    m = _windows(wave.shape[0], sr)
    assert {"under_a_batch": m < PER_STEP, "one_batch": m == PER_STEP,
            "padded_last_batch": m > PER_STEP and m % PER_STEP != 0}[case]
    got = _same_as_frozen(conv, wave, sr)
    assert 0 <= got.shape[0] - wave.shape[0] <= 3 and np.isfinite(got).all()


@pytest.mark.parametrize("gain_db", [0.0, -7.5])
@pytest.mark.parametrize("normalize", [False, True])
def test_gain_and_normalisation_equal_the_frozen_driver(models, normalize, gain_db):
    conv = _converter(models, normalize=normalize, gain_db=gain_db)
    got = _same_as_frozen(conv, _at(44_100, LENGTHS["padded_last_batch"], seed=3), 44_100)
    if normalize:
        assert np.abs(got).max() == pytest.approx(1.0, abs=2e-2)   # the resample back moves the peak a little


@pytest.mark.parametrize("sr", [16_000, 44_100])
def test_silent_file(models, sr):
    """Peak 0: neither normalisation divides, in or out."""
    conv = _converter(models, normalize=True)
    got = _same_as_frozen(conv, np.zeros(9000, np.float32), sr)
    assert np.isfinite(got).all()


def test_convert_16k_and_channel_layouts(models):
    """``convert_16k`` straight, and a two-channel file either way round,
    cross once each way."""
    conv = _converter(models)
    wave = _speech(LENGTHS["padded_last_batch"], seed=4)
    want = frozen_convert_16k(conv, wave)
    offline.reset_crossings()
    assert np.array_equal(conv.convert_16k(wave), want)
    assert offline.CROSSINGS == {"to_card": 1, "to_host": 1}
    stereo = np.stack([wave, 0.5 * wave])
    for layout in (stereo, stereo.T):
        _same_as_frozen(conv, layout, 16_000)


@pytest.mark.parametrize("sr", [16_000, 44_100])
def test_world_pitch_labels_from_one_host_copy(models, sr):
    """WORLD labels the windows on the host: one more download (the
    normalised 16 kHz wave) and one more upload (the labels, once a file)."""
    conv = _converter(models, world_pitch=True)
    _same_as_frozen(conv, _at(sr, LENGTHS["padded_last_batch"], seed=6), sr, crossings=(2, 2))


@pytest.mark.parametrize("sr", [16_000, 44_100])
def test_knnvc_through_the_shared_driver(knnvc_model, sr):
    mset = torch.randn(96, 32, generator=torch.Generator().manual_seed(9))
    conv = offline.KnnVCConverter(knnvc_model, mset, device="cpu")
    assert type(conv).convert is offline.OfflineConverter.convert
    got = _same_as_frozen(conv, _at(sr, 7000, seed=7), sr)
    assert np.isfinite(got).all()
    with pytest.raises(ValueError):
        conv.convert(_speech(conv.min_samples - 1), 16_000)
