"""The PyTorch port's offline conversion end to end against the JAX package's
``convert_window(impl='pallas')`` on the CPU (its Pallas kernels in
interpret mode), at small widths with bridged parameters.

Tolerances: waveform 5e-3 abs in fp32 (PARITY.md's decoder tolerance).  The
window-level comparison passes ``f0_override``: a random-init F0 estimator's
argmax may flip on a near-tie between the frameworks, which would change the
waveform by far more than any tolerance; the estimator's bins are held by
test_torch_port_models.py.  The file-level driver runs the estimator on both
sides, and at 24 and 44.1 kHz resamples in and back as JAX ``convert``
does.  bf16 is held to the licence: log-mel L1 <= 0.25 against fp32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from alivevc_tpu.config import InferenceConfig as JInferenceConfig
from alivevc_tpu.infer import offline as joffline
from alivevc_tpu_torch.config import InferenceConfig
from alivevc_tpu_torch.infer import offline as toffline
from alivevc_tpu_torch.ops.stft import log_mel_spectrogram

from test_torch_port_util import jax_models, max_err, port_models


@pytest.fixture(scope="module")
def models():
    params, cfgs = jax_models(0)
    return params, cfgs, port_models(params)


def _windows():
    rng = np.random.default_rng(0)
    tt = np.arange(9600) / 16000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * f * tt) + 0.02 * rng.standard_normal(9600)
                  for f in (120.0, 220.0)]).astype(np.float32)
    tgt = rng.standard_normal((300, 64)).astype(np.float32)
    f0 = (rng.random((2, 30, 1)) * 200 + 100).astype(np.float32)
    return x, tgt, f0


@pytest.mark.parametrize("alpha,pitch", [(0.0, 0.0), (0.25, 3.0)])
def test_convert_window_fp32(models, alpha, pitch):
    params, cfgs, (ce, f0m, dec) = models
    x, tgt, f0 = _windows()
    with pltpu.force_tpu_interpret_mode():
        want = joffline.convert_window(
            params[0], params[1], params[2], jnp.asarray(x), jnp.asarray(tgt),
            pitch_shift=pitch, intonation=1.2, alpha=alpha, dec_cfg=cfgs[2], impl="pallas",
            f0_override=jnp.asarray(f0))
    got = toffline.convert_window(ce, f0m, dec, x, tgt, pitch_shift=pitch, intonation=1.2,
                                  alpha=alpha, f0_override=f0, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max_err(got, want) <= 5e-3


def test_convert_window_bf16_licence(models):
    _, _, (ce, f0m, dec) = models
    x, tgt, f0 = _windows()
    o32 = toffline.convert_window(ce, f0m, dec, x, tgt, f0_override=f0, device="cpu")
    o16 = toffline.convert_window(ce, f0m, dec, x, tgt, f0_override=f0, dtype="bf16", device="cpu")
    assert torch.isfinite(o16).all()
    mel_l1 = float((log_mel_spectrogram(o16) - log_mel_spectrogram(o32)).abs().mean())
    assert mel_l1 <= 0.25
    # the caller's modules keep their float32 parameters
    assert next(ce.parameters()).dtype == torch.float32


def test_offline_converter_convert_16k(models):
    """Peak normalisation, overlap-discard windows and tail padding of the
    last window batch (5 windows in steps of 2), estimator included."""
    params, cfgs, (ce, f0m, dec) = models
    rng = np.random.default_rng(3)
    tt = np.arange(5000) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 150 * tt) + 0.02 * rng.standard_normal(5000)).astype(np.float32)
    tgt = rng.standard_normal((200, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jc = joffline.OfflineConverter(params[0], params[1], params[2], jnp.asarray(tgt),
                                       JInferenceConfig(chunk=1600, max_windows_per_step=2),
                                       cfgs[2], impl="pallas")
        want = jc.convert_16k(wave)
        # any other rate resamples to 16 kHz and back (ops/resample.py)
        want_sr = {sr: jc.convert(wave, sr) for sr in (24_000, 44_100)}
    tc = toffline.OfflineConverter(ce, f0m, dec, tgt, InferenceConfig(chunk=1600, max_windows_per_step=2),
                                   device="cpu")
    got = tc.convert_16k(wave)
    assert got.shape == wave.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 5e-3
    assert np.abs(tc.convert(wave[None, :], 16_000) - got).max() == 0.0
    for sr, w in want_sr.items():
        out = tc.convert(wave, sr)     # the output at the input rate
        assert out.shape == w.shape and 0 <= out.shape[0] - wave.shape[0] <= 3
        assert np.abs(out - w).max() <= 5e-3


def test_build_target_matrix(models):
    params, _, (ce, _, _) = models
    rng = np.random.default_rng(4)
    wave = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    tokens = rng.standard_normal((16, 64)).astype(np.float32)
    want = joffline.build_target_matrix(params[0], target_wave=wave,
                                        library_tokens=jnp.asarray(tokens), decimation=2)
    got = toffline.build_target_matrix(ce, target_wave=wave, library_tokens=tokens,
                                       decimation=2, device="cpu")
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-4
    with pytest.raises(ValueError):
        toffline.build_target_matrix(ce, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_cpu(models):
    """No CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    _, _, (ce, f0m, dec) = models
    x, tgt, _ = _windows()
    with pytest.raises(RuntimeError):
        toffline.convert_window(ce, f0m, dec, x, tgt)
    with pytest.raises(RuntimeError):
        toffline.OfflineConverter(ce, f0m, dec, tgt)
    with pytest.raises(RuntimeError):
        toffline.build_target_matrix(ce, target_wave=x[0])
    with pytest.raises(ValueError):      # modules on the CPU, device asked elsewhere
        toffline.convert_window(ce, f0m, dec, x, tgt, device="meta")
