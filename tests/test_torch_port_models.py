"""Frame-rate models and decoder pieces of the PyTorch port against the JAX
package on the CPU, with bridged parameters at small widths.

Tolerances: content encoder and F0 logits 1e-4 abs (float32 on both sides,
sums in another order); f0 bins identical wherever the top two logits are
more than 1e-4 apart (the argmax is discrete: a near-tie may flip on a
rounding difference); decoder pieces and the filter U-Net 5e-3 abs
(PARITY.md's filter tolerance)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alivevc_tpu_torch.models import content_encoder as tce
from alivevc_tpu_torch.models import decoder as tdec
from alivevc_tpu_torch.models import f0_estimator as tf0
from alivevc_tpu_torch.ops.stft import spectrogram

from test_torch_port_util import jax_models, max_err, n, port_models, t

# the JAX package's models/__init__.py re-exports functions of these names
jce = importlib.import_module("alivevc_tpu.models.content_encoder")
jdec = importlib.import_module("alivevc_tpu.models.decoder")
jf0 = importlib.import_module("alivevc_tpu.models.f0_estimator")


@pytest.fixture(scope="module")
def models():
    params, cfgs = jax_models(0)
    return params, cfgs, port_models(params)


@pytest.fixture(scope="module")
def spec():
    rng = np.random.default_rng(0)
    tt = np.arange(6400) / 16000.0
    x = np.stack([0.4 * np.sin(2 * np.pi * 180 * tt),
                  0.1 * rng.standard_normal(6400)]).astype(np.float32)
    return n(spectrogram(t(x)))


def test_content_encoder(models, spec):
    params, _, (ce, _, _) = models
    want = jce.content_encoder(params[0], jnp.asarray(spec))
    got = tce.content_encoder(ce, t(spec))
    assert got.shape == want.shape
    assert max_err(got, want) <= 1e-4


def test_f0_estimator_logits_and_bins(models, spec):
    params, _, (_, f0, _) = models
    want = np.asarray(jf0.f0_estimator(params[1], jnp.asarray(spec)))
    got = n(tf0.f0_estimator(f0, t(spec)))
    assert np.abs(got - want).max() <= 1e-4
    bins_j = np.asarray(jf0.f0_estimate(params[1], jnp.asarray(spec)))[..., 0]
    bins_t = n(tf0.f0_estimate(f0, t(spec)))[..., 0]
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(bins_t[clear], bins_j[clear])


def test_feature_extractor(models):
    params, _, (_, _, dec) = models
    rng = np.random.default_rng(1)
    content = rng.standard_normal((2, 20, 64)).astype(np.float32)
    f0 = (rng.random((2, 20, 1)) * 300 + 80).astype(np.float32)
    want = jdec.feature_extractor(params[2]["feature_extractor"], jnp.asarray(content), jnp.asarray(f0))
    got = tdec.feature_extractor(dec.feature_extractor, t(content), t(f0))
    assert max_err(got, want) <= 1e-4


def test_plain_oscillator_phi_crop(models):
    """The plain oscillator with the streaming phi/crop semantics; float32
    phase cumsums over 6 400 samples in another order: 2e-3 abs."""
    params, cfgs, (_, _, dec) = models
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 20, 32)).astype(np.float32)
    f0 = (rng.random((2, 20, 1)) * 300 + 80).astype(np.float32)
    phi = (rng.random((2, 1, 16)) - 0.5).astype(np.float32)
    for ph, crop in ((0.0, (0, -1)), (phi, (5, -1))):
        jp = ph if isinstance(ph, float) else jnp.asarray(ph)
        tp = ph if isinstance(ph, float) else t(ph)
        w_j, phi_j = jdec.harmonic_oscillator(params[2]["harmonic_oscillator"], jnp.asarray(feats),
                                              jnp.asarray(f0), phi=jp, crop=crop, num_harmonics=16)
        w_t, phi_t = tdec.harmonic_oscillator(dec.harmonic_oscillator, t(feats), t(f0), phi=tp,
                                              crop=crop, num_harmonics=16)
        assert max_err(w_t, w_j) <= 2e-3
        assert phi_t.shape == phi_j.shape


def test_rate_convs_and_filter_block(models):
    params, _, (_, _, dec) = models
    rng = np.random.default_rng(3)
    jf = params[2]["filter"]
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    assert max_err(tdec._down(dec.filter.downs[0], t(x), 2), jdec._down(jf["downs"][0], jnp.asarray(x), 2)) <= 1e-4
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    # ups[2]: 64 -> 16 at rate 2; ups[3]: 16 -> 8 at rate 2
    assert max_err(tdec._up(dec.filter.ups[3], t(x), 2), jdec._up(jf["ups"][3], jnp.asarray(x), 2)) <= 1e-4
    cond = (0.5 * rng.standard_normal((2, 4, 32))).astype(np.float32)
    x = (0.3 * rng.standard_normal((2, 80, 8))).astype(np.float32)
    want = jdec.filter_block(jf["blocks"][3], jnp.asarray(x), jnp.asarray(cond))
    got = tdec.filter_block(dec.filter.blocks[3], t(x), t(cond))
    assert max_err(got, want) <= 5e-3


@pytest.mark.parametrize("frames", [10, 20])
def test_filter_unet(models, frames):
    """The whole U-Net; each up level runs through kernels/filter.py (its
    plain version on the CPU)."""
    params, cfgs, (_, _, dec) = models
    rng = np.random.default_rng(4 + frames)
    src = (0.3 * rng.standard_normal((2, 320 * frames, 1))).astype(np.float32)
    cond = (0.5 * rng.standard_normal((2, frames, 32))).astype(np.float32)
    want = jdec.filter_unet(params[2]["filter"], jnp.asarray(src), jnp.asarray(cond), cfgs[2])
    got = tdec.filter_unet(dec.filter, t(src), t(cond), dec.cfg)
    assert max_err(got, want) <= 5e-3


def test_decoder_plain_matches_xla(models):
    """The offline call (Chebyshev source, filter levels; their plain
    versions on the CPU) against the JAX package's XLA decoder."""
    params, cfgs, (_, _, dec) = models
    rng = np.random.default_rng(5)
    content = rng.standard_normal((2, 10, 64)).astype(np.float32)
    f0 = (rng.random((2, 10, 1)) * 300 + 80).astype(np.float32)
    want, _ = jdec.decoder(params[2], jnp.asarray(content), jnp.asarray(f0), cfg=cfgs[2])
    got, phi = tdec.decoder(dec, t(content), t(f0))
    assert phi is None
    assert got.shape == want.shape
    assert max_err(got, want) <= 5e-3


def test_decoder_phi_crop_matches_xla(models):
    """A call with phi and crop (the streaming semantics) takes the plain
    oscillator and returns the per-harmonic phase, as the XLA decoder does."""
    params, cfgs, (_, _, dec) = models
    rng = np.random.default_rng(6)
    content = rng.standard_normal((2, 10, 64)).astype(np.float32)
    f0 = (rng.random((2, 10, 1)) * 300 + 80).astype(np.float32)
    phi = (rng.random((2, 1, cfgs[2].num_harmonics)) - 0.5).astype(np.float32)
    want, phi_j = jdec.decoder(params[2], jnp.asarray(content), jnp.asarray(f0), phi=jnp.asarray(phi),
                               crop=(3, -1), cfg=cfgs[2])
    got, phi_t = tdec.decoder(dec, t(content), t(f0), phi=t(phi), crop=(3, -1))
    assert max_err(got, want) <= 5e-3
    assert phi_t.shape == phi_j.shape


def test_kernel_oscillator_is_offline_only(models):
    """Only phi = 0 with crop = (0, -1) takes the Chebyshev source (no phase
    out); any other crop takes the streaming source, which returns the
    phase (on the CPU its plain version, the plain oscillator)."""
    _, cfgs, (_, _, dec) = models
    content, f0 = torch.zeros(1, 10, 64), torch.full((1, 10, 1), 100.0)
    assert tdec.decoder(dec, content, f0)[1] is None
    _, phi = tdec.decoder(dec, content, f0, crop=(2, -1))
    assert phi.shape == (1, 10 * 320, cfgs[2].num_harmonics)
