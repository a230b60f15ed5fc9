"""The port's WavLM teacher (``alivevc_tpu_torch/models/wavlm.py``) against
the JAX package's (``alivevc_tpu/models/wavlm.py``) on the CPU, at a narrow
configuration with a Hugging Face state dict drawn from a seed.

The JAX oracle is ``import_wavlm(sd, cfg)`` + ``wavlm_hidden_states``; its
features are formed from those states here (JAX's jitted ``wavlm_features``
runs the default configuration).  Tolerances: every hidden state and the
features 1e-4 abs (float32 convolutions, products and softmax in another
order through 10 layers; measured on the CPU: 4.5e-6 against JAX, 9.5e-7
against transformers); the relative-position bucket tables equal; the two
weight-norm key forms bit-equal outputs; ``wavlm_state`` round trips
bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alivevc_tpu.models import wavlm as jwavlm
from alivevc_tpu.ops.interp import linear_interpolate as jinterp
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.models import wavlm as twavlm

from test_torch_port_util import max_err, n

NARROW = dict(hidden_size=64, num_layers=10, num_heads=4, intermediate_size=128,
              conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
              num_buckets=320, max_distance=800)
TOL = 1e-4


@pytest.fixture(scope="module")
def narrow():
    sd = twavlm.seeded_state(twavlm.WavLMConfig(**NARROW), seed=0)
    wave = (0.1 * np.random.default_rng(1).standard_normal((2, 16_000))).astype(np.float32)
    jcfg = jwavlm.WavLMConfig(**NARROW)
    params = jwavlm.import_wavlm(sd, jcfg)
    hs = jwavlm.wavlm_hidden_states(params, jnp.asarray(wave), jcfg)
    feat = jinterp((hs[4] + hs[9]) * 0.5, wave.shape[1] // 320, axis=1)
    return sd, wave, params, [np.asarray(h) for h in hs], np.asarray(feat)


def test_hidden_states_and_features_match_jax(narrow):
    sd, wave, _, want_hs, want_feat = narrow
    m = twavlm.import_wavlm(sd)
    with torch.no_grad():
        got_hs = twavlm.wavlm_hidden_states(m, torch.from_numpy(wave))
        got_feat = twavlm.wavlm_features(m, torch.from_numpy(wave))
    assert len(got_hs) == len(want_hs) == 11
    for i, (g, w) in enumerate(zip(got_hs, want_hs)):
        assert g.shape == w.shape == (2, 49, 64)
        assert max_err(g, w) <= TOL, i
    # 49 frames interpolated to 16 000 // 320 = 50
    assert got_feat.shape == want_feat.shape == (2, 50, 64)
    assert max_err(got_feat, want_feat) <= TOL


@pytest.mark.parametrize("t", [1, 50, 204, 900])
def test_bucket_table_equals_jax(t):
    got = twavlm.rel_buckets_np(t, t, 320, 800)
    want = jwavlm._rel_buckets_np(t, t, 320, 800)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_both_weight_norm_forms_load_the_same(narrow):
    sd, wave, *_ = narrow
    legacy = twavlm.seeded_state(twavlm.WavLMConfig(**NARROW), seed=0, legacy_weight_norm=True)
    assert "encoder.pos_conv_embed.conv.weight_g" in legacy
    assert "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd
    # a Hugging Face checkpoint's pre-training key is read and left out
    legacy["masked_spec_embed"] = np.zeros(64, np.float32)
    with torch.no_grad():
        a = twavlm.wavlm_features(twavlm.import_wavlm(sd), torch.from_numpy(wave))
        b = twavlm.wavlm_features(twavlm.import_wavlm(legacy), torch.from_numpy(wave))
    assert torch.equal(a, b)


def test_wavlm_state_round_trips(narrow):
    sd, _, params, *_ = narrow
    back = weights.wavlm_state(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert sorted(back) == sorted(twavlm.import_wavlm(sd).state_dict())


def test_wavlm_config_reads_the_widths(narrow):
    sd, *_ = narrow
    assert weights.wavlm_config(sd) == twavlm.WavLMConfig(**NARROW)
    legacy = twavlm.hf_state(twavlm.seeded_state(twavlm.WavLMConfig(**NARROW), 0, True))
    assert weights.wavlm_config(legacy) == twavlm.WavLMConfig(**NARROW)
    assert twavlm.WavLMConfig() == twavlm.WavLMConfig(**{
        f: getattr(jwavlm.WavLMConfig(), f) for f in jwavlm.WavLMConfig.__dataclass_fields__})
    # the fields the JAX package lacks select the Large form and HuBERT; their defaults are Base+'s
    assert set(twavlm.WavLMConfig.__dataclass_fields__) - set(jwavlm.WavLMConfig.__dataclass_fields__) == {
        "feat_extract_norm", "do_stable_layer_norm", "relative_position_bias"}
    assert (twavlm.WavLMConfig().feat_extract_norm, twavlm.WavLMConfig().do_stable_layer_norm,
            twavlm.WavLMConfig().relative_position_bias) == ("group", False, True)


def test_matches_transformers_wavlm():
    """Hugging Face ``WavLMModel`` (its own random weights, its own key
    layout) through ``import_wavlm``: the hidden states within 1e-4."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WavLMConfig(
        hidden_size=64, num_hidden_layers=10, num_attention_heads=4, intermediate_size=128,
        conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False, num_buckets=320,
        max_bucket_distance=800, layerdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.WavLMModel(hf_cfg).eval()
    wave = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal((2, 8000))).astype(np.float32))
    m = twavlm.import_wavlm(hf.state_dict())
    assert m.cfg == twavlm.WavLMConfig(**NARROW)
    with torch.no_grad():
        want = hf(wave, output_hidden_states=True).hidden_states
        got = twavlm.wavlm_hidden_states(m, wave)
    assert len(got) == len(want) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        assert max_err(g, w) <= TOL, (i, max_err(g, w), float(np.abs(n(w)).max()))
