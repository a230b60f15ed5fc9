"""kNN-VC on the port (``models/wavlm.py`` in its Large form,
``models/hifigan.py``, ``infer/offline.py:KnnVCConverter``) against the
benchmark's plain reference (``vcbench/reference/knnvc.py``) on the CPU, at
small widths, on seeded weights that both load by the published names.

Tolerances: the port and the reference compute the same float32 products
in other orders (PyTorch's linear against ``@``, one softmax against
another), which moves a value by a few float32 ulps a layer; 1e-5 of the
largest magnitude holds that with room (the port reads 1e-6).  Products on TF32 operands (10
mantissa bits) move them by 2e-4 to 1e-3, so the same comparison of the
reference computed in TF32 fails it: each test checks that too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alivevc_tpu_torch.compat.weights import wavlm_config
from alivevc_tpu_torch.infer.offline import (KnnVC, KnnVCConverter, OfflineConverter, build_matching_set,
                                             knnvc_features)
from alivevc_tpu_torch.models import hifigan as port_hifigan
from alivevc_tpu_torch.models import wavlm as port_wavlm
from alivevc_tpu_torch.utils.profiling import PREFIX

VCBENCH = Path(__file__).resolve().parent.parent / "vcbench"
if str(VCBENCH) not in sys.path:
    sys.path.insert(0, str(VCBENCH))

import program_knnvc  # noqa: E402
import weights  # noqa: E402
from reference import knnvc  # noqa: E402
from reference.numerics import exact_float32  # noqa: E402

TOL = 1e-5
WAVLM = dict(hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64, conv_dim=[16] * 7,
             conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=True,
             feat_extract_norm="layer", do_stable_layer_norm=True, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, num_buckets=320, max_distance=800, layer_norm_eps=1e-5)
VOCODER = dict(input_channels=32, hidden_channels=16, upsample_initial_channel=32, upsample_rates=[10, 8, 2, 2],
               upsample_kernel_sizes=[20, 16, 4, 4], resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3, lrelu_slope=0.1)
MODEL = dict(sample_rate=16_000, layer=2, wavlm=WAVLM, knn=dict(k=4), vocoder=VOCODER)
TF32 = knnvc.Precisions({"wavlm": "tf32", "knn": "tf32", "vocoder": "tf32"})


def _speech(n: int, seed: int) -> np.ndarray:
    """A glide of harmonics with noise, about a voice's level."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / 16_000
    x = sum(np.sin(h * phase) / h for h in range(1, 8)) * (0.5 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (0.3 * x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def params():
    return weights.draw(knnvc.param_specs(MODEL), torch.Generator().manual_seed(21), "cpu")


@pytest.fixture(scope="module")
def model(params):
    return program_knnvc.build_model(MODEL, params)


@pytest.mark.parametrize("upto", [2, 4])
def test_wavlm_large_hidden_states_match_the_reference(params, model, upto):
    wave = torch.from_numpy(_speech(12_000, 1))[None]
    with torch.no_grad():
        got = port_wavlm.wavlm_hidden_states(model.wavlm, wave, upto=upto)
        with exact_float32():
            want = knnvc.hidden_states(knnvc.Precisions()["wavlm"], params["wavlm"], WAVLM, wave, upto)
            low = knnvc.hidden_states(TF32["wavlm"], params["wavlm"], WAVLM, wave, upto)
    assert len(got) == len(want) == upto + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 37, 32)
        assert _gap(g, w) < TOL, (i, _gap(g, w))
    assert _gap(low[-1], want[-1]) > 3 * TOL


def test_wavlm_large_stops_at_upto_and_leaves_the_state_unnormed(params):
    """Layers past ``upto`` never run (NaN weights there change nothing),
    and the state returned is layer ``upto``'s output, which the encoder's
    LayerNorm does not touch."""
    sd = {k: v.clone() for k, v in params["wavlm"].items()}
    for k in sd:
        if k.startswith(("encoder.layers.2.", "encoder.layers.3.")) and "rel_attn_embed" not in k:
            sd[k].fill_(float("nan"))
    sd["encoder.layer_norm.weight"].fill_(float("nan"))
    m = port_wavlm.import_wavlm(sd, stable_layer_norm=True)
    wave = torch.from_numpy(_speech(8_000, 2))[None]
    with torch.no_grad():
        hs = port_wavlm.wavlm_hidden_states(m, wave, upto=2)
        with exact_float32():
            want = knnvc.hidden_states(knnvc.Precisions()["wavlm"], params["wavlm"], WAVLM, wave, 2)
    assert torch.isfinite(hs[2]).all()
    assert _gap(hs[2], want[2]) < TOL
    normed = torch.nn.functional.layer_norm(hs[2], (32,))
    assert _gap(normed, hs[2]) > 0.1


def test_hifigan_matches_the_reference_and_gives_320_samples_a_frame(params, model):
    feats = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = port_hifigan.hifigan(model.vocoder, feats)
        with exact_float32():
            want = knnvc.vocoder(knnvc.Precisions()["vocoder"], params["vocoder"], VOCODER, feats)
            low = knnvc.vocoder(TF32["vocoder"], params["vocoder"], VOCODER, feats)
    assert got.shape == want.shape == (2, 9 * 320)
    assert model.vocoder.cfg.hop_length == 320
    assert _gap(got, want) < TOL
    assert _gap(low, want) > 3 * TOL
    assert float(got.abs().max()) <= 1.0


def test_matching_set_is_each_utterance_alone(params, model):
    waves = [_speech(n, 10 + n) for n in (6_000, 9_000, 4_000)]
    got = build_matching_set(model, waves, device="cpu")
    with torch.no_grad(), exact_float32():
        want = knnvc.matching_set(knnvc.Precisions(), params, MODEL, [torch.from_numpy(w) for w in waves])
    assert got.shape == want.shape == (18 + 27 + 12, 32)
    assert _gap(got, want) < TOL
    alone = knnvc_features(model, torch.from_numpy(waves[1]))
    assert torch.equal(got[18:45], alone)
    with pytest.raises(ValueError):
        build_matching_set(model, [], device="cpu")


@pytest.mark.parametrize("sr", [16_000, 22_050])
def test_convert_matches_the_reference(params, model, sr):
    """The whole ``OfflineConverter.convert`` of a kNN-VC converter: the
    file's length comes back, and the output is the reference's.  Where the
    reference's k-th and (k+1)-th scores lie closer than float32 rounding
    can tell (a near-tie, under 1e-5), the port may take either row, so the
    reference with that choice taken the other way counts too (the stream
    cell's rule)."""
    targets = [_speech(n, 30 + n) for n in (16_000, 12_000, 20_000)]
    mset = build_matching_set(model, targets, device="cpu")
    conv = KnnVCConverter(model, mset, k=4, device="cpu")
    assert isinstance(conv, OfflineConverter) and type(conv).convert is OfflineConverter.convert
    wave = _speech(int(1.3 * sr), 5)
    got = torch.from_numpy(conv.convert(wave, sr))
    assert got.shape == wave.shape
    pr = knnvc.Precisions()
    with torch.no_grad(), exact_float32():
        ref_set = knnvc.matching_set(pr, params, MODEL, [torch.from_numpy(w) for w in targets])
        want = torch.from_numpy(knnvc.convert_file(pr, params, MODEL, wave, sr, ref_set, "cpu"))
        low = torch.from_numpy(knnvc.convert_file(TF32, params, MODEL, wave, sr, knnvc.matching_set(
            TF32, params, MODEL, [torch.from_numpy(w) for w in targets]), "cpu"))
        x16 = knnvc.dsp.resample(torch.from_numpy(wave)[None], sr, 16_000)[0]
        _, margin = knnvc.convert(pr, params, MODEL, x16, ref_set)
        gap = _gap(got, want)
        ties = torch.nonzero(margin < 1e-5)[:, 0].tolist()
        for t in ties:
            swap = torch.zeros_like(margin, dtype=torch.bool)
            swap[t] = True
            alt, _ = knnvc.convert(pr, params, MODEL, x16, ref_set, knn_swap=swap)
            gap = min(gap, _gap(got, knnvc.dsp.resample(alt[None], 16_000, sr)[0]))
    assert len(ties) <= 2
    assert gap < TOL
    assert _gap(low, want) > 3 * TOL


def test_convert_refuses_an_input_shorter_than_a_frame(model):
    conv = KnnVCConverter(model, torch.randn(8, 32), device="cpu")
    assert conv.min_samples == 400
    assert conv.convert(_speech(400, 1), 16_000).shape == (400,)
    with pytest.raises(ValueError):
        conv.convert(_speech(399, 1), 16_000)


def test_import_wavlm_large_layout_strictly():
    """A seeded Hugging Face state dict in the Large layout (a LayerNorm on
    every conv, conv biases) imports strictly, with the pre-LN flag given
    (the keys cannot tell it), and runs as the reference runs it."""
    cfg = port_wavlm.WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in WAVLM.items()})
    sd = port_wavlm.seeded_state(cfg, seed=4)
    for i in range(7):
        assert f"feature_extractor.conv_layers.{i}.layer_norm.weight" in sd
        assert f"feature_extractor.conv_layers.{i}.conv.bias" in sd
    assert wavlm_config(sd, True) == cfg
    assert wavlm_config(sd).feat_extract_norm == "layer" and not wavlm_config(sd).do_stable_layer_norm
    m = port_wavlm.import_wavlm(sd, stable_layer_norm=True)
    assert m.cfg == cfg
    wave = torch.from_numpy(_speech(9_000, 6))[None]
    p = {k: torch.from_numpy(v) for k, v in port_wavlm.hf_state(sd).items()}
    with torch.no_grad():
        got = port_wavlm.wavlm_hidden_states(m, wave, upto=4)[4]
        post = port_wavlm.wavlm_hidden_states(port_wavlm.import_wavlm(sd), wave, upto=4)[4]
        with exact_float32():
            want = knnvc.hidden_states(knnvc.Precisions()["wavlm"], p, WAVLM, wave, 4)[4]
    assert _gap(got, want) < TOL
    assert _gap(post, want) > 0.1
    legacy = port_wavlm.seeded_state(cfg, seed=4, legacy_weight_norm=True)
    with torch.no_grad():
        assert torch.equal(port_wavlm.wavlm_hidden_states(port_wavlm.import_wavlm(legacy, True), wave, 4)[4], got)
    del sd["feature_extractor.conv_layers.3.layer_norm.bias"]
    with pytest.raises(RuntimeError):
        port_wavlm.import_wavlm(sd, stable_layer_norm=True)


def test_knnvc_spans_nest_in_a_step_a_file(model):
    mset = torch.randn(64, 32, generator=torch.Generator().manual_seed(8))
    conv = KnnVCConverter(model, mset, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        conv.convert(_speech(10_000, 9), 16_000)
        conv.convert(_speech(7_000, 9), 16_000)
    spans = {}
    for e in prof.events():
        if e.name.startswith(PREFIX):
            spans.setdefault(e.name[len(PREFIX):], []).append((e.time_range.start, e.time_range.end))
    assert len(spans["offline.convert"]) == len(spans["offline.step"]) == 2
    for name in ("knnvc.content", "knnvc.match", "knnvc.vocoder"):
        assert len(spans[name]) == 2
    assert len(spans["wavlm.attention"]) == 2 * MODEL["layer"]
    inside = lambda c, ps: any(a <= c[0] and c[1] <= b for a, b in ps)  # noqa: E731
    assert all(inside(s, spans["knnvc.content"]) for s in spans["wavlm.attention"])
    assert all(inside(s, spans["offline.step"]) for n in ("knnvc.content", "knnvc.match", "knnvc.vocoder")
               for s in spans[n])


def test_model_bundle_reads_layer_six_by_default():
    assert KnnVC(None, None).layer == 6
    assert port_wavlm.WAVLM_LARGE.hidden_size == 1024 and port_wavlm.WAVLM_LARGE.do_stable_layer_norm
    with pytest.raises(ValueError), torch.device("meta"):
        port_wavlm.WavLM(port_wavlm.WavLMConfig(feat_extract_norm="batch"))
