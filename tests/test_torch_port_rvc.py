"""RVC v2 on the port (``models/wavlm.py`` in its HuBERT form, ``models/rvc.py``,
``models/hifigan.py:NsfHiFiGAN``, the L2 mode of ``kernels/knn.py``,
``infer/offline.py:RvcConverter``) on the CPU at small widths, against
``transformers``' HuBERT and VITS modules (where installed), against NumPy
transcriptions of RVC's ``Pipeline.vc`` and ``Pipeline.pipeline``, and against
the benchmark's plain reference (``vcbench/reference/rvc.py``) on seeded
weights that both load by the published names.

Tolerances: the port and the reference compute the same float32 products in
other orders, which moves a value by a few float32 ulps a layer; 1e-5 of the
largest magnitude holds that with room.  The reference computed on TF32
operands (10 mantissa bits) moves them by 1e-4 to 1e-2, so the same
comparison fails it: each such test checks that too.
"""

import math
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from alivevc_tpu_torch.config import RvcConfig, RvcInferenceConfig
from alivevc_tpu_torch.infer import offline
from alivevc_tpu_torch.infer.offline import RvcConverter, build_rvc_index
from alivevc_tpu_torch.kernels import knn as kknn
from alivevc_tpu_torch.models import hifigan as port_hifigan
from alivevc_tpu_torch.models import rvc as port_rvc
from alivevc_tpu_torch.models import wavlm as port_wavlm
from alivevc_tpu_torch.ops.knn import rvc_blend

VCBENCH = Path(__file__).resolve().parent.parent / "vcbench"
if str(VCBENCH) not in sys.path:
    sys.path.insert(0, str(VCBENCH))

import program_rvc  # noqa: E402
import weights  # noqa: E402
from reference import rvc as ref  # noqa: E402
from reference.numerics import exact_float32  # noqa: E402

TOL = 1e-5
HUBERT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=[16] * 7,
              conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=False,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=320, max_distance=800,
              layer_norm_eps=1e-5, feat_extract_norm="group", do_stable_layer_norm=False,
              relative_position_bias=False)
GENERATOR = dict(initial_channel=8, upsample_initial_channel=64, upsample_rates=[10, 10, 2, 2],
                 upsample_kernel_sizes=[16, 16, 4, 4], resblock_kernel_sizes=[3, 7, 11],
                 resblock_dilation_sizes=[[1, 3, 5]] * 3, gin_channels=8, sample_rate=40_000, sine_amp=0.1,
                 noise_std=0.003, lrelu_slope=0.1)
SYNTH = dict(phone_channels=32, inter_channels=8, hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2,
             kernel_size=3, window_size=10, pitch_bins=256, flow_kernel_size=5, flow_dilation_rate=1, flow_layers=3,
             n_flows=4, gin_channels=8, spk_embed_dim=3, noise_scale=0.66666, generator=GENERATOR)
DRIVER = dict(window=160, x_pad=1, x_query=1, x_center=2, x_max=3, highpass_order=5, highpass_hz=48.0, k=8,
              index_rate=0.75, protect=0.33, sid=0, f0_min=50.0, f0_max=1100.0)
MODEL = dict(sample_rate=16_000, hubert=HUBERT, synthesizer=SYNTH, driver=DRIVER)
TF32 = ref.Precisions({"hubert": "tf32", "knn": "tf32", "prior": "tf32", "vocoder": "tf32"})
SR = 16_000


def _sung(n: int, seed: int, sr: int = SR):
    """A glide of harmonics with noise and a rest, and its F0 curve at 100
    frames a second (0 in the rest)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 180 + 70 * np.sin(2 * np.pi * 0.6 * t + rng.uniform(0, 6))
    voiced = (t % 2.0) < 1.6
    x = sum(np.sin(h * 2 * np.pi * np.cumsum(f0) / sr) / h for h in range(1, 8)) * voiced
    wave = (0.3 * x + 0.01 * rng.standard_normal(n)).astype(np.float32)
    frames = np.arange(int(math.ceil(n * 16_000 / sr)) // 160) / 100
    curve = np.where((frames % 2.0) < 1.6, 180 + 70 * np.sin(2 * np.pi * 0.6 * frames), 0.0).astype(np.float32)
    return wave, curve


def _gap(got, want) -> float:
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def params():
    return weights.draw(ref.param_specs(MODEL), torch.Generator().manual_seed(26), "cpu")


@pytest.fixture(scope="module")
def model(params):
    return program_rvc.build_model(MODEL, params)[0]


@pytest.fixture(scope="module")
def biased(params):
    """``params`` with every generator bias redrawn small and nonzero
    (uniform within 0.05 / sqrt(fan-in), off the tanh rails), and its model:
    the benchmark's draw holds those biases at 0, on which a port that
    dropped or misplaced one would pass."""
    g = torch.Generator().manual_seed(27)
    synth = dict(params["synth"])
    for name, b in params["synth"].items():
        if name.startswith("dec.") and name.endswith(".bias"):
            w = synth[name[:-len("bias")] + "weight"]
            fan = w.shape[0] * w.shape[2] if name.startswith("dec.ups.") else w[0].numel()   # ConvTranspose1d
            synth[name] = (torch.rand(b.shape, generator=g) * 2 - 1) * (0.05 / math.sqrt(fan))
    out = {**params, "synth": synth}
    return out, program_rvc.build_model(MODEL, out)[0]


# ---------------------------------------------------------------------------
# HuBERT
# ---------------------------------------------------------------------------


def test_hubert_matches_transformers_and_the_reference(params, model):
    """The HuBERT form against Hugging Face ``HubertModel``'s
    ``last_hidden_state`` on its own initialisation (strictly loaded, the
    state dict's keys HF's less ``masked_spec_embed``), and against the
    reference on the benchmark's draw; the reference in TF32 fails."""
    tr = pytest.importorskip("transformers")
    cfg = tr.HubertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                          conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    torch.manual_seed(0)
    hf = tr.HubertModel(cfg).eval()
    sd = hf.state_dict()
    port = port_wavlm.import_wavlm(sd, num_heads=4)
    assert set(port.state_dict()) == set(sd) - {"masked_spec_embed"}
    assert port.cfg == port_wavlm.WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in HUBERT.items()})
    wave = torch.from_numpy(_sung(9_000, 1)[0])[None]
    with torch.no_grad():
        want = hf(wave).last_hidden_state
        got = port_wavlm.wavlm_hidden_states(port, wave)[-1]
    assert got.shape == want.shape and _gap(got, want) <= TOL
    with pytest.raises(ValueError):
        port_wavlm.import_wavlm(sd)
    with torch.no_grad():
        got = port_wavlm.wavlm_hidden_states(model.hubert, wave)[-1]
        with exact_float32():
            want = ref.hubert(ref.Precisions()["hubert"], params["hubert"], HUBERT, wave)
            tf32 = ref.hubert(TF32["hubert"], params["hubert"], HUBERT, wave)
    assert _gap(got, want) <= TOL < _gap(tf32, want)


# ---------------------------------------------------------------------------
# the prior's encoder and the flow
# ---------------------------------------------------------------------------


def _vits_config(tr):
    return tr.VitsConfig(hidden_size=16, num_attention_heads=2, window_size=10, ffn_dim=32, ffn_kernel_size=3,
                         num_hidden_layers=2, layer_norm_eps=1e-5, hidden_act="relu", flow_size=8,
                         prior_encoder_num_flows=4, prior_encoder_num_wavenet_layers=3, wavenet_kernel_size=5,
                         wavenet_dilation_rate=1, speaker_embedding_size=8)


def _stir(module: torch.nn.Module, seed: int) -> None:
    """Every parameter redrawn uniform in [-0.4, 0.4] (no zero-initialised
    layer left an identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.rand(p.shape, generator=g) * 0.8 - 0.4)


@pytest.mark.parametrize("t", [7, 60])
def test_prior_encoder_matches_vits_and_the_reference(params, model, t):
    """The prior's encoder stack (banded relative attention, window 10)
    against ``transformers``' ``VitsEncoder`` with its weights, at a length
    under the window and one over it; the reference's [T, 2T - 1] form on
    the benchmark's draw; the reference in TF32 fails."""
    tr = pytest.importorskip("transformers")
    from transformers.models.vits.modeling_vits import VitsEncoder

    hf = VitsEncoder(_vits_config(tr)).eval()
    _stir(hf, t)
    sd = {}
    for i, layer in enumerate(hf.layers):
        a = layer.attention
        for ours, theirs in (("q", a.q_proj), ("k", a.k_proj), ("v", a.v_proj), ("o", a.out_proj)):
            sd[f"attn_layers.{i}.conv_{ours}.weight"] = theirs.weight[:, :, None]
            sd[f"attn_layers.{i}.conv_{ours}.bias"] = theirs.bias
        sd[f"attn_layers.{i}.emb_rel_k"], sd[f"attn_layers.{i}.emb_rel_v"] = a.emb_rel_k, a.emb_rel_v
        for ours, theirs in (("norm_layers_1", layer.layer_norm), ("norm_layers_2", layer.final_layer_norm)):
            sd[f"{ours}.{i}.gamma"], sd[f"{ours}.{i}.beta"] = theirs.weight, theirs.bias
        for c in ("conv_1", "conv_2"):
            for w in ("weight", "bias"):
                sd[f"ffn_layers.{i}.{c}.{w}"] = getattr(getattr(layer.feed_forward, c), w)
    cfg = RvcConfig(**{k: v for k, v in SYNTH.items() if k != "generator"})
    enc = port_rvc._Encoder(cfg)
    enc.load_state_dict({k: v.detach() for k, v in sd.items()}, strict=True)
    x = torch.randn(1, t, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(x, torch.ones(1, t, 1), return_dict=True).last_hidden_state.transpose(1, 2)
        got = port_rvc.encoder(enc, cfg, x.transpose(1, 2))
    assert _gap(got, want) <= TOL
    phone = torch.randn(1, t, 32, generator=torch.Generator().manual_seed(2))
    pitch = torch.randint(1, 256, (1, t), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = port_rvc.prior(model.synth.enc_p, model.synth.cfg, phone, pitch)
        with exact_float32():
            want = ref.prior(ref.Precisions()["prior"], params["synth"], SYNTH, phone, pitch)
            tf32 = ref.prior(TF32["prior"], params["synth"], SYNTH, phone, pitch)
    for a, b, c in zip(got, want, tf32):
        assert _gap(a, b) <= TOL < _gap(c, b)


def test_flow_reverse_matches_vits_and_the_reference(params, model):
    """The reversed flow against ``transformers``' ``VitsResidualCouplingBlock``
    (reverse=True) with its weights (weight norm evaluated), and against the
    reference on the benchmark's draw; the reference in TF32 fails."""
    tr = pytest.importorskip("transformers")
    from transformers.models.vits.modeling_vits import VitsResidualCouplingBlock

    hf = VitsResidualCouplingBlock(_vits_config(tr)).eval()
    _stir(hf, 4)
    sd = {}
    for i, layer in enumerate(hf.flows):
        p = f"flows.{2 * i}"
        for ours, theirs in (("pre", layer.conv_pre), ("post", layer.conv_post), ("enc.cond_layer",
                                                                                   layer.wavenet.cond_layer)):
            sd[f"{p}.{ours}.weight"], sd[f"{p}.{ours}.bias"] = theirs.weight, theirs.bias
        for j in range(3):
            for name in ("in_layers", "res_skip_layers"):
                conv = getattr(layer.wavenet, name)[j]
                sd[f"{p}.enc.{name}.{j}.weight"], sd[f"{p}.enc.{name}.{j}.bias"] = conv.weight, conv.bias
    cfg = RvcConfig(**{k: v for k, v in SYNTH.items() if k != "generator"})
    flow = port_rvc.Flow(cfg)
    flow.load_state_dict({k: v.detach() for k, v in sd.items()}, strict=True)
    z = torch.randn(1, 8, 50, generator=torch.Generator().manual_seed(5))
    g = torch.randn(1, 8, 1, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = hf(z, torch.ones(1, 1, 50), g, reverse=True)
        got = port_rvc.flow_reverse(flow, z, g)
    assert _gap(got, want) <= TOL
    with torch.no_grad():
        got = port_rvc.flow_reverse(model.synth.flow, z, g)
        with exact_float32():
            want = ref.flow_reverse(ref.Precisions()["prior"], params["synth"], SYNTH, z, g)
            tf32 = ref.flow_reverse(TF32["prior"], params["synth"], SYNTH, z, g)
    assert _gap(got, want) <= TOL < _gap(tf32, want)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------


def test_l2_eight_nearest_equal_exhaustive_float64_with_ties():
    """The L2 mode's 8 rows (scores q.x - |x|^2 / 2 plus exact ties, on
    small integers, so that every score is exact in float32) are the 8 with
    the least float64 squared distance, ties to the smaller index; the
    cosine mode on the same operands ranks otherwise."""
    g = torch.Generator().manual_seed(7)
    lib = torch.randint(-4, 5, (300, 24), generator=g).float()
    lib[150:200] = lib[100:150]                      # duplicated rows: exact ties at other indices
    lib[200:210] *= 3                                # longer rows, nearer in cosine than in L2
    q = torch.cat([lib[torch.randint(0, 300, (40,), generator=g)] +
                   torch.randint(-1, 2, (40, 24), generator=g).float(),
                   torch.randint(-4, 5, (24, 24), generator=g).float()])
    _, idx = kknn.l2_topk(q, lib, kknn.l2_penalty(lib))
    d = ((q.double()[:, None] - lib.double()[None]) ** 2).sum(-1).numpy()
    want = np.stack([np.lexsort((np.arange(300), row))[:8] for row in d])
    assert np.array_equal(idx.numpy(), want)
    assert not np.array_equal(kknn.knn_topk(q, lib, 8, "high")[1].numpy(), want)
    # routed to the card, a library this small (the carried form's size for
    # cosine) still takes the two-pass launches, with unit row scales
    calls = []

    def launch(source, library, k, precision, **kw):
        calls.append(kw)
        v, i = kknn.knn_topk_plain(source, library, k, precision, **kw)
        return v, i.int(), None, None

    with mock.patch.object(kknn._lib, "route", lambda x: "cuda"), \
            mock.patch.object(kknn, "knn_topk_launch", launch), \
            mock.patch.object(kknn, "knn_topk_carried", side_effect=AssertionError("carried form")):
        _, routed = kknn.l2_topk(q, lib, kknn.l2_penalty(lib))
    assert len(calls) == 1 and calls[0]["normalize"] is False
    assert routed.dtype == torch.int64 and np.array_equal(routed.numpy(), want)


def test_blend_coarse_pitch_and_protect_match_pipeline_vc():
    """``rvc_blend``, ``rvc_pitch``'s bins and ``rvc_protect`` against a NumPy
    transcription of Pipeline.vc / get_f0 (faiss's squared distances, the
    (1 / score)^2 weights, the blend; 1127 ln(1 + f0 / 700) mapped to
    1..255; nearest doubling and protect)."""
    rng = np.random.default_rng(8)
    big_npy = rng.standard_normal((500, 16)).astype(np.float32)
    npy = rng.standard_normal((30, 16)).astype(np.float32)
    ix = rng.integers(0, 500, (30, 8))
    score = ((npy[:, None] - big_npy[ix]) ** 2).sum(-1)
    weight = np.square(1 / score)
    weight /= weight.sum(axis=1, keepdims=True)
    want = np.sum(big_npy[ix] * np.expand_dims(weight, axis=2), axis=1) * 0.75 + (1 - 0.75) * npy
    got = rvc_blend(torch.from_numpy(npy), torch.from_numpy(big_npy), torch.from_numpy(ix), 0.75).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    f0 = np.concatenate([[0.0, 0.5, 30.0, 49.9, 50.0, 1100.0, 1500.0], rng.uniform(60, 1000, 400)]).astype(np.float32)
    cfg = RvcInferenceConfig()
    f0p, coarse = offline.rvc_pitch(f0, f0.shape[0] * 160, cfg)
    pad = np.pad(f0, (100, 100), mode="reflect")
    f0_mel = 1127 * np.log(1 + pad.astype(np.float64) / 700)
    lo, hi = 1127 * np.log(1 + 50 / 700), 1127 * np.log(1 + 1100 / 700)
    f0_mel[f0_mel > 0] = (f0_mel[f0_mel > 0] - lo) * 254 / (hi - lo) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > 255] = 255
    assert np.array_equal(f0p, pad) and np.array_equal(coarse, np.rint(f0_mel).astype(np.int64))
    assert coarse.min() == 1 and coarse.max() == 255

    feats, feats0 = (torch.from_numpy(rng.standard_normal((25, 16)).astype(np.float32)) for _ in range(2))
    pitchf = torch.from_numpy(f0[:49])
    up = lambda x: F.interpolate(x.T[None], scale_factor=2)[0].T.numpy()     # noqa: E731
    pitchff = pitchf.numpy().copy()
    pitchff[pitchf.numpy() > 0] = 1
    pitchff[pitchf.numpy() < 1] = 0.33
    want = up(feats)[:49] * pitchff[:, None] + up(feats0)[:49] * (1 - pitchff[:, None])
    got = offline.rvc_protect(feats, feats0, pitchf, 49, 0.33).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the driver's cuts and segments
# ---------------------------------------------------------------------------


def test_cuts_and_segments_match_pipeline_on_a_100_s_input():
    """``rvc_split_points`` and ``rvc_segments`` against a NumPy transcription
    of Pipeline.pipeline's loop at RVC's fp32 settings on 100 s of audio
    (cuts near 38 and 76 s): the same cuts, and the same padded-audio and
    pitch slices of every segment."""
    cfg = RvcInferenceConfig()
    wave, curve = _sung(100 * SR, 9)
    audio = offline.rvc_highpass(wave, cfg)
    window, t_pad = 160, 16_000
    t_pad2, t_query, t_center, t_max = 2 * t_pad, 6 * SR, 38 * SR, 41 * SR
    audio_pad = np.pad(audio, (window // 2, window // 2), mode="reflect")
    opt_ts = []
    if audio_pad.shape[0] > t_max:
        audio_sum = np.zeros_like(audio)
        for i in range(window):
            audio_sum += np.abs(audio_pad[i:i - window])
        for t in range(t_center, audio.shape[0], t_center):
            part = np.abs(audio_sum[t - t_query:t + t_query])
            opt_ts.append(t - t_query + np.where(part == part.min())[0][0])
    cuts = offline.rvc_split_points(audio, cfg)
    assert cuts == opt_ts and len(cuts) == 2
    audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
    p_len = audio_pad.shape[0] // window
    pitch = np.arange(p_len)
    want, s, t = [], 0, None
    for t in opt_ts:
        t = t // window * window
        want.append((audio_pad[s:t + t_pad2 + window], pitch[s // window:(t + t_pad2) // window]))
        s = t
    want.append((audio_pad[t:], pitch[t // window:]))
    got = offline.rvc_segments(audio.shape[0], cuts, cfg)
    assert len(got) == len(want) == 3
    for (a0, a1, b0, b1), (wa, wp) in zip(got, want):
        assert np.array_equal(audio_pad[a0:a1], wa) and np.array_equal(pitch[b0:b1], wp)
    assert offline.rvc_segments(20 * SR, [], cfg) == [(0, 22 * SR, 0, 22 * SR // window)]
    f0p, _ = offline.rvc_pitch(curve, wave.shape[0], cfg)
    assert f0p.shape[0] == p_len


# ---------------------------------------------------------------------------
# the generator and the whole converter
# ---------------------------------------------------------------------------


def test_nsf_generator_matches_the_reference(model, biased):
    """The NSF generator (source, noise convs, cond, ResBlocks, bias-free
    conv_post), every bias nonzero, against the reference on the same noise;
    the reference in TF32 fails, and so does the port with the biases at 0."""
    params, biased_model = biased
    g = torch.Generator().manual_seed(10)
    t = 40
    z = torch.randn(1, 8, t, generator=g)
    f0 = torch.where(torch.arange(t) % 13 < 9, 150 + 100 * torch.rand(t, generator=g), 0.0)[None]
    spk = params["synth"]["emb_g.weight"][1][None, :, None]
    noise = torch.randn(1, t * 400, 1, generator=g)
    with torch.no_grad():
        got = port_hifigan.nsf_hifigan(biased_model.synth.dec, z, f0, spk, noise)
        unbiased = port_hifigan.nsf_hifigan(model.synth.dec, z, f0, spk, noise)
        with exact_float32():
            want = ref.generator(ref.Precisions()["vocoder"], params["synth"], GENERATOR, z, f0, spk, noise)
            tf32 = ref.generator(TF32["vocoder"], params["synth"], GENERATOR, z, f0, spk, noise)
    assert got.shape == (1, t * 400) and _gap(got, want) <= TOL < _gap(tf32, want)
    assert _gap(unbiased, want) > 100 * TOL
    sine = port_hifigan.sine_source(f0, 400, 40_000, noise)
    assert torch.equal(sine, ref.sine_gen(f0, 400, 40_000, noise))


def test_converter_matches_the_reference_and_counts_its_crossings(biased):
    """``RvcConverter.convert`` of a 7 s stereo file at 44.1 kHz (cut at three
    places at these settings), the generator's biases nonzero, against the
    reference's pipeline on the same curve and noise, its index built alike:
    within 1e-5 of the peak, and the reference in TF32 (its own index too)
    fails.  The file goes up once, the 16 kHz wave down and the padded wave
    and pitch up once each, the output down once."""
    params, model = biased
    wave, curve = _sung(7 * 44_100 + 77, 11, 44_100)
    stereo = np.stack([0.9 * wave, 0.7 * wave])
    pieces = [_sung(SR, s)[0] for s in range(12, 20)]
    index = build_rvc_index(model, pieces, device="cpu")
    conv = RvcConverter(model, index, RvcInferenceConfig(**DRIVER), device="cpu")
    offline.reset_crossings()
    got = conv.convert(stereo, 44_100, f0=curve, generator=torch.Generator().manual_seed(5))
    assert offline.CROSSINGS == {"to_card": 3, "to_host": 2}
    with torch.no_grad(), exact_float32():
        rows = ref.index_rows(ref.Precisions(), params, MODEL, [torch.from_numpy(p) for p in pieces])
        audio = ref.file_16k(stereo, 44_100, "cpu")
        cuts = ref.cuts(ref.highpass(audio, DRIVER), DRIVER)
        want = ref.pipeline(ref.Precisions(), params, MODEL, audio, curve, rows, torch.Generator().manual_seed(5),
                            "cpu", cuts)
        tf32 = ref.pipeline(TF32, params, MODEL, audio, curve, ref.index_rows(TF32, params, MODEL,
                                                                               [torch.from_numpy(p) for p in pieces]),
                            torch.Generator().manual_seed(5), "cpu", cuts)
    assert len(cuts) == 3 and conv.last_cuts == cuts
    assert got.shape == want.shape and _gap(got, want) <= TOL < _gap(tf32, want)
    with pytest.raises(ValueError):
        conv.convert(stereo, 44_100)


# ---------------------------------------------------------------------------
# what this does not change
# ---------------------------------------------------------------------------


def _frozen_hifigan(m, feats):
    """``models/hifigan.py:hifigan`` as it was before the NSF form shared its
    stage loop."""
    cfg = m.cfg
    slope = cfg.lrelu_slope
    kernels = len(cfg.resblock_kernel_sizes)
    x = m.lin_pre(feats).transpose(1, 2)
    x = port_hifigan._conv(m.conv_pre, x)
    for i, up in enumerate(m.ups):
        x = F.conv_transpose1d(F.leaky_relu(x, slope), up.weight, up.bias, stride=up.stride, padding=up.padding)
        x = port_hifigan._resblocks(m.resblocks[i * kernels:(i + 1) * kernels], x.transpose(1, 2).contiguous(), slope)
        x = x.transpose(1, 2).contiguous()
    x = port_hifigan._conv(m.conv_post, F.leaky_relu(x))
    return torch.tanh(x)[:, 0]


def _frozen_wavlm_attention(m, x, position_bias, cfg):
    """``models/wavlm.py:_attention`` as it was before HuBERT's plain form."""
    n, t, d = x.shape
    h = cfg.num_heads
    hd = d // h
    heads = lambda y: y.reshape(n, t, h, hd).transpose(1, 2)   # noqa: E731
    proj = m.gru_rel_pos_linear(heads(x)).reshape(n, h, t, 2, 4).sum(-1)
    gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)
    gate = gate_a * (gate_b * m.gru_rel_pos_const - 1.0) + 2.0
    q, k, v = heads(m.q_proj(x)), heads(m.k_proj(x)), heads(m.v_proj(x))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + gate * position_bias[None]
    return m.out_proj((torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(n, t, d))


@pytest.mark.parametrize("stable", [False, True])
def test_wavlm_and_knnvc_vocoder_are_bit_equal_to_before(monkeypatch, stable):
    """WavLM (Base+ and Large forms) and kNN-VC's vocoder compute the same
    bits as the code before the HuBERT and NSF forms were added beside them
    (frozen copies of the old attention and stage loop)."""
    from alivevc_tpu_torch.config import HiFiGANConfig

    cfg = port_wavlm.WavLMConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, conv_dim=(16,) * 7,
                                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                                 feat_extract_norm="layer" if stable else "group", do_stable_layer_norm=stable,
                                 conv_bias=stable)
    m = port_wavlm.import_wavlm(port_wavlm.seeded_state(cfg, seed=3), stable_layer_norm=stable)
    wave = torch.from_numpy(_sung(8_000, 2)[0])[None]
    with torch.no_grad():
        got = port_wavlm.wavlm_hidden_states(m, wave)
        monkeypatch.setattr(port_wavlm, "_attention", _frozen_wavlm_attention)
        want = port_wavlm.wavlm_hidden_states(m, wave)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    vcfg = HiFiGANConfig(input_channels=32, hidden_channels=16, upsample_initial_channel=32)
    torch.manual_seed(4)
    voc = port_hifigan.HiFiGAN(vcfg).eval()
    feats = torch.randn(1, 9, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        assert torch.equal(port_hifigan.hifigan(voc, feats), _frozen_hifigan(voc, feats))
