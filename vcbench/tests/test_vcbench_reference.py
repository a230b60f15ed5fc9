"""The plain reference against alivevc_tpu_torch's CPU path at small
widths, on the same seeded weights, which both load by the published
parameter names."""

import numpy as np
import pytest
import torch

import common
import program
from reference import dsp, paths
from reference.model import param_specs
from reference.numerics import Math, exact_float32


@pytest.fixture()
def setup(tiny_spec):
    spec = tiny_spec("stream-fp32-60ms")
    params, _ = common.draw_weights(spec.config, 11, "cpu")
    return spec.config["model"], params, program.build_models(spec.config["model"], params)


def test_spec_is_the_programs_state_dict(tiny_spec, bench):
    import cell
    from conftest import ROOT

    for spec in (tiny_spec("stream-fp32-60ms"), cell.Spec(bench, "offline-fp32-long", ROOT)):
        specs = param_specs(spec.config["model"])
        with torch.device("meta"):
            from alivevc_tpu_torch.config import ContentEncoderConfig, DecoderConfig, F0EstimatorConfig
            from alivevc_tpu_torch.models.content_encoder import ContentEncoder
            from alivevc_tpu_torch.models.decoder import Decoder
            from alivevc_tpu_torch.models.f0_estimator import F0Estimator

            m = spec.config["model"]
            dcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in m["decoder"].items()}
            mods = {"ce": ContentEncoder(ContentEncoderConfig(**m["content_encoder"])),
                    "f0": F0Estimator(F0EstimatorConfig(**m["f0_estimator"])),
                    "dec": Decoder(DecoderConfig(**dcfg))}
        for key, mod in mods.items():
            want = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
            assert want == {n: tuple(s) for n, s, _ in specs[key]}


def test_offline_windows(setup):
    from alivevc_tpu_torch.infer.offline import convert_window

    cfg, params, (ce, f0m, dec) = setup
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 14_400, generator=g) * 0.3
    tgt = torch.randn(256, 24, generator=g)
    got = convert_window(ce, f0m, dec, x, tgt, device="cpu", knn_precision="highest")
    with exact_float32():
        want = paths.convert_windows(paths.Precisions(), params, cfg, x, tgt,
                                     dict(intonation=1.0, pitch_shift=0.0, f0_rate=1.0))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_stream_hop(setup):
    from alivevc_tpu_torch.config import StreamingConfig
    from alivevc_tpu_torch.infer.streaming import init_stream_state, streaming_step

    cfg, params, (ce, f0m, dec) = setup
    g = torch.Generator().manual_seed(2)
    state = init_stream_state(StreamingConfig(), dec.cfg, "cpu")
    state = state._replace(window=torch.randn(1, 7680, generator=g) * 0.3,
                           phi=torch.rand(1, 1, 8, generator=g))
    chunk = torch.randn(960, generator=g) * 0.3
    tgt = torch.randn(256, 24, generator=g)
    nxt, out = streaming_step(ce, f0m, dec, state, chunk, tgt)
    win = torch.cat([state.window[:, 960:], chunk[None]], 1)
    st = dict(chunk=960, buffer_size=8, f0_rate=1.0, pitch_shift=0.0, k=4, alpha=0.0)
    with exact_float32():
        want, phi, _, _ = paths.stream_hops(paths.Precisions(), params, cfg, win, state.phi, tgt, st)
    assert float((out - want[0]).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((nxt.phi[0, 0] - phi[0]).abs().max()) <= 1e-5


def test_target_matrix(setup):
    from alivevc_tpu_torch.infer.offline import build_target_matrix

    cfg, params, (ce, _, _) = setup
    g = torch.Generator().manual_seed(3)
    wave, tokens = torch.randn(16_000, generator=g) * 0.3, torch.randn(32, 24, generator=g)
    got = build_target_matrix(ce, wave.numpy(), tokens, decimation=4, device="cpu")
    with exact_float32():
        want = paths.target_matrix(paths.Precisions(), params, cfg, wave, tokens, 4)
    assert got.shape == want.shape == (50 // 4 + 1 + 32, 24)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("orig,new", [(48_000, 16_000), (16_000, 48_000), (44_100, 16_000)])
def test_resample(orig, new):
    from alivevc_tpu_torch.ops.resample import resample

    x = torch.randn(2, 9_001, generator=torch.Generator().manual_seed(4))
    got, want = resample(x, orig, new), dsp.resample(x, orig, new)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


def test_log_mel_is_the_licence_measure():
    from alivevc_tpu_torch.ops.stft import log_mel_spectrogram

    x = torch.randn(2, 16_000, generator=torch.Generator().manual_seed(5))
    assert torch.allclose(dsp.log_mel(x), log_mel_spectrogram(x), atol=1e-4)


@pytest.mark.parametrize("mode", ["tf32", "bf16", "fp8"])
def test_lower_precisions_round(mode):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(6))
    err = float((Math(mode).r(x) - x).abs().max() / x.abs().max())
    assert {"tf32": 1e-3, "bf16": 8e-3, "fp8": 7e-2}[mode] > err > 0
    assert np.isfinite(err)
