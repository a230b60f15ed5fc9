"""The PyTorch port's streaming path (alivevc_tpu_torch/infer/streaming.py)
against the JAX package's ``infer/streaming.py`` on the CPU, at small widths
with bridged parameters and ``StreamingConfig(chunk=640, buffer_size=4)``;
and the five properties of tests/test_streaming.py on the port.

Tolerances: the waveform 5e-3 abs (PARITY.md's decoder tolerance).  phi
(= asin(sin theta), 1-Lipschitz in theta) within 2e-3 abs: theta is a
float32 prefix sum over the window of f / sample rate, under 1 024 cycles
at these widths (16 harmonics of <= 380 Hz, f0 shifted up, over 2 560
samples), where float32 values are 2^-14 cycles apart; the two frameworks
sum in another order, and a few such steps times 2 pi stay under 2e-3
radians.  The step-level comparison
passes ``f0_override`` (a random-init estimator's argmax may flip on a
near-tie between the frameworks); the converter-level one runs the
estimator on both sides, as the file-level offline test does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alivevc_tpu.config import StreamingConfig as JStreamingConfig
from alivevc_tpu.infer import streaming as jstreaming
from alivevc_tpu_torch.config import DecoderConfig, StreamingConfig
from alivevc_tpu_torch.infer import streaming as tstreaming

from test_torch_port_util import jax_models, max_err, port_models

CFG = dict(chunk=640, buffer_size=4)


@pytest.fixture(scope="module")
def setup():
    params, cfgs = jax_models(0)
    rng = np.random.default_rng(0)
    tgt = rng.standard_normal((200, 64)).astype(np.float32)
    return params, cfgs, port_models(params), tgt


def _speech(n_chunks, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(640 * n_chunks) / 16000.0
    f = 150.0 + 40.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f) / 16000.0
    return (0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def _tone(n, f=220.0, sr=16000, phase=0.0):
    return (0.5 * np.sin(2 * np.pi * f * np.arange(n) / sr + phase)).astype(np.float32)


def test_streaming_step_vs_jax(setup):
    """Eight hops with phi carried on each side, f0 given, pitch shifted."""
    params, cfgs, (ce, f0m, dec), tgt = setup
    jcfg, tcfg = JStreamingConfig(**CFG), StreamingConfig(**CFG)
    jst = jstreaming.init_stream_state(jcfg, cfgs[2])
    tst = tstreaming.init_stream_state(tcfg, dec.cfg, device="cpu")
    x = _speech(8)
    rng = np.random.default_rng(1)
    for h in range(8):
        chunk = x[h * 640:(h + 1) * 640]
        f0 = (100.0 + 200.0 * rng.random((1, 8, 1))).astype(np.float32)
        jst, want = jstreaming.streaming_step(
            params[0], params[1], params[2], jst, jnp.asarray(chunk), jnp.asarray(tgt),
            1.1, 2.0, 4, 0.25, jcfg, cfgs[2], jnp.asarray(f0))
        tst, got = tstreaming.streaming_step(ce, f0m, dec, tst, chunk, torch.from_numpy(tgt),
                                             1.1, 2.0, 4, 0.25, tcfg, None, f0)
        assert got.shape == (640,) and tst.phi.shape == (1, 1, 16)
        assert max_err(got, want) <= 5e-3, h
        assert max_err(tst.phi, jst.phi) <= 2e-3, h
        assert max_err(tst.window, jst.window) == 0.0


def test_streaming_converter_vs_jax(setup):
    """Ten hops through both converters after priming, estimator included."""
    params, cfgs, (ce, f0m, dec), tgt = setup
    x = _speech(14, seed=2)
    jc = jstreaming.StreamingConverter(params[0], params[1], params[2], jnp.asarray(tgt),
                                       JStreamingConfig(**CFG), cfgs[2])
    tc = tstreaming.StreamingConverter(ce, f0m, dec, tgt, StreamingConfig(**CFG), device="cpu")
    jc.prime(x[:4 * 640])
    tc.prime(x[:4 * 640])
    for h in range(4, 14):
        chunk = x[h * 640:(h + 1) * 640]
        want, got = jc.process_chunk(chunk), tc.process_chunk(chunk)
        assert got.shape == (640,) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 5e-3, h


@pytest.fixture(scope="module")
def small_setup(setup):
    _, _, (ce, f0m, dec), tgt = setup
    return ce, f0m, dec, tgt[:64], StreamingConfig(**CFG)


def test_stream_deterministic_after_reset(small_setup):
    ce, f0m, dec, tgt, cfg = small_setup
    conv = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, device="cpu")
    chunks = [_tone(cfg.chunk, phase=i) for i in range(6)]
    out1 = [conv.process_chunk(c) for c in chunks]
    conv.reset()
    out2 = [conv.process_chunk(c) for c in chunks]
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)


def test_stream_output_shape_and_latency(small_setup):
    ce, f0m, dec, tgt, cfg = small_setup
    conv = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, device="cpu")
    out = conv.process_chunk(_tone(cfg.chunk))
    assert out.shape == (cfg.chunk,)
    assert np.isfinite(out).all()
    # the hop returns the window's centre chunk: buffer_size / 2 chunks late
    assert tstreaming.output_span(cfg) == (960, 1600)
    with pytest.raises(ValueError):
        conv.process_chunk(_tone(cfg.chunk + 1))


def test_stream_steady_state_periodic(small_setup):
    """Identical chunks: after buffer_size hops the window is constant and
    only phi evolves; the output stays finite and bounded."""
    ce, f0m, dec, tgt, cfg = small_setup
    conv = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, device="cpu")
    chunk = _tone(cfg.chunk)
    outs = [conv.process_chunk(chunk) for _ in range(cfg.buffer_size + 6)]
    window = conv.state.window.clone()
    conv.process_chunk(chunk)
    assert torch.equal(conv.state.window, window)
    a, b = outs[-2], outs[-1]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(b).max() < 1e3


def test_stream_pipelined_equals_sync_delayed(small_setup):
    """pipeline_depth=1 returns identical chunks one hop late; the first is
    silence and flush() drains the hop in flight."""
    ce, f0m, dec, tgt, cfg = small_setup
    chunks = [_tone(cfg.chunk, phase=i) for i in range(6)]
    sync = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, device="cpu")
    want = [sync.process_chunk(c) for c in chunks]
    pipe = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, pipeline_depth=1, device="cpu")
    got = [pipe.process_chunk(c) for c in chunks]
    np.testing.assert_array_equal(got[0], np.zeros(cfg.chunk, np.float32))
    for a, b in zip(want[:-1], got[1:]):
        np.testing.assert_array_equal(a, b)
    tail = pipe.flush()
    assert len(tail) == 1
    np.testing.assert_array_equal(want[-1], tail[0])
    assert pipe.flush() == []


def test_stream_state_shapes(small_setup):
    _, _, _, _, cfg = small_setup
    st = tstreaming.init_stream_state(cfg, DecoderConfig(), device="cpu")
    assert st.window.shape == (1, cfg.buffer_size * cfg.chunk)
    assert st.phi.shape == (1, 1, 64)
    assert st.window.dtype == st.phi.dtype == torch.float32


def test_streaming_entry_points_need_cuda_unless_asked_for_cpu(small_setup):
    """No CPU fallback (WORLD pitch included), no graph on the CPU; WORLD
    pitch runs on the CPU when asked for by name."""
    ce, f0m, dec, tgt, cfg = small_setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tstreaming.init_stream_state(cfg)
        with pytest.raises(RuntimeError):
            tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg)
        with pytest.raises(RuntimeError):
            tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, world_pitch=True)
    with pytest.raises(ValueError):
        tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, cuda_graph=True, device="cpu")
    conv = tstreaming.StreamingConverter(ce, f0m, dec, tgt, cfg, world_pitch=True, device="cpu")
    out = conv.process_chunk(_tone(cfg.chunk))
    assert out.shape == (cfg.chunk,) and np.isfinite(out).all()
