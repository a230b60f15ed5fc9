"""The port's WORLD pitch path (``alivevc_tpu_torch/ops/world.py``, the native
labeler and ring buffer of ``native_bindings.py``, ``world_pitch`` in both
converters) against the JAX package's on the CPU.

The JAX package's native library is built from its own sources into a
temporary directory (``test_torch_port_util.build_jax_native``) and JAX's
bindings are pointed at it, so both sides run a native labeler whatever a
checkout holds.

Tolerances, with their reasons:
  * the numpy DIO, FixF0Contour, StoneMask and ``compute_f0_dio(use_native=
    False)``: equal (atol 0), the same numpy code on the same input;
  * the native labeler, per item and batched: equal, the same C++ source
    on the same input;
  * ``compute_f0``: the two resamplers to 8 kHz agree to 1e-5 (the same
    float32 filter bank, summed by a convolution on each side), so a frame
    may move by a little: voiced/unvoiced agreement >= 98 % of frames, and
    the frames voiced on both sides within 0.5 Hz;
  * the converters with ``world_pitch``: waveform 5e-3 abs in fp32
    (PARITY.md's decoder tolerance); bf16 within the licence, log-mel L1
    <= 0.25 against JAX's fp32.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from alivevc_tpu import native_bindings as jnative
from alivevc_tpu.config import InferenceConfig as JInferenceConfig
from alivevc_tpu.config import StreamingConfig as JStreamingConfig
from alivevc_tpu.infer import offline as joffline
from alivevc_tpu.infer import streaming as jstreaming
from alivevc_tpu.ops import world as jworld
from alivevc_tpu.ops.resample import resample as jresample
from alivevc_tpu_torch import native_bindings as tnative
from alivevc_tpu_torch.config import InferenceConfig, StreamingConfig
from alivevc_tpu_torch.infer import offline as toffline
from alivevc_tpu_torch.infer import streaming as tstreaming
from alivevc_tpu_torch.kernels import _lib
from alivevc_tpu_torch.ops import world as tworld
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.ops.stft import log_mel_spectrogram

from test_torch_port_util import build_jax_native, jax_models, port_models
from test_world import harmonic_signal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's bindings on a library built here from ``native/*.cpp``."""
    so = build_jax_native(tmp_path_factory.mktemp("jax_native"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATHS", [so])
        mp.setattr(jnative, "_lib", None)
        assert jnative.native_available()
        yield jnative


def _signals():
    fs = 8000
    sigs = {f"harmonic{int(f)}": harmonic_signal(f, fs, 1.0, seed=i)
            for i, f in enumerate((100.0, 220.0, 400.0))}
    t = np.arange(fs) / fs
    sigs["glide"] = 0.5 * np.sin(2 * np.pi * (120.0 * t + 60.0 * t * t)) * (t > 0.3)
    sigs["silence"] = np.zeros(fs)
    return sigs


SIGNALS = _signals()


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_numpy_labeler_equals_jax(name):
    x = SIGNALS[name]
    f0, t = tworld.dio(x, 8000)
    jf0, jt = jworld.dio(x, 8000)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(tworld.stonemask(x, f0, t, 8000), jworld.stonemask(x, jf0, jt, 8000))
    got = tworld.compute_f0_dio(x, use_native=False)
    np.testing.assert_array_equal(got, jworld.compute_f0_dio(x, use_native=False))
    assert got.shape == (8000 // 256,)
    if name == "silence":
        assert not got.any()


def test_fix_f0_contour_equals_jax():
    """Octave jumps, runs shorter than 6 frames, and band candidates to
    extend the surviving runs with."""
    rng = np.random.default_rng(3)
    f0 = np.zeros(80)
    f0[5:30] = 200.0 + rng.normal(0, 2, 25)
    f0[17] = 410.0                       # an octave spike
    f0[34:37] = 150.0                    # too short
    f0[45:70] = 120.0 + rng.normal(0, 1, 25)
    cand = np.where(rng.random((7, 80)) < 0.7, f0[None] * (1 + rng.normal(0, 0.03, (7, 80))), 0.0)
    cand[:, 70:75] = 121.0 + rng.normal(0, 1, (7, 5))
    cand[:, 1:5] = 199.0
    got = tworld.fix_f0_contour(f0.copy(), cand)
    np.testing.assert_array_equal(got, jworld.fix_f0_contour(f0.copy(), cand))
    assert got[17] == 0.0 and not got[34:37].any() and got[70] > 0


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_native_labeler_equals_jax(jax_native, name):
    x = SIGNALS[name]
    for kw in ({}, {"f0_floor": 20.0, "f0_ceil": 4096.0}):
        np.testing.assert_array_equal(tnative.dio_stonemask_native(x, 8000, **kw),
                                      jax_native.dio_stonemask_native(x, 8000, **kw))
    np.testing.assert_array_equal(tworld.compute_f0_dio(x), jworld.compute_f0_dio(x))


def test_native_batch_equals_per_item_and_jax(jax_native):
    fs, n = 8000, 8000
    t = np.arange(n) / fs
    waves = np.stack([(0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)
                      for f in (110.0, 170.0, 230.0, 90.0)])
    batch = tnative.dio_stonemask_native_batch(waves, fs, f0_floor=20.0, f0_ceil=4096.0)
    np.testing.assert_array_equal(
        batch, jax_native.dio_stonemask_native_batch(waves, fs, f0_floor=20.0, f0_ceil=4096.0))
    for i, w in enumerate(waves):
        item = tnative.dio_stonemask_native(w, fs, f0_floor=20.0, f0_ceil=4096.0)
        np.testing.assert_array_equal(batch[i][: len(item)], item)


def test_native_library_is_the_ports_own_build():
    """Built from the port's copy of the sources into ``_build/``; the copy
    is verbatim, and nothing of the JAX package's bindings is loaded."""
    lib = tnative.load_native()
    assert os.path.dirname(lib._name) == str(_lib.BUILD_DIR)
    for src in _lib.NATIVE_SOURCES:
        with open(os.path.join(REPO, "native", src)) as a, open(_lib.NATIVE / src) as b:
            assert a.read() == b.read(), src
    assert tnative.native_available()


def test_ring_buffer_spsc():
    rb = tnative.NativeRingBuffer(4096)
    assert len(rb) == 0
    assert rb.pop(10) is None
    data = np.arange(1000, dtype=np.float32)
    rb.push(data)
    assert len(rb) == 1000
    np.testing.assert_array_equal(rb.pop(600), data[:600])
    assert len(rb) == 400
    rb.push(data)
    np.testing.assert_array_equal(rb.pop(1400), np.concatenate([data[600:], data]))
    assert rb.overruns == 0


def test_ring_buffer_overflow_drops_newest():
    rb = tnative.NativeRingBuffer(256)
    data = np.arange(300, dtype=np.float32)
    assert rb.push(data) == 256          # never overwrites live data
    assert rb.overruns == 44
    assert len(rb) == 256
    np.testing.assert_array_equal(rb.pop(256), data[:256])


def test_ring_buffer_concurrent_stress():
    """A producer and a consumer thread hammer push/pop; the consumed stream
    is exactly the produced one (no torn reads, no loss with retries)."""
    total = 1_000_000
    rb = tnative.NativeRingBuffer(1 << 12)
    seq = np.arange(total, dtype=np.float32)
    consumed = []
    stop = threading.Event()

    def producer():
        rng = np.random.default_rng(1)
        i = 0
        while i < total:
            i += rb.push(seq[i: i + int(rng.integers(1, 1500))])
        stop.set()

    def consumer():
        rng = np.random.default_rng(2)
        got = 0
        while got < total:
            n = min(int(rng.integers(1, 1500)), total - got)
            out = rb.pop(n)
            if out is None:
                if not (stop.is_set() and 0 < len(rb) < n):
                    continue
                out = rb.pop(len(rb))
                if out is None:
                    continue
            consumed.append(out)
            got += len(out)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    np.testing.assert_array_equal(np.concatenate(consumed), seq)


def _speech(n, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f = 150.0 + 40.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f) / sr
    return (0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("sr", [16_000, 22_050])
def test_compute_f0_vs_jax(jax_native, sr):
    n = int(1.2 * sr)
    wave = np.stack([_speech(n, sr, 0), 0.5 * _speech(n, sr, 1)[::-1], np.zeros(n, np.float32)])
    w8 = resample(torch.from_numpy(wave), sr, 8000).numpy()
    assert np.abs(w8 - np.asarray(jresample(jnp.asarray(wave), sr, 8000))).max() <= 1e-5
    got, want = tworld.compute_f0(wave, sr), jworld.compute_f0(wave, sr)
    assert got.shape == want.shape == (3, n // 320) and got.dtype == np.float32
    assert ((got > 0) == (want > 0)).mean() >= 0.98
    both = (got > 0) & (want > 0)
    assert both.sum() > 0.5 * got[:2].size
    assert np.abs(got - want)[both].max() <= 0.5
    assert not got[2].any()


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a native source that does not compile makes the labeler
    raise with the compiler's output, and ``compute_f0`` with it."""
    src = tmp_path / "native"
    src.mkdir()
    for name in _lib.NATIVE_SOURCES:
        (src / name).write_text((_lib.NATIVE / name).read_text())
    (src / "world.cpp").write_text((src / "world.cpp").read_text() + "\nnot C++ at all;\n")
    monkeypatch.setattr(_lib, "NATIVE", src)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="world.cpp"):
        tnative.load_native()
    with pytest.raises(RuntimeError, match="the build failed"):
        tworld.compute_f0(np.zeros((1, 3200), np.float32))


@pytest.fixture(scope="module")
def models():
    params, cfgs = jax_models(0)
    ce, f0m, dec = port_models(params)
    calls = []
    # f0_estimate calls the estimator's layers as modules: a hook on the
    # first one counts the estimator's runs
    f0m.input_layer.register_forward_hook(lambda *_: calls.append(1))
    rng = np.random.default_rng(0)
    tgt = rng.standard_normal((300, 64)).astype(np.float32)
    return params, cfgs, (ce, f0m, dec), tgt, calls


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_offline_converter_world_pitch_vs_jax(jax_native, models, dtype):
    params, cfgs, (ce, f0m, dec), tgt, calls = models
    wave = _speech(8000, 16_000, 2)
    with pltpu.force_tpu_interpret_mode():
        want = joffline.OfflineConverter(
            params[0], params[1], params[2], jnp.asarray(tgt),
            JInferenceConfig(chunk=1600, max_windows_per_step=2), cfgs[2], impl="pallas",
            world_pitch=True).convert_16k(wave)
    conv = toffline.OfflineConverter(ce, f0m, dec, tgt,
                                     InferenceConfig(chunk=1600, max_windows_per_step=2),
                                     world_pitch=True, dtype=dtype, device="cpu")
    before = len(calls)
    got = conv.convert_16k(wave)
    assert len(calls) == before, "the F0 estimator ran under world_pitch"
    assert got.shape == want.shape == wave.shape and np.isfinite(got).all()
    assert 0.05 < np.abs(want).max()
    if dtype == "fp32":
        assert np.abs(got - want).max() <= 5e-3
    else:
        mel = lambda w: log_mel_spectrogram(torch.from_numpy(np.asarray(w, np.float32))[None])  # noqa: E731
        assert float((mel(got) - mel(want)).abs().mean()) <= 0.25
    # the estimator does run without world_pitch: the hook sees it
    toffline.OfflineConverter(ce, f0m, dec, tgt, InferenceConfig(chunk=1600),
                              device="cpu").convert_16k(wave[:3200])
    assert len(calls) > before


CFG = dict(chunk=640, buffer_size=4)


def test_streaming_converter_world_pitch_vs_jax(jax_native, models):
    """20 hops, eager on the CPU, after priming; the host window stays the
    state's window, and the estimator never runs."""
    params, cfgs, (ce, f0m, dec), tgt, calls = models
    x = _speech(640 * 24, 16_000, 3)
    jc = jstreaming.StreamingConverter(params[0], params[1], params[2], jnp.asarray(tgt),
                                       JStreamingConfig(**CFG), cfgs[2], world_pitch=True)
    tc = tstreaming.StreamingConverter(ce, f0m, dec, tgt, StreamingConfig(**CFG),
                                       world_pitch=True, device="cpu")
    jc.prime(x[:4 * 640])
    tc.prime(x[:4 * 640])
    before = len(calls)
    for h in range(4, 24):
        chunk = x[h * 640:(h + 1) * 640]
        want, got = jc.process_chunk(chunk), tc.process_chunk(chunk)
        assert got.shape == (640,) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 5e-3, h
        np.testing.assert_array_equal(tc.state.window[0].numpy(), tc._host_window)
    assert len(calls) == before, "the F0 estimator ran under world_pitch"
    tc.reset()
    assert not tc._host_window.any() and not tc.state.window.any()


def test_streaming_world_pitch_pipelined_equals_sync_delayed(jax_native, models):
    _, _, (ce, f0m, dec), tgt, _ = models
    x = _speech(640 * 6, 16_000, 4)
    chunks = [x[i * 640:(i + 1) * 640] for i in range(6)]
    sync = tstreaming.StreamingConverter(ce, f0m, dec, tgt[:64], StreamingConfig(**CFG),
                                         world_pitch=True, device="cpu")
    want = [sync.process_chunk(c) for c in chunks]
    pipe = tstreaming.StreamingConverter(ce, f0m, dec, tgt[:64], StreamingConfig(**CFG),
                                         world_pitch=True, pipeline_depth=1, device="cpu")
    got = [pipe.process_chunk(c) for c in chunks] + pipe.flush()
    assert not got[0].any() and len(got) == 7
    for a, b in zip(want, got[1:]):
        np.testing.assert_array_equal(a, b)
