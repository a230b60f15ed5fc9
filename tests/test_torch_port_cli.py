"""The port's audio boundary: resampling, checkpoints and the two inference
CLIs in file mode, against the JAX package on the CPU.

Tolerances: resampling 1e-5 abs (the same float32 filter bank, summed by a
convolution instead of a product); checkpoints bit-equal to the weight
bridge; the offline CLI 5e-3 abs against JAX ``OfflineConverter.convert``
(PARITY.md's decoder tolerance; both sides read the same 16-bit input, and
the CLI's 16-bit output adds at most 2^-15); the realtime CLI equal to the
port's ``StreamingConverter`` run directly, after the same 16-bit rounding.
Models are the small-width ones of tests/test_torch_port_util.py, written
to disk by the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu import native_bindings as jnative
from alivevc_tpu.compat import torch_export
from alivevc_tpu.config import InferenceConfig as JInferenceConfig
from alivevc_tpu.config import StreamingConfig as JStreamingConfig
from alivevc_tpu.config import VoiceLibraryConfig
from alivevc_tpu.infer import offline as joffline
from alivevc_tpu.infer import streaming as jstreaming
from alivevc_tpu.io.checkpoint import load_checkpoint as jload_checkpoint
from alivevc_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
from alivevc_tpu.models.voice_library import init_voice_library
from alivevc_tpu.ops.resample import resample as jresample
from alivevc_tpu.ops.stft import log_mel_spectrogram as jlog_mel
from alivevc_tpu_torch.cli import common, inference, realtime_inference
from alivevc_tpu_torch.compat import weights
from alivevc_tpu_torch.config import StreamingConfig
from alivevc_tpu_torch.infer.streaming import StreamingConverter
from alivevc_tpu_torch.io import checkpoint
from alivevc_tpu_torch.io.audio import read_wav, write_wav
from alivevc_tpu_torch.ops.resample import resample
from alivevc_tpu_torch.utils import plotting as tplotting

from test_torch_port_util import build_jax_native, jax_models
from test_torch_port_world import _speech

KINDS = ("content_encoder", "f0_estimator", "decoder")


@pytest.mark.parametrize("orig,new", [(24_000, 16_000), (44_100, 16_000), (22_050, 16_000),
                                      (16_000, 24_000), (16_000, 44_100)])
def test_resample_vs_jax(orig, new):
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 4001))).astype(np.float32)
    want = np.asarray(jresample(jnp.asarray(x), orig, new))
    got = resample(torch.from_numpy(x), orig, new)
    assert got.shape == want.shape == (2, -(-new * 4001 // orig))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The small-width models as JAX .npz checkpoints and as reference .pt
    state dicts, a voice library .pt, and the JAX params."""
    d = tmp_path_factory.mktemp("models")
    params, cfgs = jax_models(0)
    exports = (torch_export.export_content_encoder(params[0]),
               torch_export.export_f0_estimator(params[1]),
               torch_export.export_decoder(params[2], cfgs[2]))
    paths = {}
    for kind, p, sd in zip(KINDS, params, exports):
        jsave_checkpoint(str(d / f"{kind}.npz"), p)
        torch_export.save_torch_state_dict(str(d / f"{kind}.pt"), sd)
        paths[kind] = (str(d / f"{kind}.npz"), str(d / f"{kind}.pt"))
    lib = init_voice_library(jax.random.PRNGKey(5))
    torch_export.save_torch_state_dict(str(d / "library.pt"), torch_export.export_voice_library(lib))
    jsave_checkpoint(str(d / "library.npz"), lib)
    # a library of the small models' width, for the CLIs
    small = init_voice_library(jax.random.PRNGKey(6), VoiceLibraryConfig(num_tokens=32, dim=64))
    torch_export.save_torch_state_dict(str(d / "small_library.pt"),
                                       torch_export.export_voice_library(small))
    return d, params, cfgs, paths, lib


def test_checkpoints_load_bit_equal_to_the_bridge(files):
    """Both formats give the modules exactly the weight bridge's state dict."""
    _, params, cfgs, paths, lib = files
    bridge = {"content_encoder": weights.content_encoder_state(params[0]),
              "f0_estimator": weights.f0_estimator_state(params[1]),
              "decoder": weights.decoder_state(params[2], cfgs[2])}
    for kind in KINDS:
        for path in paths[kind]:
            module = common.load_params_or_init(path, kind, torch.device("cpu"))
            sd = module.state_dict()
            assert sorted(sd) == sorted(bridge[kind]), path
            for k, v in bridge[kind].items():
                np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=f"{path}: {k}")
    assert common.load_params_or_init(paths["decoder"][0], "decoder", torch.device("cpu")).cfg \
        == weights.decoder_config(bridge["decoder"])
    for path in ("library.pt", "library.npz"):
        vl = common.load_params_or_init(str(files[0] / path), "voice_library", torch.device("cpu"))
        tokens = vl.matrix()
        assert tokens.shape == (512, 768)
        np.testing.assert_array_equal(tokens.detach().numpy(), np.asarray(lib["tokens"]))


def test_checkpoint_writer_round_trips_through_jax(files, tmp_path):
    """The port writes the JAX format: JAX reads it back into its own tree,
    and the port's reader rebuilds dicts, lists, tuples and None."""
    _, params, _, _, _ = files
    tree = {"dec": params[2], "step": np.int32(7), "pair": (np.ones(2), None), "empty": None}
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, tree)
    back = jload_checkpoint(path, tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mine = checkpoint.load_checkpoint(path)
    assert mine["pair"][1] is None and mine["empty"] is None and isinstance(mine["pair"], tuple)
    assert isinstance(mine["dec"]["filter"]["ups"], list)
    np.testing.assert_array_equal(mine["dec"]["filter"]["ups"][2]["w"],
                                  np.asarray(params[2]["filter"]["ups"][2]["w"]))


def test_missing_checkpoint_initialises_from_seed_0():
    a = common.load_params_or_init(None, "f0_estimator", torch.device("cpu"))
    b = common.load_params_or_init("no/such/file.pt", "f0_estimator", torch.device("cpu"))
    assert a.cfg == weights.f0_estimator_config(a.state_dict())
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def _wave(sr, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * (140 + 30 * t) * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("sr", [16_000, 22_050])
def test_offline_cli_vs_jax(files, tmp_path, sr):
    d, params, cfgs, paths, _ = files
    (tmp_path / "in").mkdir()
    write_wav(str(tmp_path / "in" / "a.wav"), _wave(sr, 0.35, 1), sr)
    write_wav(str(tmp_path / "target.wav"), _wave(16_000, 0.5, 2), 16_000)
    inference.main([
        "-i", str(tmp_path / "in"), "-o", str(tmp_path / "out"), "-t", str(tmp_path / "target.wav"),
        "-cep", paths["content_encoder"][0], "-f0ep", paths["f0_estimator"][1],
        "-dep", paths["decoder"][0], "-c", "1600", "-p", "1.5", "-g", "-30", "--device", "cpu"])
    got, got_sr = read_wav(str(tmp_path / "out" / "0_a.wav"))

    wave, _ = read_wav(str(tmp_path / "in" / "a.wav"))
    tw, _ = read_wav(str(tmp_path / "target.wav"))
    tgt = joffline.build_target_matrix(params[0], target_wave=tw[0] / np.abs(tw).max())
    conv = joffline.OfflineConverter(params[0], params[1], params[2], tgt,
                                     JInferenceConfig(chunk=1600, pitch_shift=1.5, gain_db=-30.0),
                                     cfgs[2])
    want = conv.convert(wave, sr)
    assert got_sr == sr and got.shape == (1, want.shape[0])
    assert 0.05 < np.abs(want).max() < 1.0     # -30 dB keeps the random models' output unclipped
    assert float(np.abs(got[0] - want).max()) <= 5e-3


def test_realtime_cli_equals_streaming_converter(files, tmp_path):
    d, _, _, paths, _ = files
    write_wav(str(tmp_path / "in.wav"), _wave(16_000, 0.5, 3), 16_000)
    write_wav(str(tmp_path / "target.wav"), _wave(16_000, 0.5, 4), 16_000)
    argv = ["--input-wav", str(tmp_path / "in.wav"), "--output-wav", str(tmp_path / "out.wav"),
            "-t", str(tmp_path / "target.wav"), "-lib", str(d / "small_library.pt"),
            "-cep", paths["content_encoder"][1], "-f0ep", paths["f0_estimator"][0],
            "-dep", paths["decoder"][1], "-c", "640", "-b", "4", "-p", "-2", "-g", "-30",
            "--device", "cpu"]
    realtime_inference.main(argv)
    got, got_sr = read_wav(str(tmp_path / "out.wav"))

    cpu = torch.device("cpu")
    args = realtime_inference.build_parser().parse_args(argv)
    ce, f0m, dec = (common.load_params_or_init(p, k, cpu) for p, k in zip(
        (paths["content_encoder"][1], paths["f0_estimator"][0], paths["decoder"][1]), KINDS))
    tgt = common.target_matrix(args, ce, cpu, decimation=4)
    assert tgt.shape[0] == 25 // 4 + 1 + 32
    conv = StreamingConverter(ce, f0m, dec, tgt, StreamingConfig(chunk=640, buffer_size=4,
                                                                 pitch_shift=-2.0),
                              pipeline_depth=1, device="cpu")
    wave, _ = read_wav(str(tmp_path / "in.wav"))
    outs = [conv.process_chunk(wave[0, i * 640:(i + 1) * 640]) for i in range(12)]
    want = np.concatenate(outs[1:] + conv.flush()) * 10.0 ** (-30 / 20)
    assert 0.05 < np.abs(want).max() < 1.0
    want16 = (np.clip(want, -1, 1) * 32767.0).astype(np.int16) / 32768.0
    assert got_sr == 16_000
    np.testing.assert_array_equal(got[0], want16.astype(np.float32))


def test_cli_flags_of_later_slices_and_the_device_rule(files, tmp_path, monkeypatch):
    """``-wpe`` and ``--save-spectrograms`` (once refused as later slices) on
    the CPU: the offline CLI against JAX ``OfflineConverter(world_pitch=True)
    .convert`` (what JAX's CLI runs) within 5e-3, with two PNGs a file whose
    plotted log-mels are JAX's within 1e-3 (input) and 5e-2 (output: the
    waves differ by up to 5e-3); the realtime CLI against JAX
    ``StreamingConverter(world_pitch=True)`` within 5e-3 plus the 16-bit
    rounding.  Both sides label pitch with a native library built from the
    same source.  Then the device rule: without CUDA, the CLIs raise."""
    d, params, cfgs, paths, _ = files
    monkeypatch.setattr(jnative, "_LIB_PATHS", [build_jax_native(tmp_path)])
    monkeypatch.setattr(jnative, "_lib", None)
    plotted = []
    real_plot = tplotting.plot_spectrogram
    monkeypatch.setattr(tplotting, "plot_spectrogram",
                        lambda spec, path, log=True: (plotted.append(spec), real_plot(spec, path, log)))

    sr = 22_050
    (tmp_path / "in").mkdir()
    write_wav(str(tmp_path / "in" / "a.wav"), _speech(int(0.4 * sr), sr, 5), sr)
    write_wav(str(tmp_path / "target.wav"), _wave(16_000, 0.5, 2), 16_000)
    inference.main([
        "-i", str(tmp_path / "in"), "-o", str(tmp_path / "out"), "-t", str(tmp_path / "target.wav"),
        "-cep", paths["content_encoder"][0], "-f0ep", paths["f0_estimator"][1],
        "-dep", paths["decoder"][0], "-c", "1600", "-g", "-30", "-wpe", "--save-spectrograms",
        "--device", "cpu"])
    got, got_sr = read_wav(str(tmp_path / "out" / "0_a.wav"))
    wave, _ = read_wav(str(tmp_path / "in" / "a.wav"))
    tw, _ = read_wav(str(tmp_path / "target.wav"))
    tgt = joffline.build_target_matrix(params[0], target_wave=tw[0] / np.abs(tw).max())
    want = joffline.OfflineConverter(params[0], params[1], params[2], tgt,
                                     JInferenceConfig(chunk=1600, gain_db=-30.0), cfgs[2],
                                     world_pitch=True).convert(wave, sr)
    assert got_sr == sr and got.shape == (1, want.shape[0])
    assert 0.05 < np.abs(want).max() < 1.0
    assert float(np.abs(got[0] - want).max()) <= 5e-3
    for tag in ("input", "output"):
        png = tmp_path / "out" / f"0_a_{tag}_spec.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(plotted) == 2
    for spec, w, tol in ((plotted[0], wave[0], 1e-3), (plotted[1], want, 5e-2)):
        ref = np.asarray(jlog_mel(jnp.asarray(w, jnp.float32)[None], sr))[0]
        assert spec.shape == ref.shape and float(np.abs(spec - ref).max()) <= tol

    write_wav(str(tmp_path / "rt_in.wav"), _speech(8000, 16_000, 6), 16_000)
    realtime_inference.main([
        "--input-wav", str(tmp_path / "rt_in.wav"), "--output-wav", str(tmp_path / "rt_out.wav"),
        "-t", str(tmp_path / "target.wav"), "-cep", paths["content_encoder"][1],
        "-f0ep", paths["f0_estimator"][0], "-dep", paths["decoder"][1], "-c", "640", "-b", "4",
        "-g", "-30", "-wpe", "--device", "cpu"])
    rt, _ = read_wav(str(tmp_path / "rt_out.wav"))
    x, _ = read_wav(str(tmp_path / "rt_in.wav"))
    jtgt = joffline.build_target_matrix(params[0], target_wave=tw[0] / np.abs(tw).max(),
                                        decimation=4)
    jconv = jstreaming.StreamingConverter(params[0], params[1], params[2], jtgt,
                                          JStreamingConfig(chunk=640, buffer_size=4), cfgs[2],
                                          world_pitch=True, pipeline_depth=1)
    outs = [jconv.process_chunk(x[0, i * 640:(i + 1) * 640]) for i in range(12)]
    rt_want = np.concatenate(outs[1:] + jconv.flush()) * 10.0 ** (-30 / 20)
    assert rt.shape == (1, rt_want.shape[0]) and 0.05 < np.abs(rt_want).max() < 1.0
    assert float(np.abs(rt[0] - rt_want).max()) <= 5e-3 + 2.0 ** -15

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            inference.main(["-i", str(tmp_path), "-o", str(tmp_path / "o")])
        with pytest.raises(RuntimeError):
            realtime_inference.main(["--input-wav", str(tmp_path / "x.wav")])
