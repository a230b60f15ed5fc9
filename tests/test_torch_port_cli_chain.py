"""The port's CLIs on their default file names, one after another in one
working directory, on the CPU at the test widths; and every default the
port's parsers share with the JAX package's.

The chain: ``train_content_encoder`` (``--teacher-features`` from a seeded
``.npz``), ``train_f0_estimator``, ``generate_voice_library``,
``train_decoder``, ``fine_tune`` and ``inference``.  No model path is
passed but where the JAX defaults leave a gap: the JAX ``train_decoder``
writes only ``gan_state.ckpt``, while ``fine_tune`` reads ``-dep
decoder.ckpt`` and ``-disp discriminator.ckpt``, so ``fine_tune`` gets
``-dep gan_state.ckpt -disp gan_state.ckpt``.  Before the trainers' first
runs, their states are written at the test widths under the default names;
the trainers resume by existence, so they keep those widths.

Each stage must build every model from the file the stage before it wrote
(state-dict-equal to it) and print a line naming that file; a missing file
prints the seed-0 line instead.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from alivevc_tpu_torch import config as tc
from alivevc_tpu_torch.cli import fine_tune, generate_voice_library, inference
from alivevc_tpu_torch.cli import train_content_encoder, train_decoder, train_f0_estimator
from alivevc_tpu_torch.compat import jax_train_state
from alivevc_tpu_torch.compat.torch_import import load_params_or_init, reference_state
from alivevc_tpu_torch.io.audio import write_wav
from alivevc_tpu_torch.models.content_encoder import ContentEncoder
from alivevc_tpu_torch.models.decoder import Decoder
from alivevc_tpu_torch.models.discriminator import Discriminator
from alivevc_tpu_torch.models.f0_estimator import F0Estimator
from alivevc_tpu_torch.train.distill import init_distill
from alivevc_tpu_torch.train.f0 import init_f0_train
from alivevc_tpu_torch.train.gan import init_gan

from test_torch_port_util import CE_KW, DEC_KW, DISC_KW, F0_KW, train_wave

CLIS = ("inference", "realtime_inference", "train_content_encoder", "train_f0_estimator",
        "generate_voice_library", "train_decoder", "fine_tune", "export")
CPU = ["--device", "cpu"]


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _spy(monkeypatch, modules):
    """Record (kind, path, a copy of the state dict) of every model the CLI
    modules build through ``load_params_or_init``."""
    built = []

    def spy(path, kind, device):
        module = load_params_or_init(path, kind, device)
        built.append((kind, path, {k: v.clone() for k, v in module.state_dict().items()}))
        return module

    for m in modules:
        monkeypatch.setattr(m, "load_params_or_init", spy)
    return built


def _assert_built_from(built, want):
    """Every model built is one of ``want`` {(kind, path): state dict read
    from the file before the stage}, equal to it, and each was built."""
    assert sorted((k, p) for k, p, _ in built) == sorted(want), (built, want)
    for kind, path, sd in built:
        ref = want[(kind, path)]
        assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd), (kind, path)


def _state(path: str, kind: str) -> dict:
    return {k: torch.as_tensor(v) for k, v in reference_state(path, kind).items()}


def _files(*pairs):
    return {(kind, path): _state(path, kind) for kind, path in pairs}


def test_default_chain_reads_each_stage_s_files(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    os.makedirs("inputs")
    write_wav("data/0.wav", train_wave(1, 21_000, seed=31)[0], 16_000)
    write_wav("inputs/voice.wav", train_wave(1, 16_000, seed=32)[0], 16_000)
    np.savez("feats.npz", features=0.1 * np.random.default_rng(33).standard_normal(
        (3, 20, CE_KW["output_channels"])).astype(np.float32))
    g = torch.Generator().manual_seed(30)
    jax_train_state.write("content_encoder.ckpt", init_distill(
        ContentEncoder(tc.ContentEncoderConfig(**CE_KW), generator=g)))
    jax_train_state.write("f0_estimator.ckpt", init_f0_train(
        F0Estimator(tc.F0EstimatorConfig(**F0_KW), generator=g)))
    jax_train_state.write("gan_state.ckpt", init_gan(
        Decoder(tc.DecoderConfig(**DEC_KW), generator=g),
        Discriminator(tc.DiscriminatorConfig(**DISC_KW), generator=g)))
    capsys.readouterr()

    def lines():
        out = capsys.readouterr().out
        assert "seed-" not in out, out
        return out.splitlines()

    # 1-2: the two trainers resume the states under their default names
    state = train_content_encoder.main(["data", "--teacher-features", "feats.npz", "-e", "1",
                                        "-b", "3", "-len", "6400", *CPU])
    out = lines()
    assert state.step == 1 and "resumed at step 0" in out
    assert "content_encoder: content_encoder.ckpt (JAX training state, step 0)" in out
    state = train_f0_estimator.main(["data", "-e", "1", "-b", "3", "-len", "6400", *CPU])
    out = lines()
    assert state.step == 1 and "f0_estimator: f0_estimator.ckpt (JAX training state, step 0)" in out
    ce_line = "content_encoder: content_encoder.ckpt (JAX training state, step 1)"
    f0_line = "f0_estimator: f0_estimator.ckpt (JAX training state, step 1)"

    # 3: the library from the trained encoder
    built = _spy(monkeypatch, [generate_voice_library])
    want = _files(("content_encoder", "content_encoder.ckpt"))
    vl = generate_voice_library.main(["data", *CPU])
    _assert_built_from(built, want)
    assert ce_line in lines() and vl.matrix().shape[1] == CE_KW["output_channels"]

    # 4: the GAN with the trained encoder and estimator
    built = _spy(monkeypatch, [train_decoder])
    want = _files(("content_encoder", "content_encoder.ckpt"), ("f0_estimator", "f0_estimator.ckpt"))
    state = train_decoder.main(["data", "-e", "1", "-b", "2", "-len", "9600", *CPU])
    _assert_built_from(built, want)
    out = lines()
    assert {ce_line, f0_line, "decoder: gan_state.ckpt (JAX training state, step 0)",
            "discriminator: gan_state.ckpt (JAX training state, step 0)"} <= set(out)
    assert state.step == 1

    # 5: fine-tuning from the GAN state, with the library; the GAN state stays as it was
    built = _spy(monkeypatch, [fine_tune])
    want = _files(("content_encoder", "content_encoder.ckpt"), ("f0_estimator", "f0_estimator.ckpt"),
                  ("decoder", "gan_state.ckpt"), ("discriminator", "gan_state.ckpt"),
                  ("voice_library", "voice_library.ckpt"))
    gan_digest = _digest("gan_state.ckpt")
    state = fine_tune.main(["data", "-dep", "gan_state.ckpt", "-disp", "gan_state.ckpt", "-e", "1",
                            "-b", "1", "-len", "9600", "--max-step", "1", *CPU])
    _assert_built_from(built, want)
    out = lines()
    assert {ce_line, f0_line, "decoder: gan_state.ckpt (JAX training state, step 1)",
            "discriminator: gan_state.ckpt (JAX training state, step 1)",
            "voice_library: voice_library.ckpt (JAX parameter tree)",
            "decoder: gan_state.ckpt is a training state; the fine-tuned decoder goes to "
            "decoder.ckpt"} <= set(out)
    assert state.step == 1 and _digest("gan_state.ckpt") == gan_digest
    assert all(torch.equal(v, state.dec.state_dict()[k])
               for k, v in _state("decoder.ckpt", "decoder").items())
    assert jax_train_state.read("fine_tune_state.ckpt", "fine_tune", "cpu").step == 1

    # 6: inference with the fine-tuned decoder
    built = _spy(monkeypatch, [inference])
    want = _files(("content_encoder", "content_encoder.ckpt"), ("f0_estimator", "f0_estimator.ckpt"),
                  ("decoder", "decoder.ckpt"))
    outs = inference.main(["-t", "data/0.wav", "-c", "9600", *CPU])
    _assert_built_from(built, want)
    assert {ce_line, f0_line, "decoder: decoder.ckpt (JAX parameter tree)"} <= set(lines())
    assert len(outs) == 1 and outs[0].shape == (16_000,) and np.isfinite(outs[0]).all()
    assert os.path.exists("outputs/0_voice.wav")


def test_a_missing_default_file_prints_the_seed_0_line(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    write_wav("data/0.wav", train_wave(1, 16_000, seed=34)[0], 16_000)
    vl = generate_voice_library.main(["data", *CPU])
    assert "content_encoder: no file at content_encoder.ckpt, seed-0 weights" in \
        capsys.readouterr().out.splitlines()
    assert vl.matrix().shape[1] == tc.ContentEncoderConfig().output_channels


def test_fine_tune_refuses_to_write_its_decoder_over_a_training_state(tmp_path, monkeypatch):
    """A training state named ``decoder.ckpt`` as ``-dep``: the decoder's
    one other place is the file itself, so the run stops before training."""
    monkeypatch.chdir(tmp_path)
    g = torch.Generator().manual_seed(35)
    jax_train_state.write("decoder.ckpt", init_gan(
        Decoder(tc.DecoderConfig(**DEC_KW), generator=g),
        Discriminator(tc.DiscriminatorConfig(**DISC_KW), generator=g)))
    with pytest.raises(SystemExit, match="would be written over it"):
        fine_tune.main(["data", *CPU])


@pytest.mark.parametrize("name", CLIS)
def test_parser_defaults_match_the_jax_package(name):
    """For every flag both packages' parsers have, the same option strings
    and default.  ``--device`` is the port's alone; ``--impl`` names the
    compute path, and the port has one, its kernels ('xla' and 'pallas' are
    the JAX package's)."""
    import importlib

    jax_parser = importlib.import_module(f"alivevc_tpu.cli.{name}").build_parser()
    port_parser = importlib.import_module(f"alivevc_tpu_torch.cli.{name}").build_parser()
    jax_actions = {a.dest: a for a in jax_parser._actions}
    port_actions = {a.dest: a for a in port_parser._actions}
    assert set(port_actions) - set(jax_actions) == {"device"}
    assert set(jax_actions) <= set(port_actions)
    for dest, a in jax_actions.items():
        b = port_actions[dest]
        assert a.option_strings == b.option_strings, dest
        if dest == "impl":
            assert (a.default, b.default, b.choices) == ("xla", "kernels", ["kernels"])
            continue
        assert (a.default, a.type, a.nargs) == (b.default, b.type, b.nargs), dest
