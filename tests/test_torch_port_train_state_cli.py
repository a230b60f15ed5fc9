"""The port's training CLIs on JAX-written ``.ckpt`` files (part (e) of
``tests/test_torch_port_train_state.py``), on the CPU at the test widths,
over a temporary directory of synthetic WAVs.

Every file a CLI starts from is written by the JAX package's own
``save_checkpoint``: a ``GanState``, ``FineTuneState``, ``F0TrainState``
and ``DistillState`` at step 2 with nonzero moments, and parameter trees of
the decoder, discriminator and library.  The JAX CLIs cannot write them:
they build full-width templates.  Each port CLI resumes ("resumed at step
2"), trains, and writes ``.ckpt`` files that JAX ``load_checkpoint`` reads
into its own templates (``init_*``'s shapes).  The inference CLIs' loader
takes a model out of a JAX training state, which the JAX trainers write by
default (``content_encoder.ckpt``, ``f0_estimator.ckpt``), and refuses a
state that holds no model of the kind asked for.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from alivevc_tpu import config as jc
from alivevc_tpu.io.checkpoint import load_checkpoint as jload_checkpoint
from alivevc_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
from alivevc_tpu.models.content_encoder import init_content_encoder
from alivevc_tpu.models.decoder import init_decoder
from alivevc_tpu.models.discriminator import init_discriminator
from alivevc_tpu.models.f0_estimator import init_f0_estimator
from alivevc_tpu.models.voice_library import init_voice_library
from alivevc_tpu.train import distill as jdistill
from alivevc_tpu.train import f0 as jf0
from alivevc_tpu.train import fine_tune as jft
from alivevc_tpu.train import gan as jgan
from alivevc_tpu.train.optim import radam
from alivevc_tpu_torch.cli import common, inference
from alivevc_tpu_torch.cli import fine_tune as cli_ft
from alivevc_tpu_torch.cli import generate_voice_library as cli_lib
from alivevc_tpu_torch.cli import train_content_encoder as cli_ce
from alivevc_tpu_torch.cli import train_decoder as cli_gan
from alivevc_tpu_torch.cli import train_f0_estimator as cli_f0
from alivevc_tpu_torch.io.audio import write_wav

from test_torch_port_util import (
    CE_KW,
    DEC_KW,
    DISC_KW,
    F0_KW,
    VL_KW,
    jax_train_state,
    noise_tree,
    state_models,
    train_wave,
)

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")


def _at_step_2(tree):
    """``tree`` (a JAX training state) as after two updates: every Adam
    count and schedule count 2, moments drawn (nu positive), step 2."""
    two = jnp.asarray(2, jnp.int32)

    def opt(state, seed):
        if state is None:
            return None
        adam = state[0]._replace(count=two, mu=noise_tree(state[0].mu, seed, 1e-3),
                                 nu=jax.tree_util.tree_map(np.abs,
                                                           noise_tree(state[0].nu, seed + 1, 1e-3)))
        rest = tuple(s._replace(count=two) if "count" in s._fields else s for s in state[1:])
        return (adam, *rest)

    fields = {f: opt(getattr(tree, f), 10 * i) for i, f in enumerate(tree._fields)
              if f.endswith("opt") or f == "opt_state"}
    return tree._replace(step=two, **fields)


def _shapes(fn):
    return jax.eval_shape(fn)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_state_cli")
    data = tmp / "data"
    data.mkdir()
    for i, w in enumerate(train_wave(2, 21_000, seed=11)):
        write_wav(str(data / f"{i}.wav"), w, 16_000)
    params, _ = state_models()
    paths = {}
    for name, tree in (("gan", _at_step_2(jax_train_state("gan", params))),
                       ("fine_tune", _at_step_2(jax_train_state("fine_tune", params))),
                       ("f0", _at_step_2(jax_train_state("f0", params))),
                       ("distill", _at_step_2(jax_train_state("distill", params))),
                       ("dec", params["dec"]), ("disc", params["disc"]), ("vl", params["vl"]),
                       ("ce", params["ce"])):
        paths[name] = str(tmp / f"{name}.ckpt")
        jsave_checkpoint(paths[name], tree)
    return tmp, data, params, paths


def _copy(src: str, dst) -> str:
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    return str(dst)


def _jax_reads(path: str, template):
    """JAX ``load_checkpoint`` of ``path`` into ``template``, with every
    leaf's shape and dtype equal to the template's."""
    back = jload_checkpoint(path, template)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(template)
    for a, s in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(template)):
        assert (a.shape, a.dtype) == (s.shape, s.dtype)
    return back


def _params_shapes():
    return {"ce": _shapes(lambda: init_content_encoder(KEY, jc.ContentEncoderConfig(**CE_KW))),
            "f0": _shapes(lambda: init_f0_estimator(KEY, jc.F0EstimatorConfig(**F0_KW))),
            "dec": _shapes(lambda: init_decoder(KEY, jc.DecoderConfig(**DEC_KW))),
            "disc": _shapes(lambda: init_discriminator(KEY, jc.DiscriminatorConfig(**DISC_KW))),
            "vl": _shapes(lambda: init_voice_library(KEY, jc.VoiceLibraryConfig(**VL_KW)))}


def test_train_decoder_cli_resumes_a_jax_gan_state(files, capsys):
    tmp, data, _, paths = files
    sp = _copy(paths["gan"], tmp / "gan_run.ckpt")
    state = cli_gan.main([str(data), "-sp", sp, "-cep", paths["distill"], "-f0ep", paths["f0"],
                          "-e", "1", "-b", "2", "-len", "9600", "--device", "cpu"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert state.step == 4                 # 2 + 2 chunks of 9 600 samples: 2 batches
    back = _jax_reads(sp, _shapes(lambda: jgan.init_gan(
        KEY, jc.TrainConfig(), jc.DecoderConfig(**DEC_KW), jc.DiscriminatorConfig(**DISC_KW))))
    assert int(back.step) == 4
    assert int(back.dec_opt[0].count) == int(back.dec_opt[2].count) == int(back.disc_opt[0].count) == 4


def test_fine_tune_cli_resumes_a_jax_state_and_writes_jax_files(files, capsys):
    tmp, data, params, paths = files
    sp = _copy(paths["fine_tune"], tmp / "ft_run.ckpt")
    dep, lib = str(tmp / "ft_decoder.ckpt"), str(tmp / "ft_library.ckpt")
    args = [str(data), "-dep", dep, "-disp", paths["disc"], "-cep", paths["ce"], "-f0ep",
            paths["f0"], "-sp", sp, "-e", "2", "-b", "1", "-len", "9600", "--device", "cpu"]
    state = cli_ft.main(args + ["-lib", lib, "--max-step", "3"])
    assert "resumed at step 2" in capsys.readouterr().out and state.step == 3
    shapes = _params_shapes()
    back = _jax_reads(sp, _shapes(lambda: jft.init_fine_tune(
        shapes["dec"], shapes["disc"], shapes["vl"], jc.TrainConfig())))
    assert int(back.step) == 3 and int(back.vl_opt[0].count) == 3
    dec = _jax_reads(dep, shapes["dec"])
    assert np.array_equal(np.asarray(dec["filter"]["ups"][1]["w"]),
                          np.asarray(back.dec_params["filter"]["ups"][1]["w"]))
    tokens = np.asarray(_jax_reads(lib, shapes["vl"])["tokens"])
    assert np.array_equal(tokens, np.asarray(back.vl_params["tokens"]))
    assert not np.array_equal(tokens, np.asarray(params["vl"]["tokens"]))   # the library trained
    with pytest.raises(SystemExit, match="holds a voice library, but -lib is NONE"):
        cli_ft.main(args + ["-lib", "NONE"])


def test_train_f0_estimator_cli_resumes_a_jax_state(files, capsys):
    tmp, data, _, paths = files
    mp = _copy(paths["f0"], tmp / "f0_run.ckpt")
    state = cli_f0.main([str(data), "-mp", mp, "-e", "1", "-b", "2", "-len", "6400",
                         "--device", "cpu"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert state.step == 5                 # 3 + 3 chunks of 6 400 samples: 3 batches
    p = _params_shapes()["f0"]
    back = _jax_reads(mp, _shapes(lambda: jf0.F0TrainState(p, radam().init(p),
                                                           jnp.zeros((), jnp.int32))))
    assert int(back.step) == int(back.opt_state[0].count) == 5


def test_train_content_encoder_cli_resumes_a_jax_state(files, capsys):
    tmp, data, _, paths = files
    mp = _copy(paths["distill"], tmp / "ce_run.ckpt")
    feats = str(tmp / "feats.npz")
    np.savez(feats, features=0.1 * np.random.default_rng(3).standard_normal(
        (6, 20, CE_KW["output_channels"])).astype(np.float32))
    state = cli_ce.main([str(data), "-mp", mp, "--teacher-features", feats, "-e", "1", "-b", "2",
                         "-len", "6400", "--device", "cpu"])
    assert "resumed at step 2" in capsys.readouterr().out and state.step == 5
    p = _params_shapes()["ce"]
    back = _jax_reads(mp, _shapes(lambda: jdistill.DistillState(p, radam().init(p),
                                                                jnp.zeros((), jnp.int32))))
    assert int(back.step) == int(back.opt_state[0].count) == 5


def test_generate_voice_library_cli_writes_a_jax_library(files):
    tmp, data, _, paths = files
    out = str(tmp / "generated.ckpt")
    vl = cli_lib.main([str(data), "-lib", out, "-cep", paths["distill"], "--device", "cpu"])
    tokens = np.asarray(_jax_reads(out, _params_shapes()["vl"])["tokens"])
    assert np.array_equal(tokens, vl.matrix().detach().numpy())


def test_inference_reads_a_model_out_of_a_jax_training_state(files, tmp_path):
    """``inference -cep`` on a JAX ``DistillState`` gives what its
    parameters alone give; the loader takes each model out of its state and
    refuses a state without one."""
    tmp, data, _, paths = files
    a = common.load_params_or_init(paths["distill"], "content_encoder", CPU)
    b = common.load_params_or_init(paths["ce"], "content_encoder", CPU)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    outs = []
    for cep in (paths["distill"], paths["ce"]):
        outs.append(inference.main(["-i", str(data), "-o", str(tmp_path / os.path.basename(cep)),
                                    "-cep", cep, "-f0ep", paths["f0"], "-dep", paths["dec"],
                                    "-t", str(data / "0.wav"), "-c", "9600", "--device", "cpu"]))
    assert all(np.array_equal(x, y) for x, y in zip(*outs)) and len(outs[0]) == 2
    for path, kind in ((paths["gan"], "decoder"), (paths["gan"], "discriminator"),
                       (paths["fine_tune"], "voice_library"), (paths["f0"], "f0_estimator")):
        assert common.load_params_or_init(path, kind, CPU) is not None
    with pytest.raises(ValueError, match="GanState holds no content_encoder"):
        common.load_params_or_init(paths["gan"], "content_encoder", CPU)
    with pytest.raises(ValueError, match="not a content_encoder's parameters"):
        common.load_params_or_init(paths["f0"], "content_encoder", CPU)
