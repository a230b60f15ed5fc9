"""The port's four training CLIs on the CPU (``--device cpu``), on a
temporary directory of synthetic WAVs (16 kHz and 22.05 kHz) with the small
test widths: every model file and training state is written beforehand at
those widths, and each CLI builds its models at the widths its files hold.

Checks: the dataset against the JAX package's (chunks, batch order); the
step counts and the files each CLI writes; a training state resumes (step,
optimizer) and the inference CLIs' loader reads a model out of it; a
``GanState`` the JAX package wrote (``.ckpt``) resumes too, and an output
file that is neither ``.pt`` nor ``.ckpt`` is refused; and
``train_f0_estimator --dp`` as 2 gloo ranks under a torchrun-like environment, whose ranks hold 2 and 1
files and run the same number of steps (the minimum over the ranks).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from alivevc_tpu.io import dataset as jdataset
from alivevc_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint
from alivevc_tpu_torch.cli import common
from alivevc_tpu_torch.cli import fine_tune as cli_ft
from alivevc_tpu_torch.cli import generate_voice_library as cli_lib
from alivevc_tpu_torch.cli import train_decoder as cli_gan
from alivevc_tpu_torch.cli import train_f0_estimator as cli_f0
from alivevc_tpu_torch.config import VoiceLibraryConfig
from alivevc_tpu_torch.io import dataset as tdataset
from alivevc_tpu_torch.io.audio import write_wav
from alivevc_tpu_torch.models.voice_library import VoiceLibrary
from alivevc_tpu_torch.train.f0 import init_f0_train
from alivevc_tpu_torch.train.gan import init_gan
from alivevc_tpu_torch.train.state import load_train_state, save_reference_state, save_train_state

from test_torch_port_util import DEC_KW, jax_train_state, train_models, train_wave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train_cli"))
    data = os.path.join(tmp, "data")
    os.makedirs(os.path.join(data, "sub"))
    waves = train_wave(3, 21_000, seed=11)
    write_wav(os.path.join(data, "a.wav"), waves[0], 16_000)
    write_wav(os.path.join(data, "b.wav"), waves[1], 16_000)
    write_wav(os.path.join(data, "sub", "c.wav"), waves[2][:20_000], 22_050)
    _, (ce, f0m, dec, disc) = train_models(0)
    paths = {k: os.path.join(tmp, f"{k}.pt") for k in ("ce", "f0", "dec", "disc", "vl")}
    for k, m in (("ce", ce), ("f0", f0m), ("dec", dec), ("disc", disc),
                 ("vl", VoiceLibrary(VoiceLibraryConfig(num_tokens=64, dim=DEC_KW["content_channels"]),
                                     generator=torch.Generator().manual_seed(2)))):
        save_reference_state(paths[k], m)
    gan = init_gan(dec, disc)
    paths["gan"] = os.path.join(tmp, "gan_state.pt")
    save_train_state(paths["gan"], 0, {"decoder": dec, "discriminator": disc},
                     {"decoder": gan.opt_g, "discriminator": gan.opt_d})
    f0s = init_f0_train(f0m)
    paths["f0_state"] = os.path.join(tmp, "f0_state.pt")
    save_train_state(paths["f0_state"], 0, {"f0_estimator": f0m}, {"f0_estimator": f0s.opt})
    return tmp, data, paths


def test_dataset_matches_jax(files):
    """The same chunks as the JAX package's WaveChunkDataset (the 22.05 kHz
    file resampled: 1e-4 abs, the resamplers' float32 sums in another
    order), the same host shards, and the same shuffled batches."""
    _, data, _ = files
    for shard in (None, (0, 2), (1, 2)):
        got = tdataset.WaveChunkDataset([data], length=9600, host_shard=shard)
        want = jdataset.WaveChunkDataset([data], length=9600, host_shard=shard)
        assert got.chunks.shape == want.chunks.shape and len(got) == len(want)
        assert np.abs(got.chunks - want.chunks).max() <= 1e-4
    batches = list(tdataset.batch_iterator(got, 1, seed=3))
    assert len(batches) == len(got) and np.array_equal(
        np.concatenate(batches), np.concatenate(list(jdataset.batch_iterator(want, 1, seed=3))))
    with pytest.raises(ValueError):
        tdataset.WaveChunkDataset([data], host_shard=(2, 2))


def test_train_decoder_cli(files, capsys):
    tmp, data, paths = files
    state = cli_gan.main([data, "-sp", paths["gan"], "-cep", paths["ce"], "-f0ep", paths["f0"],
                          "-e", "1", "-b", "2", "-len", "9600", "--save-every", "1",
                          "--device", "cpu"])
    # 2 + 2 + 1 chunks of 9 600 samples (the 22.05 kHz file resampled): 2 batches
    assert state.step == 2
    saved = load_train_state(paths["gan"])
    assert saved["step"] == 2 and saved["configs"]["decoder"]["channels"] == DEC_KW["channels"]
    dec = common.load_params_or_init(paths["gan"], "decoder", torch.device("cpu"))
    assert all(torch.equal(v, state.dec.state_dict()[k]) for k, v in dec.state_dict().items())
    # a GanState the JAX package wrote (.ckpt) resumes; another extension is refused
    jax_sp = os.path.join(tmp, "gan_state.ckpt")
    jsave_checkpoint(jax_sp, jax_train_state("gan", train_models(0)[0])._replace(
        step=jnp.asarray(2, jnp.int32)))
    capsys.readouterr()
    state = cli_gan.main([data, "-sp", jax_sp, "-cep", paths["ce"], "-f0ep", paths["f0"],
                          "-e", "1", "-b", "2", "-len", "9600", "--device", "cpu"])
    assert "resumed at step 2" in capsys.readouterr().out and state.step == 4
    with pytest.raises(SystemExit, match=r"\.pt .*\.ckpt"):
        cli_gan.main([data, "-sp", os.path.join(tmp, "gan_state.bin"), "--device", "cpu"])


def test_fine_tune_cli_writes_and_resumes(files):
    tmp, data, paths = files
    dep = os.path.join(tmp, "ft_decoder.pt")
    lib = os.path.join(tmp, "ft_library.pt")
    sp = os.path.join(tmp, "ft_state.pt")
    torch.save(torch.load(paths["dec"]), dep)
    torch.save(torch.load(paths["vl"]), lib)
    args = [data, "-dep", dep, "-disp", paths["disc"], "-cep", paths["ce"], "-f0ep", paths["f0"],
            "-lib", lib, "-sp", sp, "-e", "3", "-b", "1", "-len", "9600", "--device", "cpu"]
    state = cli_ft.main(args + ["--max-step", "2"])
    assert state.step == 2
    tokens = torch.load(lib)["tokens"]
    assert not torch.equal(tokens, torch.load(paths["vl"])["tokens"])      # the library trained
    state = cli_ft.main(args + ["--max-step", "3", "-fd"])
    assert state.step == 3 and load_train_state(sp)["step"] == 3
    assert int(state.opt_vl.state[state.vl.tokens]["step"]) == 3          # optimizer resumed
    vl = common.load_params_or_init(lib, "voice_library", torch.device("cpu"))
    assert vl.tokens.shape == (1, DEC_KW["content_channels"], 64)


def test_train_f0_estimator_cli(files):
    tmp, data, paths = files
    state = cli_f0.main([data, "-mp", paths["f0_state"], "-e", "2", "-b", "2", "-len", "6400",
                         "--device", "cpu"])
    # 3 + 3 + 2 chunks of 6 400 samples: 4 batches an epoch
    assert state.step == 8 and load_train_state(paths["f0_state"])["step"] == 8


def test_generate_voice_library_cli(files):
    tmp, data, paths = files
    out = os.path.join(tmp, "generated.pt")
    vl = cli_lib.main([data, "-lib", out, "-cep", paths["ce"], "--device", "cpu"])
    sd = torch.load(out)
    assert sd["tokens"].shape == (1, DEC_KW["content_channels"], 512)
    assert torch.equal(sd["tokens"], vl.tokens.detach())


def test_train_f0_estimator_cli_dp_two_ranks(files):
    """2 gloo ranks: rank 0 loads a.wav and sub/c.wav (3 + 2 chunks of
    6 400), rank 1 b.wav (3): each takes 1 item a step, and both run 3
    steps, the minimum."""
    tmp, data, paths = files
    state = os.path.join(tmp, "f0_dp_state.pt")
    torch.save(torch.load(paths["f0_state"]), state)
    start = load_train_state(state)["step"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "alivevc_tpu_torch.cli.train_f0_estimator", data, "-mp", state,
             "-e", "1", "-b", "2", "-len", "6400", "--dp", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    steps = [int(line.split()[3]) for line in outs[0].splitlines() if line.startswith("epoch 0 step")]
    assert steps == [start + 1, start + 2, start + 3], outs[0]
    assert "Loaded 5 chunks" in outs[0] and "Loaded 3 chunks" in outs[1]
    assert load_train_state(state)["step"] == start + 3
