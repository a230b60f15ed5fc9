"""The JAX package's own F0 trainer CLI resumes a state the port's CLI wrote,
at full width on the CPU.

The port's ``train_f0_estimator`` takes 2 steps (one chunk of 6 400
samples, 2 epochs) into ``f0_estimator.ckpt`` (27.4 MB, the JAX
``F0TrainState`` with RAdam's moments).  ``alivevc_tpu.cli.
train_f0_estimator.main`` then runs on that file, unchanged, for one step;
the file it writes back reads in the port at step 3.  That step is held to
the port's ``train/f0.py:f0_train_step`` on the same state, the same batch
(the JAX dataset's chunk and WORLD labels) and the same amplitude, drawn
as the JAX CLI draws it: ``PRNGKey(1)`` split once, the second key into
``f0_train_step``'s ``uniform((N, 1)) * 0.75 + 0.25``.
"""

import shutil

import jax
import numpy as np
import torch

from alivevc_tpu.cli import train_f0_estimator as jax_cli
from alivevc_tpu.io.dataset import WaveChunkDataset
from alivevc_tpu_torch.cli import train_f0_estimator as port_cli
from alivevc_tpu_torch.compat import jax_train_state
from alivevc_tpu_torch.io.audio import write_wav
from alivevc_tpu_torch.train.f0 import f0_train_step

from test_torch_port_util import state_tensors, train_wave, worst_rel

LEN = 6400
STEP_TOL = 1e-5      # chip_smoke.py's resume gate for the F0 trainer


def test_jax_cli_resumes_a_port_written_f0_state(tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    write_wav(str(data / "0.wav"), train_wave(1, LEN + 100, seed=41)[0], 16_000)
    path = str(tmp_path / "f0_estimator.ckpt")
    flags = [str(data), "-mp", path, "-b", "1", "-len", str(LEN)]
    state = port_cli.main(flags + ["-e", "2", "--device", "cpu"])
    assert state.step == 2
    at_2 = str(tmp_path / "f0_estimator_step2.ckpt")
    shutil.copyfile(path, at_2)
    capsys.readouterr()

    jax_cli.main(flags + ["-e", "1"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "epoch 0 step 3" in out, out

    got = jax_train_state.read(path, "f0", "cpu")
    assert got.step == 3
    assert {int(s["step"]) for s in got.opt.state.values()} == {3}

    ds = WaveChunkDataset([str(data)], length=LEN, with_f0=True)
    assert len(ds) == 1
    _, sub = jax.random.split(jax.random.PRNGKey(1))
    amp = np.array(jax.random.uniform(sub, (1, 1)) * 0.75 + 0.25)
    mine = jax_train_state.read(at_2, "f0", "cpu")
    f0_train_step(mine, torch.from_numpy(ds.chunks), torch.from_numpy(ds.f0), torch.from_numpy(amp))
    err, name = worst_rel(state_tensors(mine), state_tensors(got))
    assert err <= STEP_TOL, (err, name)
